"""Scene 4 cut to 540 kb (tests/test_torch_scene4.py) through the port's
``jax`` backend (the per-lane search for every search, K8's plain version
on the CPU) on the three runs: every report file's digest equal to the
reference's on the cut scene (``testing/scene4_digests.json``)."""
import pytest
import torch

from pindel_tpu_torch.__main__ import main as port_main
from pindel_tpu_torch.testing import scenes
from pindel_tpu_torch.testing.scenes import SCENE4_RUNS, bam_argv
from test_torch_scene4 import CUT_FLAGS, cut_digests

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    return scenes.build_scene4(str(tmp_path_factory.mktemp("scene4_cut")),
                               cut=scenes.SCENE4_CUT)


@pytest.mark.parametrize("name", list(SCENE4_RUNS))
def test_jax_backend_matches_reference(tmp_path, paths, name):
    prefix = str(tmp_path / "jax")
    assert port_main(bam_argv(SCENE4_RUNS[name], paths, prefix) + CUT_FLAGS
                     + ["--backend", "jax", "--device", "cpu"]) == 0
    assert scenes.digests(scenes.reports(prefix)) == cut_digests()[name]
