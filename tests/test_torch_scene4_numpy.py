"""Scene 4 cut to 540 kb (tests/test_torch_scene4.py) through the port's
``numpy`` backend (its copy of the NumPy oracle, on the host) on the runs
``scene4`` and ``scene4_c`` (``scene4_bed`` is in
tests/test_torch_scene4_hosts.py, to keep each file under two minutes):
every report file's digest equal to the reference's on the cut scene
(``testing/scene4_digests.json``)."""
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


def numpy_run(tmp_path, paths, name):
    """The port's numpy backend on run ``name`` of the cut scene, held to
    the reference's digests."""
    prefix = str(tmp_path / "numpy")
    assert port_main(bam_argv(SCENE4_RUNS[name], paths, prefix) + CUT_FLAGS
                     + ["--backend", "numpy", "--device", "cpu"]) == 0
    assert scenes.digests(scenes.reports(prefix)) == cut_digests()[name]


@pytest.mark.parametrize("name", ["scene4", "scene4_c"])
def test_numpy_matches_reference(tmp_path, paths, name):
    numpy_run(tmp_path, paths, name)
