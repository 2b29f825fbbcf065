"""Scene 4 cut to 540 kb (tests/test_torch_scene4.py) through the port's
data-parallel ``mesh`` backend over two CPU shards, and through the JAX
package's ``fused`` backend, on the three runs: every report file's digest
equal to the reference's on the cut scene (``testing/scene4_digests.json``,
written by the JAX package's numpy backend), so the digests are fresh too.
The port's ``jax`` backend is in tests/test_torch_scene4_jax.py, its
``numpy`` backend in tests/test_torch_scene4_numpy.py and
tests/test_torch_scene4_hosts.py, ``--hosts 2`` in the latter.  Each file
stays under two minutes on the CPU alone."""
import pytest
import torch

from pindel_tpu.__main__ import main as reference_main
from pindel_tpu_torch.__main__ import build_parser, settings_from_args
from pindel_tpu_torch.pipeline import run_files
from pindel_tpu_torch.testing import scenes
from pindel_tpu_torch.testing.scenes import SCENE4_RUNS, bam_argv
from test_torch_scene4 import CUT_FLAGS, cut_digests

# one intra-op thread: the test workers share the machine's cores, and
# torch's per-op thread pool oversubscribes them (the scan is many small ops)
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    return scenes.build_scene4(str(tmp_path_factory.mktemp("scene4_cut")),
                               cut=scenes.SCENE4_CUT)


@pytest.mark.parametrize("name", list(SCENE4_RUNS))
def test_mesh_matches_reference(tmp_path, paths, name):
    prefix = str(tmp_path / "mesh")
    args = build_parser().parse_args(
        bam_argv(SCENE4_RUNS[name], paths, prefix) + CUT_FLAGS)
    run_files(args.fasta, None, prefix, settings=settings_from_args(args),
              device="cpu", bam_config=args.config, backend="mesh",
              devices=["cpu", "cpu"])
    assert scenes.digests(scenes.reports(prefix)) == cut_digests()[name]


@pytest.mark.parametrize("name", list(SCENE4_RUNS))
def test_jax_package_fused_matches_reference(tmp_path, paths, name):
    prefix = str(tmp_path / "fused")
    assert reference_main(bam_argv(SCENE4_RUNS[name], paths, prefix)
                          + CUT_FLAGS + ["--backend", "fused"]) == 0
    assert scenes.digests(scenes.reports(prefix)) == cut_digests()[name]
