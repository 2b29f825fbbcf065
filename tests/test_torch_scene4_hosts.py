"""Scene 4 cut to 540 kb (tests/test_torch_scene4.py) at ``--hosts 2``
(two processes, the windows dealt out in turn, rank 0 reporting them in
order, the interchromosomal pool among them), in the port and in the JAX
package, with the fused backend on the CPU, on the runs over more than
one window (``scene4``, ``scene4_bed``; at one window the second rank owns
none): the two packages' reports are byte-identical, and equal to the
reference's one-process digests of the cut scene
(``testing/scene4_digests.json``).  Also the port's numpy backend on
``scene4_bed`` (tests/test_torch_scene4_numpy.py has the other runs)."""
import pytest
import torch

from pindel_tpu.__main__ import main as reference_main
from pindel_tpu_torch.__main__ import main as port_main
from pindel_tpu_torch.testing import scenes
from pindel_tpu_torch.testing.scenes import SCENE4_RUNS, bam_argv
from test_torch_scene4 import CUT_FLAGS, cut_digests
from test_torch_scene4_numpy import numpy_run

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def one_thread_workers(monkeypatch):
    """Worker processes inherit the environment: one torch thread each."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    return scenes.build_scene4(str(tmp_path_factory.mktemp("scene4_cut")),
                               cut=scenes.SCENE4_CUT)


@pytest.mark.parametrize("name", ["scene4", "scene4_bed"])
def test_hosts2_matches_jax_package(tmp_path, paths, name):
    argv = bam_argv(SCENE4_RUNS[name], paths, str(tmp_path / "x")) + CUT_FLAGS
    out = {}
    for who, main, extra in (
            ("port", port_main, ["--device", "cpu"]),
            ("jax", reference_main, [])):
        prefix = str(tmp_path / who)
        argv[argv.index("-o") + 1] = prefix
        assert main(argv + ["--hosts", "2", "--backend", "fused", *extra]) \
            == 0
        out[who] = scenes.reports(prefix)
    assert out["port"] == out["jax"]
    assert scenes.digests(out["port"]) == cut_digests()[name]
    if name == "scene4":
        assert b"Anchor + chr1" in out["port"]["INT"]


def test_numpy_matches_reference_bed(tmp_path, paths):
    numpy_run(tmp_path, paths, "scene4_bed")
