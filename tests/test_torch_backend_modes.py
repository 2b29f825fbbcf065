"""The port's ``--backend numpy`` and ``--backend jax`` in the modes beside
discovery, on the CPU: ``-q``, ``-z`` and ``--hosts 2`` must write reports
byte-identical to ``python -m pindel_tpu --backend <same name>`` (one
process for ``--hosts``, whose reports are a one-process run's), and
``numpy`` runs ``-x 5``, which the device backends refuse, as the
reference's does."""
import os

import pytest
import torch

from test_torch_backends import NAMES, _both, _text
from pindel_tpu_torch.testing.scenes import BAM_SCENES, bam_argv, load_golden

torch.set_num_threads(1)


@pytest.mark.parametrize("backend", NAMES)
@pytest.mark.parametrize("scene", ["dd_q", "assembly_z"])
def test_bam_mode(tmp_path, scene, backend):
    spec = BAM_SCENES[scene]
    paths = spec.build(str(tmp_path))
    want, got = _both(tmp_path, lambda p: bam_argv(spec, paths, p), backend)
    assert got == want
    assert got == load_golden()[scene]


@pytest.mark.parametrize("backend", NAMES)
def test_hosts(tmp_path, monkeypatch, backend):
    """Two ranks over three 20 kb windows write the one-process reports of
    the reference's same backend name."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    argv_of = _text(tmp_path, "seed0")
    want, got = _both(tmp_path, lambda p: argv_of(p) + ["-w", "0.02"],
                      backend, ["--hosts", "2"])
    assert got == want and got["D"]
    from pindel_tpu_torch.parallel import multihost
    assert [r["devices"] for r in multihost.LAST_RANKS] == [["cpu"]] * 2
    assert all(r["windows"] for r in multihost.LAST_RANKS)


def test_numpy_runs_wide_far_rounds(tmp_path):
    """-x 5: the device backends refuse it (the window outgrows the
    spacer); the NumPy backend runs it, in both packages."""
    from pindel_tpu_torch.testing.scenes import write_scene
    fa, reads_txt, _n = write_scene(str(tmp_path), seed=4, chrom_len=20_000,
                                    reads_per_event=4, kinds=["DEL"],
                                    n_noise=2)
    want, got = _both(tmp_path, lambda p: ["-f", fa, "-p", reads_txt, "-s",
                                           "-x", "5", "-o", p], "numpy")
    assert got == want and got["D"]
