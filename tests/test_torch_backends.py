"""The port's ``--backend numpy`` and ``--backend jax`` on the CPU.

``numpy`` runs the port's copy of the NumPy oracle on the host and ``jax``
runs the per-lane search (K8, ``TorchLaneBackend``) for every search; each
must write reports byte-identical to ``python -m pindel_tpu --backend <same
name>`` on two text scenes and two BAM scenes (``-q``, ``-z``, ``--hosts 2``
and ``-x 5``: tests/test_torch_backend_modes.py; the converters:
tests/test_torch_converters.py).
"""
import os

import numpy as np
import pytest
import torch

from pindel_tpu.__main__ import main as reference_main
from pindel_tpu_torch.__main__ import main as port_main
from pindel_tpu_torch.config import Settings
from pindel_tpu_torch.ops.engine_jax import TorchLaneBackend
from pindel_tpu_torch.pipeline import make_backend_factory
from pindel_tpu_torch.testing.scenes import (BAM_SCENES, SMALL_SCENES,
                                             bam_argv, load_golden, reports,
                                             write_scene)

torch.set_num_threads(1)

NAMES = ["numpy", "jax"]


def _both(tmp_path, argv_of, backend, port_extra=()):
    """The reference's CLI and the port's (on the CPU) with ``backend``;
    returns both runs' reports."""
    ref = str(tmp_path / "ref" / "out")
    port = str(tmp_path / "port" / "out")
    os.makedirs(os.path.dirname(ref))
    os.makedirs(os.path.dirname(port))
    assert reference_main(argv_of(ref) + ["--backend", backend]) == 0
    assert port_main(argv_of(port) + ["--backend", backend, "--device", "cpu",
                                      *port_extra]) == 0
    return reports(ref), reports(port)


def _text(tmp_path, scene):
    scene_kw, flags, _fields = SMALL_SCENES[scene]
    fa, reads_txt, _n = write_scene(str(tmp_path), **scene_kw)
    return lambda prefix: ["-f", fa, "-p", reads_txt, "-s", *flags,
                           "-o", prefix]


@pytest.mark.parametrize("backend", NAMES)
@pytest.mark.parametrize("scene", ["seed0", "seed11_inv_td"])
def test_text_scene(tmp_path, scene, backend):
    want, got = _both(tmp_path, _text(tmp_path, scene), backend)
    assert got == want
    assert got == load_golden()[scene]
    assert got["CloseEndMapped"]


@pytest.mark.parametrize("backend", NAMES)
@pytest.mark.parametrize("scene", ["bam_seed3", "bam_bd_bigdel"])
def test_bam_scene(tmp_path, scene, backend):
    spec = BAM_SCENES[scene]
    paths = spec.build(str(tmp_path))
    want, got = _both(tmp_path, lambda p: bam_argv(spec, paths, p), backend)
    assert got == want
    assert got == load_golden()[scene]


def test_backend_factory(monkeypatch):
    """numpy is no factory and needs no card; jax is TorchLaneBackend on
    the device; unknown names raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    s = Settings()
    assert make_backend_factory(s, "cuda", "numpy") is None

    class Chrom:
        seq = np.zeros(1000, np.int8)
        name = "chrT"

    backend = make_backend_factory(s, "cpu", "jax")(Chrom())
    assert isinstance(backend, TorchLaneBackend)
    assert backend.device == torch.device("cpu")
    assert backend.chrom_name == "chrT"
    with pytest.raises(RuntimeError, match="cuda"):
        make_backend_factory(s, "cuda", "jax")
    with pytest.raises(ValueError, match="unknown backend"):
        make_backend_factory(s, "cpu", "tpu")
