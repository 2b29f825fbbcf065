"""The port's multi-GPU data-parallel backend (``TorchMeshBackend``, K10)
on the CPU, over lists of CPU devices.

Its three dispatch points must give, bit for bit, what
``TorchFusedBackend``'s give and what the JAX package's ``MeshFusedBackend``
gives on a dp mesh of the same size (the 8-device CPU mesh of
tests/conftest.py), on the inputs of tests/test_torch_engine.py; runs with
``backend="mesh"`` must write the reports of the reference's ``--backend
mesh`` and of the port's ``fused`` backend, for pindel-text, BAM with
BreakDancer windows, ``-q`` and ``-z``.  Tolerance 0 throughout: the search
is integer-only.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pindel_tpu.__main__ import main as reference_main
from pindel_tpu.config import Settings
from pindel_tpu.parallel.mesh_fused import MeshFusedBackend, make_dp_mesh
from pindel_tpu.search import Searcher
from pindel_tpu_torch.__main__ import build_parser, main as port_main
from pindel_tpu_torch.__main__ import settings_from_args
from pindel_tpu_torch.ops import engine_fused as tx
from pindel_tpu_torch.parallel.mesh_fused import TorchMeshBackend
from pindel_tpu_torch.pipeline import (run_assembly_files, run_dd_files,
                                       run_files)
from pindel_tpu_torch.testing.scenes import (BAM_SCENES, bam_argv,
                                             load_golden, reports,
                                             write_scene)
from test_search_semantics import make_genome, sample_reads
from test_torch_engine import budgets, far_win_payload, read_codes, to_port

# one intra-op thread: the test workers share the machine's cores, and
# torch's per-op thread pool oversubscribes them (the scan is many small ops)
torch.set_num_threads(1)

N_DEVICES = (1, 2, 4, 8)
MESH4 = ["cpu"] * 4


def _rows_multiple_of(payload: np.ndarray, k: int = 8) -> np.ndarray:
    """The payload with its first rows repeated up to a multiple of ``k``
    rows (a launch's rows always divide by the device count)."""
    n = -(-payload.shape[0] // k) * k
    return np.concatenate([payload, payload[:n - payload.shape[0]]])


def close_case():
    """tests/test_torch_engine.py::test_close_kernel_matches_jax's inputs."""
    rng = np.random.default_rng(3)
    settings = Settings()
    chrom = make_genome(rng).chromosomes[0]
    reads = sample_reads(rng, chrom, n_reads=40)
    lmax = 128
    codes, qlen = read_codes(reads, lmax)
    minus = np.array([r.matched_d == "-" for r in reads])
    pos = np.array([r.matched_rel_pos for r in reads], np.int64)
    isz = np.array([r.insert_size for r in reads], np.int64)
    ms, tm, thr = budgets(settings, qlen)
    payload = tx._pack_payload(
        np.concatenate([codes, tx._reverse_codes_np(codes, qlen)], axis=1),
        tx._close_meta(pos, isz, qlen, ms, tm, thr, minus))
    static = dict(w0=tx.TorchFusedBackend._w_bucket(int(isz.max())),
                  w1=tx.TorchFusedBackend._w_bucket(3 * int(isz.max())),
                  lmax=lmax, mpm=settings.min_perfect_match_around_bp,
                  bp_start=settings.min_close, lsteps=64, with_r1=True)
    return settings, chrom, payload, static


def far_case():
    """tests/test_torch_engine.py::test_far_kernel_matches_jax's inputs at
    -x 2."""
    rng = np.random.default_rng(4)
    settings = Settings()
    chrom = make_genome(rng).chromosomes[0]
    reads = sample_reads(rng, chrom, n_reads=36)
    searcher = Searcher(settings)
    searcher.map_close_ends(chrom, reads)
    kept = searcher.finalize_close_ends(reads)
    lmax = 128
    codes, qlen = read_codes(kept, lmax)
    ms, tm, thr = budgets(settings, qlen)
    payload = tx._pack_payload(codes, tx._far_meta(
        np.array([r.last_abs_loc_close_end() for r in kept], np.int64),
        qlen, np.array([r.max_len_close() for r in kept], np.int32),
        np.array([r.max_len_far() for r in kept], np.int32),
        ms, tm, thr, chrom.comp_size))
    spans = tuple(64 * 4 ** k for k in range(3))
    static = dict(spans=spans,
                  ws=tuple(tx.TorchFusedBackend._w_bucket(2 * s)
                           for s in spans),
                  lmax=lmax, mpm=settings.min_perfect_match_around_bp,
                  bp_start=10, lsteps=64)
    return settings, chrom, payload, static


def far_win_case():
    """tests/test_torch_engine.py::test_far_win_kernel_matches_jax's
    inputs at w=2048, lmax=128."""
    w, lmax = 2048, 128
    rng = np.random.default_rng(w + lmax)
    settings = Settings()
    chrom = make_genome(rng, length=20_000).chromosomes[0]
    payload, qmax = far_win_payload(rng, settings, chrom, w, lmax)
    static = dict(w=w, lmax=lmax, mpm=settings.min_perfect_match_around_bp,
                  bp_start=10, lsteps=tx._round_up(qmax, 16))
    return settings, chrom, payload, static


CASES = {"close": (close_case, "_close_call"),
         "far": (far_case, "_far_call"),
         "far_win": (far_win_case, "_far_win_call")}


@pytest.mark.parametrize("call", list(CASES))
@pytest.mark.parametrize("n", N_DEVICES)
def test_mesh_dispatch_matches_fused_and_reference(n, call):
    build, method = CASES[call]
    settings, chrom, payload, static = build()
    payload = _rows_multiple_of(payload)
    port_settings = to_port(settings)
    maxmm = settings.max_mismatch()
    fused = tx.TorchFusedBackend(port_settings, maxmm, chrom.seq,
                                 chrom_name=chrom.name, device="cpu")
    mesh = TorchMeshBackend(port_settings, maxmm, chrom.seq, ["cpu"] * n,
                            chrom_name=chrom.name)
    assert len(mesh.states) == 1            # one replica per distinct device
    got = getattr(mesh, method)(payload, **static).get()
    want = getattr(fused, method)(payload, **static).get()
    ref = MeshFusedBackend(settings, maxmm, chrom.seq, make_dp_mesh(n),
                           chrom_name=chrom.name)
    ref_out = np.asarray(getattr(ref, method)(
        ref.chromcat_dev, jnp.asarray(payload), ref.maxmm_dev, **static))
    assert got.dtype == np.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, ref_out)
    assert (got[:, static["lmax"] // 32] != 0).any()     # chains emit


@pytest.mark.parametrize("call", list(CASES))
def test_mesh_shards_each_reach_the_scan(monkeypatch, call):
    """Over four devices every scan call of the fused backend becomes four,
    one per shard, each on a quarter of the rows and on its shard's
    device."""
    build, method = CASES[call]
    settings, chrom, payload, static = build()
    payload = _rows_multiple_of(payload)
    port_settings = to_port(settings)
    maxmm = settings.max_mismatch()
    scan = tx.scan_rows
    calls = []

    def recording(tiles, *a, **kw):
        calls.append((tiles.shape[0], tiles.device.type))
        return scan(tiles, *a, **kw)

    monkeypatch.setattr(tx, "scan_rows", recording)
    fused = tx.TorchFusedBackend(port_settings, maxmm, chrom.seq,
                                 chrom_name=chrom.name, device="cpu")
    getattr(fused, method)(payload, **static).get()
    fused_calls, calls[:] = list(calls), []
    mesh = TorchMeshBackend(port_settings, maxmm, chrom.seq, MESH4,
                            chrom_name=chrom.name)
    getattr(mesh, method)(payload, **static).get()
    assert fused_calls
    assert sorted(calls) == sorted(
        (rows // 4, dev) for rows, dev in fused_calls for _ in range(4))


def test_mesh_refuses_indivisible_buckets():
    """Three devices do not divide the reference's 256-row bucket, and its
    assert fails.  The port has no buckets (a launch takes a chunk's real
    rows, rounded up to dp): over three devices it gives the fused
    backend's rows, and refuses with ValueError (an assert would vanish
    under python -O) only a payload whose rows do not split over them."""
    settings, chrom, payload, static = far_win_case()
    port_settings = to_port(settings)
    maxmm = settings.max_mismatch()
    payload = _rows_multiple_of(payload, 3)
    mesh = TorchMeshBackend(port_settings, maxmm, chrom.seq, ["cpu"] * 3,
                            chrom_name=chrom.name)
    fused = tx.TorchFusedBackend(port_settings, maxmm, chrom.seq,
                                 chrom_name=chrom.name, device="cpu")
    np.testing.assert_array_equal(mesh._far_win_call(payload, **static).get(),
                                  fused._far_win_call(payload, **static).get())
    with pytest.raises(ValueError, match="split over 3 devices"):
        mesh._far_win_call(payload[:-1], **static)
    with pytest.raises(AssertionError, match="divide"):
        MeshFusedBackend(settings, settings.max_mismatch(), chrom.seq,
                         make_dp_mesh(3))


# ------------------------------------------------------------ end to end
def _same(got, want, label):
    assert set(got) == set(want), label
    for suffix, data in want.items():
        assert got[suffix] == data, f"_{suffix} differs from {label}"


@pytest.mark.parametrize("seed", [0, 11])
def test_mesh_text_reports_match(tmp_path, seed):
    """tests/test_mesh_pipeline.py's scenes through run_files(backend=
    "mesh") on four CPU devices: the reports of the reference's --backend
    mesh (8-device CPU mesh) and of the port's fused backend."""
    fa, reads_txt, _n = write_scene(
        str(tmp_path), seed=seed, kinds=["DEL", "SI", "DI", "INV", "TD"],
        chrom_len=60_000, reads_per_event=10, n_noise=16)
    argv = ["-f", fa, "-p", reads_txt, "-s"]
    prefix = {k: str(tmp_path / k) for k in ("mesh", "fused", "ref")}
    args = build_parser().parse_args(argv + ["-o", prefix["mesh"]])
    win0 = tx.FAR_WIN_ROWS
    run_files(fa, reads_txt, prefix["mesh"], settings=settings_from_args(args),
              device="cpu", backend="mesh", devices=MESH4)
    assert port_main(argv + ["-o", prefix["fused"], "--device", "cpu"]) == 0
    assert reference_main(argv + ["-o", prefix["ref"],
                                  "--backend", "mesh"]) == 0
    mesh = reports(prefix["mesh"])
    assert b"ChrID" in mesh["D"]
    _same(mesh, reports(prefix["ref"]), "the reference's mesh")
    _same(mesh, reports(prefix["fused"]), "the port's fused")
    assert tx.FAR_WIN_ROWS == win0          # text input: no evidence windows


@pytest.mark.parametrize("name", ["bam_bd_bigdel", "dd_q", "assembly_z"])
def test_mesh_bam_modes_match_golden(tmp_path, name):
    """BAM + BreakDancer discovery (through the sharded _far_win_kernel),
    -q and -z with backend="mesh" on four CPU devices write the golden
    reports (pindel_tpu's NumPy backend)."""
    scene = BAM_SCENES[name]
    prefix = str(tmp_path / "mesh")
    argv = bam_argv(scene, scene.build(str(tmp_path)), prefix)
    args = build_parser().parse_args(argv)
    s = settings_from_args(args)
    win0 = tx.FAR_WIN_ROWS
    if args.assembly:
        run_assembly_files(args.fasta, args.config, args.assembly, prefix,
                           settings=s, device="cpu", backend="mesh",
                           devices=MESH4)
    elif args.detect_DD:
        run_dd_files(args.fasta, args.config, prefix, settings=s,
                     device="cpu", backend="mesh", devices=MESH4)
    else:
        run_files(args.fasta, None, prefix, settings=s, device="cpu",
                  bam_config=args.config, backend="mesh", devices=MESH4)
    if scene.far_win:
        assert tx.FAR_WIN_ROWS > win0
    _same(reports(prefix), load_golden()[name], "the golden reports")


def test_cli_backend_mesh(tmp_path):
    """--backend mesh on --device cpu (one CPU device) writes the golden
    reports; an unknown backend name is refused."""
    fa, reads_txt, _n = write_scene(str(tmp_path), seed=0)
    prefix = str(tmp_path / "cli")
    assert port_main(["-f", fa, "-p", reads_txt, "-o", prefix, "-s",
                      "--device", "cpu", "--backend", "mesh"]) == 0
    _same(reports(prefix), load_golden()["seed0"], "the golden reports")
    with pytest.raises(SystemExit):
        port_main(["-f", fa, "-p", reads_txt, "-o", prefix,
                   "--device", "cpu", "--backend", "tpu"])
    assert os.path.exists(prefix + "_D")


def test_mesh_on_cuda_without_card_raises(tmp_path):
    """``mesh`` on CUDA without a card is an error, as ``fused`` is."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from pindel_tpu_torch.parallel.mesh_fused import make_device_list
    with pytest.raises(RuntimeError, match="cuda"):
        make_device_list()
    fa, reads_txt, _n = write_scene(str(tmp_path), seed=4, chrom_len=20_000,
                                    reads_per_event=2, kinds=["DEL"],
                                    n_noise=2)
    with pytest.raises(RuntimeError, match="cuda"):
        port_main(["-f", fa, "-p", reads_txt, "-o", str(tmp_path / "x"),
                   "--backend", "mesh"])
