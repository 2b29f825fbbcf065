"""K2 (``_close_kernel``), K3 (``_far_kernel``) and K4 (``_far_win_kernel``)
of the port against the JAX package's, on the CPU, on the inputs built for
the fused kernels' edge cases (``pindel_tpu_torch/testing/fused_cases.py``,
lmax 128 to 512); every comparison is exact (tolerance 0: the search is
integer-only).

On the CPU the port runs the plain versions (``_close_kernel_ref``,
``_far_kernel_ref``, ``_far_win_kernel_ref``); the CUDA kernels
(``csrc/fused_search.cu``) compute the same function on the card, where
chip_smoke.py holds them against these plain versions on the same cases.
Here the tests also check:

* that a launch's real rows do not depend on the padding rows after them
  (the backend now sends a chunk's real rows, rounded up to ``dp``, where it
  sent a ``B_BUCKETS`` size), for K2, K3 and K4 in both packages;
* the rows the fused kernels skip, on the plain version: the range-1 window
  of a read with a range-0 emission, and the windows of a far round after a
  read's first inactive round, scrambled, leave the output unchanged;
* the dispatch: a CPU tensor never reaches ``fused_cuda``, which refuses
  CPU tensors, and the wrappers' checks;
* the rows ``measure.fused_rows`` counts for each kernel's bound.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pindel_tpu.config import Settings
from pindel_tpu.ops import engine_fused as jx
from pindel_tpu_torch.ops import engine_fused as tx
from pindel_tpu_torch.ops import fused_cuda
from pindel_tpu_torch.testing.fused_cases import (CASES, FAR_WIN_CASES,
                                                  fused_case)
from pindel_tpu_torch.tools import measure
from test_search_semantics import make_genome, sample_reads
from test_torch_engine import (assert_same, far_win_payload, run_port_search,
                               to_port, torch_backend)

# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)

JIT = {"_close_kernel": jx._close_kernel_jit,
       "_far_kernel": jx._far_kernel_jit,
       "_far_win_kernel": jx._far_win_kernel_jit}
PORT = {"_close_kernel": tx._close_kernel, "_far_kernel": tx._far_kernel,
        "_far_win_kernel": tx._far_win_kernel}


def port_call(name, chrom, maxmm, payload, static):
    return PORT[name](tx._chrom_cat(torch.from_numpy(chrom)),
                      torch.from_numpy(payload.copy()),
                      torch.from_numpy(maxmm.copy()), **static)


def jax_call(name, chrom, maxmm, payload, static):
    return np.asarray(JIT[name](jx._chrom_cat(jnp.asarray(chrom)),
                                jnp.asarray(payload), jnp.asarray(maxmm),
                                **static))


def flags_of(out, static):
    return out[:, static["lmax"] // 32 + 1].numpy()


# ------------------------------------------------------------ edge cases
@pytest.mark.parametrize("case", CASES)
def test_fused_case_matches_jax(case):
    name, chrom, maxmm, payload, static = fused_case(case)
    got = port_call(name, chrom, maxmm, payload, static)
    assert got.dtype == torch.int32
    assert got.shape == (payload.shape[0], static["lmax"] // 32 + 2)
    assert_same(got, jax_call(name, chrom, maxmm, payload, static))
    flags = flags_of(got, static)
    if case in ("close", "close_full"):
        # every attempt wins somewhere, and some reads emit nowhere
        assert set(np.unique(flags & 255)) == {0, 1, 2, 3, 255}
    if case == "close_r0":
        assert set(np.unique(flags & 255)) <= {0, 1, 255}
    if case.startswith("far_x") and case != "far_x0":
        rounds = (flags & 255)[(flags >> 8) & 1 == 1]
        assert len(set(rounds.tolist())) > 1    # replaced in several rounds
    if case in ("close_long384", "close_long512", "far_long384",
                "far_long512") or case in FAR_WIN_CASES:
        # some reads emit, and (K4) some do not
        words = got[:, :static["lmax"] // 32].numpy()
        assert (words != 0).any()
        if case in FAR_WIN_CASES:
            assert set(np.unique(flags & 1)) == {0, 1}


# ------------------------------------------------------- real rows only
def pad_rows(name, payload, static, chrom, rows):
    """``payload`` with padding rows after its own, as the backend pads a
    launch: no sequence, qlen 1 (and close_max 1), budgets of 0."""
    lmax = static["lmax"]
    settings = Settings()
    n = rows - payload.shape[0]
    ms = np.zeros(n, np.int32)
    tm = ms + settings.additional_mismatch
    thr = np.full(n, int(np.ceil(np.float32(settings.max_allowed_mismatch_rate))),
                  np.int32)
    one = np.ones(n, np.int32)
    zero = np.zeros(n, np.int64)
    if name == "_close_kernel":
        meta = tx._close_meta(zero, zero, one, ms, tm, thr,
                              np.zeros(n, bool))
        codes = np.full((n, 2 * lmax), tx.dna.N, np.int8)
    elif name == "_far_kernel":
        meta = tx._far_meta(zero, one, one, np.zeros(n, np.int32), ms, tm,
                            thr, chrom.shape[0])
        codes = np.full((n, lmax), tx.dna.N, np.int8)
    else:
        meta = np.zeros((n, tx.FW_WORDS), np.int32)
        meta[:, 2] = 1
        meta[:, 3] = ms | (tm << 8) | (thr << 16)
        codes = np.full((n, lmax), tx.dna.N, np.int8)
    return np.concatenate([payload, tx._pack_payload(codes, meta)])


def far_win_case():
    rng = np.random.default_rng(7)
    settings = Settings()
    chrom = make_genome(rng, length=20_000).chromosomes[0]
    w, lmax = 2048, 128
    payload, qmax = far_win_payload(rng, settings, chrom, w, lmax)
    static = dict(w=w, lmax=lmax, mpm=settings.min_perfect_match_around_bp,
                  bp_start=10, lsteps=tx._round_up(qmax, 16))
    return ("_far_win_kernel", chrom.seq, settings.max_mismatch(), payload,
            static)


@pytest.mark.parametrize("package", ["port", "jax"])
@pytest.mark.parametrize("kernel", ["close", "far_x2", "far_win"])
def test_real_rows_do_not_depend_on_padding(kernel, package):
    name, chrom, maxmm, payload, static = (
        far_win_case() if kernel == "far_win" else fused_case(kernel))
    n = payload.shape[0]
    padded = pad_rows(name, payload, static, chrom, 256)
    call = port_call if package == "port" else jax_call
    alone = np.asarray(call(name, chrom, maxmm, payload, static))
    with_pad = np.asarray(call(name, chrom, maxmm, padded, static))
    assert with_pad.shape[0] == 256
    np.testing.assert_array_equal(with_pad[:n], alone)


@pytest.mark.parametrize("mesh", [False, True])
def test_backend_launches_real_rows(mesh, monkeypatch):
    """The fused backend's launches take a chunk's real rows (rounded up to
    the mesh's dp), not a B_BUCKETS size."""
    from pindel_tpu_torch.parallel.mesh_fused import TorchMeshBackend
    rng = np.random.default_rng(11)
    settings = Settings()
    chrom = make_genome(rng).chromosomes[0]
    reads = sample_reads(rng, chrom, n_reads=45)
    if mesh:
        ps = to_port(settings)
        backend = TorchMeshBackend(ps, ps.max_mismatch(), chrom.seq,
                                   ["cpu", "cpu"], chrom_name=chrom.name)
    else:
        backend = torch_backend(settings, chrom)
    rows = []
    real = tx.TorchFusedBackend._launch if not mesh else \
        TorchMeshBackend._launch

    def recording(self, kernel, payload, static):
        rows.append((kernel.__name__, payload.shape[0]))
        return real(self, kernel, payload, static)

    monkeypatch.setattr(type(backend), "_launch", recording)
    run_port_search(settings, chrom, reads, backend)
    names = {name for name, _ in rows}
    assert {"_close_kernel", "_far_kernel"} <= names
    dp = 2 if mesh else 1
    # the smallest bucket was 256 rows
    assert all(r % dp == 0 and r <= tx._round_up(len(reads), dp)
               for _, r in rows)


# ------------------------------------------------------------- the skips
def scrambled_windows(monkeypatch, rows_of_call):
    """Patch ``_scan_lanes`` so that call k gets random window starts on the
    rows ``rows_of_call(k)`` (a bool array, or None for none)."""
    real = tx._scan_lanes
    rng = np.random.default_rng(99)
    calls = []

    def scrambled(chrom, slice_start, *rest, **kw):
        rows = rows_of_call(len(calls))
        calls.append(rows)
        if rows is not None and rows.any():
            slice_start = slice_start.clone()
            sel = torch.from_numpy(rows)
            slice_start[sel] = torch.from_numpy(rng.integers(
                0, chrom.shape[0] * 64, (int(rows.sum()),
                                         slice_start.shape[1]))
                .astype(np.int32))
        return real(chrom, slice_start, *rest, **kw)

    monkeypatch.setattr(tx, "_scan_lanes", scrambled)
    return calls


@pytest.mark.parametrize("case", ["close", "close_edges"])
def test_close_range1_read_only_without_range0_hit(case, monkeypatch):
    name, chrom, maxmm, payload, static = fused_case(case)
    want = port_call(name, chrom, maxmm, payload, static)
    winner = flags_of(want, static) & 255
    has0 = winner < 2
    assert has0.any() and (~has0).any()
    # call 0 is range 0, call 1 range 1
    calls = scrambled_windows(monkeypatch,
                              lambda k: has0 if k == 1 else None)
    got = port_call(name, chrom, maxmm, payload, static)
    assert len(calls) == 2
    assert_same(got, want.numpy())


@pytest.mark.parametrize("case", ["far_active", "far_x3"])
def test_far_rounds_after_inactive_are_not_read(case, monkeypatch):
    name, chrom, maxmm, payload, static = fused_case(case)
    want = port_call(name, chrom, maxmm, payload, static)
    # each read's active rounds, from the rounds' emissions (_far_kernel:
    # active = close_max + st_max < qlen; replaced where new_max >= st_max)
    emitted = []
    real_rules = tx._emit_rules

    def recording(*a, **kw):
        out = real_rules(*a, **kw)
        emitted.append((out[3][:, 0].numpy(), out[4][:, 0].numpy()))
        return out

    monkeypatch.setattr(tx, "_emit_rules", recording)
    port_call(name, chrom, maxmm, payload, static)
    monkeypatch.setattr(tx, "_emit_rules", real_rules)
    _codes, meta = tx._unpack_payload(torch.from_numpy(payload),
                                      static["lmax"], tx.FM_WORDS)
    meta = meta.numpy()
    qlen = meta[:, 1] & 0x3ff
    close_max = (meta[:, 1] >> 10) & 0x3ff
    st_max = (meta[:, 1] >> 20) & 0x3ff
    inactive = []
    for any_emit, last in emitted:
        active = close_max + st_max < qlen
        inactive.append(~active)
        new_max = np.where(any_emit, last + 1, 0)
        st_max = np.where(active & (new_max >= st_max), new_max, st_max)
    # some read turns inactive after a round (and, in far_active, some is
    # inactive from round 0)
    assert inactive[0].any() == (case == "far_active")
    assert any((inactive[r] & ~inactive[0]).any()
               for r in range(1, len(inactive)))
    calls = scrambled_windows(monkeypatch, lambda k: inactive[k])
    got = port_call(name, chrom, maxmm, payload, static)
    assert len(calls) == len(static["spans"])
    assert_same(got, want.numpy())


# ------------------------------------------------------------- dispatch
def test_cpu_tensors_never_reach_fused_cuda(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("a CPU tensor reached fused_cuda")

    monkeypatch.setattr(fused_cuda, "pt_close", refuse)
    monkeypatch.setattr(fused_cuda, "pt_far", refuse)
    for case in ("close_r0", "far_x0"):
        name, chrom, maxmm, payload, static = fused_case(case)
        out = port_call(name, chrom, maxmm, payload[:4], static)
        assert out.shape[0] == 4


WRAPPERS = {"_close_kernel": "pt_close", "_far_kernel": "pt_far",
            "_far_win_kernel": "pt_far_win"}
ARGS = {"_close_kernel": fused_cuda.close_args,
        "_far_kernel": fused_cuda.far_args,
        "_far_win_kernel": fused_cuda.far_win_args}


def test_far_win_cpu_tensor_takes_the_plain_version(monkeypatch):
    """On CPU tensors ``_far_win_kernel`` runs ``_far_win_kernel_ref`` and
    never reaches ``fused_cuda``."""
    def refuse(*a, **kw):
        raise AssertionError("a CPU tensor reached fused_cuda")

    taken = []
    real = tx._far_win_kernel_ref

    def ref(*a, **kw):
        taken.append(kw["w"])
        return real(*a, **kw)

    monkeypatch.setattr(fused_cuda, "pt_far_win", refuse)
    monkeypatch.setattr(tx, "_far_win_kernel_ref", ref)
    name, chrom, maxmm, payload, static = fused_case("far_win")
    out = port_call(name, chrom, maxmm, payload[:4], static)
    assert out.shape == (4, static["lmax"] // 32 + 2)
    assert taken == [static["w"]]


@pytest.mark.parametrize("case", ["close", "far_x1", "far_win"])
def test_fused_cuda_refuses_cpu_tensors(case):
    name, chrom, maxmm, payload, static = fused_case(case)
    fn = getattr(fused_cuda, WRAPPERS[name])
    with pytest.raises(ValueError, match="CUDA tensors"):
        fn(tx._chrom_cat(torch.from_numpy(chrom)),
           torch.from_numpy(payload.copy()), torch.from_numpy(maxmm.copy()),
           **static)


def test_far_win_other_devices_raise():
    name, chrom, maxmm, payload, static = fused_case("far_win")
    with pytest.raises(ValueError, match="no kernel for device"):
        tx._far_win_kernel(tx._chrom_cat(torch.from_numpy(chrom)),
                           torch.empty(payload.shape, dtype=torch.int8,
                                       device="meta"),
                           torch.from_numpy(maxmm.copy()), **static)


def test_other_devices_raise():
    name, chrom, maxmm, payload, static = fused_case("close")
    meta = torch.empty(payload.shape, dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        tx._close_kernel(tx._chrom_cat(torch.from_numpy(chrom)), meta,
                         torch.from_numpy(maxmm.copy()), **static)
    name, chrom, maxmm, payload, static = fused_case("far_x0")
    with pytest.raises(ValueError, match="no kernel for device"):
        tx._far_kernel(tx._chrom_cat(torch.from_numpy(chrom)),
                       torch.empty(payload.shape, dtype=torch.int8,
                                   device="meta"),
                       torch.from_numpy(maxmm.copy()), **static)


@pytest.mark.parametrize("bad", ["lmax", "dtype", "shape", "maxmm",
                                 "rounds", "key"])
def test_fused_args_checks(bad):
    """The wrappers' checks (run here with the CPU as the device)."""
    cpu = torch.device("cpu")
    name, chrom, maxmm, payload, static = fused_case(
        "close" if bad in ("lmax", "dtype", "shape", "maxmm", "key")
        else "far_x1")
    cat = tx._chrom_cat(torch.from_numpy(chrom))
    p = torch.from_numpy(payload.copy())
    m = torch.from_numpy(maxmm.copy())
    static = dict(static)
    if bad == "lmax":
        static["lmax"] = 100
    elif bad == "dtype":
        p = p.to(torch.int32)
    elif bad == "shape":
        p = p[:, :-4].contiguous()
    elif bad == "maxmm":
        m = m[:64].contiguous()
    elif bad == "rounds":
        static["ws"] = static["ws"][:-1]
    else:
        static["w1"] = 1 << 24
    args = fused_cuda.close_args if name == "_close_kernel" else \
        fused_cuda.far_args
    with pytest.raises((ValueError, TypeError)):
        args(cat, p, m, cpu, **static)


@pytest.mark.parametrize("bad", ["lmax", "shape", "spacer", "dtype"])
def test_far_win_args_checks(bad):
    """``far_win_args`` refuses a bad lmax, a payload row of a close call's
    width, a tile of ``w + lmax`` past the spacer and a payload that is not
    int8."""
    cpu = torch.device("cpu")
    name, chrom, maxmm, payload, static = fused_case("far_win")
    cat = tx._chrom_cat(torch.from_numpy(chrom))
    p = torch.from_numpy(payload.copy())
    m = torch.from_numpy(maxmm.copy())
    static = dict(static)
    if bad == "lmax":
        static["lmax"] = 100
    elif bad == "shape":
        p = torch.zeros((p.shape[0], static["lmax"] + 12), dtype=torch.int8)
    elif bad == "spacer":
        static["w"] = 100_000 - static["lmax"] + 1
    else:
        p = p.to(torch.int32)
    with pytest.raises((ValueError, TypeError)):
        fused_cuda.far_win_args(cat, p, m, cpu, **static)
    # the widest bucket that fits takes a key that fits in int32
    static = dict(static, w=98304, lmax=512, lsteps=512)
    p = torch.zeros((2, 512 // 2 + 16), dtype=torch.int8)
    out, args = fused_cuda.far_win_args(cat, p, m, cpu, **static)
    assert out.shape == (2, 18) and args[7] == 19


def test_fused_args_accept_the_cases():
    """Every edge case passes the wrappers' checks (on the CPU as the
    device), with one output row per read."""
    cpu = torch.device("cpu")
    for case in CASES:
        name, chrom, maxmm, payload, static = fused_case(case)
        out, args = ARGS[name](tx._chrom_cat(torch.from_numpy(chrom)),
                               torch.from_numpy(payload.copy()),
                               torch.from_numpy(maxmm.copy()), cpu, **static)
        assert out.shape == (payload.shape[0], static["lmax"] // 32 + 2)


# ------------------------------------------------------------- the bound
@pytest.mark.parametrize("case", ["far_win", "far_win_edges"])
def test_fused_rows_counts_every_far_win_row_twice(case):
    """K4 scans both lanes of every read: ``measure.fused_rows`` gives its
    one scan call every row, and ``fused_bound`` scans all of them."""
    name, chrom, maxmm, payload, static = fused_case(case)
    cat = tx._chrom_cat(torch.from_numpy(chrom))
    p = torch.from_numpy(payload.copy())
    m = torch.from_numpy(maxmm.copy())
    out, scans, rules = measure.composition_scans(name, cat, p, m, static)
    assert_same(out, jax_call(name, chrom, maxmm, payload, static))
    rows = measure.fused_rows(name, p, static, out, rules)
    assert len(rows) == len(scans) == 1
    assert rows[0].shape == (2 * p.shape[0],) and bool(rows[0].all())
    assert scans[0][0][0].shape[0] == 2 * p.shape[0]
    b = measure.fused_bound(name, cat, p, m, static)
    assert b["rows_scanned"] == b["rows_all"] == 2 * p.shape[0]
    assert b["bound_ms"] > 0 and b["composition_bound_ms"] > 0
