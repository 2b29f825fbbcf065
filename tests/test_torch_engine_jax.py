"""The port's legacy per-lane backend (K8) against the JAX package's, on the
CPU.

``_search_kernel`` is compared on numpy-built inputs, packed output bit for
bit; ``TorchLaneBackend.run`` at the Searcher level against ``JaxBackend``
and the NumPy oracle (as tests/test_engine_jax.py does for the JAX engine).
All comparisons are exact: the search is integer-only, and the one float
compare (the whole-read fit) gets the same host-made float32 threshold.
Each backend runs under its own package's Searcher, on its own host
objects.
"""
import copy

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pindel_tpu.config import Settings
from pindel_tpu.ops import engine_jax as jj
from pindel_tpu.search import Searcher
from pindel_tpu_torch.ops import engine_jax as tj
from pindel_tpu_torch.ops.engine_fused import device_state_from_numpy
from test_search_semantics import make_genome, sample_reads, ups_key
from test_torch_engine import run_port_search, to_port, to_reference

# one intra-op thread: the test workers share the machine's cores, and
# torch's per-op thread pool oversubscribes them (the scan is many small ops)
torch.set_num_threads(1)


def search_case(seed, *, w, lmax, nl, rows, chrom_len=None):
    """Inputs of ``_search_kernel``: a low-complexity chromosome (many
    seeds, so the uniqueness rules bite), queries copied from it with two
    substitutions, forward and backward lanes, half of them placed over
    their query's copy.  Starts run from below 0 to past the end, so the
    kernel's wrap-and-clamp of the tile start is exercised."""
    rng = np.random.default_rng(seed)
    c = chrom_len or max(3 * (w + lmax), 5000)
    chrom = rng.integers(0, 5, c).astype(np.int8)
    chrom[rng.random(c) < 0.7] = rng.integers(0, 4)
    slice_start = rng.integers(-200, c - w - lmax + 200,
                               (rows, nl)).astype(np.int32)
    reverse = rng.random((rows, nl)) < 0.5
    qq = np.full((rows, nl, lmax), 4, np.int8)
    qlen = rng.integers(20, lmax, rows).astype(np.int32)
    for i in range(rows):
        s = int(rng.integers(0, c - lmax))
        n = qlen[i]
        q = chrom[s:s + n].copy()
        q[rng.integers(0, n, 2)] = rng.integers(0, 5, 2)
        for j in range(nl):
            qq[i, j, :n] = q[::-1] if reverse[i, j] else q
            if rng.random() < 0.5:
                slice_start[i, j] = (s + n + int(rng.integers(0, w)) - w - lmax
                                     if reverse[i, j]
                                     else s - int(rng.integers(0, w)))
    valid_w = rng.integers(0, w + 1, (rows, nl)).astype(np.int32)
    return chrom, slice_start, reverse, qq, valid_w, qlen


def kernel_args(case, settings):
    chrom, slice_start, reverse, qq, valid_w, qlen = case
    maxmm = settings.max_mismatch().astype(np.int32)
    ms = maxmm[qlen].astype(np.int32)
    tm = (ms + settings.additional_mismatch).astype(np.int32)
    max_allowed = np.float32(qlen.astype(np.float64)
                             * np.float64(settings.max_allowed_mismatch_rate))
    return [chrom, slice_start, reverse, qq, valid_w, qlen, ms, tm, maxmm,
            max_allowed]


def both_kernels(args, **static):
    want = np.asarray(jj._search_kernel(*[jnp.asarray(a) for a in args],
                                        **static))
    got = tj._search_kernel(
        *[torch.from_numpy(np.ascontiguousarray(a)) for a in args], **static)
    assert got.dtype == torch.int8
    return got.numpy(), want


@pytest.mark.parametrize("nl,mpm,w,lmax", [
    (1, 3, 512, 128), (2, 3, 512, 128), (4, 5, 2048, 128),
    (2, 5, 128, 256), (4, 3, 8192, 128),
])
def test_search_kernel_matches_jax(nl, mpm, w, lmax):
    settings = Settings()
    case = search_case(nl * 100 + w + mpm, w=w, lmax=lmax, nl=nl, rows=24)
    got, want = both_kernels(kernel_args(case, settings), w=w, lmax=lmax,
                             nl=nl, mpm=mpm, bp_start=8)
    np.testing.assert_array_equal(got, want)
    assert got[:, :lmax].sum() > 0          # chains do emit


def test_search_kernel_int16_offset_wraps_like_jax():
    """At the 65536 window bucket a representative offset >= 32768 comes
    back negative through the kernel's int16 (engine_jax.py:174): the port
    keeps the JAX kernel's bytes, fault included (ROADMAP Queue 3)."""
    settings = Settings()
    w, lmax, off = 65536, 128, 40_000
    rng = np.random.default_rng(21)
    chrom = rng.integers(0, 4, w + lmax + 1000).astype(np.int8)
    qlen = np.array([90, 70], np.int32)
    qq = np.full((2, 1, lmax), 4, np.int8)
    for i, n in enumerate(qlen):
        # the first 60 bases match at `off`, the rest diverge (a split
        # read's far end must not fit the whole read)
        qq[i, 0, :n] = (chrom[off:off + n] + (np.arange(n) >= 60)) % 4
    case = (chrom, np.zeros((2, 1), np.int32), np.zeros((2, 1), bool), qq,
            np.full((2, 1), w, np.int32), qlen)
    got, want = both_kernels(kernel_args(case, settings), w=w, lmax=lmax,
                             nl=1, mpm=3, bp_start=8)
    np.testing.assert_array_equal(got, want)
    emit, _mm, _lane, rep_w, _full = tj.unpack_kernel_output(got, lmax)
    assert emit.any(axis=1).all()
    assert set(rep_w[emit].tolist()) == {off - 65536}


def lane_backend(settings, chrom):
    settings = to_port(settings)
    return tj.TorchLaneBackend(
        settings, device_state_from_numpy(chrom.seq, settings.max_mismatch(),
                                          "cpu"))


def run_search(settings, chrom, reads, backend=None):
    searcher = Searcher(settings, backend=backend)
    searcher.map_close_ends(chrom, reads)
    kept = searcher.finalize_close_ends(reads)
    searcher.search_far_ends(chrom, kept)
    return kept


def assert_kept_equal(kept_a, kept_b):
    assert len(kept_a) == len(kept_b)
    for a, b in zip(kept_a, kept_b):
        assert a.name == b.name
        assert a.seq == b.seq, a.name
        assert ups_key(a.up_close) == ups_key(b.up_close), a.name
        assert ups_key(a.up_far) == ups_key(b.up_far), a.name
        assert a.close_end_mismatch == b.close_end_mismatch, a.name
        assert a.far_end_mismatch == b.far_end_mismatch, a.name


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_lane_backend_matches_jax_and_numpy(seed):
    """tests/test_engine_jax.py's scenes: every close attempt and far round
    runs through ``run`` (the backend has no fused methods)."""
    rng = np.random.default_rng(seed + 100)
    settings = Settings()
    chrom = make_genome(rng).chromosomes[0]
    reads = sample_reads(rng, chrom, n_reads=50)
    reads_jx = copy.deepcopy(reads)
    before = tj.LEGACY_ROWS
    kept_tt = run_port_search(settings, chrom, reads,
                              lane_backend(settings, chrom))
    kept_np = run_search(settings, chrom, reads)
    kept_jx = run_search(settings, chrom, reads_jx, backend=jj.JaxBackend(
        settings, settings.max_mismatch(), chrom.seq))
    assert tj.LEGACY_ROWS > before
    assert_kept_equal(kept_tt, kept_jx)
    assert_kept_equal(kept_tt, kept_np)
    assert sum(bool(r.up_far) for r in kept_tt) > 0


def test_lane_backend_chunking_does_not_change_results():
    """Batches split by MAX_CHUNK and row groups cut by ROW_ELEMS give the
    results of one launch."""
    rng = np.random.default_rng(104)
    settings = Settings()
    chrom = make_genome(rng).chromosomes[0]
    reads = sample_reads(rng, chrom, n_reads=40)
    kept = run_port_search(settings, chrom, reads,
                           lane_backend(settings, chrom))
    small = lane_backend(settings, chrom)
    small.MAX_CHUNK = 7
    small.ROW_ELEMS = 3 * 512          # three reads of one lane per group
    kept_small = run_port_search(settings, chrom, reads, small)
    assert_kept_equal(kept_small, kept)
    assert sum(bool(r.up_far) for r in kept) > 0


@pytest.mark.parametrize("scale", [1, 8])
def test_lane_backend_on_chip_smoke_lanes(scale):
    """The two-region batch chip_smoke.py runs through the legacy backend
    on the card and on the CPU (window buckets 2048 and 8192 here; the card
    also runs 32768): the CPU side equals JaxBackend and the NumPy
    oracle, each on its own package's lanes."""
    from pindel_tpu.search import NumpyBackend
    from pindel_tpu_torch.testing.scenes import (legacy_anchors,
                                                 two_region_lanes)
    settings = Settings()
    batch = two_region_lanes(scale, 12, scale)
    got = legacy_anchors(batch, "cpu")
    chrom, lanes, ms, tm = to_reference(batch)
    want = jj.JaxBackend(settings, settings.max_mismatch(), chrom.seq) \
        .run(lanes, 10, ms, tm)
    exp = NumpyBackend(settings, settings.max_mismatch()).run(lanes, 10, ms,
                                                              tm)
    for (key_g, mm_g), (ups_w, mm_w), (ups_e, _mm_e) in zip(got, want, exp):
        assert key_g == ups_key(ups_w) == ups_key(ups_e)
        assert mm_g == mm_w
    assert all(key for key, _ in got)
