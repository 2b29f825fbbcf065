"""The port's plain PyTorch scan must equal the JAX package's scan bit for
bit: ``scan_rows_ref`` against ``_xla_scan_rows`` and the Pallas kernel run
in interpret mode, on the same numpy-made inputs (tolerance 0: the scan is
integer-only).  The CUDA kernel is held against ``scan_rows_ref`` on the
card by ``chip_smoke.py``."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pindel_tpu import dna
from pindel_tpu.ops.engine_fused import _xla_scan_rows
from pindel_tpu.ops.pallas_scan import pallas_scan_rows
from pindel_tpu_torch.ops.scan import scan_rows, scan_rows_ref
from pindel_tpu_torch.ops.scan_cuda import scan_rows_cuda

# one intra-op thread: the test workers share the machine's cores, and
# torch's per-op thread pool oversubscribes them (the scan is many small ops)
torch.set_num_threads(1)


def near_match_case(seed, w, lmax, rows):
    """The inputs of tests/test_pallas_scan.py: queries embed a near-match
    of their own tile, so real chains emit."""
    rng = np.random.default_rng(seed)
    tiles = rng.integers(0, 5, (rows, w + lmax)).astype(np.int8)
    qq = np.full((rows, lmax), dna.N, np.int8)
    qlen = rng.integers(30, min(lmax, 120), rows).astype(np.int32)
    for i in range(rows):
        n = qlen[i]
        s = int(rng.integers(0, w))
        qq[i, :n] = tiles[i, s:s + n]
        for j in rng.integers(0, n, size=int(rng.integers(0, 4))):
            qq[i, j] = rng.integers(0, 5)
    valid_w = rng.integers(1, w + 1, rows).astype(np.int32)
    thr = rng.integers(1, 8, rows).astype(np.int32)
    return [tiles, qq, valid_w, qlen, thr]


def aligned_case(seed, w, lmax, rows):
    """128-aligned tiles as _scan_lanes builds them: T = 128 *
    (ceil((w + lmax) / 128) + 1), the window starting at off in [0, 128)."""
    rng = np.random.default_rng(seed)
    t = 128 * (-(-(w + lmax) // 128) + 1)
    tiles = rng.integers(0, 5, (rows, t)).astype(np.int8)
    qq = rng.integers(0, 5, (rows, lmax)).astype(np.int8)
    qlen = rng.integers(20, lmax + 1, rows).astype(np.int32)
    valid_w = rng.integers(0, w + 1, rows).astype(np.int32)
    thr = rng.integers(0, 12, rows).astype(np.int32)
    off = rng.integers(0, 128, rows).astype(np.int32)
    for i in range(0, rows, 3):
        # every third row embeds an exact hit at its window start
        n = int(qlen[i])
        qq[i, :n] = tiles[i, off[i]:off[i] + n]
    return [tiles, qq, valid_w, qlen, thr, off]


def assert_scans_equal(args, *, w, lmax, lsteps, pallas=True):
    got = scan_rows_ref(*[torch.from_numpy(a) for a in args],
                        w=w, lmax=lmax, mpm=3, lsteps=lsteps)
    jargs = [jnp.asarray(a) for a in args]
    refs = [("xla", _xla_scan_rows(*jargs, w=w, lmax=lmax, mpm=3,
                                   lsteps=lsteps))]
    if pallas:
        refs.append(("pallas", pallas_scan_rows(
            *jargs, w=w, lmax=lmax, mpm=3, lsteps=lsteps, interpret=True)))
    for ref_name, ref in refs:
        for name, g, want in zip(("kmin", "k2"), got, ref):
            np.testing.assert_array_equal(
                g.numpy(), np.asarray(want),
                err_msg=f"{name} vs {ref_name} w={w} lmax={lmax}")


@pytest.mark.parametrize("seed,w,lmax,rows", [
    (0, 128, 128, 64), (1, 512, 128, 300), (2, 2048, 128, 17),
])
def test_scan_ref_matches_jax(seed, w, lmax, rows):
    assert_scans_equal(near_match_case(seed, w, lmax, rows),
                       w=w, lmax=lmax, lsteps=0)


@pytest.mark.parametrize("w,lmax,lsteps", [
    (128, 128, 112),      # far round 0 at the main path's lsteps
    (192, 128, 64),
    (512, 128, 112),      # close range 0 / far round 1
    (768, 128, 128),
    (1536, 128, 112),     # close range 1
    (256, 256, 0),        # lmax > 255: dead level 1000
    (512, 256, 144),
])
def test_scan_ref_aligned_matches_jax(w, lmax, lsteps):
    """W_BUCKETS x LMAXES of tests/test_pallas_onchip.py with r = 192 (not a
    multiple of the Pallas block) and per-row off != 0."""
    assert_scans_equal(aligned_case(w * 1000 + lmax, w, lmax, 192),
                       w=w, lmax=lmax, lsteps=lsteps)


def test_scan_ref_wide_window_matches_xla():
    """A far bucket beyond the main path (w = 8192), against the XLA scan."""
    assert_scans_equal(aligned_case(5, 8192, 128, 6), w=8192, lmax=128,
                       lsteps=112, pallas=False)


def test_scan_rows_dispatch_by_device():
    args = aligned_case(3, 192, 128, 16)
    cpu = [torch.from_numpy(a) for a in args]
    got = scan_rows(*cpu, w=192, lmax=128, mpm=3, lsteps=64)
    want = scan_rows_ref(*cpu, w=192, lmax=128, mpm=3, lsteps=64)
    for g, r in zip(got, want):
        assert torch.equal(g, r)
    meta = [a.to("meta") for a in cpu]
    with pytest.raises(ValueError, match="no scan for device"):
        scan_rows(*meta, w=192, lmax=128, mpm=3, lsteps=64)


def test_scan_rows_cuda_refuses_cpu_tensors():
    """The kernel's wrapper never computes on the CPU in the card's place."""
    cpu = [torch.from_numpy(a) for a in aligned_case(4, 128, 128, 4)]
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        scan_rows_cuda(*cpu, w=128, lmax=128, mpm=3, lsteps=64)
