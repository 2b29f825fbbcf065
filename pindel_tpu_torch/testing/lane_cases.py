"""Inputs of the per-lane search's packed kernel (``ops/engine_jax.py:
_search_kernel`` and ``_route_kernel``), built from a numpy seed: the ten
arrays ``chrom, slice_start, reverse, qq, valid_w, qlen, max_snp,
tsec_minus, maxmm, max_allowed``.  tests/test_torch_lane_route.py holds
the route against the JAX kernel on them, and chip_smoke.py holds the
route against the plain kernel on the card.

The rows: a low-complexity chromosome with N bases; queries copied from
it with two substitutions, both directions, half of the lanes placed over
their query's copy; starts from below 0 to past the end (the tile start
wraps and clamps); ``valid_w`` below ``w``; then a row whose queries start
with N and one with no valid column (no seed at all), a row with an N run
in its queries, budgets of 0 (``tsec_minus`` 0) on rows 3 and 4, and row 5
with half of a unique copy at 5/8 of the window in one lane (at the 65536
bucket its offset is past 32768, where the packed int16 ``rep_w`` wraps).
``dead_level_case`` builds rows whose candidates reach the DEAD level
(127) and pass it, for budgets at and past it.
"""
from __future__ import annotations

import numpy as np

from pindel_tpu_torch.config import MAX_READ_LENGTH, Settings

N = 4


def lane_case(seed: int, *, w: int, nl: int, rows: int, lmax: int = 128):
    """The ten arrays of the packed kernel for one batch (rows >= 6)."""
    settings = Settings()
    rng = np.random.default_rng(seed)
    c = max(3 * (w + lmax), 5000)
    chrom = rng.integers(0, 5, c).astype(np.int8)
    chrom[rng.random(c) < 0.7] = rng.integers(0, 4)
    slice_start = rng.integers(-200, c - w - lmax + 200,
                               (rows, nl)).astype(np.int32)
    reverse = rng.random((rows, nl)) < 0.5
    qq = np.full((rows, nl, lmax), N, np.int8)
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

    chrom[rng.integers(0, c - 20):][:12] = N
    qq[0, :, 0] = N
    valid_w[1] = 0
    n = int(qlen[2])
    qq[2, :, n // 3:n // 3 + 4] = N
    # row 5: a unique stretch, its tile not clamped, in the backward lane
    # when there is one; the half next to the lane's anchor matches, the
    # other does not (a split read's far end must not fit the whole read)
    at = 5 * w // 8
    s = w + lmax + int(rng.integers(0, 100))
    n = int(qlen[5])
    chrom[s:s + n] = rng.integers(0, 4, n)
    j = 1 if nl > 1 else 0
    q = (chrom[s:s + n] + ((np.arange(n) < n // 2) if j
                           else (np.arange(n) >= n // 2))) % 4
    valid_w[5] = 0
    valid_w[5, j] = w
    reverse[5, j] = j == 1
    slice_start[5, j] = s + n + at - w - lmax if j else s - at
    qq[5, j, :n] = q[::-1] if j else q

    maxmm = settings.max_mismatch().astype(np.int32)
    max_snp = maxmm[qlen].astype(np.int32)
    tsec_minus = (max_snp + settings.additional_mismatch).astype(np.int32)
    max_snp[3:5] = 0
    tsec_minus[3:5] = 0
    max_allowed = np.float32(qlen.astype(np.float64)
                             * np.float64(settings.max_allowed_mismatch_rate))
    return (chrom, slice_start, reverse, qq, valid_w, qlen, max_snp,
            tsec_minus, maxmm, max_allowed)


def dead_level_case(ms: int, tm: int):
    """Rows whose candidates walk to the DEAD level (127) and past it, w = 8
    and two lanes a row over runs of one base: lane 0 of rows 0-2 has one
    unseeded column (7), the other 15 candidates mismatch at every step of
    a query of C after its seed (row 1's query matches at steps 130-132),
    and row 3 has no unseeded column.  At ``ms``, ``tm`` = 130, 131 row 0's
    one dead candidate is alone at 127 from step 129 (its strict ring full)
    and row 1's emits at step 132 (its ring empty); at 3, 131 the live
    candidates at 127 and the dead ones share the level, the least key
    naming the representative; row 3's candidates all sit at one level
    past 127 when ``ms`` reaches it."""
    w, lmax, nl, rows = 8, 256, 2, 4
    a, c, g = 0, 1, 2
    chrom = np.random.default_rng(5).integers(0, 4, 4000).astype(np.int8)
    chrom[1000:1000 + w + lmax] = a
    chrom[2000:2000 + w + lmax] = a
    chrom[1007] = g
    slice_start = np.array([[1000, 2000]] * 3 + [[2000, 2000]], np.int32)
    reverse = np.zeros((rows, nl), bool)
    qq = np.full((rows, nl, lmax), c, np.int8)
    qq[:, :, 0] = a
    qq[1, :, 130:133] = a
    valid_w = np.full((rows, nl), w, np.int32)
    qlen = np.full(rows, lmax, np.int32)
    max_snp = np.full(rows, ms, np.int32)
    tsec_minus = np.full(rows, tm, np.int32)
    maxmm = np.full(MAX_READ_LENGTH, 200, np.int32)
    max_allowed = np.zeros(rows, np.float32)
    return ((chrom, slice_start, reverse, qq, valid_w, qlen, max_snp,
             tsec_minus, maxmm, max_allowed),
            dict(w=w, lmax=lmax, nl=nl, mpm=3, bp_start=3))
