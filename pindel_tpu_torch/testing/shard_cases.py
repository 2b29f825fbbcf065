"""Inputs of the window-parallel search (``parallel/mesh.py:sharded_search``,
the JAX ``build_sharded_search``) built for the places where its exactness
could break.  Each case is the ten arrays of the search function
(``chrom, slice_start, reverse, qq, valid_w, qlen, max_snp, tsec_minus,
maxmm, max_allowed``) and its static arguments (``w_total, lmax, nl, mpm,
bp_start``); the tests hold the port against JAX on them and chip_smoke.py
holds the shard kernel against its plain twin.

* ``random``: a low-complexity chromosome, queries copied from it with two
  substitutions, both directions, starts from below 0 to past the end;
* ``dead``: random queries under budgets of 0, so every candidate is DEAD
  from a few steps on (the representative is then the smallest DEAD key),
  plus rows with no seed, no valid column and a padding row;
* ``bigkey``: every candidate alive but above ``max_snp`` (no DEAD one), so
  the key is 2^30;
* ``clamped``: starts near both ends of the chromosome, so single shards'
  tiles are clamped (and a negative start wraps first);
* ``backward``: every lane backward;
* ``strict_step0``: strict mismatches (``N`` in the query) at steps 1 and
  2, in the ring of the last ``mpm`` steps with the cleared step 0;
* ``wide``: w_total = 40960, representative columns at and past 32768.
"""
from __future__ import annotations

import numpy as np

from pindel_tpu_torch.config import Settings

N = 4
CASES = ("random", "dead", "bigkey", "clamped", "backward", "strict_step0",
         "wide")


def _base(rows, nl, lmax, w_total, chrom):
    return dict(
        chrom=chrom,
        slice_start=np.zeros((rows, nl), np.int32),
        reverse=np.zeros((rows, nl), bool),
        qq=np.full((rows, nl, lmax), N, np.int8),
        valid_w=np.full((rows, nl), w_total, np.int32),
        qlen=np.full(rows, lmax - 8, np.int32),
        max_snp=np.full(rows, 2, np.int32),
        tsec_minus=np.full(rows, 3, np.int32))


def shard_case(name: str, seed: int = 0):
    """(arrays, static) for case ``name``; arrays is a tuple in the search
    function's order."""
    rng = np.random.default_rng(seed)
    maxmm = np.asarray(Settings().max_mismatch(), np.int32)
    w_total, lmax, nl, rows = 512, 64, 3, 16
    if name == "wide":
        w_total, lmax, nl, rows = 40960, 64, 1, 4
    c = max(4 * (w_total + lmax), 6000)
    chrom = rng.integers(0, 4, c).astype(np.int8)
    if name in ("random", "clamped", "backward", "strict_step0"):
        chrom[rng.random(c) < 0.6] = rng.integers(0, 4)   # many seeds
    a = _base(rows, nl, lmax, w_total, chrom)
    ss, rev, qq = a["slice_start"], a["reverse"], a["qq"]

    if name in ("random", "clamped", "backward", "strict_step0"):
        lo, hi = -200, c - w_total - lmax + 200
        if name == "clamped":
            lo, hi = -w_total // 2, c - w_total // 2
        for i in range(rows):
            n = int(rng.integers(20, lmax - 4))
            s = int(rng.integers(0, c - lmax))
            q = chrom[s:s + n].copy()
            if name != "strict_step0":
                q[rng.integers(1, n, 2)] = rng.integers(0, 5, 2)
            else:
                q[1:3] = N
            a["qlen"][i] = n
            for j in range(nl):
                back = (name == "backward" or
                        (name != "strict_step0" and rng.random() < 0.5))
                rev[i, j] = back
                qq[i, j] = N
                qq[i, j, :n] = q[::-1] if back else q
                if rng.random() < 0.6:
                    # over the query's copy
                    ss[i, j] = (s + n + int(rng.integers(0, w_total))
                                - w_total - lmax if back
                                else s - int(rng.integers(0, w_total)))
                else:
                    ss[i, j] = int(rng.integers(lo, hi))
                if name == "clamped":
                    ss[i, j] = int(rng.choice([lo, -1, 0, hi - 1, c - 1,
                                               int(rng.integers(lo, hi))]))
        a["valid_w"][:] = rng.integers(0, w_total + 1, (rows, nl))
        a["valid_w"][::3] = w_total
        a["max_snp"][:] = rng.integers(0, 4, rows)
        a["tsec_minus"][:] = a["max_snp"] + rng.integers(0, 3, rows)
    elif name == "dead":
        for i in range(rows):
            n = int(rng.integers(20, lmax - 4))
            a["qlen"][i] = n
            for j in range(nl):
                qq[i, j] = N
                qq[i, j, :n] = rng.integers(0, 4, n)
                ss[i, j] = int(rng.integers(0, c - w_total - lmax))
                rev[i, j] = rng.random() < 0.5
        a["max_snp"][:] = 0
        a["tsec_minus"][:] = 0
        qq[1, :, 0] = N                      # no seed in the row
        a["valid_w"][2] = 0                  # no valid column
        a["valid_w"][3] = [0, 7, w_total]
        qq[rows - 1] = N                     # a padding row
        a["qlen"][rows - 1] = 0
    elif name == "bigkey":
        # homopolymer windows: every valid column is seeded and walks the
        # same mismatches, alive above max_snp for steps 1..tsec_minus
        chrom[:] = 0
        for i in range(rows):
            n = lmax - 8
            a["qlen"][i] = n
            q = np.full(n, 1, np.int8)
            q[0] = 0
            for j in range(nl):
                rev[i, j] = (i + j) % 2 == 1
                qq[i, j] = N
                qq[i, j, :n] = q[::-1] if rev[i, j] else q
                # keep step 0 the seed: a backward lane reads its query
                # from the end
                qq[i, j, 0] = 0
                ss[i, j] = int(rng.integers(0, c - w_total - lmax))
        a["max_snp"][:] = 0
        a["tsec_minus"][:] = 5
    elif name == "wide":
        cols = [32768, 35000, 40959 - 70, 36000]
        for i in range(rows):
            n = 50
            back = i % 2 == 1
            s0 = int(rng.integers(1000, c - w_total - 2 * lmax - 1000))
            col = cols[i]
            if back:
                # backward tile index t reads chrom[s0 + tile_len - 1 - t]
                tile_len = w_total + lmax
                end = s0 + tile_len - 1 - col
                q = chrom[end - n + 1:end + 1][::-1].copy()
            else:
                q = chrom[s0 + col:s0 + col + n].copy()
            q[n // 2] = (q[n // 2] + 1) % 4        # one substitution
            qq[i, 0] = N
            qq[i, 0, :n] = q
            rev[i, 0] = back
            ss[i, 0] = s0
            a["qlen"][i] = n
        a["max_snp"][:] = 2
        a["tsec_minus"][:] = 3
    else:
        raise ValueError(f"unknown case {name!r}")
    rate = np.float64(Settings().max_allowed_mismatch_rate)
    max_allowed = np.float32(a["qlen"].astype(np.float64) * rate)
    arrays = (a["chrom"], a["slice_start"], a["reverse"], a["qq"],
              a["valid_w"], a["qlen"], a["max_snp"], a["tsec_minus"], maxmm,
              max_allowed.astype(np.float32))
    static = dict(w_total=w_total, lmax=lmax, nl=nl, mpm=3, bp_start=8)
    return arrays, static
