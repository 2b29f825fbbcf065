"""Scan inputs that drive each branch of the CUDA scan kernel, shared by
tests/test_torch_scan.py (on the CPU, against the JAX package) and
chip_smoke.py (on the card, against the plain version).

The kernel walks only the seeded lanes of a row with two or more seeds and
every lane of the other rows, and a row of many seeds also walks every lane
when ``valid_w > w`` or ``min(lsteps, qlen) > dead`` (``csrc/scan.cu``);
``branch_case`` builds one row of each named kind, on the aligned layout
``_scan_lanes`` gives (T = 128 * (ceil((w + lmax) / 128) + 1), lane space
WE = T - lmax).
"""
from __future__ import annotations

import numpy as np

from pindel_tpu_torch import dna

# one row each: how its seeds are laid out
KINDS = (
    "random",    # random bases and window, an exact hit at the window start
    "q0_n",      # the query starts with N: no seeds
    "vw0",       # an empty window (a padding row of the batch buckets)
    "vw1",       # a window of one lane
    "seeds0",    # a window without seeds
    "seeds1",    # exactly one seed
    "seeds2",    # exactly two seeds
    "edges",     # two seeds, at off and off + valid_w - 1
    "end",       # a window ending at WE - 1, seeded there and once more
    "all",       # a tile of one base equal to q[0]: every lane seeded
    "wide",      # many seeds, valid_w > w: the window runs to WE - 1 and
                 # every seed lies past off + w - 1, where woff clamps to
                 # w - 1, in a run of q[0] as long as the query, so all
                 # seeded keys are one key
)
# rows that need lmax > 1001 (dead level 1000): many seeds, qlen > dead
LONG = "long"    # a query of one base, qlen = lmax: the seeds mismatch at
                 # every step, so their levels pass the dead level, while
                 # the unseeded lane WE - 1 matches at every step (the
                 # tile's tail) and keeps it


def tile_width(w: int, lmax: int) -> int:
    return 128 * (-(-(w + lmax) // 128) + 1)


def branch_case(seed: int, w: int, lmax: int, kinds):
    """Numpy inputs (tiles, qq, valid_w, qlen, thr, off), one row per entry
    of ``kinds`` (names of ``KINDS``, or ``LONG``)."""
    rng = np.random.default_rng(seed)
    t = tile_width(w, lmax)
    we = t - lmax
    rows = len(kinds)
    tiles = rng.integers(0, 5, (rows, t)).astype(np.int8)
    qq = rng.integers(0, 5, (rows, lmax)).astype(np.int8)
    qq[:, 0] = rng.integers(0, 4, rows)
    qlen = rng.integers(20, lmax + 1, rows).astype(np.int32)
    thr = rng.integers(0, 12, rows).astype(np.int32)
    off = rng.integers(0, 128, rows).astype(np.int32)
    valid_w = rng.integers(4, w + 1, rows).astype(np.int32)
    for i, kind in enumerate(kinds):
        q0 = int(qq[i, 0])
        if kind == "random":
            valid_w[i] = rng.integers(0, w + 1)
            n = int(qlen[i])
            qq[i, :n] = tiles[i, off[i]:off[i] + n]
            continue
        if kind == "q0_n":
            qq[i, 0] = dna.N
            continue
        if kind in ("vw0", "vw1"):
            valid_w[i] = 0 if kind == "vw0" else 1
            continue
        if kind == "all":
            tiles[i] = q0
            valid_w[i] = w
            continue
        if kind == "wide":
            off[i] = lo = int(rng.integers(0, 8))
            valid_w[i] = we - lo
            others = np.array([b for b in range(5) if b != q0], np.int8)
            tiles[i, lo:lo + w - 1] = rng.choice(others, w - 1)
            tiles[i, lo + w - 1:] = q0
            qq[i] = q0
            continue
        if kind == LONG:
            if lmax <= 1001:
                raise ValueError(f"{LONG!r} rows need lmax > 1001")
            a = (q0 + 1) % 4
            tiles[i, :we] = a
            tiles[i, we:] = q0
            qq[i] = q0
            qlen[i] = lmax
            valid_w[i] = min(w, 64)
            lo = int(off[i])
            tiles[i, lo + rng.choice(int(valid_w[i]), 4, replace=False)] = q0
            continue
        if kind == "end":
            valid_w[i] = min(w, we)
            off[i] = we - valid_w[i]
        lo, vw = int(off[i]), int(valid_w[i])
        # the window's bases all differ from q[0], then the seeds
        others = np.array([b for b in range(5) if b != q0], np.int8)
        tiles[i, lo:lo + vw] = rng.choice(others, vw)
        if kind == "seeds0":
            picks = []
        elif kind == "seeds1":
            picks = [lo + int(rng.integers(0, vw))]
        elif kind == "seeds2":
            picks = lo + rng.choice(vw, 2, replace=False)
        elif kind == "edges":
            picks = [lo, lo + vw - 1]
        elif kind == "end":
            picks = [we - 1, lo + int(rng.integers(0, vw - 1))]
        else:
            raise ValueError(f"unknown row kind {kind!r}")
        tiles[i, picks] = q0
        # a query that matches the tile from one seed on, so chains emit
        if len(picks):
            s = int(picks[0])
            n = min(int(qlen[i]), t - s)
            qq[i, :n] = tiles[i, s:s + n]
    return [tiles, qq, valid_w, qlen, thr, off]
