"""Dense NumPy oracle of the pattern-growth anchor search.

The reference explores candidate alignments with a per-base recursion
(``CheckLeft_Close``/``CheckRight_Close`` searcher.cpp:153-329,
``CheckBoth`` pindel.cpp:2823-2902, ``CategorizePositions`` searcher.cpp:48-63).
That recursion is equivalent to the following dense computation, which is what
the TPU kernels implement; this module is the bit-exact CPU reference.

For a *lane* = (window of candidate seed positions, oriented query q of length
n, direction):

* candidate p0 is seeded iff chr[p0] == q[0] exactly (PD[0] seeding,
  pindel.cpp:2283-2316, farend_searcher.cpp:75-81); a backward lane is the
  same computation on the reversed chromosome slice and reversed query.
* cum[p0, L] = number of Matches()-mismatches of q[0:L] aligned at p0
  (capped: candidates whose cum exceeds TOTAL_SNP_ERROR_CHECKED_Minus are
  dropped, as in CategorizePositions' maxNumMismatches cut).
* the per-level position lists PD[m] at length L are {p0 : cum[p0,L] == m};
  only their *sizes* and the unique member (when size is 1) matter.

Emission of a UniquePoint at length L (identical logic in CheckLeft_Close /
CheckRight_Close / CheckBoth):

* only for L in [bp_start, bp_end], and only while the running search has not
  been cut: the search stops at the first L in range where
  min-nonempty-level(L) > g_maxMismatch[L] (the early ``return``,
  searcher.cpp:166-169 / pindel.cpp:2835-2838);
* with m* = min nonempty level (levels 0..MAX_SNP_ERROR): emit iff
  count(L, m*) == 1 and L >= bp_start + m* and
  sum_{j<=m*+ADDITIONAL_MISMATCH} count(L, j) == 1 and
  m* <= g_maxMismatch[L] and CheckMismatches passes;
* CheckMismatches (searcher.cpp:331-388): the *whole read* must mismatch the
  reference at >= read_len * MaximumAllowedMismatchRate positions (inverted
  comparison — a read that fits the reference well is not SV evidence), and
  the Min_Perfect_Match_Around_BP bases at the split must match *strictly*
  (byte equality; forward direction additionally requires L > MPM, backward
  requires L >= MPM via the substring-length comparison).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from refpindel import dna

BIG = np.int32(127)  # dead-candidate level sentinel


@dataclasses.dataclass
class Lane:
    """One candidate window on one strand/direction."""

    chrom: np.ndarray        # full padded chromosome codes (int8)
    query: np.ndarray        # oriented query codes (int8), length n
    start: int               # seed window [start, end), padded coords
    end: int
    forward: bool            # True: steps at p0+l; False: steps at p0-l
    direction: str           # UniquePoint.Direction for this lane
    strand: str              # UniquePoint.Strand for this lane
    chr_name: str = ""


@dataclasses.dataclass
class LaneStats:
    """Aggregated per-(length, level) statistics of one or more lanes."""

    n: int                              # query length
    nlevels: int                        # TOTAL_SNP_ERROR_CHECKED levels
    counts: np.ndarray                  # [n, nlevels] int32, index L-1
    # representative (first) candidate per (L, m): only valid if counts == 1
    rep_abs_loc: np.ndarray             # [n, nlevels] int64
    rep_full_mm: np.ndarray             # [n, nlevels] int32
    rep_strict_ok: np.ndarray           # [n, nlevels] bool
    rep_lane: np.ndarray                # [n, nlevels] int32 lane index

    @classmethod
    def empty(cls, n: int, nlevels: int) -> "LaneStats":
        z = lambda dt: np.zeros((n, nlevels), dtype=dt)
        return cls(n, nlevels, z(np.int32), z(np.int64), z(np.int32),
                   np.zeros((n, nlevels), dtype=bool), z(np.int32))

    def merge(self, other: "LaneStats") -> "LaneStats":
        pick = (self.counts == 0) & (other.counts > 0)
        return LaneStats(
            self.n, self.nlevels, self.counts + other.counts,
            np.where(pick, other.rep_abs_loc, self.rep_abs_loc),
            np.where(pick, other.rep_full_mm, self.rep_full_mm),
            np.where(pick, other.rep_strict_ok, self.rep_strict_ok),
            np.where(pick, other.rep_lane, self.rep_lane))


def lane_stats(lane: Lane, lane_index: int, tsec_minus: int, mpm: int) -> LaneStats:
    """Compute per-(L, level) stats for one lane."""
    n = int(lane.query.shape[0])
    nlevels = tsec_minus + 1
    stats = LaneStats.empty(n, nlevels)
    start, end = lane.start, lane.end
    if end <= start or n == 0:
        return stats
    w = end - start

    if lane.forward:
        ref = lane.chrom[start:end + n - 1]
        q = lane.query
        # step l of candidate w0: ref[w0 + l]
        steps = np.lib.stride_tricks.sliding_window_view(ref, n)  # [w, n]
        abs_loc0 = np.arange(start, end, dtype=np.int64)          # seed pos
        loc_step = 1
    else:
        ref = lane.chrom[start - n + 1:end][::-1]
        q = lane.query[::-1]
        steps = np.lib.stride_tricks.sliding_window_view(ref, n)[:w]
        abs_loc0 = np.arange(end - 1, start - 1, -1, dtype=np.int64)
        loc_step = -1

    seeded = steps[:, 0] == q[0]
    if q[0] == dna.N or not seeded.any():
        return stats

    mm = ~dna.matches(q[None, :], steps)            # Matches() mismatch steps
    strict_mm = steps != q[None, :]                 # strict mismatch steps
    cum = np.cumsum(mm, axis=1, dtype=np.int32)     # cum[:, L-1] = mm in q[0:L]
    full_mm = cum[:, -1]

    # strict window ok at L: no strict mismatches among steps L-mpm..L-1
    scum = np.cumsum(strict_mm, axis=1, dtype=np.int32)
    strict_ok = np.empty((w, n), dtype=bool)        # index L-1
    for L in range(1, n + 1):
        lo = max(L - mpm, 0)
        base = scum[:, lo - 1] if lo > 0 else 0
        strict_ok[:, L - 1] = (scum[:, L - 1] - base) == 0

    level = np.where(seeded[:, None], cum, BIG)     # [w, n] at length index
    alive = level <= tsec_minus

    for m in range(nlevels):
        sel = (level == m) & alive                  # [w, n]
        stats.counts[:, m] = sel.sum(axis=0, dtype=np.int32)
        first = np.argmax(sel, axis=0)              # first candidate index
        has = sel.any(axis=0)
        Ls = np.arange(1, n + 1, dtype=np.int64)
        stats.rep_abs_loc[:, m] = np.where(
            has, abs_loc0[first] + loc_step * (Ls - 1), 0)
        stats.rep_full_mm[:, m] = np.where(has, full_mm[first], 0)
        stats.rep_strict_ok[:, m] = np.where(
            has, strict_ok[first, np.arange(n)], False)
        stats.rep_lane[:, m] = lane_index
    return stats


def emit_unique_points(
    stats: LaneStats,
    lanes: Sequence[Lane],
    *,
    bp_start: int,
    bp_end: int,
    max_snp_error: int,
    additional_mismatch: int,
    max_mismatch: np.ndarray,
    mpm: int,
    mismatch_rate: float,
) -> Tuple[List["UP"], int]:
    """Apply the per-length emission rules; returns (points, last full_mm)."""
    from refpindel.reads import UniquePoint

    ups: List[UniquePoint] = []
    last_full_mm = 0
    counts = stats.counts
    n = stats.n
    for L in range(1, min(bp_end, n - 1) + 1):
        if L < bp_start:
            continue
        row = counts[L - 1]
        nz = np.nonzero(row[:max_snp_error + 1])[0]
        min_mm = int(nz[0]) if nz.size else max_snp_error + 1
        if min_mm > int(max_mismatch[L]):
            break  # early return: the whole search stops here
        if min_mm > max_snp_error:
            continue
        m = min_mm
        if row[m] != 1:
            continue
        if L < bp_start + m:
            continue
        hi = min(m + additional_mismatch, stats.nlevels - 1)
        if int(row[:hi + 1].sum()) != 1:
            continue
        # CheckMismatches
        lane = lanes[int(stats.rep_lane[L - 1, m])]
        full_mm = int(stats.rep_full_mm[L - 1, m])
        if lane.direction == "+":      # FORWARD: requires L > mpm
            if L <= mpm:
                continue
        else:                          # BACKWARD: substring compare needs L >= mpm
            if L < mpm:
                continue
        if not bool(stats.rep_strict_ok[L - 1, m]):
            continue
        max_allowed = np.float32(n * mismatch_rate)
        if not (np.float32(full_mm) >= max_allowed):
            continue
        ups.append(UniquePoint(
            chr_name=lane.chr_name, length_str=L,
            abs_loc=int(stats.rep_abs_loc[L - 1, m]),
            direction=lane.direction, strand=lane.strand, mismatches=m))
        last_full_mm = full_mm
    return ups, last_full_mm


def merged_stats(lanes: Sequence[Lane], tsec_minus: int, mpm: int) -> LaneStats:
    stats: Optional[LaneStats] = None
    for i, lane in enumerate(lanes):
        s = lane_stats(lane, i, tsec_minus, mpm)
        stats = s if stats is None else stats.merge(s)
    assert stats is not None
    return stats
