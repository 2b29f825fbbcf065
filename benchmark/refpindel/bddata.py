"""BreakDancer / discordant-read-pair evidence windows.

Behavior-faithful reimplementation of the reference's bddata.cpp:

* external BD file loading with format validation (loadBDFile :91-136,
  CheckBreakDancerFileFormat :47-89): events stored in both coordinate
  orders, ±spacer, same-chromosome pairs closer than 500 bp dropped;
* RP-cluster conversion (UpdateBD :646-811): ModifyRP's reciprocal-overlap
  coordinate merging (:180-237, :253-330), Summarize's identical-window
  counting with support cutoff 5 (:470-560), emission of the ``_RP`` file
  and conversion into BD-like events (both orders);
* per-window rasterization (loadRegion :852-946): the sliding
  [startOfEventList, endOfEventList) index range over first-coordinate-
  sorted events — including the quirk that events whose window starts
  before the scan start are only absorbed into the range when a later
  event is added — and cluster materialization (createRegionCluster
  :820-849) by second coordinate with chain-merging of overlapping
  windows (the merged end is the LAST event's end, not the maximum);
* read→cluster lookup (getCorrespondingSearchWindowCluster :949-967) and
  event confirmation for -Q (isBreakDancerEvent :981-995).

Positions are padded ("computer science") coordinates throughout, as in
the reference.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, TextIO, Tuple

import numpy as np

from refpindel.genome import SPACER

BREAKDANCER_WINDOWSPAN = 200        # control_state.h:46
RP_SUPPORT_CUTOFF = 5               # Summarize, bddata.cpp:474


@dataclasses.dataclass(frozen=True)
class BDCoord:
    """BreakDancerCoordinate (control_state.cpp:25-46): pos <= pos2 is
    normalized by the two-position constructor."""

    chr_name: str
    pos: int
    pos2: int

    @classmethod
    def make(cls, chr_name: str, pos: int,
             pos2: Optional[int] = None) -> "BDCoord":
        if pos2 is None:
            return cls(chr_name, pos, pos)
        if pos <= pos2:
            return cls(chr_name, pos, pos2)
        return cls(chr_name, pos2, pos)

    def start_of_window(self) -> int:
        tmp = self.pos2 if (self.pos2 < self.pos and self.pos2 > 0) \
            else self.pos
        return tmp - BREAKDANCER_WINDOWSPAN \
            if tmp >= BREAKDANCER_WINDOWSPAN else 0

    def end_of_window(self) -> int:
        tmp = self.pos2 if (self.pos2 > self.pos and self.pos2 > 0) \
            else self.pos
        return tmp + BREAKDANCER_WINDOWSPAN

    def key(self):
        # operator< compares chromosome name then position only
        return (self.chr_name, self.pos)


Event = Tuple[BDCoord, BDCoord]


def _first_key(ev: Event):
    return ev[0].key() + ev[1].key()


def _second_key(ev: Event):
    return ev[1].key() + ev[0].key()


@dataclasses.dataclass
class RPRead:
    """RP_READ (pindel.h:229-249)."""

    chr_name_a: str = ""
    chr_name_b: str = ""
    da: str = "+"
    db: str = "+"
    pos_a: int = 0
    pos_b: int = 0
    pos_a1: int = 0
    pos_b1: int = 0
    original_pos_a: int = 0
    original_pos_b: int = 0
    insert_size: int = 0
    read_length: int = 0
    tag: str = ""
    tags: List[str] = dataclasses.field(default_factory=list)
    visited: bool = False
    report: bool = False
    num_identical: int = 0


# ------------------------------------------------------------ BD file load

def _is_number(s: str) -> bool:
    return bool(s) and all("0" <= c <= "9" for c in s)


def _at_least_6_fields(line: str) -> bool:
    """AtLeast6Fields (bddata.cpp:23-45)."""
    if not line or line[0] in " \t":
        return False
    n_fields = 0
    in_space = False
    for ch in line[1:]:
        if ch in " \t":
            in_space = True
        elif in_space:
            n_fields += 1
            in_space = False
    return n_fields >= 5


def check_bd_file_format(path: str) -> bool:
    """CheckBreakDancerFileFormat (bddata.cpp:47-89): non-comment lines
    need >= 6 fields with numeric fields 2 and 5."""
    with open(path) as fh:
        for line in fh:
            line = line.rstrip("\n").rstrip("\r")
            if line.startswith("#") or line == "":
                continue
            if not _at_least_6_fields(line):
                return False
            parts = line.split()
            if not (_is_number(parts[1]) and _is_number(parts[4])):
                return False
    return True


class BDData:
    def __init__(self, genome=None):
        self.genome = genome
        self.events_external: List[Event] = []
        self.events: List[Event] = []
        self._mask: Optional[np.ndarray] = None
        self._clusters: List[List[Tuple[str, int, int]]] = [[]]
        self._win_start = 0
        self._win_end = 0
        self._win_chr = ""

    # ------------------------------------------------------------- loading
    def load_bd_file(self, path: str) -> None:
        if not check_bd_file_format(path):
            print("\nIgnore breakdancer file due to an error in the "
                  "BreakDancer file format.\n")
            return
        with open(path) as fh:
            for line in fh:
                line = line.rstrip("\n")
                if line.startswith("#") or not line.split():
                    continue
                parts = line.split()
                first_chr, second_chr = parts[0], parts[3]
                first_pos = int(parts[1]) + SPACER
                second_pos = int(parts[4]) + SPACER
                if (first_chr == second_chr and second_chr != ""
                        and abs(first_pos - second_pos) < 500):
                    continue
                if first_chr and second_chr:
                    a = BDCoord.make(first_chr, first_pos)
                    b = BDCoord.make(second_chr, second_pos)
                    self.events_external.append((a, b))
                    self.events_external.append((b, a))
        self.events_external.sort(key=_first_key)

    # --------------------------------------------------------- RP clusters
    def update_bd(self, rp_reads: List[RPRead],
                  rp_interchr: List[RPRead], rp_out: TextIO,
                  report_interchromosomal: bool) -> List[Event]:
        """UpdateBD (bddata.cpp:646-811).

        Returns the window's event DELTA (everything appended beyond the
        external events): BD state is per-window (the reference rebuilds
        m_bdEvents from m_bdEvents_external each window, bddata.cpp:649),
        so under --hosts the owning rank ships this delta plus the _RP
        text to the coordinator instead of every rank replaying the
        whole RP channel (apply_bd_delta)."""
        self.events = list(self.events_external)
        rp_reads.sort(key=lambda r: (r.pos_a, r.pos_b))
        modify_rp(rp_reads)
        summarize(rp_reads)
        for read in rp_reads:
            if not read.report:
                continue
            shift = read.insert_size
            first_pos = read.pos_a + SPACER
            first_pos2 = read.pos_a1 + SPACER
            if first_pos > first_pos2:
                first_pos, first_pos2 = first_pos2, first_pos
            if read.da == "+" and first_pos > shift:
                first_pos -= shift
            elif shift * 2 < SPACER:
                first_pos2 += shift
            second_pos = read.pos_b + SPACER
            second_pos2 = read.pos_b1 + SPACER
            if second_pos > second_pos2:
                second_pos, second_pos2 = second_pos2, second_pos
            if read.db == "+" and second_pos > shift:
                second_pos -= shift
            # (reference quirk: the second coordinate's else-branch tests
            # shift*2 < shift, which never holds — no extension here)
            if read.chr_name_a and read.chr_name_b:
                a = BDCoord.make(read.chr_name_a, first_pos, first_pos2)
                b = BDCoord.make(read.chr_name_b, second_pos, second_pos2)
                self.events.append((a, b))
                self.events.append((b, a))
                rp_out.write(
                    f"{read.chr_name_a}\t"
                    f"{first_pos - SPACER if first_pos > SPACER else 1}\t"
                    f"{first_pos2 - SPACER}\t{read.da}\t"
                    f"{first_pos2 - first_pos}\t{read.chr_name_b}\t"
                    f"{second_pos - SPACER if second_pos > SPACER else 1}"
                    f"\t{second_pos2 - SPACER}\t{read.db}\t"
                    f"{second_pos2 - second_pos}\t"
                    f"{abs(second_pos - first_pos)}\tSupport: "
                    f"{read.num_identical}\t"
                    + _support_per_sample(read) + "\n")
        rp_reads.clear()

        if report_interchromosomal and rp_interchr:
            modify_rp_interchr(rp_interchr)
            summarize_interchr(rp_interchr)
            for read in rp_interchr:
                if not read.report:
                    continue
                shift = read.insert_size
                first_pos = read.pos_a + SPACER
                first_pos2 = read.pos_a1 + SPACER
                second_pos = read.pos_b + SPACER
                second_pos2 = read.pos_b1 + SPACER
                if first_pos > first_pos2:
                    first_pos, first_pos2 = first_pos2, first_pos
                if read.da == "+" and first_pos > shift:
                    first_pos -= shift
                elif shift * 2 < SPACER:
                    first_pos2 += shift
                if second_pos > second_pos2:
                    second_pos, second_pos2 = second_pos2, second_pos
                if read.db == "+" and second_pos > shift:
                    second_pos -= shift
                elif shift * 2 < SPACER:
                    second_pos2 += shift
                if read.chr_name_a and read.chr_name_b:
                    a = BDCoord.make(read.chr_name_a, first_pos,
                                     first_pos2)
                    b = BDCoord.make(read.chr_name_b, second_pos,
                                     second_pos2)
                    self.events.append((a, b))
                    self.events.append((b, a))
                    rp_out.write(
                        f"{read.chr_name_a}\t"
                        f"{first_pos - SPACER if first_pos > SPACER else 1}"
                        f"\t{first_pos2 - SPACER}\t{read.da}\t"
                        f"{first_pos2 - first_pos}\t{read.chr_name_b}\t"
                        f"{second_pos - SPACER if second_pos > SPACER else 1}"
                        f"\t{second_pos2 - SPACER}\t{read.db}\t0\t"
                        f"\tSupport: {read.num_identical}"
                        + _support_per_sample(read) + "\n")
        rp_interchr.clear()
        delta = self.events[len(self.events_external):]
        self.events.sort(key=_first_key)
        return delta

    def apply_bd_delta(self, delta: List[Event]) -> None:
        """Coordinator side of the sharded evidence chain: install a
        window's RP->BD event delta computed by its owning rank."""
        self.events = list(self.events_external) + list(delta)
        self.events.sort(key=_first_key)

    # ------------------------------------------------------- rasterization
    def load_region(self, chr_name: str, padded_start: int,
                    padded_end: int) -> None:
        """loadRegion (bddata.cpp:852-946) over the padded window,
        extended by 3*1000 on both sides."""
        insert = 1000
        start = padded_start - 3 * insert if padded_start >= 3 * insert \
            else 0
        end = padded_end + 3 * insert
        self._win_chr = chr_name
        self._win_start = start
        self._win_end = end
        size = end - start + 1
        self._mask = np.zeros(size, dtype=np.int32)
        self._clusters = [[]]

        keys = [(_first_key(ev)) for ev in self.events]
        import bisect
        lo = bisect.bisect_left(keys, (chr_name, start, "", 0))
        hi = bisect.bisect_right(keys, (chr_name, end) + ("￿", 0))
        # the events visible to the scan, in first-coordinate order
        evs = self.events[lo:hi]
        if not evs:
            return
        starts = [ev[0].start_of_window() for ev in evs]
        ends = [ev[0].end_of_window() for ev in evs]
        # positions where the scan state can change
        points = sorted({p for p in starts if start <= p < end}
                        | {e + 1 for e in ends if start <= e + 1 < end})
        s = e = 0
        index = 0
        prev_pos = start
        prev_val = 0
        for p in points:
            # fill [prev_pos, p) with the previous value
            self._mask[prev_pos - start: p - start] = prev_val
            changed = False
            while s < e and ends[s] < p:
                s += 1
                changed = True
            it = e
            while it < len(evs):
                if p < starts[it]:
                    break
                if p == starts[it]:
                    e += 1
                    changed = True
                it += 1
            if s == e:
                prev_val = 0
            else:
                if changed:
                    index += 1
                    self._clusters.append(
                        self._make_cluster(evs[s:e]))
                prev_val = index
            prev_pos = p
        self._mask[prev_pos - start:] = prev_val

    def _make_cluster(self, events: List[Event]
                      ) -> List[Tuple[str, int, int]]:
        """createRegionCluster (bddata.cpp:820-849): sort by second
        coordinate, chain-merge overlapping second-coordinate windows;
        the merged end is the LAST merged event's end (not the max)."""
        evs = sorted(events, key=_second_key)
        cluster: List[Tuple[str, int, int]] = []
        i = 0
        while i < len(evs):
            chrom = evs[i][1].chr_name
            w_start = evs[i][1].start_of_window()
            w_end = evs[i][1].end_of_window()
            while (i + 1 < len(evs)
                   and evs[i + 1][1].chr_name == chrom
                   and evs[i + 1][1].start_of_window() <= w_end + 1):
                i += 1
                w_end = evs[i][1].end_of_window()
            cluster.append((chrom, w_start, w_end))
            i += 1
        return cluster

    # ------------------------------------------------------------- queries
    def cluster_for(self, last_abs_loc_close_end: int
                    ) -> List[Tuple[str, int, int]]:
        """getCorrespondingSearchWindowCluster (bddata.cpp:949-967)."""
        if self._mask is None:
            return []
        offset = last_abs_loc_close_end - self._win_start
        if offset < 0 or offset > self._win_end - self._win_start + 1:
            return self._clusters[0]
        if last_abs_loc_close_end > self._win_start \
                and offset < len(self._mask):
            return self._clusters[int(self._mask[offset])]
        return self._clusters[0]

    def is_breakdancer_event(self, left: int, right: int) -> bool:
        """isBreakDancerEvent (bddata.cpp:981-995); biological coords."""
        if self._mask is None:
            return False
        raw_left = left + SPACER - self._win_start
        raw_right = right + SPACER - self._win_start
        if not (0 <= raw_left < len(self._mask)
                and 0 <= raw_right < len(self._mask)):
            return False
        if self._mask[raw_left] != 0 and self._mask[raw_right] != 0:
            cluster = self._clusters[int(self._mask[raw_left])]
            pos = raw_right        # rawRightPosition - window start
            for chrom, w_start, w_end in cluster:
                # SearchWindow::encompasses over the current chromosome
                if (chrom == self._win_chr
                        and w_start <= pos <= w_end):
                    return True
        return False


def _support_per_sample(read: RPRead) -> str:
    """DisplayBDSupportPerSample (bddata.cpp:624-643)."""
    tags = sorted(read.tags)
    out = []
    count = 1
    current = tags[0]
    for tag in tags[1:]:
        if tag == current:
            count += 1
        else:
            out.append(f"\t{current} {count}")
            current = tag
            count = 1
    out.append(f"\t{current} {count}")
    return "".join(out)


# ----------------------------------------------------------- RP machinery

def initialize_a1b1(reads: List[RPRead]) -> None:
    """InitializeA1B1 (bddata.cpp:253-300)."""
    for r in reads:
        distance = r.insert_size
        if r.da == "+":
            if r.pos_a > r.read_length * 2:
                r.pos_a = r.pos_a - r.read_length * 2
            else:
                r.pos_a = 1
            r.pos_a1 = r.pos_a + distance + r.read_length * 2
        else:
            if r.pos_a > distance:
                r.pos_a = r.pos_a - distance
            else:
                r.pos_a = 1
            r.pos_a1 = r.pos_a + distance + r.read_length
        if r.db == "+":
            if r.pos_b > r.read_length * 2:
                r.pos_b = r.pos_b - r.read_length * 2
            else:
                r.pos_b = 1
            r.pos_b1 = r.pos_b + distance + r.read_length
        else:
            if r.pos_b > distance:
                r.pos_b = r.pos_b - distance
            else:
                r.pos_b = 1
            r.pos_b1 = r.pos_b + distance + r.read_length


def reciprocal_overlap(first: RPRead, second: RPRead) -> bool:
    """RecipicalOverlap (bddata.cpp:180-237): 0.9 reciprocal overlap of
    the [midA, midB] spans, same strands, spans within 1000."""
    distance = 1000
    if abs(first.pos_a - first.pos_a1) > distance:
        return False
    if abs(first.pos_b - first.pos_b1) > distance:
        return False
    if abs(second.pos_a - second.pos_a1) > distance:
        return False
    if abs(second.pos_b - second.pos_b1) > distance:
        return False
    cutoff = 0.9
    fa = (first.pos_a + first.pos_a1) // 2
    fb = (first.pos_b + first.pos_b1) // 2
    if fa > fb:
        fa, fb = fb, fa
    sa = (second.pos_a + second.pos_a1) // 2
    sb = (second.pos_b + second.pos_b1) // 2
    if sa > sb:
        sa, sb = sb, sa
    if first.da != second.da or first.db != second.db:
        return False
    if fa > sb + 200 or fb + 200 < sa:
        return False
    if fa <= sa and sb <= fb:
        if (sb - sa) / (fb - fa) >= cutoff:
            return True
    if sa <= fa and fb <= sb:
        if (fb - fa) / (sb - sa) >= cutoff:
            return True
    if fa <= sa <= fb <= sb:
        if ((fb - sa) / (fb - fa) >= cutoff
                and (fb - sa) / (sb - sa) >= cutoff):
            return True
    if sa <= fa <= sb <= fb:
        if ((sb - fa) / (fb - fa) >= cutoff
                and (sb - fa) / (sb - sa) >= cutoff):
            return True
    return False


def _process_same_chr_same_strand(first: RPRead, second: RPRead) -> None:
    """ProcessSameChromosomeSameStrand (bddata.cpp:302-353)."""
    if (second.pos_a1 - second.pos_a > 10000
            or second.pos_b1 - second.pos_b > 10000):
        return
    if ((first.da == "+" and first.pos_a < second.pos_a
         and second.pos_a < first.pos_a1
         and first.pos_a1 < second.pos_a1)
            or (first.da == "-" and first.pos_a < second.pos_a1
                and second.pos_a1 < first.pos_a1
                and second.pos_a < first.pos_a)):
        first.pos_a = second.pos_a
        first.pos_a1 = second.pos_a1
    if ((first.db == "+" and first.pos_b < second.pos_b
         and second.pos_b < first.pos_b1
         and first.pos_b1 < second.pos_b1)
            or (first.db == "-" and second.pos_b < first.pos_b
                and first.pos_b < second.pos_b1
                and second.pos_b1 < first.pos_b1)):
        first.pos_b = second.pos_b
        first.pos_b1 = second.pos_b1


def _overlap_mask(i: int, J: np.ndarray, pos_a, pos_a1, pos_b, pos_b1,
                  span_ok) -> np.ndarray:
    """Vectorized RecipicalOverlap(reads[i], reads[J]) (bddata.cpp:
    180-237) for seconds J that already share reads[i]'s strands.

    Matches the scalar rule bit-for-bit on integer inputs: midpoints via
    floor division, float64 ratio compares.  Degenerate zero-length
    spans (which would raise ZeroDivisionError in the scalar form and
    can't occur on well-formed RP reads) evaluate to non-overlap."""
    if not span_ok[i]:
        return np.zeros(J.shape, dtype=bool)
    fa = (int(pos_a[i]) + int(pos_a1[i])) // 2
    fb = (int(pos_b[i]) + int(pos_b1[i])) // 2
    if fa > fb:
        fa, fb = fb, fa
    sa = (pos_a[J] + pos_a1[J]) // 2
    sb = (pos_b[J] + pos_b1[J]) // 2
    lo = np.minimum(sa, sb)
    hi = np.maximum(sa, sb)
    m = span_ok[J] & ~((fa > hi + 200) | (fb + 200 < lo))
    if not m.any():
        return m
    flen = np.float64(fb - fa)
    with np.errstate(divide="ignore", invalid="ignore"):
        slen = (hi - lo).astype(np.float64)
        c = ((fa <= lo) & (hi <= fb) & ((hi - lo) / flen >= 0.9))
        c |= ((lo <= fa) & (fb <= hi) & ((fb - fa) / slen >= 0.9))
        c |= ((fa <= lo) & (lo <= fb) & (fb <= hi)
              & ((fb - lo) / flen >= 0.9) & ((fb - lo) / slen >= 0.9))
        c |= ((lo <= fa) & (fa <= hi) & (hi <= fb)
              & ((hi - fa) / flen >= 0.9) & ((hi - fa) / slen >= 0.9))
    return m & c


def _apply_process(i: int, j: int, pos_a, pos_a1, pos_b, pos_b1,
                   da, db) -> bool:
    """ProcessSameChromosomeSameStrand (bddata.cpp:302-353) on the SoA
    arrays; returns whether reads[i] changed (so the caller re-tests the
    remaining seconds against the updated coordinates, exactly like the
    scalar loop's visibility order)."""
    if (pos_a1[j] - pos_a[j] > 10000
            or pos_b1[j] - pos_b[j] > 10000):
        return False
    changed = False
    if ((da[i] and pos_a[i] < pos_a[j] < pos_a1[i] < pos_a1[j])
            or (not da[i] and pos_a[i] < pos_a1[j] < pos_a1[i]
                and pos_a[j] < pos_a[i])):
        pos_a[i] = pos_a[j]
        pos_a1[i] = pos_a1[j]
        changed = True
    if ((db[i] and pos_b[i] < pos_b[j] < pos_b1[i] < pos_b1[j])
            or (not db[i] and pos_b[j] < pos_b[i] < pos_b1[j]
                and pos_b1[j] < pos_b1[i])):
        pos_b[i] = pos_b[j]
        pos_b1[i] = pos_b1[j]
        changed = True
    return changed


def _native_rp():
    """The port loads native/rp.cpp here; the plain reference runs the
    vectorized Python re-statement of ModifyRP's loop (None)."""
    return None


def modify_rp(reads: List[RPRead]) -> None:
    """ModifyRP (bddata.cpp:386-436) — sequential (-T 1) semantics.

    The pairwise merge loop is inherently sequential (a merge updates
    ``first`` mid-scan), so it runs in native code with the reference's
    exact loop structure (native/rp.cpp); a vectorized Python
    re-statement of the same order serves as fallback."""
    if not reads:
        return
    reads.sort(key=lambda r: (-r.original_pos_a, -r.original_pos_b))
    initialize_a1b1(reads)
    n = len(reads)
    pos_a = np.fromiter((r.pos_a for r in reads), np.int64, n)
    pos_a1 = np.fromiter((r.pos_a1 for r in reads), np.int64, n)
    pos_b = np.fromiter((r.pos_b for r in reads), np.int64, n)
    pos_b1 = np.fromiter((r.pos_b1 for r in reads), np.int64, n)
    da = np.fromiter((r.da == "+" for r in reads), bool, n)
    db = np.fromiter((r.db == "+" for r in reads), bool, n)
    # spans <= 1000 is invariant under merges (a merge copies a span
    # from a second that itself passed the span test)
    span_ok = ((np.abs(pos_a - pos_a1) <= 1000)
               & (np.abs(pos_b - pos_b1) <= 1000))
    try:
        lib = _native_rp()
    except Exception:
        lib = None
    if lib is not None:
        lo = np.empty(n, np.int64)
        hi = np.empty(n, np.int64)
        lib.ptrp_modify(n, pos_a, pos_a1, pos_b, pos_b1,
                        da.astype(np.uint8), db.astype(np.uint8),
                        span_ok.astype(np.uint8), lo, hi)
        _writeback_rp(reads, pos_a, pos_a1, pos_b, pos_b1)
        return
    groups = {}
    for key in ((False, False), (False, True), (True, False), (True, True)):
        groups[key] = np.flatnonzero((da == key[0]) & (db == key[1]))
    arrays = (pos_a, pos_a1, pos_b, pos_b1)
    # midpoint interval [lo, hi] per read, maintained across merges: the
    # overlap rule requires [lo_i-200, hi_i+200] to intersect [lo_j, hi_j],
    # which prunes the candidate seconds to near-neighbours in 2 compares
    mid_a = (pos_a + pos_a1) // 2
    mid_b = (pos_b + pos_b1) // 2
    lo = np.minimum(mid_a, mid_b)
    hi = np.maximum(mid_a, mid_b)
    BLOCK = 256

    def refresh_interval(i: int) -> None:
        ma = (int(pos_a[i]) + int(pos_a1[i])) // 2
        mb = (int(pos_b[i]) + int(pos_b1[i])) // 2
        lo[i] = min(ma, mb)
        hi[i] = max(ma, mb)

    def scan_first(i: int, cand: np.ndarray, start_j: int):
        """Apply merges of reads[i] against candidate seconds >= start_j
        (ascending); returns the second AFTER the first merge, or None
        when no merge fired (the scalar loop re-tests remaining seconds
        with updated coordinates after every merge)."""
        cand = cand[cand >= start_j]
        hits = np.flatnonzero(_overlap_mask(i, cand, *arrays, span_ok))
        for h in hits.tolist():
            j = int(cand[h])
            if _apply_process(i, j, *arrays, da, db):
                refresh_interval(i)
                return j + 1
        return None

    for key, J in groups.items():
        if J.size == 0:
            continue
        for bs in range(0, J.size, BLOCK):
            bidx = J[bs:bs + BLOCK]
            # block prefilter: [firsts, seconds] interval-intersection
            # matrix (one numpy pass instead of two per first)
            M = ((hi[J][None, :] >= lo[bidx][:, None] - 200)
                 & (lo[J][None, :] <= hi[bidx][:, None] + 200))
            # seconds mutated after M was built (as earlier firsts) may
            # have drifted into overlap — test them exactly as well
            mutated_since: List[int] = []
            for k in range(bidx.size):
                i = int(bidx[k])
                if not span_ok[i]:
                    continue
                cand = J[M[k]]
                if mutated_since:
                    cand = np.union1d(cand,
                                      np.asarray(mutated_since, np.int64))
                start = 0
                mutated_i = False
                while True:
                    nxt = scan_first(i, cand, start)
                    if nxt is None:
                        break
                    mutated_i = True
                    start = nxt
                    # i's interval changed: the prefilter row is stale,
                    # re-derive candidates from the full group
                    cand = J[(hi[J] >= lo[i] - 200)
                             & (lo[J] <= hi[i] + 200)]
                if mutated_i:
                    mutated_since.append(i)
    _writeback_rp(reads, pos_a, pos_a1, pos_b, pos_b1)


def _writeback_rp(reads: List[RPRead], pos_a, pos_a1, pos_b, pos_b1
                  ) -> None:
    """SoA results back into the objects + the post-merge adjustments of
    ModifyRP's tail (bddata.cpp:424-435)."""
    for k, r in enumerate(reads):
        r.pos_a = int(pos_a[k])
        r.pos_a1 = int(pos_a1[k])
        r.pos_b = int(pos_b[k])
        r.pos_b1 = int(pos_b1[k])
        if r.da == "+":
            r.pos_a += r.read_length
            r.pos_a1 += r.read_length
        if r.db == "+":
            r.pos_b += r.read_length
            r.pos_b1 += r.read_length
        if r.chr_name_a == r.chr_name_b and abs(r.pos_a - r.pos_b) < 500:
            r.visited = True


def modify_rp_interchr(reads: List[RPRead]) -> None:
    """ModifyRP_InterChr (bddata.cpp:443-468)."""
    if not reads:
        return
    reads.sort(key=lambda r: (-r.original_pos_a, -r.original_pos_b))
    initialize_a1b1(reads)
    for i in range(len(reads) - 1):
        first = reads[i]
        for second in reads:
            if (first.chr_name_a == second.chr_name_a
                    and first.chr_name_b == second.chr_name_b):
                if first.da == second.da and first.db == second.db:
                    if reciprocal_overlap(first, second):
                        _process_same_chr_same_strand(first, second)
            elif (first.chr_name_a == second.chr_name_b
                  and first.chr_name_b == second.chr_name_a):
                if first.da == second.db and first.db == second.da:
                    flipped = dataclasses.replace(
                        second, da=second.db, db=second.da,
                        pos_a=second.pos_b, pos_a1=second.pos_b1,
                        pos_b=second.pos_a, pos_b1=second.pos_a1)
                    if reciprocal_overlap(first, flipped):
                        _process_same_chr_same_strand(first, flipped)


def summarize(reads: List[RPRead]) -> None:
    """Summarize (bddata.cpp:470-560), restructured as a group-by.

    The reference's first O(n^2) pass groups non-visited reads with an
    identical (pos/strand) key onto the first occurrence; its second
    pass over the group representatives can never merge again (two reps
    sharing a key would already have merged) and only sets ``report``.
    Quirks kept: the last read (index n-1) is never an outer ``first``,
    so a singleton group anchored there is dropped; with two or more
    representatives the LAST one never has ``report`` set (the second
    pass iterates ``range(len(good)-1)``)."""
    n = len(reads)
    if n < RP_SUPPORT_CUTOFF:
        for r in reads:
            r.report = False
        return
    active = [i for i in range(n) if not reads[i].visited]
    if not active:
        return
    key2first: dict = {}
    good: List[int] = []
    for i in active:
        r = reads[i]
        key = (r.pos_a, r.pos_b, r.pos_a1, r.pos_b1, r.da, r.db)
        rep = key2first.get(key)
        if rep is None:
            if i == n - 1:
                # never an outer `first` in the reference's range(n-1)
                continue
            key2first[key] = i
            r.num_identical = 1
            good.append(i)
        else:
            first = reads[rep]
            first.num_identical += 1
            r.visited = True
            if r.tags:
                first.tags.extend(r.tags)
                r.tags = []
    if not good:
        return
    if len(good) == 1:
        reads[good[0]].report = \
            reads[good[0]].num_identical >= RP_SUPPORT_CUTOFF
        return
    for i in good[:-1]:
        a = reads[i]
        a.report = a.num_identical >= RP_SUPPORT_CUTOFF


def summarize_interchr(reads: List[RPRead]) -> None:
    """Summarize_InterChr (bddata.cpp:562-612).

    Quirk kept: NumberOfIdentical starts at 0 here (not 1)."""
    if not reads:
        return
    for i in range(len(reads) - 1):
        first = reads[i]
        if first.visited:
            continue
        first.num_identical = 0
        for j in range(i + 1, len(reads)):
            second = reads[j]
            if second.visited:
                continue
            if (first.chr_name_a == second.chr_name_a
                    and first.chr_name_b == second.chr_name_b
                    and first.pos_a == second.pos_a
                    and first.pos_b == second.pos_b
                    and first.da == second.da and first.db == second.db):
                first.num_identical += 1
                if first.tags:
                    first.tags.extend(second.tags)
                    second.tags = []
                second.visited = True
        first.report = first.num_identical >= RP_SUPPORT_CUTOFF
