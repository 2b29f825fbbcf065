"""Clustering and bit-identical text report emission.

Ports the reference reporter's box clustering, ordering quirks and exact
output formats (reporter.cpp): ``smaller``/``CompareFragName`` comparator
(:908-942), selection-style ``bubblesortReads`` that reorders equal keys
(:932-942), ``markDuplicates`` (:946-972), Indel4output run grouping, the
``OutputDeletions``/``OutputSIs``/``OutputDI``/``OutputShortInversion``
writers (:271-880, :1588-1697) and the global counters
(output_file_data.*, NumberOfSIsInstances, g_numberOfInvInstances).
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Optional, TextIO

import numpy as np

from refpindel.config import Settings
from refpindel.events.canonical import (cap2low,
                                               get_real_start_4_deletion,
                                               get_real_start_4_insertion,
                                               is_inversion, report_event,
                                               revcomp_str)
from refpindel.genome import SPACER
from refpindel.reads import MINUS, PLUS, SplitRead


def compare_frag_name(a: str, b: str) -> bool:
    """Reference CompareFragName (reporter.cpp:875-906), quirks included."""
    if len(a) > len(b):
        for pos in range(len(b)):
            if ord(a[pos]) > ord(b[pos]):
                return True
            if ord(a[pos]) < ord(b[pos]):
                return False
    else:
        # both the a<b and a==b branches compare the common prefix only
        # (the reference's inner double loop reduces to this)
        for pos in range(min(len(a), len(b))):
            if ord(a[pos]) > ord(b[pos]):
                return True
            if ord(a[pos]) < ord(b[pos]):
                return False
    return False


def smaller(a: SplitRead, b: SplitRead) -> bool:
    """Reference ``smaller`` (reporter.cpp:908-930)."""
    if a.frag_name != b.frag_name:
        return compare_frag_name(a.frag_name, b.frag_name)
    if a.bp_left != b.bp_left:
        return a.bp_left < b.bp_left
    if a.bp_right != b.bp_right:
        return a.bp_right < b.bp_right
    if a.indel_size != b.indel_size:
        return a.indel_size < b.indel_size
    if a.nt_size != b.nt_size:
        return a.nt_size < b.nt_size
    if a.bp != b.bp:
        return a.bp < b.bp
    return False


def bubblesort_reads(reads: List[SplitRead], indices: List[int]) -> None:
    """Exchange sort that also swaps on ties (reporter.cpp:932-942).

    Swapping on every non-smaller pair yields ascending order with tied
    elements in REVERSED input order (verified against the literal loop
    in tests), so when every read shares one fragment name — always true
    inside a per-chromosome box, making the CompareFragName quirk moot —
    the permutation is one stable lexsort on (keys..., -input index).
    Mixed fragment names fall back to the literal loop."""
    n = len(indices)
    if n < 2:
        return
    frag0 = reads[indices[0]].frag_name
    if n > 8 and all(reads[i].frag_name == frag0 for i in indices):
        keys = np.empty((5, n), np.int64)
        for k, i in enumerate(indices):
            r = reads[i]
            keys[0, k] = r.bp_left
            keys[1, k] = r.bp_right
            keys[2, k] = r.indel_size
            keys[3, k] = r.nt_size
            keys[4, k] = r.bp
        order = np.lexsort((-np.arange(n), keys[4], keys[3], keys[2],
                            keys[1], keys[0]))
        indices[:] = [indices[k] for k in order]
        return
    for first in range(n - 1):
        for second in range(first + 1, n):
            if not smaller(reads[indices[first]], reads[indices[second]]):
                indices[first], indices[second] = (indices[second],
                                                   indices[first])


def mark_duplicates(reads: List[SplitRead], indices: List[int]) -> None:
    """Reference markDuplicates (reporter.cpp:946-972): every read whose
    (left, right, name) was already seen by an earlier (still-unique)
    read loses its unique flag — equivalent to keeping only the first
    occurrence of each triple, since reads enter with unique_read True
    (finalize_close_ends) and the first occurrence always marks the
    rest of its group."""
    seen = set()
    for i in indices:
        r = reads[i]
        key = (r.left, r.right, r.name)
        if key in seen:
            r.unique_read = False
        else:
            seen.add(key)


@dataclasses.dataclass
class Indel4output:
    """Reference pindel.h:402-451."""

    bp_left: int = 0
    bp_right: int = 0
    indel_size: int = 0
    start: int = 0
    end: int = 0
    real_start: int = 0
    real_end: int = 0
    nt_size: int = 0
    whether_report: bool = False
    indel_str: str = ""
    chr_name: str = ""
    support: int = 0

    def initialize(self, start: int, read: SplitRead) -> None:
        self.start = start
        self.end = start
        self.support = 1
        self.indel_size = read.indel_size
        self.indel_str = read.nt_str
        self.bp_left = read.bp_left
        self.bp_right = read.bp_right
        self.whether_report = True
        self.chr_name = read.frag_name
        self.real_start = 0
        self.real_end = 0
        self.nt_size = 0

    def complete(self) -> None:
        self.real_start = self.bp_left
        self.real_end = self.bp_right
        self.support = self.end - self.start + 1


class ReporterState:
    """Cross-window globals of the reference reporter.

    g_sampleNames (std::set → sorted order), g_reportLength, the SV
    counters, the per-chromosome mask, and the ref-coverage region.
    """

    def __init__(self, settings: Settings):
        self.settings = settings
        self.sample_names: set = set()
        self.report_length = 1          # g_reportLength
        self.template_counter = 0       # OutputFileData m_templateCounter
        self.nontemplate_counter = 0
        self.num_si = 0                 # NumberOfSIsInstances
        self.num_inv = 0                # g_numberOfInvInstances
        self.num_td = 0                 # NumberOfTDInstances
        self.count_li = 0               # SortOutputLI's static Count_LI
        self.max_insert_size = 0        # g_maxInsertSize (pindel.cpp:114)
        self.mask: Optional[bytearray] = None   # CurrentChrMask
        self.region_start = 0           # g_RegionStart
        self.region_end = 0             # g_RegionEnd
        self.bd = None                  # BDData when -b is set
        # g_RefCoverageRegion: [window_len+1, n_samples] per-position
        # per-sample counts; pindel-format input has no reference-
        # supporting reads so all counts are zero
        self.ref_coverage = None    # numpy int32 array in BAM mode
        # -N germline RD filter context (BAM mode only): bam config
        # entries, open readers and the genome for depth queries
        self.bam_entries = []
        self.bam_readers: dict = {}
        self.genome = None

    @property
    def sv_index(self) -> int:
        return self.template_counter + self.nontemplate_counter

    def sorted_samples(self) -> List[str]:
        return sorted(self.sample_names)

    def coverage_at(self, pos: int, sample_idx: int) -> int:
        """g_RefCoverageRegion[pos - g_RegionStart] lookup
        (reporter.cpp:216,359,368,...); zero-filled for pindel input."""
        if self.ref_coverage is None:
            return 0
        i = pos - self.region_start
        if 0 <= i < len(self.ref_coverage):
            return int(self.ref_coverage[i][sample_idx])
        return 0

    def mask_set(self, padded_pos: int) -> None:
        if self.mask is not None and 0 <= padded_pos < len(self.mask):
            self.mask[padded_pos] = ord("B")


# --------------------------------------------------------------- support math

def support_counts(reads: List[SplitRead], c_s: int, c_e: int,
                   state: ReporterState):
    """calculateSupportPerTag + PerStrand (reporter.cpp:68-117)."""
    samples = state.sorted_samples()
    idx = {s: i for i, s in enumerate(samples)}
    per = [[0, 0, 0, 0] for _ in samples]   # NumPlus, NumMinus, NumUPlus, NumUMinus
    for i in range(c_s, c_e + 1):
        r = reads[i]
        s2n = r.sample_name_to_number or {r.tag: 1}
        for name, count in s2n.items():
            t = idx[name]
            if r.matched_d == PLUS:
                per[t][0] += count
                if r.unique_read:
                    per[t][2] += count
            else:
                per[t][1] += count
                if r.unique_read:
                    per[t][3] += count
    left_s = sum(p[0] for p in per)
    left_u = sum(p[2] for p in per)
    right_s = sum(p[1] for p in per)
    right_u = sum(p[3] for p in per)
    num_reads = left_s + right_s
    num_u_reads = left_u + right_u
    n_sup_samples = sum(1 for p in per if p[0] + p[1])
    n_u_sup_samples = sum(1 for p in per if p[2] + p[3])
    return (samples, per, left_s, left_u, right_s, right_u,
            num_reads, num_u_reads, n_sup_samples, n_u_sup_samples)


def _sample_columns(state: ReporterState, samples, per,
                    bp_left: int, bp_right: int) -> str:
    """Per-sample coverage+support columns shared by all writers."""
    cols = []
    in_start = (bp_left + 2 >= state.region_start
                and bp_left + 2 < state.region_end)
    in_end = (bp_right > state.region_start
              and bp_right < state.region_end)
    for i, name in enumerate(samples):
        cov_s = state.coverage_at(bp_left + 2, i) if in_start else -1
        cov_e = state.coverage_at(bp_right, i) if in_end else -1
        cols.append(f"\t{name} {cov_s} {cov_e} "
                    f"{per[i][0]} {per[i][2]} {per[i][1]} {per[i][3]}")
    return "".join(cols)


HASHLINE = "#" * 100


def _sum_ms(reads, c_s, c_e):
    return sum(reads[i].ms for i in range(c_s, c_e + 1))


def report_breakdancer_event(state: ReporterState, chrom: str, left: int,
                             right: int, size: int, sv_type: str,
                             counter: int) -> None:
    """reportBreakDancerEvent (pindel.cpp:534-541): with -Q and -b set,
    events confirmed by a BreakDancer call are appended to the -Q file
    (which the reference never truncates)."""
    s = state.settings
    if not (s.breakdancer_output_filename and s.breakdancer_filename):
        return
    if state.bd is not None and state.bd.is_breakdancer_event(left, right):
        with open(s.breakdancer_output_filename, "a") as fh:
            fh.write(f"{chrom}\t{left}\t{right}\t{size}\t{sv_type}"
                     f"\t{counter}\n")


# ------------------------------------------------------------------- writers

def output_deletions(reads: List[SplitRead], chr_seq: str, c_s: int, c_e: int,
                     real_start: int, real_end: int, out: TextIO,
                     state: ReporterState) -> None:
    """Reference OutputDeletions (reporter.cpp:271-446)."""
    (samples, per, left_s, left_u, right_s, right_u,
     num_reads, num_u, n_sup, n_u_sup) = support_counts(reads, c_s, c_e, state)
    first = reads[c_s]
    easy_score = (left_s + 1) * (right_s + 1)
    if first.indel_size < 14:
        gap_size = first.indel_size
    else:
        gap_size = 13 + int(math.log10(first.indel_size - 10))
    state.mask_set(first.bp_left + SPACER)
    state.mask_set(first.bp_right + SPACER)
    state.mask_set(real_start + SPACER)
    state.mask_set(real_end + SPACER)
    report_breakdancer_event(state, first.frag_name, first.bp_left + 1,
                             first.bp_right + 1, first.indel_size, "D",
                             state.sv_index)

    out.write(HASHLINE + "\n")
    out.write(f"{state.sv_index}\tD {first.indel_size}"
              f"\tNT {first.nt_size} \"{first.nt_str}\""
              f"\tChrID {first.frag_name}"
              f"\tBP {first.bp_left + 1}\t{first.bp_right + 1}"
              f"\tBP_range {real_start + 1}\t{real_end + 1}"
              f"\tSupports {num_reads}\t{num_u}"
              f"\t+ {left_s}\t{left_u}\t- {right_s}\t{right_u}"
              f"\tS1 {easy_score}"
              f"\tSUM_MS {_sum_ms(reads, c_s, c_e)}"
              f"\t{len(samples)}\tNumSupSamples {n_sup}\t{n_u_sup}"
              + _sample_columns(state, samples, per,
                                first.bp_left, first.bp_right) + "\n")

    rl = state.report_length
    pos = first.left - rl + first.bp + 1
    line = chr_seq[pos:pos + rl]
    if first.indel_size >= 14:
        line += cap2low(chr_seq[first.left + first.bp + 1:
                                first.left + first.bp + 6])
        line += f"<{first.indel_size - 10}>"
        p2 = first.right - first.read_length + first.bp - 3
        line += cap2low(chr_seq[p2:p2 + 5])
    else:
        line += cap2low(chr_seq[first.left + first.bp + 1:
                                first.left + first.bp + 1 + gap_size])
    p3 = first.left + first.bp + 1 + first.indel_size
    line += chr_seq[p3:p3 + rl - gap_size]
    out.write(line + "\n")

    for gi in range(c_s, c_e + 1):
        r = reads[gi]
        space_before = rl - r.bp - 1
        parts = [" " * max(space_before, 0)]
        seq = r.seq if r.matched_d == MINUS else revcomp_str(r.seq)
        parts.append(seq[:r.bp + 1])
        parts.append(" " * gap_size)
        parts.append(seq[r.bp + 1: r.bp + 1 + r.read_length - r.bp])
        space_before_d = rl + rl - space_before - r.read_length
        parts.append(" " * max(space_before_d, 0))
        parts.append(f"\t{r.matched_d}\t{r.matched_rel_pos}\t{r.ms}"
                     f"\t{r.tag}\t{r.name}")
        out.write("".join(parts) + "\n")


def output_sis(reads: List[SplitRead], chr_seq: str, c_s: int, c_e: int,
               real_start: int, real_end: int, out: TextIO,
               state: ReporterState) -> None:
    """Reference OutputSIs (reporter.cpp:637-756)."""
    (samples, per, left_s, left_u, right_s, right_u,
     num_reads, num_u, n_sup, n_u_sup) = support_counts(reads, c_s, c_e, state)
    first = reads[c_s]
    easy_score = (left_s + 1) * (right_s + 1)
    state.mask_set(first.bp_left + SPACER)
    state.mask_set(first.bp_right + SPACER)
    state.mask_set(real_start + SPACER)
    state.mask_set(real_end + SPACER)
    report_breakdancer_event(state, first.frag_name, first.bp_left + 1,
                             first.bp_right + 1, first.indel_size, "SI",
                             state.num_si)

    # consensus NT string: majority vote over read NT strings
    counts: Dict[str, int] = {}
    for i in range(c_s, c_e + 1):
        counts[reads[i].nt_str] = counts.get(reads[i].nt_str, 0) + 1
    consensus, best = "", 0
    for nt in sorted(counts):          # std::map iterates keys in order
        if counts[nt] > best:
            best = counts[nt]
            consensus = nt

    out.write(HASHLINE + "\n")
    out.write(f"{state.num_si}\tI {first.indel_size}"
              f"\tNT {first.indel_size} \"{consensus}\""
              f"\tChrID {first.frag_name}"
              f"\tBP {first.bp_left + 1}\t{first.bp_right + 1}"
              f"\tBP_range {real_start + 1}\t{real_end + 1}"
              f"\tSupports {num_reads}\t{num_u}"
              f"\t+ {left_s}\t{left_u}\t- {right_s}\t{right_u}"
              f"\tS1 {easy_score}"
              f"\tSUM_MS {_sum_ms(reads, c_s, c_e)}"
              f"\t{len(samples)}\tNumSupSamples {n_sup}\t{n_u_sup}"
              + _sample_columns(state, samples, per,
                                first.bp_left, first.bp_right) + "\n")

    rl = state.report_length
    pos = first.left - rl + first.bp + 1
    line = chr_seq[pos:pos + rl]
    line += " " * first.indel_size
    line += chr_seq[first.left + first.bp + 1:
                    first.left + first.bp + 1 + rl]
    out.write(line + "\n")

    for gi in range(c_s, c_e + 1):
        r = reads[gi]
        space_before = rl - r.bp - 1
        parts = [" " * max(space_before, 0)]
        seq = r.seq if r.matched_d == MINUS else revcomp_str(r.seq)
        parts.append(seq)
        space_before_d = rl + rl - space_before - r.read_length
        parts.append(" " * max(space_before_d, 0))
        parts.append(f"\t{r.matched_d}\t{r.matched_rel_pos}\t{r.ms}"
                     f"\t{r.tag}\t{r.name}")
        out.write("".join(parts) + "\n")
    state.num_si += 1


def output_di(reads: List[SplitRead], chr_seq: str, c_s: int, c_e: int,
              out: TextIO, state: ReporterState) -> None:
    """Reference OutputDI (reporter.cpp:758-880)."""
    (samples, per, left_s, left_u, right_s, right_u,
     num_reads, num_u, n_sup, n_u_sup) = support_counts(reads, c_s, c_e, state)
    first = reads[c_s]
    easy_score = (left_s + 1) * (right_s + 1)
    state.mask_set(first.bp_left + SPACER)
    state.mask_set(first.bp_right + SPACER)
    report_breakdancer_event(state, first.frag_name, first.bp_left + 1,
                             first.bp_right + 1, first.indel_size, "D",
                             state.sv_index)

    out.write(HASHLINE + "\n")
    out.write(f"{state.sv_index}\tD {first.indel_size}"
              f"\tNT {first.nt_size} \"{first.nt_str}\""
              f"\tChrID {first.frag_name}"
              f"\tBP {first.bp_left + 1}\t{first.bp_right + 1}"
              f"\tBP_range {first.bp_left + 1}\t{first.bp_right + 1}"
              f"\tSupports {num_reads}\t{num_u}"
              f"\t+ {left_s}\t{left_u}\t- {right_s}\t{right_u}"
              f"\tS1 {easy_score}"
              f"\tSUM_MS {_sum_ms(reads, c_s, c_e)}"
              f"\t{len(samples)}\tNumSupSamples {n_sup}\t{n_u_sup}"
              + _sample_columns(state, samples, per,
                                first.bp_left, first.bp_right) + "\n")

    rl = state.report_length
    pos = first.left - rl + first.bp + 1
    line = chr_seq[pos:pos + rl]
    line += " " * first.nt_size
    p2 = first.left + first.bp + 1 + first.indel_size
    line += chr_seq[p2:p2 + rl]
    out.write(line + "\n")

    for gi in range(c_s, c_e + 1):
        r = reads[gi]
        space_before = rl - r.bp - 1
        parts = [" " * max(space_before, 0)]
        seq = r.seq if r.matched_d == MINUS else revcomp_str(r.seq)
        parts.append(seq + "\t")
        parts.append(f"\t{r.matched_d}\t{r.matched_rel_pos}\t{r.ms}"
                     f"\t{r.tag}\t{r.name}")
        out.write("".join(parts) + "\n")


def output_short_inversion(reads: List[SplitRead], chr_seq: str,
                           c_s: int, c_e: int, real_start: int, real_end: int,
                           out: TextIO, state: ReporterState) -> None:
    """Reference OutputShortInversion (reporter.cpp:1588-1695)."""
    (samples, per, left_s, left_u, right_s, right_u,
     num_reads, num_u, n_sup, n_u_sup) = support_counts(reads, c_s, c_e, state)
    first = reads[c_s]
    easy_score = (left_s + 1) * (right_s + 1)
    state.mask_set(first.bp_left + SPACER)
    state.mask_set(first.bp_right + SPACER)
    report_breakdancer_event(state, first.frag_name, first.bp_left + 1,
                             first.bp_right + 1, first.indel_size, "INV",
                             state.sv_index)

    out.write(HASHLINE + "\n")
    out.write(f"{state.num_inv}\tINV {first.indel_size}"
              f"\tNT {first.nt_size} \"{first.nt_str}\""
              f"\tChrID {first.frag_name}"
              f"\tBP {first.bp_left + 1}\t{first.bp_right + 1}"
              f"\tBP_range {first.bp_left + 1}\t{first.bp_right + 1}"
              f"\tSupports {num_reads}\t{num_u}"
              f"\t+ {left_s}\t{left_u}\t- {right_s}\t{right_u}"
              f"\tS1 {easy_score}"
              f"\tSUM_MS {_sum_ms(reads, c_s, c_e)}"
              f"\t{len(samples)}\tNumSupSamples {n_sup}\t{n_u_sup}"
              + _sample_columns(state, samples, per,
                                first.bp_left, first.bp_right) + "\n")
    state.num_inv += 1

    rl = state.report_length
    pos = first.left - rl + first.bp + 1
    line = chr_seq[pos:pos + rl]
    line += cap2low(revcomp_str(
        chr_seq[first.left + first.bp + 1:
                first.left + first.bp + 1 + first.nt_size]))
    p2 = first.left + first.bp + 1 + first.indel_size
    line += chr_seq[p2:p2 + rl]
    out.write(line + "\n")

    for gi in range(c_s, c_e + 1):
        r = reads[gi]
        space_before = rl - r.bp - 1
        parts = [" " * max(space_before, 0)]
        seq = r.seq if r.matched_d == MINUS else revcomp_str(r.seq)
        parts.append(seq + "\t")
        parts.append(f"\t{r.matched_d}\t{r.matched_rel_pos}\t{r.ms}"
                     f"\t{r.tag}\t{r.name}")
        out.write("".join(parts) + "\n")


def output_tds(reads: List[SplitRead], chr_seq: str, c_s: int, c_e: int,
               real_start: int, real_end: int, out: TextIO,
               state: ReporterState) -> None:
    """Reference OutputTDs (reporter.cpp:157-269).

    Quirk: each supporting read is TWO output lines (endl after the
    sequence, then the tab-metadata line)."""
    (samples, per, left_s, left_u, right_s, right_u,
     num_reads, num_u, n_sup, n_u_sup) = support_counts(reads, c_s, c_e, state)
    first = reads[c_s]
    easy_score = (left_s + 1) * (right_s + 1)
    state.mask_set(first.bp_left + SPACER)
    state.mask_set(first.bp_right + SPACER)
    report_breakdancer_event(state, first.frag_name, first.bp_left,
                             first.bp_right, first.indel_size, "TD",
                             state.num_td)

    # TD coverage columns use BPLeft+1 / BPRight+1 bounds
    cols = []
    in_start = (first.bp_left + 1 >= state.region_start
                and first.bp_left + 1 < state.region_end)
    in_end = (first.bp_right + 1 > state.region_start
              and first.bp_right + 1 < state.region_end)
    for i, name in enumerate(samples):
        cov_s = state.coverage_at(first.bp_left + 1, i) if in_start else -1
        cov_e = state.coverage_at(first.bp_right + 1, i) if in_end else -1
        cols.append(f"\t{name} {cov_s} {cov_e} "
                    f"{per[i][0]} {per[i][2]} {per[i][1]} {per[i][3]}")

    out.write(HASHLINE + "\n")
    out.write(f"{state.num_td}\tTD {first.indel_size}"
              f"\tNT {first.nt_size} \"{first.nt_str}\""
              f"\tChrID {first.frag_name}"
              f"\tBP {first.bp_left}\t{first.bp_right + 2}"
              f"\tBP_range {first.bp_left}\t{first.bp_right + 2}"
              f"\tSupports {num_reads}\t{num_u}"
              f"\t+ {left_s}\t{left_u}\t- {right_s}\t{right_u}"
              f"\tS1 {easy_score}"
              f"\tSUM_MS {_sum_ms(reads, c_s, c_e)}"
              f"\t{len(samples)}\tNumSupSamples {n_sup}\t{n_u_sup}"
              + "".join(cols) + "\n")

    rl = state.report_length
    pos = first.bp_right + SPACER - rl + 1
    line = chr_seq[pos:pos + rl]
    line += " " * first.nt_size
    line += cap2low(chr_seq[first.bp_left + SPACER:
                            first.bp_left + SPACER + rl])
    out.write(line + "\n")

    for gi in range(c_s, c_e + 1):
        r = reads[gi]
        space_before = rl - r.bp - 1
        seq = r.seq if r.matched_d == MINUS else revcomp_str(r.seq)
        out.write(" " * max(space_before, 0) + seq + "\n")
        out.write(f"\t{r.matched_d}\t{r.matched_rel_pos}\t{r.ms}"
                  f"\t{r.tag}\t{r.name}\n")


def output_inversions(reads: List[SplitRead], chr_seq: str, c_s: int,
                      c_e: int, out: TextIO, state: ReporterState) -> None:
    """Reference OutputInversions (reporter.cpp:446-637)."""
    left_nt_size = right_nt_size = 0
    left_nt_str = right_nt_str = ""
    for i in range(c_s, c_e + 1):
        if reads[i].matched_d == PLUS:
            left_nt_size = reads[i].nt_size
            left_nt_str = reads[i].nt_str
            break
    for i in range(c_s, c_e + 1):
        if reads[i].matched_d == MINUS:
            right_nt_size = reads[i].nt_size
            right_nt_str = reads[i].nt_str
            break
    (samples, per, left_s, left_u, right_s, right_u,
     num_reads, num_u, n_sup, n_u_sup) = support_counts(reads, c_s, c_e, state)
    first = reads[c_s]
    easy_score = (left_s + 1) * (right_s + 1)
    state.mask_set(first.bp_left + SPACER)
    state.mask_set(first.bp_right + SPACER)
    report_breakdancer_event(state, first.frag_name, first.bp_left,
                             first.bp_right + 2, first.indel_size, "INV",
                             state.num_inv)

    # INV coverage columns use BPLeft+1 / BPRight+1 bounds
    cols = []
    in_start = (first.bp_left + 1 >= state.region_start
                and first.bp_left + 1 < state.region_end)
    in_end = (first.bp_right + 1 > state.region_start
              and first.bp_right + 1 < state.region_end)
    for i, name in enumerate(samples):
        cov_s = state.coverage_at(first.bp_left + 1, i) if in_start else -1
        cov_e = state.coverage_at(first.bp_right + 1, i) if in_end else -1
        cols.append(f"\t{name} {cov_s} {cov_e} "
                    f"{per[i][0]} {per[i][2]} {per[i][1]} {per[i][3]}")

    out.write(HASHLINE + "\n")
    out.write(f"{state.num_inv}\tINV {first.indel_size}"
              f"\tNT {left_nt_size}:{right_nt_size}"
              f" \"{left_nt_str}\":\"{right_nt_str}\""
              f"\tChrID {first.frag_name}"
              f"\tBP {first.bp_left}\t{first.bp_right + 2}"
              f"\tBP_range {first.bp_left}\t{first.bp_right + 2}"
              f"\tSupports {num_reads}\t{num_u}"
              f"\t+ {left_s}\t{left_u}\t- {right_s}\t{right_u}"
              f"\tS1 {easy_score}"
              f"\tSUM_MS {_sum_ms(reads, c_s, c_e)}"
              f"\t{len(samples)}\tNumSupSamples {n_sup}\t{n_u_sup}"
              + "".join(cols) + "\n")
    state.num_inv += 1

    rl = state.report_length
    line = chr_seq[first.bp_left + SPACER - rl: first.bp_left + SPACER]
    line += " " * left_nt_size
    line += cap2low(revcomp_str(
        chr_seq[first.bp_right + 1 + SPACER - rl:
                first.bp_right + 1 + SPACER]))
    out.write(line + "\n")
    for gi in range(c_s, c_e + 1):
        r = reads[gi]
        if r.matched_d != PLUS:
            continue
        space_before = rl - r.bp - 1
        parts = [" " * max(space_before, 0)]
        if r.up_close[0].abs_loc < r.up_far[0].abs_loc:
            parts.append(revcomp_str(r.seq))
            parts.append(" " * r.bp)
        else:
            parts.append(r.seq)
        parts.append(f"\t{r.matched_d}\t{r.matched_rel_pos}\t{r.ms}"
                     f"\t{r.tag}\t{r.name}")
        out.write("".join(parts) + "\n")
    out.write("-" * 100 + "\n")

    line = cap2low(revcomp_str(
        chr_seq[first.bp_left + SPACER: first.bp_left + SPACER + rl]))
    line += " " * right_nt_size
    line += chr_seq[first.bp_right + 1 + SPACER:
                    first.bp_right + 1 + SPACER + rl]
    out.write(line + "\n")
    for gi in range(c_s, c_e + 1):
        r = reads[gi]
        if r.matched_d != MINUS:
            continue
        space_before = rl - r.bp - 1
        parts = [" " * max(space_before, 0)]
        if r.up_close[0].abs_loc > r.up_far[0].abs_loc:
            parts.append(r.seq)
            parts.append(" " * r.bp)
        else:
            parts.append(revcomp_str(r.seq))
        parts.append(f"\t{r.matched_d}\t{r.matched_rel_pos}\t{r.ms}"
                     f"\t{r.tag}\t{r.name}")
        out.write("".join(parts) + "\n")


def _is_good_td(good: List[SplitRead], ev, real_start: int, real_end: int,
                state: ReporterState) -> bool:
    """Germline read-depth filter for TDs (IsGoodTD,
    reporter.cpp:1093-1155; the early RealStart/RealEnd checks live at
    the call site).  Active only for BAM input with -N; a relative
    coverage >= 2.7 in (nearly) all supporting samples confirms the
    duplication."""
    s = state.settings
    if not state.bam_entries or not s.normal_samples:
        return True
    if real_end - real_start < good[0].read_length * 2:
        return True
    raise NotImplementedError("the plain reference has no -N depth filter")


def sort_and_output_tandem_duplications(
        reads: List[SplitRead], boxes: List[List[int]], chr_seq: str,
        out: TextIO, state: ReporterState, non_template: bool) -> None:
    """Reference SortAndOutputTandemDuplications (reporter.cpp:1157-1287)."""
    cutoff = state.settings.num_reads_to_report_cutoff
    for box in boxes:
        if len(box) < cutoff:
            continue
        bubblesort_reads(reads, box)
        mark_duplicates(reads, box)
        good = [reads[i] for i in box if reads[i].unique_read]
        if not good:
            continue
        events: List[Indel4output] = []
        ev = Indel4output()
        ev.chr_name = good[0].frag_name
        ev.start = 0
        ev.end = 0
        ev.support = 1
        ev.bp_left = good[0].bp_left
        ev.bp_right = good[0].bp_right
        ev.whether_report = True
        for gi in range(1, len(good)):
            g = good[gi]
            if g.bp_left == ev.bp_left and g.bp_right == ev.bp_right:
                ev.end = gi
            else:
                ev.real_start, ev.real_end = get_real_start_4_deletion(
                    chr_seq, ev.bp_left, ev.bp_right)
                ev.support = ev.end - ev.start + 1
                events.append(ev)
                ev2 = Indel4output()
                ev2.start = gi
                ev2.end = gi
                ev2.bp_left = g.bp_left
                ev2.bp_right = g.bp_right
                ev2.chr_name = g.frag_name
                ev2.whether_report = True
                ev = ev2
        ev.real_start, ev.real_end = get_real_start_4_deletion(
            chr_seq, ev.bp_left, ev.bp_right)
        ev.support = ev.end - ev.start + 1
        events.append(ev)

        for ev in events:
            if not ev.whether_report:
                continue
            real_start, real_end = ev.real_start, ev.real_end
            # IsGoodTD early checks (reporter.cpp:1096-1103); pindel-format
            # input then short-circuits to true
            if real_end < real_start or real_start == 0:
                continue
            if not _is_good_td(good, ev, real_start, real_end, state):
                continue
            if ev.support >= cutoff:
                if good[ev.start].indel_size < state.settings.balance_cutoff:
                    output_tds(good, chr_seq, ev.start, ev.end,
                               real_start, real_end, out, state)
                    state.num_td += 1
                elif report_event(good, ev.start, ev.end):
                    output_tds(good, chr_seq, ev.start, ev.end,
                               real_start, real_end, out, state)
                    state.num_td += 1


def do_sort_and_output_inversions(
        reads: List[SplitRead], boxes: List[List[int]], chr_seq: str,
        out: TextIO, state: ReporterState, non_template: bool) -> None:
    """Reference OutputSorter::DoSortAndOutputInversions
    (output_sorter.cpp:62-260) + ReportIndelEvents (:370-396).

    Quirks preserved: GoodIndels keeps ALL reads (no UniqueRead filter);
    a failed size-harmonization poisons WhetherReport for the REST of the
    box; BP/BPLeft/BPRight are harmonized on copies.
    """
    import copy
    cutoff = state.settings.num_reads_to_report_cutoff
    for box in boxes:
        if len(box) < cutoff:
            continue
        n = len(box)
        for first in range(n - 1):
            for second in range(first + 1, n):
                a, b = reads[box[first]], reads[box[second]]
                swap = False
                sa = a.bp_left + a.bp_right
                sb = b.bp_left + b.bp_right
                if sa < sb:
                    continue
                elif sa > sb:
                    swap = True
                elif a.indel_size > b.indel_size:
                    continue
                elif a.indel_size < b.indel_size:
                    swap = True
                elif a.bp_left < b.bp_left:
                    continue
                elif a.bp_left > b.bp_left:
                    swap = True
                else:
                    if a.bp_right < b.bp_right:
                        continue
                    elif a.bp_right > b.bp_right:
                        swap = True
                    elif non_template:
                        if a.nt_size < b.nt_size:
                            continue
                        elif a.nt_size > b.nt_size:
                            swap = True
                        elif a.bp > b.bp:
                            swap = True
                    elif a.bp > b.bp:
                        swap = True
                if swap:
                    box[first], box[second] = box[second], box[first]
        for first in range(n - 1):
            for second in range(first + 1, n):
                a, b = reads[box[first]], reads[box[second]]
                if (a.left_most_pos == b.left_most_pos
                        or a.left_most_pos + a.read_length
                        == b.left_most_pos + b.read_length):
                    if a.matched_d == b.matched_d:
                        b.unique_read = False

        good = [copy.copy(reads[i]) for i in box]
        if not good:
            continue
        events: List[Indel4output] = []
        ev = Indel4output()
        ev.start = 0
        ev.end = 0
        ev.support = 1
        ev.bp_left = good[0].bp_left
        ev.bp_right = good[0].bp_right
        ev.whether_report = True

        def harmonize(ev: Indel4output) -> None:
            max_size = 0
            for i in range(ev.start, ev.end + 1):
                max_size = max(max_size, good[i].indel_size)
            for i in range(ev.start, ev.end + 1):
                g = good[i]
                if (g.indel_size / float(max_size) < 0.95
                        or max_size + 30 > g.read_length + g.indel_size):
                    ev.whether_report = False
                    break
                diff = (max_size - g.indel_size) // 2
                g.indel_size = max_size
                g.bp_left -= diff
                g.bp_right += diff
                if g.matched_d == PLUS:
                    if g.bp > diff:
                        g.bp -= diff
                else:
                    if g.bp + diff < g.read_length - 1:
                        g.bp += diff

        for gi in range(1, len(good)):
            g = good[gi]
            if g.bp_left + g.bp_right == ev.bp_left + ev.bp_right:
                ev.end = gi
            else:
                harmonize(ev)
                ev.real_start = good[ev.start].bp_left
                ev.real_end = good[ev.start].bp_right
                ev.support = ev.end - ev.start + 1
                if ev.whether_report:
                    events.append(ev)
                ev2 = Indel4output()
                ev2.start = gi
                ev2.end = gi
                ev2.bp_left = g.bp_left
                ev2.bp_right = g.bp_right
                # WhetherReport intentionally NOT reset (reference bug):
                ev2.whether_report = ev.whether_report
                ev = ev2
        harmonize(ev)
        ev.real_start = ev.bp_left
        ev.real_end = ev.bp_right
        ev.support = ev.end - ev.start + 1
        if ev.whether_report:
            events.append(ev)

        for ev in events:
            if ev.support < cutoff:
                continue
            # IsGoodINV early checks; pindel input then true
            if ev.real_end < ev.real_start or ev.real_start == 0:
                continue
            if good[ev.start].indel_size < state.settings.balance_cutoff:
                output_inversions(good, chr_seq, ev.start, ev.end, out, state)
            elif report_event(good, ev.start, ev.end):
                output_inversions(good, chr_seq, ev.start, ev.end, out, state)


# ------------------------------------------------------------- sort + output

def sort_output_d(reads: List[SplitRead], boxes: List[List[int]],
                  chr_seq: str, out: TextIO, state: ReporterState) -> None:
    """Reference SortOutputD (reporter.cpp:1395-1570)."""
    cutoff = state.settings.num_reads_to_report_cutoff
    for box in boxes:
        if len(box) < cutoff:
            continue
        bubblesort_reads(reads, box)
        mark_duplicates(reads, box)
        good = [reads[i] for i in box if reads[i].unique_read]
        if not good:
            continue
        events: List[Indel4output] = []
        ev = Indel4output()
        ev.start = 0
        ev.end = 0
        ev.chr_name = good[0].frag_name
        ev.bp_left = good[0].bp_left
        ev.bp_right = good[0].bp_right
        ev.whether_report = True
        for gi in range(1, len(good)):
            g = good[gi]
            if (g.bp_left == ev.bp_left and g.bp_right == ev.bp_right
                    and g.frag_name == ev.chr_name
                    and g.far_frag_name == ev.chr_name):
                ev.end = gi
            else:
                ev.real_start, ev.real_end = get_real_start_4_deletion(
                    chr_seq, ev.bp_left, ev.bp_right)
                ev.support = ev.end - ev.start + 1
                events.append(ev)
                ev = Indel4output()
                ev.start = gi
                ev.end = gi
                ev.bp_left = g.bp_left
                ev.bp_right = g.bp_right
                ev.chr_name = g.frag_name
                ev.whether_report = True
        ev.real_start, ev.real_end = get_real_start_4_deletion(
            chr_seq, ev.bp_left, ev.bp_right)
        ev.support = ev.end - ev.start + 1
        events.append(ev)

        for ev in events:
            if not ev.whether_report:
                continue
            if ev.support < cutoff:
                continue
            # IsGoodDeletion returns true unconditionally (reporter.cpp:1324)
            if good[ev.start].indel_size < state.settings.balance_cutoff:
                output_deletions(good, chr_seq, ev.start, ev.end,
                                 ev.real_start, ev.real_end, out, state)
                state.template_counter += 1
            elif report_event(good, ev.start, ev.end):
                output_deletions(good, chr_seq, ev.start, ev.end,
                                 ev.real_start, ev.real_end, out, state)
                state.template_counter += 1


def sort_output_si(reads: List[SplitRead], boxes: List[List[int]],
                   chr_seq: str, out: TextIO, state: ReporterState) -> None:
    """Reference SortOutputSI (reporter.cpp:975-1091)."""
    cutoff = state.settings.num_reads_to_report_cutoff
    for box in boxes:
        if len(box) < cutoff:
            continue
        bubblesort_reads(reads, box)
        mark_duplicates(reads, box)
        good = [reads[i] for i in box if reads[i].unique_read]
        if not good:
            continue
        events: List[Indel4output] = []
        ev = Indel4output()
        ev.initialize(0, good[0])
        for gi in range(1, len(good)):
            g = good[gi]
            if g.bp_left == ev.bp_left and g.indel_size == ev.indel_size:
                ev.end = gi
            else:
                ev.complete()
                ev.indel_str, ev.real_start, ev.real_end = \
                    get_real_start_4_insertion(chr_seq, ev.indel_str,
                                               ev.real_start, ev.real_end)
                events.append(ev)
                ev = Indel4output()
                ev.initialize(gi, g)
        ev.complete()
        ev.indel_str, ev.real_start, ev.real_end = \
            get_real_start_4_insertion(chr_seq, ev.indel_str,
                                       ev.real_start, ev.real_end)
        events.append(ev)

        for ev in events:
            if not ev.whether_report:
                continue
            if ev.support >= cutoff and ev.real_start < ev.real_end:
                output_sis(good, chr_seq, ev.start, ev.end,
                           ev.real_start, ev.real_end, out, state)


# ---------------------------------------------------------------------- INT

def _other_strand(d: str) -> str:
    return "-" if d == "+" else "+" if d == "-" else ""


def _int_exact_split(read: SplitRead, close_ascending: bool) -> bool:
    """The exact close+far==readlen anchor pairing shared by all four
    branches of the reference INT detector (reporter.cpp:2475-2640)."""
    n_close = len(read.up_close)
    n_far = len(read.up_far)
    close_range = range(n_close) if close_ascending \
        else range(n_close - 1, -1, -1)
    far_range = range(n_far - 1, -1, -1) if close_ascending \
        else range(n_far)
    for ci in close_range:
        if read.used:
            break
        close = read.up_close[ci]
        for fi in far_range:
            if read.used:
                break
            far = read.up_far[fi]
            if close.length_str + far.length_str == read.read_length:
                read.used = True
                read.bp = close.length_str - 1
                read.bp_left = close.abs_loc - SPACER
                read.bp_right = far.abs_loc - SPACER
                return True
    return False


def sort_and_report_interchromosomal_events(
        inter_reads: List[SplitRead], out: TextIO) -> None:
    """SortAndReportInterChromosomalEvents (reporter.cpp:2428-2666).

    Quirks preserved: the ReadNames dedup set is shared across ALL
    chromosome-pair iterations and reads are inserted before the pair
    match test, so with three or more chromosomes only the first pair in
    sorted order actually processes reads; calls are keyed by the full
    result string (std::map order = sorted) with support cutoff 2."""
    call_support: Dict[str, int] = {}
    chr_names = sorted({r.frag_name for r in inter_reads}
                       | {r.far_frag_name for r in inter_reads})
    read_names: set = set()
    for i, first in enumerate(chr_names):
        for second in chr_names[i + 1:]:
            for read in inter_reads:
                if read.name in read_names:
                    continue
                read_names.add(read.name)
                if read.frag_name == first \
                        and read.far_frag_name == second:
                    close_ascending = read.matched_d == "+"
                elif read.frag_name == second \
                        and read.far_frag_name == first:
                    close_ascending = read.matched_far_d == "-"
                else:
                    continue
                inserted = '""'
                good = _int_exact_split(read, close_ascending)
                if not good:
                    last_close = read.up_close[len(read.up_close) - 1]
                    last_far = read.up_far[len(read.up_far) - 1]
                    effective = last_close.length_str + last_far.length_str
                    if (effective >= 30 and last_close.length_str >= 10
                            and last_far.length_str >= 10):
                        inserted = ('"' + read.seq[
                            last_far.length_str:
                            last_far.length_str + read.read_length
                            - effective] + '"')
                        read.bp_left = last_close.abs_loc - SPACER
                        read.bp_right = last_far.abs_loc - SPACER
                        good = True
                if good:
                    key = (f"Anchor {read.matched_d} {read.frag_name} "
                           f"{read.bp_left} "
                           f"{_other_strand(read.matched_d)} "
                           f"{read.far_frag_name} {read.bp_right} "
                           f"{read.matched_far_d} {inserted}")
                    call_support[key] = call_support.get(key, 0) + 1
    for key in sorted(call_support):
        if call_support[key] >= 2:
            out.write(f"{key}\tsupport: {call_support[key]}\n")


def merge_inter_chr(int_path: str) -> None:
    """MergeInterChr (pindel.cpp:1526-1579): merges ±10 bp duplicate
    interchromosomal calls from _INT into _INT_final with support
    cutoff 2 (singletons need 4).  Quirk preserved: a single call with
    support >= 4 is written twice (once by the size<2 branch, once by
    the unpaired branch of the main loop)."""
    cutoff = 2
    calls = []
    try:
        with open(int_path) as fh:
            toks = fh.read().split()
    except OSError:
        toks = []
    i = 0
    while i + 11 <= len(toks):
        # Anchor D chr pos D chr pos D seq support: N
        calls.append({"anchor_d": toks[i + 1], "chr1": toks[i + 2],
                      "pos1": int(toks[i + 3]), "d1": toks[i + 4],
                      "chr2": toks[i + 5], "pos2": int(toks[i + 6]),
                      "d2": toks[i + 7], "seq": toks[i + 8],
                      "support": int(toks[i + 10])})
        i += 11
    with open(int_path + "_final", "w") as out:
        if not calls:
            return
        if len(calls) < 2:
            c = calls[0]
            if c["support"] >= cutoff * 2:
                out.write(f"{c['chr1']}\t{c['pos1']}\t{c['chr2']}\t"
                          f"{c['pos2']}\t{c['seq']}\t{c['support']}\t"
                          f"{c['anchor_d']}\t{c['chr1']}\t{c['pos1']}\t"
                          f"{c['d1']}\t{c['chr2']}\t{c['pos2']}\t"
                          f"{c['d2']}\t{c['seq']}\t{c['support']}\n")
        for ia, a in enumerate(calls):
            reported = False
            for b in calls[ia + 1:]:
                if (a["chr1"] == b["chr1"] and a["chr2"] == b["chr2"]
                        and abs(a["pos1"] - b["pos1"]) < 10
                        and abs(a["pos2"] - b["pos2"]) < 10
                        and a["support"] + b["support"] >= cutoff):
                    out.write(
                        f"chr\t{a['chr1']}\tpos\t"
                        f"{(a['pos1'] + b['pos1']) // 2}\tchr\t"
                        f"{a['chr2']}\tpos\t"
                        f"{(a['pos2'] + b['pos2']) // 2}\tseq\t"
                        f"{a['seq']}\tsupport\t"
                        f"{a['support'] + b['support']}\tINFOR\t"
                        f"{a['anchor_d']}\t{a['chr1']}\t{a['pos1']}\t"
                        f"{a['d1']}\t{a['chr2']}\t{a['pos2']}\t"
                        f"{a['d2']}\t{a['seq']}\t{a['support']}\t"
                        f"{b['anchor_d']}\t{b['chr1']}\t{b['pos1']}\t"
                        f"{b['d1']}\t{b['chr2']}\t{b['pos2']}\t"
                        f"{b['d2']}\t{b['seq']}\t{b['support']}\n")
                    reported = True
                    break
            if not reported and a["support"] >= cutoff * 2:
                out.write(
                    f"chr\t{a['chr1']}\tpos\t{a['pos1']}\tchr\t"
                    f"{a['chr2']}\tpos\t{a['pos2']}\tseq\t{a['seq']}"
                    f"\tsupport\t{a['support']}\tINFOR\t"
                    f"{a['anchor_d']}\t{a['chr1']}\t{a['pos1']}\t"
                    f"{a['d1']}\t{a['chr2']}\t{a['pos2']}\t{a['d2']}\t"
                    f"{a['seq']}\t{a['support']}\n")


# ------------------------------------------------------------------- LI / BP

MAX_SHORT = 128          # pileup counter saturation, reference pindel.h:126
LI_HASH = "#" * 56       # SortOutputLI's shorter hash ruler
LI_DASH = "-" * 56


class _ShiftedCounts:
    """Clamped-index window arrays (reference shifted_vector.h:40-55).

    The three window-length buffers (~60 MB at 5 Mb windows) are reused
    across windows — faulting in fresh pages every window was a
    measurable slice of the LI phase."""

    _cache = None

    def __init__(self, lo: int, hi: int):
        self.lo = lo
        self.hi = hi                           # inclusive, like the reference
        n = hi - lo + 1
        c = _ShiftedCounts._cache
        if c is not None and c[0].shape[0] >= n:
            self.plus, self.minus, self.event = (a[:n] for a in c)
            self.plus[:] = 0
            self.minus[:] = 0
            self.event[:] = -1
        else:
            self.plus = np.zeros(n, dtype=np.int32)
            self.minus = np.zeros(n, dtype=np.int32)
            self.event = np.full(n, -1, dtype=np.int32)
            _ShiftedCounts._cache = (self.plus, self.minus, self.event)

    def clamp(self, pos: int) -> int:
        return min(max(pos, self.lo), self.hi) - self.lo


def _largest_b(b_positions: np.ndarray, a: int, b: int) -> int:
    """Largest masked ('B') position in [a, b], or -1.

    Equals the reference's descending scan from b to a that breaks at the
    first hit (reporter.cpp:1912-1919).
    """
    j = int(np.searchsorted(b_positions, b, side="right")) - 1
    if j >= 0 and b_positions[j] >= a:
        return int(b_positions[j])
    return -1


class _PrevB:
    """Largest-masked-position-<=-x lookup over one window span.

    The candidate scan issues ~30 ``_largest_b`` queries per pileup
    candidate; with many candidates the O(window) prefix-max table wins,
    with few (the common case) binary search over the mark list is far
    cheaper than filling a multi-megabyte table, so the table is built
    lazily on the ~1000th query."""

    _TABLE_AFTER = 1000

    def __init__(self, b_positions: np.ndarray, lo: int, hi: int):
        self.lo = lo - 16
        self.hi = hi + 80
        self.b_positions = b_positions
        self.prev: Optional[np.ndarray] = None
        self._queries = 0

    def _build(self) -> None:
        sel = self.b_positions[(self.b_positions >= self.lo)
                               & (self.b_positions <= self.hi)]
        prev = np.full(self.hi - self.lo + 1, -1, np.int32)
        prev[sel - self.lo] = sel.astype(np.int32)
        np.maximum.accumulate(prev, out=prev)
        self.prev = prev

    def largest(self, a: int, b: int) -> int:
        if b < self.lo or b > self.hi:
            return _largest_b(self.b_positions, a, b)
        if self.prev is None:
            self._queries += 1
            if self._queries < self._TABLE_AFTER:
                return _largest_b(self.b_positions, a, b)
            self._build()
        v = int(self.prev[b - self.lo])
        return v if v >= a else -1


def _pileup(reads: List[SplitRead], sv: "_ShiftedCounts",
            saturate: int) -> np.ndarray:
    """Eligible-read close-end pileups per strand, vectorized
    (reference reporter.cpp:1874-1906).  Increments saturate at
    ``saturate`` exactly like the reference's capped ++.  Returns the
    eligible read indices."""
    n = len(reads)
    elig = np.fromiter((not r.used and not r.up_far for r in reads),
                       bool, n)
    eligible = np.flatnonzero(elig)
    if eligible.size == 0:
        return eligible
    locs = np.fromiter(
        (reads[i].up_close.loc[len(reads[i].up_close) - 1]
         for i in eligible), np.int64, eligible.size)
    plus = np.fromiter((reads[i].matched_d == PLUS for i in eligible),
                       bool, eligible.size)
    cl = np.clip(locs, sv.lo, sv.hi) - sv.lo
    np.add.at(sv.plus, cl[plus], 1)
    np.add.at(sv.minus, cl[~plus], 1)
    np.minimum(sv.plus, saturate, out=sv.plus)
    np.minimum(sv.minus, saturate, out=sv.minus)
    return eligible


def sort_output_li(reads: List[SplitRead], chr_seq: str, window_start: int,
                   window_end: int, out: TextIO,
                   state: ReporterState) -> None:
    """Long-insertion pileup detector (reference SortOutputLI,
    reporter.cpp:1853-2147).

    Reads with a close end but no far end are piled by the last close-end
    anchor position per strand; a call pairs a minus pileup >= cutoff with
    a plus pileup >= cutoff within [-1, +30] bp, skipping positions within
    10 bp of a 'B' mask mark.  The candidate scan reproduces the
    reference's in-loop index jumps exactly (including the plus-scan
    mutating the outer minus index, reporter.cpp:1925-1928).
    """
    from refpindel.profiling import g_timer
    s = state.settings
    cutoff = s.num_reads_to_report_cutoff
    comp_size = len(chr_seq)
    border = 4 * state.max_insert_size
    abs_start = SPACER + window_start
    abs_end = SPACER + window_end
    if abs_end > comp_size - SPACER:
        abs_end = comp_size - SPACER
    lo = abs_start - border
    hi = abs_end + border
    with g_timer.phase("li: alloc"):
        sv = _ShiftedCounts(lo, hi)

    with g_timer.phase("li: pileup"):
        eligible = _pileup(reads, sv, MAX_SHORT)

    with g_timer.phase("li: prevb"):
        mask_np = np.frombuffer(state.mask, dtype=np.uint8)
        b_positions = np.flatnonzero(mask_np == ord("B"))
        prevb = _PrevB(b_positions, lo, hi)

    # (plus_pos, minus_pos, plus_read_idx, minus_read_idx) in creation order
    t_scan = time.monotonic()
    li_events: List[List] = []
    minus_cands = np.flatnonzero(sv.minus >= cutoff) + lo
    # Vectorized fast-reject: a candidate whose surroundings hold no
    # masked 'B' anywhere the body could consult ([im-11, im+40] covers
    # both the direct lookup and every inner-loop lookup, since im only
    # grows when a B exists) and no plus pileup >= cutoff in
    # [im-1, im+30] runs the Python body to no effect — it emits
    # nothing and its pos = im+1 can never skip a later (strictly
    # larger) candidate.  Only the others need the exact loop.
    if minus_cands.size:
        bp = prevb.b_positions
        has_b = (np.searchsorted(bp, minus_cands + 40, "right")
                 > np.searchsorted(bp, minus_cands - 11, "left"))
        pge = np.zeros(sv.plus.shape[0] + 1, np.int64)
        np.cumsum(sv.plus >= cutoff, out=pge[1:])
        a_idx = np.clip(minus_cands - 1, lo, hi) - lo
        b_idx = np.clip(minus_cands + 30, lo, hi) - lo
        has_p = (pge[b_idx + 1] - pge[a_idx]) > 0
        minus_cands = minus_cands[has_b | has_p]
    pos = lo
    for cand in minus_cands:
        im = int(cand)
        if im < pos or im >= hi:        # outer loop bound is < absEndBuffered
            continue
        mb = prevb.largest(im - 10, im + 10)
        if mb >= 0:
            pos = mb + 11               # Index_Minus = mb + 10, then ++
            continue
        ip = im - 1
        while ip <= im + 30:
            skip = False
            mp = prevb.largest(ip - 10, ip + 10)
            if mp >= 0:
                if mp + 10 > im:
                    im = mp + 10        # mutates the outer index (reference)
                skip = True
            if not skip and sv.plus[sv.clamp(ip)] >= cutoff:
                sv.event[sv.clamp(ip)] = len(li_events)
                sv.event[sv.clamp(im)] = len(li_events)
                li_events.append([ip, im, [], []])
            ip += 1
        pos = im + 1
    g_timer.add("li: scan", time.monotonic() - t_scan)

    if not li_events:
        return
    t_write = time.monotonic()

    el_locs = np.fromiter(
        (reads[i].up_close.loc[len(reads[i].up_close) - 1]
         for i in eligible), np.int64, eligible.size)
    el_ev = sv.event[np.clip(el_locs, lo, hi) - lo]
    for k in np.flatnonzero(el_ev != -1):
        i = int(eligible[k])
        r = reads[i]
        ei = int(el_ev[k])
        r.used = True
        if r.matched_d == PLUS:
            li_events[ei][2].append(i)
        else:
            li_events[ei][3].append(i)

    samples = state.sorted_samples()
    sample_idx = {name: k for k, name in enumerate(samples)}
    rl = state.report_length
    for plus_pos, minus_pos, plus_idx, minus_idx in li_events:
        if not minus_idx or not plus_idx:
            continue
        bal_pp = bal_pm = bal_mp = bal_mm = False
        for i in minus_idx:
            r = reads[i]
            ls = int(r.up_close.length[len(r.up_close) - 1])
            if float(ls) > r.read_length * 0.5:
                bal_mp = True
            elif float(ls) < r.read_length * 0.5:
                bal_mm = True
        for i in plus_idx:
            r = reads[i]
            ls = int(r.up_close.length[len(r.up_close) - 1])
            if float(ls) > r.read_length * 0.5:
                bal_pp = True
            elif float(ls) < r.read_length * 0.5:
                bal_pm = True
        n_plus_tag = [0] * len(samples)
        n_minus_tag = [0] * len(samples)
        for i in minus_idx:
            n_minus_tag[sample_idx[reads[i].tag]] += 1
        for i in plus_idx:
            n_plus_tag[sample_idx[reads[i].tag]] += 1
        supported = any(p > 0 and m > 0
                        for p, m in zip(n_plus_tag, n_minus_tag))
        positive = sum((bal_pp, bal_pm, bal_mp, bal_mm))
        if not (supported and positive >= 1):
            continue

        first = reads[plus_idx[0]]
        report_breakdancer_event(state, first.frag_name,
                                 plus_pos - SPACER + 1,
                                 minus_pos - SPACER + 1, -1, "LI",
                                 state.count_li)
        out.write(LI_HASH + "\n")
        header = (f"{state.count_li}\tLI\tChrID {first.frag_name}"
                  f"\t{plus_pos - SPACER + 1}\t+ {len(plus_idx)}"
                  f"\t{minus_pos - SPACER + 1}\t- {len(minus_idx)}")
        state.count_li += 1
        for k, name in enumerate(samples):
            header += f"\t{name} + {n_plus_tag[k]} - {n_minus_tag[k]}"
        out.write(header + "\n")

        out.write(chr_seq[plus_pos - rl + 1: plus_pos + 1]
                  + cap2low(chr_seq[plus_pos + 1: plus_pos + 1 + rl]) + "\n")
        for i in plus_idx:
            r = reads[i]
            ls = int(r.up_close.length[len(r.up_close) - 1])
            out.write(" " * max(rl - ls, 0) + revcomp_str(r.seq)
                      + f"\t{r.matched_d}\t{r.matched_rel_pos}\t{r.ms}"
                      f"\t{r.tag}\t{r.name}\n")

        out.write(LI_DASH + "\n")
        out.write(cap2low(chr_seq[minus_pos - rl: minus_pos])
                  + chr_seq[minus_pos: minus_pos + rl] + "\n")
        for i in minus_idx:
            r = reads[i]
            ls = int(r.up_close.length[len(r.up_close) - 1])
            # reference quirk: no tab between sequence and strand column
            out.write(" " * max(rl + ls - r.read_length, 0) + r.seq
                      + f"{r.matched_d}\t{r.matched_rel_pos}\t{r.ms}"
                      f"\t{r.tag}\t{r.name}\n")
    g_timer.add("li: assign+write", time.monotonic() - t_write)


def sort_output_rest(reads: List[SplitRead], chr_seq: str, window_start: int,
                     window_end: int, out: TextIO,
                     state: ReporterState) -> None:
    """Unassigned-breakpoint detector (reference SortOutputRest,
    reporter.cpp:2149-2358).

    NOTE: the reference's call site is commented out (pindel.cpp:1171-1173)
    so `-k` produces an empty _BP file there; we keep that default for
    bit-parity and expose the resurrected detector behind
    ``Settings.force_bp_output``.  Cutoff is the fixed
    NumRead2ReportCutOff_BP = 2 (pindel.cpp:124).
    """
    cutoff_bp = 2
    comp_size = len(chr_seq)
    border = 4 * state.max_insert_size
    abs_start = SPACER + window_start
    abs_end = SPACER + window_end
    if abs_end > comp_size - SPACER:
        abs_end = comp_size - SPACER
    lo = abs_start - border
    hi = abs_end + border
    sv = _ShiftedCounts(lo, hi)

    eligible = _pileup(reads, sv, cutoff_bp)

    # (strand, abs position, supporting read indices) in position order
    rest: List[List] = []
    by_key: Dict[tuple, List[int]] = {}
    pp = np.flatnonzero(sv.plus[: hi - lo] >= cutoff_bp) + lo
    mm = np.flatnonzero(sv.minus[: hi - lo] >= cutoff_bp) + lo
    ip = im = 0
    while ip < pp.size or im < mm.size:       # position order, PLUS first
        if im >= mm.size or (ip < pp.size and pp[ip] <= mm[im]):
            ev = [PLUS, int(pp[ip]), []]
            ip += 1
        else:
            ev = [MINUS, int(mm[im]), []]
            im += 1
        rest.append(ev)
        by_key[(ev[0], ev[1])] = ev[2]
    if not rest:
        return
    for i in eligible:
        r = reads[i]
        loc = int(r.up_close.loc[len(r.up_close) - 1])
        sup = by_key.get((r.matched_d, loc))
        if sup is not None:
            r.used = True
            sup.append(int(i))

    samples = state.sorted_samples()
    sample_idx = {name: k for k, name in enumerate(samples)}
    rl = state.report_length
    for strand, pos, idxs in rest:
        bal_plus = bal_minus = False
        for i in idxs:
            r = reads[i]
            ls = int(r.up_close.length[len(r.up_close) - 1])
            if float(ls) > r.read_length * 0.5:
                bal_plus = True
            elif float(ls) < r.read_length * 0.5:
                bal_minus = True
        if not (bal_plus and bal_minus):
            continue
        n_plus = [0] * len(samples)
        n_minus = [0] * len(samples)
        for i in idxs:
            r = reads[i]
            if r.matched_d == PLUS:
                n_plus[sample_idx[r.tag]] += 1
            else:
                n_minus[sample_idx[r.tag]] += 1
        first = reads[idxs[0]]
        report_breakdancer_event(state, first.frag_name, 0, 0, -1, "BP",
                                 -1)
        out.write(LI_HASH + "\n")
        if strand == PLUS:
            header = (f"ChrID {first.frag_name}\t{pos - SPACER + 1}"
                      f"\t+ {len(idxs)}")
            for k, name in enumerate(samples):
                header += f"\t{name} {n_plus[k]}"
            out.write(header + "\n")
            out.write(chr_seq[pos - rl + 1: pos + 1]
                      + cap2low(chr_seq[pos + 1: pos + 1 + rl]) + "\n")
            for i in idxs:
                r = reads[i]
                ls = int(r.up_close.length[len(r.up_close) - 1])
                out.write(" " * max(rl - ls, 0) + revcomp_str(r.seq)
                          + f"\t{r.matched_d}\t{r.matched_rel_pos}\t{r.ms}"
                          f"\t{r.tag}\t{r.name}\n")
        else:
            header = (f"ChrID {first.frag_name}\t{pos - SPACER + 1}"
                      f"\t- {len(idxs)}")
            for k, name in enumerate(samples):
                header += f"\t{name} {n_minus[k]}"
            out.write(header + "\n")
            out.write(cap2low(chr_seq[pos - rl: pos])
                      + chr_seq[pos: pos + rl] + "\n")
            for i in idxs:
                r = reads[i]
                ls = int(r.up_close.length[len(r.up_close) - 1])
                out.write(" " * max(rl + ls - r.read_length, 0) + r.seq
                          + f"\t{r.matched_d}\t{r.matched_rel_pos}\t{r.ms}"
                          f"\t{r.tag}\t{r.name}\n")


def _di_sort(reads: List[SplitRead], box: List[int]) -> None:
    """SortOutputDI's exchange sort (reporter.cpp:1718-1752).  The tied
    elements' final order depends on the swap history (not expressible
    as a sort key), so the literal loop runs natively when available."""
    n = len(box)
    if n < 2:
        return
    from refpindel.events.detect import _native_detect
    lib = _native_detect()
    if lib is not None and n > 8:
        import ctypes
        i64p = ctypes.POINTER(ctypes.c_int64)
        bpl = np.fromiter((reads[i].bp_left for i in box), np.int64, n)
        bpr = np.fromiter((reads[i].bp_right for i in box), np.int64, n)
        nts = np.fromiter((reads[i].nt_size for i in box), np.int64, n)
        bp = np.fromiter((reads[i].bp for i in box), np.int64, n)
        idx = np.arange(n, dtype=np.int64)
        lib.ptdetect_di_sort(n, bpl.ctypes.data_as(i64p),
                             bpr.ctypes.data_as(i64p),
                             nts.ctypes.data_as(i64p),
                             bp.ctypes.data_as(i64p),
                             idx.ctypes.data_as(i64p))
        box[:] = [box[k] for k in idx.tolist()]
        return
    for first in range(n - 1):
        for second in range(first + 1, n):
            a, b = reads[box[first]], reads[box[second]]
            swap = False
            if a.bp_left < b.bp_left:
                continue
            elif a.bp_left > b.bp_left:
                swap = True
            else:
                if a.bp_right < b.bp_right:
                    continue
                elif a.bp_right > b.bp_right:
                    swap = True
                else:
                    if a.nt_size < b.nt_size:
                        continue
                    elif a.nt_size > b.nt_size:
                        swap = True
                    elif a.bp > b.bp:
                        swap = True
            if swap:
                box[first], box[second] = box[second], box[first]


def sort_output_di(reads: List[SplitRead], boxes: List[List[int]],
                   chr_seq: str, out_d: TextIO, out_inv: TextIO,
                   state: ReporterState) -> None:
    """Reference SortOutputDI (reporter.cpp:1708-1850).

    Uses its own in-place selection sort with a different key order
    (BPLeft, BPRight, NT_size, BP) and its own duplicate marking.
    """
    cutoff = state.settings.num_reads_to_report_cutoff
    for box in boxes:
        if len(box) < cutoff:
            continue
        n = len(box)
        _di_sort(reads, box)
        # duplicate marking (reporter.cpp:1754-1766): b loses its flag
        # when ANY earlier read (unique or not) shares read length and
        # strand and either end — two running seen-sets are equivalent
        seen_l = set()
        seen_r = set()
        for i in box:
            r = reads[i]
            rl = r.read_length
            kl = (rl, r.matched_d, r.left_most_pos)
            kr = (rl, r.matched_d, r.left_most_pos + rl)
            if kl in seen_l or kr in seen_r:
                r.unique_read = False
            seen_l.add(kl)
            seen_r.add(kr)
        good = [reads[i] for i in box if reads[i].unique_read]
        if not good:
            continue
        events: List[Indel4output] = []
        ev = Indel4output()
        ev.chr_name = good[0].frag_name
        ev.start = 0
        ev.end = 0
        ev.indel_size = good[0].indel_size
        ev.nt_size = good[0].nt_size
        ev.bp_left = good[0].bp_left
        ev.bp_right = good[0].bp_right
        ev.whether_report = True
        for gi in range(1, len(good)):
            g = good[gi]
            if (g.bp_left == ev.bp_left and g.indel_size == ev.indel_size
                    and g.nt_size == ev.nt_size):
                ev.end = gi
            else:
                events.append(ev)
                ev = Indel4output()
                ev.start = gi
                ev.end = gi
                ev.bp_left = g.bp_left
                ev.indel_size = g.indel_size
                ev.nt_size = g.nt_size
                ev.chr_name = g.frag_name
                ev.whether_report = True
        events.append(ev)

        for ev in events:
            if ev.end - ev.start + 1 < cutoff:
                continue
            real_start = good[ev.start].bp_left
            real_end = good[ev.start].bp_right
            if (good[ev.start].indel_size < state.settings.balance_cutoff
                    or report_event(good, ev.start, ev.end)):
                if is_inversion(good[ev.start], chr_seq):
                    output_short_inversion(good, chr_seq, ev.start, ev.end,
                                           real_start, real_end, out_inv,
                                           state)
                else:
                    # IsGoodDeletion is unconditionally true
                    output_di(good, chr_seq, ev.start, ev.end, out_d, state)
                    state.nontemplate_counter += 1
