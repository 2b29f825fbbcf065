"""Breakpoint canonicalization and balance filters.

Reference: GetRealStart4Deletion / GetRealStart4Insertion / ReportEvent
(pindel.cpp:2059-2162) and IsInversion (reporter.cpp:1697-1706).

All positions here are biological coordinates relative to the chromosome
(the reference subtracts ``g_SpacerBeforeAfter`` when storing BPLeft/BPRight);
``chr_seq`` is the spacer-padded chromosome string and SPACER re-adds the
offset exactly as the reference does.
"""
from __future__ import annotations

from typing import List, Tuple

from refpindel.genome import SPACER

MIN_FILTER_RATIO = 0.5  # Min_Filter_Ratio, pindel.cpp:99

_RC = {"A": "T", "C": "G", "G": "C", "T": "A", "N": "N",
       "a": "t", "c": "g", "g": "c", "t": "a", "n": "n"}

_RC_TABLE = str.maketrans(
    {c: "N" for c in map(chr, range(128))} | {
        "A": "T", "C": "G", "G": "C", "T": "A", "N": "N",
        "a": "t", "c": "g", "g": "c", "t": "a", "n": "n"})


def revcomp_str(s: str) -> str:
    """ReverseComplement for report strings (pindel.cpp:2037-2048)."""
    return s[::-1].translate(_RC_TABLE)


def cap2low(s: str) -> str:
    return s.lower()


def get_real_start_4_deletion(chr_seq: str, real_start: int,
                              real_end: int) -> Tuple[int, int]:
    """Left-shift an ambiguous deletion; defines the microhomology range.

    Reference: GetRealStart4Deletion, pindel.cpp:2095-2117.
    """
    if len(chr_seq) < real_start or len(chr_seq) < real_end:
        return real_start, real_end
    pos = real_start + SPACER
    start = pos + 1
    end = real_end + SPACER - 1
    while chr_seq[pos] == chr_seq[end] and chr_seq[pos] != "N":
        pos -= 1
        end -= 1
    out_start = pos - SPACER
    pos = real_end + SPACER
    while chr_seq[pos] == chr_seq[start] and chr_seq[pos] != "N":
        pos += 1
        start += 1
    out_end = pos - SPACER
    return out_start, out_end


def get_real_start_4_insertion(chr_seq: str, inserted: str, real_start: int,
                               real_end: int) -> Tuple[str, int, int]:
    """Rotate an insertion to its rightmost then leftmost placement.

    Reference: GetRealStart4Insertion, pindel.cpp:2130-2162.
    Returns (rotated insert, real_start, real_end).
    """
    if len(chr_seq) < real_start or len(chr_seq) < real_end:
        return inserted, real_start, real_end
    last_after = real_end + SPACER
    while inserted and chr_seq[last_after] == inserted[0] \
            and chr_seq[last_after] != "N":
        inserted = inserted[1:] + inserted[0]       # rotateForward
        last_after += 1
    real_end = last_after - SPACER
    last_before = last_after - 1
    while inserted and chr_seq[last_before] == inserted[-1] \
            and chr_seq[last_before] != "N":
        inserted = inserted[-1] + inserted[:-1]     # rotateBack
        last_before -= 1
    real_start = last_before - SPACER
    return inserted, real_start, real_end


def report_event(reads: List, s: int, e: int) -> bool:
    """Balance filter: breakpoint positions must span both read halves.

    Reference: ReportEvent, pindel.cpp:2059-2093.  ``reads`` are
    SplitReads with .bp/.nt_size/.read_length set.
    """
    left_min = left_max = right_min = right_max = False
    for i in range(s, e + 1):
        read_length = reads[i].read_length - reads[i].nt_size
        min_length = int(read_length * MIN_FILTER_RATIO + 0.5) - 1
        max_length = int(read_length * (1 - MIN_FILTER_RATIO) - 0.5) - 1
        if reads[i].bp <= min_length:
            left_min = True
        if reads[i].read_length - reads[i].bp - reads[i].nt_size <= min_length:
            right_min = True
        if reads[i].bp >= max_length:
            left_max = True
        if reads[i].read_length - reads[i].bp - reads[i].nt_size >= max_length:
            right_max = True
    return left_min and left_max and right_min and right_max


def is_inversion(read, chr_seq: str) -> bool:
    """A DI whose NT equals the RC of the replaced span is a short INV.

    Reference: IsInversion, reporter.cpp:1697-1706.
    """
    if read.indel_size == read.nt_size:
        replaced = chr_seq[SPACER + 1 + read.bp_left:
                           SPACER + 1 + read.bp_left + read.nt_size]
        if revcomp_str(replaced) == read.nt_str:
            return True
    return False
