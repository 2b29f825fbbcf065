"""Run settings and the mismatch-budget table.

Mirrors the semantics of the reference's flag registry and probability table
(reference: ``user_defined_settings.h``, ``fn_parameters.cpp:17-351``,
``pindel.cpp:780-819`` ``createProbTable``) with identical defaults, so that
the same inputs yield bit-identical calls.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np

MAX_READ_LENGTH = 500  # table size, reference pindel.cpp:801


@dataclasses.dataclass
class Settings:
    """All user-settable knobs, defaults matching the reference CLI.

    Reference flags in comments (fn_parameters.cpp).
    """

    reference_filename: str = ""          # -f
    pindel_filename: str = ""             # -p
    pindel_config_filename: str = ""      # -P (config of pindel files)
    bam_config_filename: str = ""         # -i
    output_prefix: str = ""               # -o
    region: str = ""                      # -c  chr[:start-end]

    search_discordant_read_pair: bool = True   # -R
    min_close: int = 8                    # -H min bases of close-end match
    num_threads: int = 1                  # -T (host-side workers)
    max_range_index: int = 2              # -x, max 9
    window_size_mb: float = 5.0           # -w
    seq_error_rate: float = 0.01          # -e
    sensitivity: float = 0.95             # -E
    max_allowed_mismatch_rate: float = 0.02  # -u
    nm: int = 2                           # -n min edit distance to realign
    analyze_inv: bool = True              # -r
    analyze_td: bool = True               # -t
    analyze_li: bool = False              # -l
    analyze_bp: bool = False              # -k (reference leaves _BP empty:
                                          #     call site commented out,
                                          #     pindel.cpp:1171-1173)
    force_bp_output: bool = False         # ours: resurrect the BP detector
    report_close_mapped_reads: bool = False       # -s
    report_only_close_mapped_reads: bool = False  # -S
    report_interchromosomal_events: bool = False  # -I
    normal_samples: bool = False          # -N germline filtering
    breakdancer_filename: str = ""        # -b
    breakdancer_output_filename: str = "" # -Q
    include_bed: str = ""                 # -j
    exclude_bed: str = ""                 # -J
    additional_mismatch: int = 1          # -a (>=1 enforced, pindel.cpp:927)
    min_perfect_match_around_bp: int = 3  # -m
    min_inversion_size: int = 50          # -v
    min_num_matched_bases: int = 30       # -d
    balance_cutoff: int = 100             # -B
    min_anchor_quality: int = 0           # -A
    num_reads_to_report_cutoff: int = 1   # -M min supporting reads
    ploidy_filename: str = ""             # -Y
    detect_dd: bool = False               # -q mobile-element / dispersed dup
    log_filename: str = ""                # -L

    # DD/MEI tuning (reference fn_parameters.cpp:305-351)
    max_dd_breakpoint_distance: int = 350
    max_distance_cluster_reads: int = 100
    min_dd_cluster_size: int = 3
    min_dd_breakpoint_support: int = 3
    min_dd_map_distance: int = 8000
    dd_report_duplication_reads: bool = False

    # device-side tuning (ours, not in reference)
    device_batch_size: int = 8192         # reads per kernel launch chunk
    max_read_length: int = MAX_READ_LENGTH
    profile: bool = False                 # --profile: sub-phase timer dump
    # streaming byte-offset intake for plain-text -p/-P inputs: memory
    # stays O(window) instead of the whole materialized read set
    # (textindex.py); gz/irregular inputs fall back to in-RAM loading
    stream_text_input: bool = True

    def __post_init__(self):
        if self.additional_mismatch < 1:
            self.additional_mismatch = 1
        if self.max_range_index > 9:
            self.max_range_index = 9

    @property
    def window_size(self) -> int:
        return int(1_000_000 * self.window_size_mb)

    def max_mismatch(self) -> np.ndarray:
        return max_mismatch_table(0.001 + self.seq_error_rate, self.sensitivity)

    # derived output filenames, reference user_defined_settings.h:192-247
    def out(self, suffix: str) -> str:
        return f"{self.output_prefix}_{suffix}"


def _prob_of_read_with_errors(length: int, errors: int, rate: float) -> float:
    """P(read of `length` has exactly `errors` errors), binomial.

    Bit-for-bit port of the reference's floating-point evaluation order
    (pindel.cpp:781-792) so the budget table matches exactly.
    """
    matched = (1.0 - rate) ** (length - errors)
    mismatched = 1.0
    for i in range(errors):
        mismatched *= ((length - i) * rate) / (errors - i)
    return matched * mismatched


@functools.lru_cache(maxsize=8)
def max_mismatch_table(rate: float, sensitivity: float) -> np.ndarray:
    """g_maxMismatch[len] = max #mismatches acceptable for a read of len.

    Reference: createProbTable, pindel.cpp:799-819.
    """
    table = np.zeros(MAX_READ_LENGTH, dtype=np.int32)
    for length in range(MAX_READ_LENGTH):
        total = 0.0
        for errors in range(length + 1):
            total += _prob_of_read_with_errors(length, errors, rate)
            if total > sensitivity:
                table[length] = errors + 1
                break
    table[0:4] = 0
    table.flags.writeable = False
    return table
