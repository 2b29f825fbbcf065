"""Read-depth module: per-sample relative coverage for germline filters.

Re-implements the reference's samtools-derived depth machinery
(bam2depth.{h,cpp}): per-BAM average coverage over a region (pileup with
mapq >= 20, deletion/refskip positions excluded — computed natively as a
match-segment overlap sum, see native/bamio.cpp ptbam_depth_sum) and the
ploidy-normalized SV-region-vs-flanks ratio used by the `-N` germline
filters and RP genotyping.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

PLOIDY = 2                          # bam2depth.cpp:115
MIN_MAPPING_QUALITY_READDEPTH = 20  # bam2depth.cpp:151


def bam2depth(readers: Sequence[object], chrom_name: str, start: int,
              end: int, min_mapq: int = MIN_MAPPING_QUALITY_READDEPTH
              ) -> List[float]:
    """Average coverage of [start, end) per BAM (bam2depth,
    bam2depth.cpp:37-110).  Division by a zero-length region follows C++
    double semantics (inf/nan), which the caller's comparisons absorb."""
    out: List[float] = []
    length = np.float64(end - start)
    with np.errstate(divide="ignore", invalid="ignore"):
        for reader in readers:
            total = np.float64(reader.depth_sum(chrom_name, start, end,
                                                min_mapq))
            out.append(float(total / length))
    return out


def get_relative_coverage_internal(chrom_name: str, chrom_size: int,
                                   start: int, end: int,
                                   readers: Sequence[object]
                                   ) -> List[float]:
    """Ploidy-normalized depth of the SV region vs its flanks
    (getRelativeCoverageInternal, bam2depth.cpp:112-137)."""
    region = end - start
    before_start = start - region if start - region >= 0 else 0
    after_end = min(end + region, chrom_size)
    before = bam2depth(readers, chrom_name, before_start, start)
    mid = bam2depth(readers, chrom_name, start, end)
    after = bam2depth(readers, chrom_name, end, after_end)
    out: List[float] = []
    for b, m, a in zip(before, mid, after):
        if b + a == 0:
            out.append(-1.0)        # SV fills the whole chromosome
        else:
            with np.errstate(divide="ignore", invalid="ignore"):
                out.append(float(PLOIDY * (2 * np.float64(m))
                                 / (np.float64(b) + np.float64(a))))
    return out


def update_sample_ids(bam_entries, supporting_tags) -> List[int]:
    """Supporting samples -> bam config indices (UpdateSampleID,
    reporter.cpp:140-156)."""
    tags = set(supporting_tags)
    return [i for i, e in enumerate(bam_entries) if e.tag in tags]


def rd_vote(signals: Sequence[float], threshold: float,
            deletion: bool) -> bool:
    """The CountGoodSamples vote shared by IsGoodDeletion/IsGoodTD
    (reporter.cpp:1380-1391, 1141-1152)."""
    n = len(signals)
    good = sum(1 for s in signals
               if (s <= threshold if deletion else s >= threshold))
    if n == 1 and good == 1:
        return True
    if 1 < n <= 4 and n - good <= 1:
        return True
    if n > 4 and good / n > 0.66:
        return True
    return False


def relative_coverage_for_filtering(genome, chrom_name: str,
                                    bam_entries, readers: Dict[str, object],
                                    sample_ids: Sequence[int],
                                    start: int, end: int) -> List[float]:
    """getRelativeCoverageForFiltering (bam2depth.cpp:166-192)."""
    chrom = genome.get(chrom_name)
    selected = [readers[bam_entries[i].path] for i in sample_ids]
    return get_relative_coverage_internal(chrom_name, chrom.biol_size,
                                          start, end, selected)
