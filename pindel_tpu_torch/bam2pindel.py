"""bam2pindel: convert BAM files to Pindel-format text input.

Functional equivalent of the reference's legacy Perl converter
(``bam2pindel.pl`` + ``Adaptor.pm``): one mapped, confident anchor plus an
unmapped/poorly-mapped mate become a 3-line Pindel record, written to one
output file per chromosome (the Perl tool's per-chromosome-arm split
without its centromere tables, quality-profile trimming and resume
machinery — those are operational conveniences of 2010-era pipelines, not
conversion semantics).  Classification (anchor confidence, weird-mate
test, N-trimming, reverse-complementing when the anchor is reversed,
MatchedRelPos conventions) reuses the native BAM split-read channel
(native/bamio.cpp), which implements the modern C++ reader's rules
(reader.cpp:483-1151) — a superset of the Perl adaptor's XT/NM checks.

Usage: python -m pindel_tpu.bam2pindel -i reads.bam -o prefix -s TAG -m 250
"""
from __future__ import annotations

import sys
from typing import List, Optional


def convert(bam_path: str, output_prefix: str, tag: str,
            insert_size: int, min_anchor_quality: int = 0,
            chromosomes: Optional[List[str]] = None) -> List[str]:
    """Write <prefix>_<chrom> Pindel-format files; returns their paths."""
    from pindel_tpu_torch.bam import BamReader
    reader = BamReader(bam_path)
    names = reader.ref_names
    out_paths: List[str] = []
    for ci, chrom in enumerate(names):
        if chromosomes and chrom not in chromosomes:
            continue
        length = int(reader.ref_lens[ci])
        reads, _ = reader.collect_sr(
            chrom, 0, length, insert_size, tag, length,
            min_anchor_quality=min_anchor_quality)
        if not reads:
            continue
        path = f"{output_prefix}_{chrom}"
        with open(path, "w") as out:
            for r in reads:
                out.write(f"{r.name}\n{r.seq}\n{r.matched_d}"
                          f"\t{r.frag_name}\t{r.matched_rel_pos}"
                          f"\t{r.ms}\t{r.insert_size}\t{r.tag}\n")
        out_paths.append(path)
    return out_paths


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="bam2pindel",
        description="Convert a BAM to Pindel-format input files "
                    "(one per chromosome)")
    ap.add_argument("-i", "--input", required=True, help="BAM file")
    ap.add_argument("-o", "--output", required=True,
                    help="output prefix (files named <prefix>_<chrom>)")
    ap.add_argument("-s", "--sample", default="S1", help="sample tag")
    ap.add_argument("-m", "--insert_size", type=int, required=True,
                    help="expected insert size for this library")
    ap.add_argument("-A", "--min_anchor_quality", type=int, default=0)
    ap.add_argument("-c", "--chromosome", action="append", default=None,
                    help="restrict to chromosome(s)")
    args = ap.parse_args(argv)
    paths = convert(args.input, args.output, args.sample,
                    args.insert_size, args.min_anchor_quality,
                    args.chromosome)
    for p in paths:
        print(p)
    return 0


if __name__ == "__main__":
    sys.exit(main())
