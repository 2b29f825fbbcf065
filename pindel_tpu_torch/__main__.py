"""CLI entry: ``python -m pindel_tpu_torch -f ref.fa -p reads.txt -o prefix``.

The flags are those of ``python -m pindel_tpu`` (reference CLI,
fn_parameters.cpp:17-351), with ``--device`` (default ``cuda``) in place of
``--backend``.  Modes whose device path is not ported yet stop with an error
that names their ROADMAP item.
"""
from __future__ import annotations

import argparse
import sys

from pindel_tpu.config import Settings
from pindel_tpu_torch.pipeline import check_supported, run_files

# flags of modes that are not ported yet -> ROADMAP Queue 1 item (-b and
# -x > 4 are refused by check_supported)
_NOT_PORTED = (
    ("config", "-i (BAM input)", "item 6"),
    ("detect_DD", "-q (dispersed duplications)", "item 8"),
    ("assembly", "-z (assembly)", "item 8"),
    ("genotyping", "-g (genotyping)", "item 8"),
)


def _unary(value: str) -> bool:
    """Reference unary-flag value parsing (readParameters,
    fn_parameters.cpp:379-389): an optional following token sets the flag
    false iff its first character is 'f'/'F'/'0', true otherwise."""
    return not (value and (value[0].lower() == "f" or value[0] == "0"))


def _bool_flag(ap, *names, default: bool = False, dest=None, help=None):
    """A reference-style unary flag: bare sets true, an optional value
    token is parsed with ``_unary``."""
    ap.add_argument(*names, nargs="?", const=True, default=default,
                    type=_unary, dest=dest, help=help, metavar="[T/F]")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="pindel_tpu_torch",
        description="Structural variant discovery (pindel-compatible) on "
                    "PyTorch + CUDA")
    ap.add_argument("-f", "--fasta", required=True)
    ap.add_argument("-p", "--pindel-file", default=None)
    ap.add_argument("-P", "--pindel-config-file", dest="pindel_config",
                    default=None,
                    help="config file naming one pindel file per line "
                         "(reference readPindelConfigFile, "
                         "pindel.cpp:705-738)")
    ap.add_argument("-i", "--config", default=None,
                    help="bam config (not ported yet)")
    ap.add_argument("-o", "--output-prefix", required=True)
    ap.add_argument("-c", "--chromosome", default="ALL")
    ap.add_argument("-j", "--include", default="",
                    help="BED file of regions to include")
    ap.add_argument("-J", "--exclude", default="",
                    help="BED file of regions to exclude")
    ap.add_argument("-x", "--max_range_index", type=int, default=2)
    ap.add_argument("-w", "--window_size", type=float, default=5.0)
    ap.add_argument("-e", "--sequencing_error_rate", type=float, default=0.01)
    ap.add_argument("-E", "--sensitivity", type=float, default=0.95)
    ap.add_argument("-u", "--maximum_allowed_mismatch_rate", type=float,
                    default=0.02)
    ap.add_argument("-m", "--min_perfect_match_around_BP", type=int,
                    default=3)
    ap.add_argument("-a", "--additional_mismatch", type=int, default=1)
    ap.add_argument("-d", "--min_num_matched_bases", type=int, default=30)
    ap.add_argument("-B", "--balance_cutoff", type=int, default=100)
    ap.add_argument("-M", "--minimum_support_for_event", type=int, default=1)
    _bool_flag(ap, "-s", "--report_close_mapped_reads")
    _bool_flag(ap, "-S", "--report_only_close_mapped_reads")
    _bool_flag(ap, "-l", "--report_long_insertions")
    _bool_flag(ap, "-k", "--report_breakpoints")
    ap.add_argument("--force_bp_output", action="store_true",
                    help="resurrect the BP detector the reference disabled")
    _bool_flag(ap, "-r", "--report_inversions", default=True)
    _bool_flag(ap, "-t", "--report_duplications", default=True)
    ap.add_argument("-v", "--min_inversion_size", type=int, default=50)
    ap.add_argument("-b", "--breakdancer", default="",
                    help="BreakDancer calls file (not ported yet)")
    ap.add_argument("-Q", "--output_of_breakdancer_events", default="",
                    help="file for SVs confirmed by BreakDancer calls")
    _bool_flag(ap, "-R", "--RP", dest="search_discordant", default=True,
               help="search for discordant read pairs (BAM input); "
                    "-R false disables")
    _bool_flag(ap, "-I", "--report_interchromosomal_events")
    _bool_flag(ap, "-q", "--detect_DD",
               help="detect dispersed duplications (not ported yet)")
    ap.add_argument("--MAX_DD_BREAKPOINT_DISTANCE", type=int, default=350)
    ap.add_argument("--MAX_DISTANCE_CLUSTER_READS", type=int, default=100)
    ap.add_argument("--MIN_DD_CLUSTER_SIZE", type=int, default=3)
    ap.add_argument("--MIN_DD_BREAKPOINT_SUPPORT", type=int, default=3)
    ap.add_argument("--MIN_DD_MAP_DISTANCE", type=int, default=8000)
    _bool_flag(ap, "--DD_REPORT_DUPLICATION_READS")
    ap.add_argument("-A", "--anchor_quality", type=int, default=0)
    ap.add_argument("-T", "--number_of_threads", type=int, default=1,
                    help="host-side worker threads (reference OpenMP -T)")
    ap.add_argument("-L", "--name_of_logfile", default="",
                    help="redirect the log stream to this file")
    ap.add_argument("-H", "--min_distance_to_the_end", type=int,
                    default=8, dest="min_close",
                    help="minimum number of bases required to match "
                         "reference (close-end)")
    ap.add_argument("-n", "--NM", type=int, default=2, dest="nm",
                    help="minimum edit distance between read and "
                         "reference for realignment (BAM channel)")
    ap.add_argument("--profile", action="store_true",
                    help="print the sub-phase timer registry at exit")
    ap.add_argument("-g", "--genotyping", default=None,
                    help="genotype the SVs listed in this file "
                         "(not ported yet)")
    ap.add_argument("-Y", "--Ploidy", dest="ploidy", default=None,
                    help="per-chromosome ploidy file (ChrName Ploidy)")
    _bool_flag(ap, "-N", "--NormalSamples", dest="normal_samples",
               help="germline read-depth filtering of calls")
    ap.add_argument("-z", "--assembly", default="",
                    help="assembly mode (not ported yet)")
    _bool_flag(ap, "-C", "--IndelCorrection",
               help="accepted for CLI parity; a no-op in the reference too "
                    "(pindel.cpp:2006)")
    ap.add_argument("--hosts", type=int, default=1,
                    help="shard windows across N processes (not ported "
                         "yet; only 1)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the search: cuda (default) or "
                         "cpu; cuda without a card is an error")
    return ap


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    for dest, what, item in _NOT_PORTED:
        if getattr(args, dest):
            ap.error(f"{what} is not ported to pindel_tpu_torch yet "
                     f"(ROADMAP Queue 1 {item})")
    if args.hosts > 1:
        ap.error("--hosts > 1 is not ported to pindel_tpu_torch yet "
                 "(ROADMAP Queue 1 item 11)")

    s = Settings(
        max_range_index=args.max_range_index,
        window_size_mb=args.window_size,
        seq_error_rate=args.sequencing_error_rate,
        sensitivity=args.sensitivity,
        max_allowed_mismatch_rate=args.maximum_allowed_mismatch_rate,
        min_perfect_match_around_bp=args.min_perfect_match_around_BP,
        additional_mismatch=args.additional_mismatch,
        min_num_matched_bases=args.min_num_matched_bases,
        balance_cutoff=args.balance_cutoff,
        num_reads_to_report_cutoff=args.minimum_support_for_event,
        report_close_mapped_reads=args.report_close_mapped_reads,
        report_only_close_mapped_reads=args.report_only_close_mapped_reads,
        analyze_li=args.report_long_insertions,
        analyze_bp=args.report_breakpoints,
        force_bp_output=args.force_bp_output,
        analyze_inv=args.report_inversions,
        analyze_td=args.report_duplications,
        min_inversion_size=args.min_inversion_size,
        region=args.chromosome,
        include_bed=args.include,
        exclude_bed=args.exclude,
        breakdancer_filename=args.breakdancer,
        breakdancer_output_filename=args.output_of_breakdancer_events,
        search_discordant_read_pair=args.search_discordant,
        report_interchromosomal_events=args.report_interchromosomal_events,
        detect_dd=args.detect_DD,
        max_dd_breakpoint_distance=args.MAX_DD_BREAKPOINT_DISTANCE,
        max_distance_cluster_reads=args.MAX_DISTANCE_CLUSTER_READS,
        min_dd_cluster_size=args.MIN_DD_CLUSTER_SIZE,
        min_dd_breakpoint_support=args.MIN_DD_BREAKPOINT_SUPPORT,
        min_dd_map_distance=args.MIN_DD_MAP_DISTANCE,
        dd_report_duplication_reads=args.DD_REPORT_DUPLICATION_READS,
        min_anchor_quality=args.anchor_quality,
        normal_samples=args.normal_samples,
        num_threads=args.number_of_threads,
        log_filename=args.name_of_logfile,
        min_close=args.min_close,
        nm=args.nm,
        profile=args.profile,
    )
    try:
        check_supported(s)
    except NotImplementedError as e:
        ap.error(str(e))
    run_files(args.fasta, args.pindel_file, args.output_prefix,
              settings=s, device=args.device,
              pindel_config=args.pindel_config)
    return 0


if __name__ == "__main__":
    sys.exit(main())
