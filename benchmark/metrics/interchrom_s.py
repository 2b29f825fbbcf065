"""Seconds a pass in the interchromosomal reports of ``-I`` (``Pipeline``'s
per-window pool of the reads whose far end lies on another contig, copied
out and reported to ``_INT``; pindel.cpp:1905-1917), the program's span
"window: interchromosomal", the mean over the window's passes; nothing
where the program has no such span."""
UNIT = "s/pass"
LAYER = "interchromosomal reports"
SOURCE = "program_span"
MOVES = "pairs_per_s"


def read(run):
    return run.phase_per_pass("window: interchromosomal")
