"""Seconds a pass in the cross-chromosome route (``Searcher._far_round``:
the reads whose far-end windows lie on another contig than the region's,
from their grouping through the partner backends' K4 calls and decode to
the NumPy oracle for the rest), the program's span "search:
cross-chromosome", the mean over the window's passes; nothing where the
program has no such span."""
UNIT = "s/pass"
LAYER = "cross-chromosome route"
SOURCE = "program_span"
MOVES = "pairs_per_s"


def read(run):
    return run.phase_per_pass("search: cross-chromosome")
