"""Seconds a pass in the reference-read coverage update
(``Pipeline._update_ref_coverage``: the per-position counts of the window's
reference reads, one slice a read), the program's span "coverage: reference
reads", the mean over the window's passes; nothing where the program has no
such span."""
UNIT = "s/pass"
LAYER = "reference-read coverage"
SOURCE = "program_span"
MOVES = "pairs_per_s"


def read(run):
    return run.phase_per_pass("coverage: reference reads")
