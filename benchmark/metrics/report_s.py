"""Seconds a pass in the program's "Searching and reporting variations" phase
(``events/``, ``report/``), the mean over the window's passes."""
UNIT = "s/pass"
LAYER = "detect and report"
SOURCE = "program_span"
MOVES = "pairs_per_s"


def read(run):
    return run.phase_per_pass("Searching and reporting variations")
