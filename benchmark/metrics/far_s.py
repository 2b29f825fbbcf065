"""Seconds a pass in the program's "Searching far ends" phase (``search.py``),
the mean over the window's passes."""
UNIT = "s/pass"
LAYER = "far search, host"
SOURCE = "program_span"
MOVES = "pairs_per_s"


def read(run):
    return run.phase_per_pass("Searching far ends")
