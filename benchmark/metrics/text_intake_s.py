"""Seconds a pass in the program's "Reading in reads" phase on pindel-text
input (``textindex.py``), the mean over the window's passes."""
UNIT = "s/pass"
LAYER = "text intake"
SOURCE = "program_span"
MOVES = "pairs_per_s"


def read(run):
    if run.input_format != "text":
        return None
    return run.phase_per_pass("Reading in reads")
