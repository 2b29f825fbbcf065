"""Seconds a pass in the program's "Reading in reads" phase on BAM input
(``bam.py`` and its native reader), the mean over the window's passes."""
UNIT = "s/pass"
LAYER = "BAM intake"
SOURCE = "program_span"
MOVES = "pairs_per_s"


def read(run):
    if run.input_format != "bam":
        return None
    return run.phase_per_pass("Reading in reads")
