"""Seconds a pass in the program's "Matching close ends" phase (``search.py``,
``ops/engine_fused.py``: pack, dispatch and decode of the close-end search,
and the host oracle's reads), the mean over the window's passes."""
UNIT = "s/pass"
LAYER = "close search, host"
SOURCE = "program_span"
MOVES = "pairs_per_s"


def read(run):
    return run.phase_per_pass("Matching close ends")
