"""Reads of the cross-chromosome route that the NumPy oracle searched on
the host in the window's last pass (the program's
``profiling.g_xchrom.oracle``, reset at each pass): those whose windows lie
on two contigs or not in K4's shape; the rest ran on the card.  Nothing
where the program has no such counter."""
UNIT = "reads"
LAYER = "cross-chromosome route"
SOURCE = "program_counter"
MOVES = "pairs_per_s"


def read(run):
    from pindel_tpu_torch import profiling
    stats = getattr(profiling, "g_xchrom", None)
    if stats is None or not run.passes:
        return None
    return float(stats.oracle)
