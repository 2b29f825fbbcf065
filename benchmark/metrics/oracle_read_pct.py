"""Share of the fused search's reads that fell back to the host oracle in
the window's last pass (the program's ``profiling.g_fallback``: reads whose
device result could not be decoded exactly, out of all it searched; reset
at each pass, whose input is the same every pass), in %; nothing where the
pass searched no read."""
UNIT = "%"
LAYER = "host oracle fallback"
SOURCE = "program_counter"
MOVES = "pairs_per_s"


def read(run):
    from pindel_tpu_torch.profiling import g_fallback
    if not run.passes or not g_fallback.total:
        return None
    return 100.0 * g_fallback.fallback / g_fallback.total
