"""Seconds a pass in RP discovery and the BreakDancer/RP evidence update
(``bddata.py``, ``pipeline.py``): the program's phases "bd: rp discovery",
"bd: update" (``update_bd`` and ``apply_bd_delta`` under one name) and
"bd: load region", summed, the mean over the window's passes; nothing
where the pass has none (pindel-text input)."""
UNIT = "s/pass"
LAYER = "RP and BD evidence"
SOURCE = "program_span"
MOVES = "pairs_per_s"


def read(run):
    return run.phase_per_pass("bd: rp discovery", "bd: update",
                              "bd: load region")
