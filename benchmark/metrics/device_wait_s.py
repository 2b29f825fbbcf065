"""Seconds a pass the host waits on the card for the search kernels'
outputs (``ops/engine_fused.py``): the program's spans "fused: close wait",
"fused: far wait" and "fused: bdwin wait" (the evidence-window call, its
launch included), summed, the mean over the window's passes; nothing where
the program has no such spans."""
UNIT = "s/pass"
LAYER = "host waits on the card"
SOURCE = "program_span"
MOVES = "pairs_per_s"


def read(run):
    return run.phase_per_pass("fused: close wait", "fused: far wait",
                              "fused: bdwin wait")
