"""Milliseconds a pass of host-to-device copies on the card: the profiler's
HtoD memcpy device time over the traced window, over its passes."""
UNIT = "ms/pass"
LAYER = "host-to-device copies"
SOURCE = "device_trace"
MOVES = "pairs_per_s"


def read(run):
    if run.trace is None or not run.trace["htod_s"]:
        return None
    return run.trace["htod_s"] * 1e3 / run.trace["passes"]
