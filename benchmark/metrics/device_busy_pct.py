"""Share of the traced window in which an operation ran on the card: the
union of the profiler's device intervals over the window's wall, in %."""
UNIT = "%"
LAYER = "device"
SOURCE = "device_trace"
MOVES = "pairs_per_s"


def read(run):
    if run.trace is None or not run.trace["busy_s"]:
        return None
    return 100.0 * run.trace["busy_s"] / run.trace["window_s"]
