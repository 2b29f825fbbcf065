"""K3 ``pt_far`` (``_far_kernel``): its share of its roofline, in %.

The least time of one pass's calls (``bounds.call_bound``, summed over the
first traced pass's calls, from their inputs) over the kernel's device time
a pass in the trace.  Nothing where the pass made no such call or the trace
holds no such kernel."""
UNIT = "%"
LAYER = "far search kernel"
SOURCE = "device_trace"
MOVES = "pairs_per_s"
KERNEL = "far"


def read(run):
    if run.trace is None:
        return None
    bound = run.trace["bounds"].get(KERNEL)
    device_s = run.trace["by_kernel"].get(KERNEL)
    if not bound or not device_s:
        return None
    return 100.0 * bound["seconds"] / (device_s / run.trace["passes"])
