"""The traced run's instruments, all attached from outside the program:

* ``torch.profiler`` over the window (host and device activity), reduced to
  device time by operation, the union of device intervals (busy time), the
  host-to-device copies, and the idle gaps between device work labelled by
  the program's ``g_timer`` phase open at the time;
* the program's own ``g_timer`` phases, each also entered as a profiler
  range (``record_function``) so the trace and the spans share a clock;
* the inputs of the search calls (``engine_fused._close_kernel``,
  ``_far_kernel``, ``_far_win_kernel``) of one pass, for the rooflines
  (``bounds.py``), counted after the window.
"""
from __future__ import annotations

import collections
import contextlib
import re
from typing import Dict, List, Optional, Tuple

import torch

# the CUDA kernels behind each search call, as the profiler names them
KERNEL_NAMES = {"close": re.compile(r"(^|[\s:])close_kernel\b"),
                "far": re.compile(r"(^|[\s:])far_kernel\b"),
                "far_win": re.compile(r"(^|[\s:])far_win_kernel\b")}
PHASE_PREFIX = "phase: "
WINDOW_RANGE = "benchmark: window"


class Calls:
    """Records the inputs of the search calls while ``armed``."""

    def __init__(self):
        self.calls: List[Tuple[str, tuple, dict]] = []
        self.armed = False

    @contextlib.contextmanager
    def attached(self):
        from pindel_tpu_torch.ops import engine_fused
        real = {name: getattr(engine_fused, name)
                for name in ("_close_kernel", "_far_kernel",
                             "_far_win_kernel")}

        def wrap(name, fn):
            def call(chrom, payload, maxmm, **static):
                if self.armed:
                    self.calls.append((name, (chrom, payload, maxmm),
                                       dict(static)))
                return fn(chrom, payload, maxmm, **static)
            return call

        for name, fn in real.items():
            setattr(engine_fused, name, wrap(name, fn))
        try:
            yield self
        finally:
            for name, fn in real.items():
                setattr(engine_fused, name, fn)


@contextlib.contextmanager
def phases_as_ranges():
    """Each ``g_timer.phase`` of the program also opens a profiler range
    named ``PHASE_PREFIX + phase``."""
    from pindel_tpu_torch.profiling import Timer
    real = Timer.phase

    @contextlib.contextmanager
    def phase(self, name):
        with torch.profiler.record_function(PHASE_PREFIX + name):
            with real(self, name):
                yield

    Timer.phase = phase
    try:
        yield
    finally:
        Timer.phase = real


def _union(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for lo, hi in sorted(spans):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return [(lo, hi) for lo, hi in out]


def reduce(prof, window: Tuple[float, float]) -> dict:
    """The profile's device time by operation, per search kernel and in
    host-to-device copies (seconds); the busy seconds (union of device
    intervals, clipped to ``window``, in the profiler's microseconds); and
    the idle seconds between device intervals inside the window by the
    innermost program phase open at each gap's middle."""
    dev, host = [], []
    for e in prof.events():
        lo, hi = e.time_range.start, e.time_range.end
        ranged = e.name.startswith(PHASE_PREFIX) or e.name == WINDOW_RANGE
        if e.device_type == torch.autograd.DeviceType.CUDA:
            # the profiler mirrors host ranges on the device's timeline;
            # they are not device work
            if not ranged:
                dev.append((e.name, lo, hi))
        elif e.name.startswith(PHASE_PREFIX):
            host.append((e.name[len(PHASE_PREFIX):], lo, hi))
    w0, w1 = window
    by_op: Dict[str, float] = collections.Counter()
    by_kernel: Dict[str, float] = collections.Counter()
    calls: Dict[str, int] = collections.Counter()
    htod = 0.0
    for name, lo, hi in dev:
        s = (hi - lo) / 1e6
        by_op[name] += s
        for k, pat in KERNEL_NAMES.items():
            if pat.search(name):
                by_kernel[k] += s
                calls[k] += 1
        if "HtoD" in name or "Host to Device" in name:
            htod += s
    busy = _union([(max(lo, w0), min(hi, w1)) for _n, lo, hi in dev
                   if hi > w0 and lo < w1])
    busy_s = sum(hi - lo for lo, hi in busy) / 1e6
    idle: Dict[str, float] = collections.Counter()
    edges = [w0] + [x for span in busy for x in span] + [w1]
    for lo, hi in zip(edges[0::2], edges[1::2]):
        if hi <= lo:
            continue
        mid = (lo + hi) / 2
        open_ = [(a, n) for n, a, b in host if a <= mid <= b]
        label = max(open_)[1] if open_ else "outside the program's phases"
        idle[label] += (hi - lo) / 1e6
    return dict(by_op=dict(by_op), by_kernel=dict(by_kernel),
                kernel_calls=dict(calls), htod_s=htod, busy_s=busy_s,
                idle=dict(idle), device_events=len(dev))


def top(d: Dict[str, float], n: int = 10) -> List[list]:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


def window_bounds(prof) -> Optional[Tuple[float, float]]:
    """The window's extent on the profiler's clock: the range the harness
    opens around it."""
    for e in prof.events():
        if (e.name == WINDOW_RANGE
                and e.device_type == torch.autograd.DeviceType.CPU):
            return e.time_range.start, e.time_range.end
    return None
