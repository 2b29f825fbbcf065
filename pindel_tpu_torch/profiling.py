"""Phase timers, log stream and read-intake counters (observability).

Mirrors the reference's coarse observability surface:

* ``Timer``/``TimerItem`` wall-clock phase accounting printed at exit
  (reference pindel.cpp:1177-1260, switched at :1587/:1783/:1835/:1886/:1923
  and dumped at :2010);
* the global ``logStream`` that ``-L`` redirects to a file
  (reference pindel.cpp:839-842, logstream.h);
* per-window read-intake counters (reference reader.cpp:57-62 and
  ``showReadStats`` reader.cpp:183-193).

The port's ``Timer`` is also a span recorder: while recording (``--profile``,
or a ``torch.profiler`` active when a run starts) every phase is kept as a
span with its parent and thread and opened as a profiler range
``PREFIX + name``, so ``--profile`` prints the span tree with self times and
an in-process reader can put the spans on the profiler's clock.
"""
from __future__ import annotations

import collections
import itertools
import sys
import threading
import time
from contextlib import contextmanager
from typing import Dict, List, NamedTuple, Optional, TextIO

# the profiler range a span opens while recording: PREFIX + its name
PREFIX = "phase: "


class Span(NamedTuple):
    """One timed interval: ``parent`` is the id of the span open around it
    on its thread (0 for a root), or for work handed to a worker thread
    the span open when it was handed over."""

    id: int
    parent: int
    name: str
    start: float        # time.monotonic_ns(), or the profiler's us
    end: float
    thread: int         # threading.get_ident()


def profiler_active() -> bool:
    """Whether a ``torch.profiler`` records on this thread
    (``torch.profiler.profile`` sets the autograd profiler's flag)."""
    torch = sys.modules.get("torch")
    return torch is not None and torch._C._autograd._profiler_enabled()


class Timer:
    """Named wall-clock phase accumulator and span recorder.

    Like the reference's ``Timer`` (pindel.cpp:1177-1260) this sums the
    seconds of each named phase; ``phase()`` contexts nest.  Sums are
    taken under a lock, since decode work of the ``-T`` pool times itself
    too.  Recording is off unless ``reset(record=True)`` or a profiler is
    active at ``reset``; off, a phase costs two clock reads and one sum.
    """

    def __init__(self) -> None:
        self._acc: Dict[str, float] = {}
        self._order: List[str] = []
        self._t0 = time.monotonic()
        self._lock = threading.Lock()
        self._local = threading.local()
        self._spans: List[Span] = []
        self._ids = itertools.count(1)
        self._range = None          # torch.profiler.record_function
        self.recording = False

    def _sum(self, name: str, seconds: float) -> None:
        with self._lock:
            if name not in self._acc:
                self._acc[name] = 0.0
                self._order.append(name)
            self._acc[name] += seconds

    def _stack(self) -> List[int]:
        """Ids of the spans open on this thread, innermost last."""
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _parent(self) -> int:
        stack = self._stack()
        return stack[-1] if stack else 0

    def add(self, name: str, seconds: float) -> None:
        """Count ``seconds`` under ``name`` for an interval that ends now;
        while recording it is also a span under the innermost open one."""
        self._sum(name, seconds)
        if self.recording:
            end = time.monotonic_ns()
            self._spans.append(Span(next(self._ids), self._parent(), name,
                                    end - int(seconds * 1e9), end,
                                    threading.get_ident()))

    @contextmanager
    def phase(self, name: str):
        if not self.recording:
            t0 = time.monotonic()
            try:
                yield
            finally:
                self._sum(name, time.monotonic() - t0)
            return
        stack = self._stack()
        sid = next(self._ids)
        parent = stack[-1] if stack else 0
        stack.append(sid)
        rng = self._range(PREFIX + name)
        rng.__enter__()
        t0 = time.monotonic_ns()
        try:
            yield
        finally:
            t1 = time.monotonic_ns()
            rng.__exit__(None, None, None)
            stack.pop()
            self._spans.append(Span(sid, parent, name, t0, t1,
                                    threading.get_ident()))
            self._sum(name, (t1 - t0) / 1e9)

    def bind(self, fn):
        """``fn`` for another thread: while recording, the spans it opens
        take the span open here and now as their parent."""
        if not self.recording:
            return fn
        parent = self._parent()

        def call(*args, **kwargs):
            stack = self._stack()
            stack.append(parent)
            try:
                return fn(*args, **kwargs)
            finally:
                stack.pop()
        return call

    def reset(self, record: bool = False) -> None:
        """Forget every sum and span; record spans from here on where
        ``record`` or a profiler is active on this thread."""
        self._acc.clear()
        self._order.clear()
        self._spans = []
        self._local = threading.local()
        self.recording = record or profiler_active()
        if self.recording and self._range is None:
            import torch
            self._range = torch.profiler.record_function
        self._t0 = time.monotonic()

    def spans(self, prof=None) -> List[Span]:
        """The recorded spans, in the order they ended, on the monotonic
        clock (ns); given a ``torch.profiler.profile`` that was active over
        the run, on the profiler's clock (us).  The first root span's range
        in the profile anchors the offset at its end: a range opens before
        its span's clock read, by the profiler's own cost of opening it
        (most on the first range of a process), and closes just after."""
        out = list(self._spans)
        if prof is None or not out:
            return out
        root = min((s for s in out if not s.parent), key=lambda s: s.start)
        want = (root.end - root.start) / 1e3
        ranges = [e.time_range for e in prof.events()
                  if e.name == PREFIX + root.name
                  and e.device_type.name == "CPU"]
        if not ranges:
            raise ValueError(f"the profile holds no range {PREFIX}{root.name}")
        best = min(ranges, key=lambda r: abs(r.end - r.start - want))
        if abs(best.end - best.start - want) > 5e3 + want / 100:
            raise ValueError(f"no range {PREFIX}{root.name} of the profile "
                             f"lasts {want:.1f} us")
        off = best.end - root.end / 1e3
        return [s._replace(start=s.start / 1e3 + off, end=s.end / 1e3 + off)
                for s in out]

    def tree(self) -> List[tuple]:
        """The spans summed by their path of names from the root, in the
        order each path first started: (depth, name, total s, self s,
        calls, on the parent's thread).  A span's self time is its length
        less the union of its children on its own thread."""
        spans = self._spans
        by_id = {s.id: s for s in spans}
        kids = collections.defaultdict(list)
        for s in spans:
            kids[s.parent].append(s)
        rows: Dict[tuple, list] = {}

        def walk(s: Span, path: tuple, same_thread: bool) -> None:
            path = path + (s.name,)
            own = sorted((max(k.start, s.start), min(k.end, s.end))
                         for k in kids[s.id] if k.thread == s.thread)
            covered, hi = 0, s.start
            for lo, end in own:
                lo = max(lo, hi)
                if end > lo:
                    covered += end - lo
                    hi = end
            row = rows.setdefault(path, [s.start, 0, 0, 0, same_thread])
            row[0] = min(row[0], s.start)
            row[1] += s.end - s.start
            row[2] += s.end - s.start - covered
            row[3] += 1
            for k in kids[s.id]:
                walk(k, path, k.thread == s.thread)

        for s in spans:
            if s.parent not in by_id:
                walk(s, (), True)
        order = sorted(rows, key=lambda p: (
            [rows[p[:i + 1]][0] for i in range(len(p))]))
        return [(len(p) - 1, p[-1], rows[p][1] / 1e9, rows[p][2] / 1e9,
                 rows[p][3], rows[p][4]) for p in order]

    def report(self, stream=None, coarse_only: bool = False) -> str:
        """Phase report in the reference's exit format (pindel.cpp:1245-1258).

        ``coarse_only`` hides the fine-grained sub-phases (names with a
        ``:``-prefixed component, e.g. ``fused: close wait``) so the
        default exit dump matches the reference's 5-phase granularity;
        otherwise (``--profile``) a recorded run prints its span tree and
        an unrecorded one every phase."""
        if not coarse_only and self._spans:
            text = self._tree_report()
        else:
            text = self._flat_report(coarse_only)
        if stream is not None:
            stream.write(text + "\n")
        return text

    def _flat_report(self, coarse_only: bool) -> str:
        # the root span is the run's wall, not a phase of it
        total = sum(v for k, v in self._acc.items() if k != ROOT)
        wall = time.monotonic() - self._t0
        head = "Timer report (wall %.3fs, accounted %.3fs):" % (wall, total)
        if total > wall:
            # software pipelining overlaps device phases with host phases,
            # so phase times can double-count wall time
            head += "  [phases overlap under pipelining]"
        lines = [head]
        for name in self._order:
            if coarse_only and ":" in name:
                continue
            sec = self._acc[name]
            pct = 100.0 * sec / total if total > 0 else 0.0
            lines.append("  %-52s %9.3fs %5.1f%%" % (name, sec, pct))
        return "\n".join(lines)

    def _tree_report(self) -> str:
        rows = self.tree()
        lines = ["Span tree (wall %.3fs): total s, self s, calls; '~' "
                 "marks work run on a -T pool thread"
                 % (time.monotonic() - self._t0)]
        for depth, name, total, own, calls, same in rows:
            label = "  " * depth + ("" if same else "~") + name
            lines.append("  %-56s %9.3fs %9.3fs %7d" % (label, total, own,
                                                        calls))
        roots = [r for r in rows if r[0] == 0 and r[1] == ROOT]
        if roots and roots[0][2] > 0:
            lines.append("  root self time %.3fs, %.1f%% of %s"
                         % (roots[0][3], 100.0 * roots[0][3] / roots[0][2],
                            ROOT))
        return "\n".join(lines)

    def items(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._acc)


# the root span of a pass (pipeline.run_files)
ROOT = "run: pass"


g_timer = Timer()


class LogStream:
    """Global log sink: stderr by default, a file when ``-L`` is set.

    The reference logs to stdout (pindel.cpp:839-842); we default to
    stderr so stdout stays clean for machine-readable output (bench JSON,
    converter pipelines)."""

    def __init__(self) -> None:
        self._fh: TextIO = sys.stderr
        self._owned = False

    def redirect(self, path: str) -> None:
        self.close()
        self._fh = open(path, "w")
        self._owned = True

    def close(self) -> None:
        if self._owned:
            self._fh.close()
            self._owned = False
            self._fh = sys.stderr

    def write(self, msg: str) -> None:
        self._fh.write(msg)

    def info(self, msg: str) -> None:
        self._fh.write(msg + "\n")

    def flush(self) -> None:
        self._fh.flush()


g_log = LogStream()


class ReadStats:
    """Per-window intake counters (reference reader.cpp:57-62, 183-193)."""

    FIELDS = ("scanned", "in_window", "close_mapped_plus",
              "close_mapped_minus", "far_mapped")

    def __init__(self) -> None:
        for f in self.FIELDS:
            setattr(self, f, 0)

    def reset(self) -> None:
        for f in self.FIELDS:
            setattr(self, f, 0)

    def show(self, window_desc: str, log: Optional[LogStream] = None) -> str:
        """showReadStats-equivalent line (reader.cpp:183-193)."""
        text = ("Window %s: reads scanned %d, in window %d, "
                "close end mapped +%d/-%d, far end mapped %d" % (
                    window_desc, self.scanned, self.in_window,
                    self.close_mapped_plus, self.close_mapped_minus,
                    self.far_mapped))
        (log or g_log).info(text)
        return text


g_read_stats = ReadStats()


class FallbackStats:
    """Fused-engine fallback counters: reads whose device result could not
    be decoded exactly (non-uniform chains, jumbo metadata) re-run on the
    exact-semantics NumPy oracle.  The fused design assumes this is rare
    (~0% on uniform scenes); golden tests assert the measured ratio so a
    scene shape that breaks chain uniformity becomes a test failure, not
    a silent perf cliff (VERDICT r4 item 9)."""

    def __init__(self) -> None:
        self.total = 0
        self.fallback = 0

    def add(self, total: int, fallback: int) -> None:
        self.total += total
        self.fallback += fallback

    def reset(self) -> None:
        self.total = 0
        self.fallback = 0

    def ratio(self) -> float:
        return self.fallback / self.total if self.total else 0.0


g_fallback = FallbackStats()
