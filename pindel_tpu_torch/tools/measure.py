"""What the port's measurement scripts share: the card's published peaks,
the scan kernel's bound, the fused kernels' bound, the card line, CUDA event timing, the
device-busy share of a profiled run, the record of a run's windows and
regions, and the count of the reads it sent to the oracle across
chromosomes.

Used by ``chip_smoke.py`` and the tools (``pindel_tpu_torch.bench``,
``pindel_tpu_torch.tools.*``).  A tool runs on the card unless it is
asked for the CPU (``--device cpu``); it takes its device from
``pipeline.resolve_device``, which raises where no card is visible, so no
measurement falls back to the CPU.
"""
from __future__ import annotations

import contextlib
import subprocess
import time
import weakref

import torch

# the H100 SXM's published peaks (NVIDIA's H100 datasheet): HBM bytes/s,
# and the int32 rate, from the float32 rate outside the tensor cores (67e12,
# an FMA counted as two operations, 128 float32 lanes per SM and clock):
# an SM issues 64 int32 operations per clock, so a quarter of it
PEAK_BYTES = 3.35e12
PEAK_INT32_OPS = 67e12 / 4
# int32 operations per candidate of the scan, as the kernel (csrc/scan.cu)
# does the work.  Pass 1, over the read's counted steps: 7 per word of four
# steps (funnel shift, a lop3 for the xor and mask, the add that flags the
# nonzero bytes, two lop3 for the or and the row's masks, popc, the add to
# the total).  Pass 2, over lsteps: 8 per step, the step's work as the plain
# version states it (mismatch test, N flip, level add, last-mismatch
# update, strict-bad test, key, min and second-min fold), fewer than the
# kernel issues (about 9 per step and 5 per word).  The bound counts them
# over the candidates a row needs: its seeded lanes when the sparse branch
# takes it (two or more seeds; ops/scan.py:sparse_rows), every lane of
# [0, WE) otherwise.  The earlier count took every row's valid_w lanes, at
# 3 operations per step of pass 1
PASS1_OPS_PER_WORD = 7
PASS2_OPS = 8
EARLIER_PASS1_OPS = 3


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader`` gives them."""
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return res.stdout.strip().splitlines()[0]


def device_line(dev: torch.device) -> str:
    """``card_line()`` on a card; on the CPU, that no card was used."""
    return card_line() if dev.type == "cuda" else "cpu (no card)"


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def min_ms(fn, dev: torch.device, n: int = 3) -> float:
    """The least time of ``n`` calls of ``fn`` after one untimed call, in
    ms: CUDA events around each call on a card, the host clock on the
    CPU."""
    fn()
    sync(dev)
    times = []
    for _ in range(n):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            stop.record()
            stop.synchronize()
            times.append(start.elapsed_time(stop))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return min(times)


def row_classes(args, kw):
    """Seeds per row and the rows the kernel walks on its sparse branch
    (two or more seeds; ops/scan.py:sparse_rows)."""
    from pindel_tpu_torch.ops.scan import seed_counts, sparse_rows
    tiles, qq, valid_w, qlen, _thr, off = args
    seeds = seed_counts(tiles, qq, valid_w, off, lmax=kw["lmax"])
    return seeds, sparse_rows(seeds, valid_w, qlen, w=kw["w"],
                              lmax=kw["lmax"], lsteps=kw["lsteps"])


def scan_ops(args, kw, seeds, sparse) -> float:
    """The int32 operations one scan call's rows need: pass 1 over each
    read's counted steps, pass 2 over ``lsteps``, on the seeded lanes of a
    sparse row and on every lane of [0, WE) of the others."""
    tiles, qlen = args[0], args[3]
    lsteps = kw["lsteps"] or kw["lmax"]
    we = tiles.shape[1] - kw["lmax"]
    steps1 = (torch.clamp(qlen.double(), max=lsteps) - 1).clamp(min=0)
    per_lane = steps1 * PASS1_OPS_PER_WORD / 4 + lsteps * PASS2_OPS
    lanes = torch.where(sparse, seeds, we)
    return float((lanes * per_lane).sum())


def scan_bound(args, kw, seeds, sparse):
    """The least time the card could take for one scan call, from its
    inputs: the int32 operations its rows need (pass 1 over the read's
    steps, pass 2 over ``lsteps``, on the seeded lanes of a sparse row and
    on every lane of [0, WE) of the others) at PEAK_INT32_OPS, or each input
    byte read and each output byte written once at PEAK_BYTES, whichever is
    longer.  Returns (ms, "operations" or "bytes", and the earlier
    valid-lane count, which takes every row's ``valid_w`` lanes as
    candidates at EARLIER_PASS1_OPS per step of pass 1, in ms)."""
    tiles, qq, valid_w, qlen, thr = args[:5]
    lsteps = kw["lsteps"] or kw["lmax"]
    ops = scan_ops(args, kw, seeds, sparse)
    steps1 = (torch.clamp(qlen.double(), max=lsteps) - 1).clamp(min=0)
    earlier = steps1 * EARLIER_PASS1_OPS + lsteps * PASS2_OPS
    dense_ops = float((valid_w.double() * earlier).sum())
    nbytes = (sum(a.numel() * a.element_size() for a in args)
              + 2 * tiles.shape[0] * kw["lmax"] * 4)
    t_ops, t_bytes = ops / PEAK_INT32_OPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes",
            max(dense_ops / PEAK_INT32_OPS, t_bytes) * 1e3)


def composition_scans(name, chromcat, payload, maxmm, static):
    """The plain composition of a fused call (``engine_fused``'s ``_ref``
    body over the scan on the payload's device): its output, its scan calls
    as (args, kw) and, per call, the emission rules' (any_emit, last) of
    group 0."""
    from pindel_tpu_torch.ops import engine_fused
    ref = {"_close_kernel": engine_fused._close_kernel_ref,
           "_far_kernel": engine_fused._far_kernel_ref,
           "_far_win_kernel": engine_fused._far_win_kernel_ref}[name]
    scans, rules = [], []
    real_scan, real_rules = engine_fused.scan_rows, engine_fused._emit_rules

    def scan(*a, **kw):
        scans.append((a, kw))
        return real_scan(*a, **kw)

    def emit_rules(*a, **kw):
        out = real_rules(*a, **kw)
        rules.append((out[3][:, 0], out[4][:, 0]))
        return out

    engine_fused.scan_rows, engine_fused._emit_rules = scan, emit_rules
    try:
        out = ref(chromcat, payload, maxmm, **static)
    finally:
        engine_fused.scan_rows, engine_fused._emit_rules = (real_scan,
                                                            real_rules)
    return out, scans, rules


def fused_rows(name, payload, static, out, rules):
    """Per scan call of the composition, the rows (two a read) that the
    fused kernel scans: for K2 range 0 whole and range 1 only for reads
    with no range-0 emission; for K3 each round only for the reads still
    active (close_max + st_max < qlen, as ``_far_kernel_ref`` replaces); for
    K4 every row of its one call."""
    from pindel_tpu_torch.ops import engine_fused as ef
    lmax = static["lmax"]
    flags = out[:, lmax // 32 + 1]
    if name == "_far_win_kernel":
        reads = [torch.ones_like(flags, dtype=torch.bool)]
    elif name == "_close_kernel":
        reads = [torch.ones_like(flags, dtype=torch.bool)]
        if static["with_r1"]:
            reads.append((flags & 255) >= 2)
    else:
        _codes, meta = ef._unpack_payload(payload, lmax, ef.FM_WORDS)
        qlen = meta[:, 1] & 0x3ff
        close_max = (meta[:, 1] >> 10) & 0x3ff
        st_max = (meta[:, 1] >> 20) & 0x3ff
        reads = []
        for any_emit, last in rules:
            active = close_max + st_max < qlen
            reads.append(active)
            new_max = torch.where(any_emit, last + 1, 0)
            st_max = torch.where(active & (new_max >= st_max), new_max,
                                 st_max)
    return [r.repeat_interleave(2) for r in reads]


def composition_bound(payload, out, scans):
    """The earlier bound of a fused call, counted as the torch composition
    works: each scan call's ``scan_bound`` over all its rows, plus the
    payload read, the chromosome span of each gathered tile and the output
    written, once each, at PEAK_BYTES; in ms."""
    k1 = 0.0
    tiles = 0
    for args, kw in scans:
        seeds, sparse = row_classes(args, kw)
        k1 += scan_bound(args, kw, seeds, sparse)[0]
        tiles += args[0].numel()
    glue = (payload.numel() + tiles
            + out.numel() * out.element_size())
    return k1 + glue / PEAK_BYTES * 1e3


def fused_bound(name, chromcat, payload, maxmm, static):
    """The least time of a fused call (``pt_close`` for ``_close_kernel``,
    ``pt_far`` for ``_far_kernel``, ``pt_far_win`` for ``_far_win_kernel``)
    as the kernel works: K1's operations (``scan_ops``) over the rows it
    scans (``fused_rows``: real rows only, range 1 only without a range-0
    hit, rounds only while active, every row of K4) at
    PEAK_INT32_OPS, or the bytes it must move at PEAK_BYTES (the payload,
    one read of each scanned tile's chromosome span, the output), whichever
    is longer.  Returns a dict: ``bound_ms``, ``bound_by``, the rows
    scanned and in all, and ``composition_bound_ms`` (the earlier count)."""
    out, scans, rules = composition_scans(name, chromcat, payload, maxmm,
                                          static)
    ops = 0.0
    nbytes = payload.numel() + out.numel() * out.element_size()
    scanned = total = 0
    for (args, kw), rows in zip(scans, fused_rows(name, payload, static,
                                                  out, rules)):
        idx = rows.nonzero().flatten()
        sub = [a.index_select(0, idx) for a in args]
        seeds, sparse = row_classes(sub, kw)
        ops += scan_ops(sub, kw, seeds, sparse)
        nbytes += len(idx) * args[0].shape[1]
        scanned += len(idx)
        total += args[0].shape[0]
    t_ops, t_bytes = ops / PEAK_INT32_OPS, nbytes / PEAK_BYTES
    return dict(bound_ms=max(t_ops, t_bytes) * 1e3,
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                rows_scanned=scanned, rows_all=total,
                composition_bound_ms=composition_bound(payload, out, scans))


def device_busy(prof, wall_s: float):
    """Device time of a ``torch.profiler`` trace (the union of its device
    events' intervals, so overlapping streams count once) and its share of
    ``wall_s``; (0.0, None) where the trace holds no device event (a CPU
    run: not measured)."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        return 0.0, None
    busy_us = 0.0
    end = float("-inf")
    for lo, hi in spans:
        if hi > end:
            busy_us += hi - max(lo, end)
            end = hi
    return busy_us / 1e6, busy_us / 1e6 / wall_s


def top_device_kernels(prof, n: int = 10):
    """The ``n`` device kernels of a trace with the most total time:
    (name, calls, total ms), longest first."""
    totals = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            calls, us = totals.get(e.name, (0, 0.0))
            totals[e.name] = (calls + 1,
                              us + e.time_range.end - e.time_range.start)
    top = sorted(totals.items(), key=lambda kv: -kv[1][1])[:n]
    return [(name, calls, us / 1e3) for name, (calls, us) in top]


@contextlib.contextmanager
def window_log():
    """Records the port's window loop in the runs inside the context: per
    window (in the order its reads were read in) its index, bounds
    (``start``, ``end``), the split reads read in, and the seconds from the
    context's start at which its reads were in (``read_s``), its search was
    staged (``staged_s``: the RP -> BD update and far-end dispatch of the
    deep pipeline) and its host stages ended (``done_s``: detectors and
    reports).  Yields the list it fills."""
    from pindel_tpu_torch.pipeline import Pipeline
    rows = []
    t0 = time.monotonic()
    real = {name: getattr(Pipeline, name) for name in (
        "_window_reads", "_window_reads_bam", "_search_stage",
        "_process_window")}

    def read_in(name):
        def wrapped(self, chrom, window):
            out = real[name](self, chrom, window)
            reads = out[0] if name == "_window_reads_bam" else out
            rows.append(dict(index=self._window_counter - 1,
                             start=window.current_start,
                             end=window.current_end, reads=len(reads),
                             read_s=time.monotonic() - t0))
            return out
        return wrapped

    def stamp(name, key):
        def wrapped(self, pending, *args):
            out = real[name](self, pending, *args)
            index = pending[0].index
            for row in reversed(rows):
                if row["index"] == index:
                    row[key] = time.monotonic() - t0
                    break
            return out
        return wrapped

    Pipeline._window_reads = read_in("_window_reads")
    Pipeline._window_reads_bam = read_in("_window_reads_bam")
    Pipeline._search_stage = stamp("_search_stage", "staged_s")
    Pipeline._process_window = stamp("_process_window", "done_s")
    try:
        yield rows
    finally:
        for name, fn in real.items():
            setattr(Pipeline, name, fn)


@contextlib.contextmanager
def oracle_reads():
    """Counts, over the runs inside the context, the reads whose far-end
    lanes ``Searcher._far_round`` sends to the NumPy oracle because one of
    them lies on another chromosome than the device backend's (search.py:
    the interchromosomal route, which adds nothing to ``g_fallback``).
    The test is ``_far_round``'s own, stated over the reads' regions (a
    read's lanes carry its regions' chromosome names); the copied
    ``search.py`` is left as it is.  Yields a dict whose ``reads`` grows."""
    from pindel_tpu_torch.search import Searcher
    real = Searcher._far_round
    count = {"reads": 0}

    def far_round(self, reads, regions, backend=None):
        name = getattr(self.backend if backend is None else backend,
                       "chrom_name", None)
        if name is not None:
            count["reads"] += sum(any(c.name != name for c, _s, _e in regs)
                                  for regs in regions)
        return real(self, reads, regions, backend)

    Searcher._far_round = far_round
    try:
        yield count
    finally:
        Searcher._far_round = real


@contextlib.contextmanager
def region_log():
    """Records each BED region of the runs inside the context when its
    window loop starts: its chromosome, the bytes of its backend's device
    state, the backend's card's allocated memory (None on the CPU) and how
    many of the backends made so far are alive (the record holds them by
    weak reference, so a region's backend that outlives it shows here).
    Yields the list it fills; a run without a device backend (``numpy``)
    records its regions with None for the backend's values."""
    from pindel_tpu_torch import pipeline
    rows, made = [], []
    real_factory = pipeline.make_backend_factory
    real_window = pipeline.LoopingSearchWindow

    def make_backend_factory(*args, **kw):
        factory = real_factory(*args, **kw)
        if factory is None:
            return None

        def tracked(chrom):
            backend = factory(chrom)
            st = backend.state
            made.append((weakref.ref(backend), st.chrom.device, sum(
                t.numel() * t.element_size()
                for t in (st.chrom, st.chromcat, st.maxmm))))
            return backend
        return tracked

    class Window(real_window):
        def __init__(self, chrom, *args, **kw):
            super().__init__(chrom, *args, **kw)
            _ref, dev, state = made[-1] if made else (None, None, None)
            rows.append(dict(
                chrom=chrom.name, state_bytes=state,
                allocated=(torch.cuda.memory_allocated(dev)
                           if dev is not None and dev.type == "cuda"
                           else None),
                alive=sum(ref() is not None for ref, _d, _s in made)))

    pipeline.make_backend_factory = make_backend_factory
    pipeline.LoopingSearchWindow = Window
    try:
        yield rows
    finally:
        pipeline.make_backend_factory = real_factory
        pipeline.LoopingSearchWindow = real_window
