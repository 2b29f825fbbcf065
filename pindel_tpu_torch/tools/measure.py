"""What the port's measurement scripts share: the card's published peaks,
the scan kernel's bound, the card line, CUDA event timing, the
device-busy share of a profiled run and the record of a run's windows.

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
    we = tiles.shape[1] - kw["lmax"]
    steps1 = (torch.clamp(qlen.double(), max=lsteps) - 1).clamp(min=0)
    per_lane = steps1 * PASS1_OPS_PER_WORD / 4 + lsteps * PASS2_OPS
    lanes = torch.where(sparse, seeds, we)
    ops = float((lanes * per_lane).sum())
    earlier = steps1 * EARLIER_PASS1_OPS + lsteps * PASS2_OPS
    dense_ops = float((valid_w.double() * earlier).sum())
    nbytes = (sum(a.numel() * a.element_size() for a in args)
              + 2 * tiles.shape[0] * kw["lmax"] * 4)
    t_ops, t_bytes = ops / PEAK_INT32_OPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes",
            max(dense_ops / PEAK_INT32_OPS, t_bytes) * 1e3)


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
