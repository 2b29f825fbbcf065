"""Time the fused search's device calls whole: ``_close_kernel`` (K2) with
both ranges and with range 0 only, ``_far_kernel`` (K3) over three rounds
and ``_far_win_kernel`` (K4) over one 2 kb evidence window a read, at
scene shapes (b rows, w0 = 512, w1 = 1536, lmax = 128, lsteps = 112), so
that their device cost is seen apart from the pipeline's host work.

    python -m pindel_tpu_torch.tools.kernel_bench [B] [--device cuda|cpu]

The counterpart of ``tools/kernel_bench.py``: the same shapes and inputs
from the same random stream (seed 0; K4's, which the reference tool does
not time, drawn after them), but the payloads are packed as the
backend packs them (the close payload holds each read and its copy
reversed within its length; both kernels take the chromosome in the
[2 * rows, 128] layout of ``engine_fused._chrom_cat``).  Each call is timed
with CUDA events, the least of 3 after a warm-up, and so is each scan
kernel (K1) launch it makes (the K1 time of the call is their sum).  Each
call's output is held, bit for bit, against the same call with the plain
scan in the kernel's place (``correct``).  Each call's bound is K1's
(``measure.scan_bound`` of each of its scan calls) plus the bytes its torch
code must move once at ``PEAK_BYTES``: the payload read, the chromosome
span of every tile it gathers, and its output written.

The last line of standard output is one JSON object with, for each call,
its ms, rows/s, K1 ms and launches, bound and the bound's share of its
time, plus ``correct``, ``device`` (the card's name and power limit),
``build_s`` (building or loading the scan kernel) and ``first_use_s`` (the
first, untimed call of each).
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from pindel_tpu_torch.genome import SPACER
from pindel_tpu_torch.ops import engine_fused, scan_cuda
from pindel_tpu_torch.ops.engine_fused import (FW_WORDS, _chrom_cat,
                                               _close_kernel, _close_meta,
                                               _far_kernel, _far_meta,
                                               _far_win_kernel,
                                               _pack_payload,
                                               _reverse_codes_np)
from pindel_tpu_torch.ops.scan import scan_rows_ref
from pindel_tpu_torch.pipeline import resolve_device
from pindel_tpu_torch.tools import measure

LMAX = 128
CLOSE = dict(w0=512, w1=1536, lmax=LMAX, mpm=3, bp_start=8, lsteps=112)
FAR = dict(spans=(64, 256, 1024), ws=(128, 512, 2048), lmax=LMAX, mpm=3,
           bp_start=10, lsteps=112)
# K4: one window of WINDOW_BP bases a read (a BreakDancer call's span), in
# the 2048 bucket
WINDOW_BP = 2000
FAR_WIN = dict(w=2048, lmax=LMAX, mpm=3, bp_start=10, lsteps=112)


def inputs(b: int):
    """The host inputs of the calls, drawn from the reference tool's random
    stream: (chromosome codes, maxmm, close payload, far payload, window
    payload)."""
    rng = np.random.default_rng(0)
    chrom_len = 6_000_000 + 2 * SPACER
    chrom = rng.integers(0, 4, chrom_len, dtype=np.int8)
    maxmm = np.minimum(np.arange(512) // 20 + 2, 30).astype(np.int32)
    qlen = np.full(b, 100, np.int32)
    codes = rng.integers(0, 4, (b, LMAX), dtype=np.int8)
    pos = rng.integers(10_000, 5_900_000, b).astype(np.int64)
    isz = np.full(b, 500, np.int64)
    ms = np.full(b, 5, np.int32)
    tm = ms + 1
    thr = np.full(b, 10, np.int32)
    minus = rng.integers(0, 2, b).astype(bool)
    meta = _close_meta(pos, isz, qlen, ms, tm, thr, minus)
    # the close payload as the native packer writes it: the read's codes,
    # then the codes reversed within the read's length
    payload = _pack_payload(
        np.concatenate([codes, _reverse_codes_np(codes, qlen)], axis=1), meta)
    center = rng.integers(200_000, 5_800_000, b).astype(np.int64)
    fmeta = _far_meta(center, qlen, np.full(b, 40, np.int32),
                      np.zeros(b, np.int32), ms, tm, thr, chrom_len)
    fpayload = _pack_payload(codes, fmeta)
    # K4's meta (start, end, qlen, ms | tm << 8 | thr << 16), as
    # TorchFusedBackend.run packs it
    wmeta = np.zeros((b, FW_WORDS), np.int32)
    wmeta[:, 0] = rng.integers(SPACER, chrom_len - SPACER - WINDOW_BP, b)
    wmeta[:, 1] = wmeta[:, 0] + WINDOW_BP
    wmeta[:, 2] = qlen
    wmeta[:, 3] = ms | (tm << 8) | (thr << 16)
    wpayload = _pack_payload(codes, wmeta)
    return chrom, maxmm, payload, fpayload, wpayload


def calls(chrom, maxmm, payload, fpayload, wpayload, dev):
    """name -> a function that makes the call on ``dev`` (the inputs
    uploaded once)."""
    chromcat = _chrom_cat(torch.from_numpy(chrom).to(dev))
    maxmm_t = torch.from_numpy(maxmm).to(dev)
    close_p = torch.from_numpy(payload).to(dev)
    far_p = torch.from_numpy(fpayload).to(dev)
    win_p = torch.from_numpy(wpayload).to(dev)
    return {
        "close_both_ranges": lambda: _close_kernel(
            chromcat, close_p, maxmm_t, with_r1=True, **CLOSE),
        "close_range0": lambda: _close_kernel(
            chromcat, close_p, maxmm_t, with_r1=False, **CLOSE),
        "far_3_rounds": lambda: _far_kernel(chromcat, far_p, maxmm_t, **FAR),
        "far_window": lambda: _far_win_kernel(chromcat, win_p, maxmm_t,
                                              **FAR_WIN),
    }


def scan_calls(fn):
    """``fn()``'s result and the scan calls it made, as (args, kw)."""
    made = []
    real = engine_fused.scan_rows

    def recording(*a, **kw):
        made.append((a, kw))
        return real(*a, **kw)

    engine_fused.scan_rows = recording
    try:
        return fn(), made
    finally:
        engine_fused.scan_rows = real


def with_plain_scan(fn):
    """``fn()`` with the plain scan in the kernel's place."""
    real = engine_fused.scan_rows
    engine_fused.scan_rows = scan_rows_ref
    try:
        return fn()
    finally:
        engine_fused.scan_rows = real


def bound(payload_bytes: int, out, scans):
    """The call's bound in ms: each scan call's ``scan_bound``, plus the
    payload read, the chromosome span of each gathered tile and the output
    written, once each, at PEAK_BYTES."""
    k1 = 0.0
    tiles = 0
    for args, kw in scans:
        seeds, sparse = measure.row_classes(args, kw)
        k1 += measure.scan_bound(args, kw, seeds, sparse)[0]
        tiles += args[0].numel()
    glue = payload_bytes + tiles + out.numel() * out.element_size()
    return k1 + glue / measure.PEAK_BYTES * 1e3


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m pindel_tpu_torch.tools.kernel_bench",
        description=__doc__.splitlines()[0])
    ap.add_argument("b", nargs="?", type=int, default=16384,
                    help="rows per call (default 16384)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    card = measure.device_line(dev)
    build_s = 0.0
    if dev.type == "cuda":
        t0 = time.monotonic()
        scan_cuda._lib()
        build_s = time.monotonic() - t0
    log(f"device: {card}; scan kernel built or loaded in {build_s:.3f} s")

    host = inputs(args.b)
    _chrom, _maxmm, payload, fpayload, wpayload = host
    sizes = {"close_both_ranges": payload.nbytes,
             "close_range0": payload.nbytes, "far_3_rounds": fpayload.nbytes,
             "far_window": wpayload.nbytes}
    result = {}
    correct = True
    with torch.inference_mode():
        for name, fn in calls(*host, dev).items():
            t0 = time.monotonic()
            scan_cuda.LAUNCHES = 0
            out, scans = scan_calls(fn)
            measure.sync(dev)
            first_s = time.monotonic() - t0
            launches = scan_cuda.LAUNCHES
            same = torch.equal(out, with_plain_scan(fn))
            correct &= same
            ms = measure.min_ms(fn, dev)
            k1_ms = sum(measure.min_ms(
                lambda a=a, kw=kw: engine_fused.scan_rows(*a, **kw), dev)
                for a, kw in scans)
            b_ms = bound(sizes[name], out, scans)
            result[name] = dict(rows=args.b, ms=ms,
                                rows_per_s=args.b / ms * 1e3, k1_ms=k1_ms,
                                k1_calls=len(scans), launches=launches,
                                bound_ms=b_ms, bound_share=b_ms / ms,
                                first_use_s=first_s, equal_to_plain=same)
            log(f"{name} b={args.b}: {ms:.4f} ms ({args.b / ms * 1e3:.0f} "
                f"rows/s), its {len(scans)} scan calls {k1_ms:.4f} ms, "
                f"bound {b_ms:.4f} ms ({b_ms / ms:.1%}), equal to the plain "
                f"scan's: {same}  [{card}]")
    print(json.dumps(dict(
        tool="kernel_bench", b=args.b, calls=result, correct=correct,
        device=card, build_s=build_s,
        first_use_s=sum(c["first_use_s"] for c in result.values()))),
        flush=True)
    return 0 if correct else 1


if __name__ == "__main__":
    sys.exit(main())
