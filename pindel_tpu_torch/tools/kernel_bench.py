"""Time the fused search's device calls whole: ``_close_kernel`` (K2) with
both ranges and with range 0 only, ``_far_kernel`` (K3) over three rounds
and ``_far_win_kernel`` (K4) over one 2 kb evidence window a read, at
scene shapes (b rows, w0 = 512, w1 = 1536, lmax = 128, lsteps = 112), so
that their device cost is seen apart from the pipeline's host work.

    python -m pindel_tpu_torch.tools.kernel_bench [B] [--device cuda|cpu]
        [--per-round]

The counterpart of ``tools/kernel_bench.py``: the same shapes and inputs
from the same random stream (seed 0; K4's, which the reference tool does
not time, drawn after them), but the payloads are packed as the
backend packs them (the close payload holds each read and its copy
reversed within its length; both kernels take the chromosome in the
[2 * rows, 128] layout of ``engine_fused._chrom_cat``).  Each call is timed
with CUDA events, the least of 3 after a warm-up.  On a card K2, K3 and K4
are the fused kernels (``fused_cuda.pt_close``/``pt_far``/``pt_far_win``);
beside each the torch composition it replaced (``_close_kernel_ref``/
``_far_kernel_ref``/``_far_win_kernel_ref`` over the scan kernel, K1) is
timed as ``parent_ms``, with its scan calls' time (``k1_ms``).  Each call's
output is held, bit for bit, against the plain version (the ``_ref`` body
over the plain scan) (``correct``).  The bound is ``measure.fused_bound``
(K1's operations over the rows the fused kernel scans, or the bytes it must
move), printed beside the earlier count (``measure.composition_bound``:
each scan call's ``scan_bound`` over all its rows plus the bytes the torch
code moves).
``--per-round`` adds K3 over each of its rounds alone (``far_round_SPAN``),
which shows the cost of a round by its window.

``--far-win-tail`` times K4's critical path instead: for the largest K4
call of scenes 3 and 4 (each built in a temporary directory and run once
through ``testing/scenes.py:run_scene``, its K4 calls recorded), this
tool's own K4 call (``far_window``) and the skewed cases of
``testing/fused_cases.py`` at 4,000 narrow reads, ``measure.far_win_tail``'s
figures (the reads' widths and seeded lanes, the bucket, the widest 1%'s
share of the operations, the floor the widest read sets) and K4 timed on
(a) the whole call, (b) its
widest read alone and (c) the call without its widest 1% of reads, each
with CUDA events and queued behind a spin of the card, in turns.

The last line of standard output is one JSON object with, for each call,
its ms, rows/s, parent and K1 ms, launches, bound, the earlier bound and
the bound's share of its time, plus ``correct``, ``device`` (the card's
name and power limit), ``build_s`` (building or loading the kernels) and
``first_use_s`` (the first, untimed call of each).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from pindel_tpu_torch.genome import SPACER
from pindel_tpu_torch.ops import engine_fused, fused_cuda, scan_cuda
from pindel_tpu_torch.ops.engine_fused import (FW_WORDS, _chrom_cat,
                                               _close_meta, _far_meta,
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


# the calls and the kernel each one names (for its plain version)
KERNELS = {"close_both_ranges": "_close_kernel",
           "close_range0": "_close_kernel", "far_3_rounds": "_far_kernel",
           "far_window": "_far_win_kernel"}
REFS = {"_close_kernel": engine_fused._close_kernel_ref,
        "_far_kernel": engine_fused._far_kernel_ref,
        "_far_win_kernel": engine_fused._far_win_kernel_ref}


def calls(chrom, maxmm, payload, fpayload, wpayload, dev):
    """name -> a function that makes the call on ``dev`` (the inputs
    uploaded once)."""
    return {name: (lambda k=KERNELS[name], a=a: getattr(engine_fused, k)(
                *a[:3], **a[3]))
            for name, a in call_args(chrom, maxmm, payload, fpayload,
                                     wpayload, dev).items()}


def call_args(chrom, maxmm, payload, fpayload, wpayload, dev,
              per_round=False):
    """name -> (chromcat, payload, maxmm, static) of each call on ``dev``
    (the inputs uploaded once); with ``per_round`` also K3 over each of its
    rounds alone."""
    chromcat = _chrom_cat(torch.from_numpy(chrom).to(dev))
    maxmm_t = torch.from_numpy(maxmm).to(dev)
    close_p = torch.from_numpy(payload).to(dev)
    far_p = torch.from_numpy(fpayload).to(dev)
    win_p = torch.from_numpy(wpayload).to(dev)
    return {
        "close_both_ranges": (chromcat, close_p, maxmm_t,
                              dict(CLOSE, with_r1=True)),
        "close_range0": (chromcat, close_p, maxmm_t,
                         dict(CLOSE, with_r1=False)),
        "far_3_rounds": (chromcat, far_p, maxmm_t, FAR),
        "far_window": (chromcat, win_p, maxmm_t, FAR_WIN),
        **{f"far_round_{span}": (chromcat, far_p, maxmm_t,
                                 dict(FAR, spans=(span,), ws=(w,)))
           for span, w in zip(FAR["spans"], FAR["ws"]) if per_round},
    }


def with_plain_scan(fn):
    """``fn()`` with the plain scan in the kernel's place."""
    real = engine_fused.scan_rows
    engine_fused.scan_rows = scan_rows_ref
    try:
        return fn()
    finally:
        engine_fused.scan_rows = real


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


TAIL_SCENES = ("scene3", "scene4")
TAIL_SKEWED_READS = 4000


def largest_far_win_calls(dev):
    """The largest K4 call of each of TAIL_SCENES, recorded from one run of
    the scene through ``scenes.run_scene`` on ``dev``: name -> (chromcat,
    payload, maxmm, static)."""
    import tempfile

    from pindel_tpu_torch.testing import scenes
    real = engine_fused._far_win_kernel
    out = {}
    for scene in TAIL_SCENES:
        calls = []

        def record(chromcat, payload, maxmm, **static):
            calls.append((chromcat, payload.clone(), maxmm, static))
            return real(chromcat, payload, maxmm, **static)

        with tempfile.TemporaryDirectory(prefix=f"kernel_bench_{scene}_") \
                as d:
            t0 = time.monotonic()
            spec = scenes.SCENES[scene](d)
            log(f"{scene}: {spec.n} read pairs, built in "
                f"{time.monotonic() - t0:.1f} s")
            engine_fused._far_win_kernel = record
            try:
                scenes.run_scene(spec, os.path.join(d, "run"), dev)
            finally:
                engine_fused._far_win_kernel = real
        if not calls:
            raise RuntimeError(f"{scene}: no K4 call")
        out[f"{scene}_largest"] = max(calls, key=lambda c: c[1].shape[0])
        log(f"{scene}: {len(calls)} K4 calls, the largest "
            f"{out[f'{scene}_largest'][1].shape[0]} reads")
    return out


def in_turns(fns, timer):
    """name -> the least of two turns of ``timer(fn)``, the calls timed in
    the order given, then in the reverse order."""
    names = list(fns)
    times = {name: [] for name in names}
    for name in names + names[::-1]:
        times[name].append(timer(fns[name]))
    return {name: min(t) for name, t in times.items()}


def tail_row(cat, pay, mm, static, dev) -> dict:
    """One K4 call: ``measure.far_win_tail``'s figures and the whole
    wrapper's times (``_far_win_kernel``, the call as the backend makes it)
    on (a) the whole call, (b) its widest read, (c) the call without its
    widest 1%, in turns: with CUDA events around each call (``ms``, as the
    other K4 timings are taken) and on a card also queued behind a spin of
    the card (``device_ms``: the host's time to make the call hidden).
    Each subset's output is held against the plain version."""
    tail = measure.far_win_tail(cat, pay, mm, static)
    keep = torch.ones(pay.shape[0], dtype=torch.bool, device=pay.device)
    keep[tail["top_idx"]] = False
    subsets = {"whole": pay,
               "widest": pay[tail["widest"]:tail["widest"] + 1],
               "rest": pay[keep].contiguous()}
    row = {k: v for k, v in tail.items() if k != "top_idx"}
    fns = {sub: (lambda p=p: engine_fused._far_win_kernel(cat, p, mm,
                                                          **static))
           for sub, p in subsets.items()}
    correct = True
    for sub, p in subsets.items():
        want = with_plain_scan(
            lambda p=p: engine_fused._far_win_kernel_ref(cat, p, mm,
                                                         **static))
        same = torch.equal(fns[sub](), want)
        correct &= same
        row.update({f"{sub}_rows": int(p.shape[0]),
                    f"{sub}_equal_to_plain": same})
    timers = {"ms": lambda fn: measure.min_ms(fn, dev)}
    if dev.type == "cuda":
        timers["device_ms"] = lambda fn: measure.device_ms(fn, 10)
    for key, timer in timers.items():
        row.update({f"{sub}_{key}": t
                    for sub, t in in_turns(fns, timer).items()})
    b_ = measure.fused_bound("_far_win_kernel", cat, pay, mm, static)
    row.update(bound_ms=b_["bound_ms"], bound_by=b_["bound_by"],
               bound_share=b_["bound_ms"] / row["whole_ms"],
               equal_to_plain=correct)
    return row


def tail_line(name: str, row: dict, card: str) -> str:
    """``tail_row``'s figures on one line."""
    times = "; ".join(
        f"{k} (a) {row['whole_' + k]:.4f} (b) {row['widest_' + k]:.4f} "
        f"(c) {row['rest_' + k]:.4f}"
        for k in ("ms", "device_ms") if "whole_" + k in row)
    return (f"{name}: {row['reads']} reads, w={row['w']}, widths "
            f"{row['width']}, seeded lanes a lane {row['seeds_per_lane']}; "
            f"widest read {row['widest_share']:.2%} of the operations, the "
            f"widest {row['top_reads']} {row['top_share']:.2%}; floor of the "
            f"widest read at one warp a lane {row['floor_ms']:.4f} ms; "
            f"{times} ms; bound {row['bound_ms']:.4f} ms "
            f"({row['bound_share']:.1%} of (a)); equal to the plain "
            f"version: {row['equal_to_plain']}  [{card}]")


def far_win_tail(b: int, dev) -> dict:
    """``--far-win-tail``: ``tail_row`` of the largest K4 call of
    TAIL_SCENES, of this tool's K4 call and of the skewed cases."""
    from pindel_tpu_torch.testing.fused_cases import fused_case
    calls = largest_far_win_calls(dev)
    calls["far_window"] = call_args(*inputs(b), dev)["far_window"]
    for case in ("far_win_skewed", "far_win_skewed32768"):
        _n, chrom_c, maxmm_c, payload_c, st = fused_case(
            case, reads=TAIL_SKEWED_READS)
        calls[case] = (_chrom_cat(torch.from_numpy(chrom_c).to(dev)),
                       torch.from_numpy(payload_c).to(dev),
                       torch.from_numpy(maxmm_c.copy()).to(dev), st)
    result = {}
    for name, (cat, pay, mm, static) in calls.items():
        result[name] = tail_row(cat, pay, mm, static, dev)
        log(tail_line(name, result[name], measure.device_line(dev)))
    return dict(calls=result,
                correct=all(r["equal_to_plain"] for r in result.values()))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m pindel_tpu_torch.tools.kernel_bench",
        description=__doc__.splitlines()[0])
    ap.add_argument("b", nargs="?", type=int, default=16384,
                    help="rows per call (default 16384)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--per-round", action="store_true",
                    help="also time K3 over each of its rounds alone")
    ap.add_argument("--far-win-tail", action="store_true",
                    help="time K4's critical path (see above) instead")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    card = measure.device_line(dev)
    build_s = 0.0
    if dev.type == "cuda":
        t0 = time.monotonic()
        scan_cuda._lib()
        fused_cuda._lib()
        build_s = time.monotonic() - t0
    log(f"device: {card}; kernels built or loaded in {build_s:.3f} s")

    if args.far_win_tail:
        with torch.inference_mode():
            tail = far_win_tail(args.b, dev)
        print(json.dumps(dict(tool="kernel_bench", mode="far_win_tail",
                              b=args.b, device=card, build_s=build_s,
                              **tail)), flush=True)
        return 0 if tail["correct"] else 1

    host = inputs(args.b)
    result = {}
    correct = True
    with torch.inference_mode():
        for name, (cat, pay, mm, static) in call_args(
                *host, dev, args.per_round).items():
            kname = KERNELS.get(name, "_far_kernel")
            kernel = getattr(engine_fused, kname)
            fn = lambda: kernel(cat, pay, mm, **static)  # noqa: E731
            t0 = time.monotonic()
            fused_cuda.reset_launches()
            out = fn()
            measure.sync(dev)
            first_s = time.monotonic() - t0
            launches = fused_cuda.search_launches()
            ms = measure.min_ms(fn, dev)
            row = dict(rows=args.b, ms=ms, rows_per_s=args.b / ms * 1e3,
                       launches=launches, first_use_s=first_s)
            ref = lambda: REFS[kname](cat, pay, mm, **static)  # noqa: E731
            same = torch.equal(out, with_plain_scan(ref))
            b = measure.fused_bound(kname, cat, pay, mm, static)
            _out, scans, _rules = measure.composition_scans(
                kname, cat, pay, mm, static)
            row.update(parent_ms=measure.min_ms(ref, dev),
                       bound_ms=b["bound_ms"], bound_by=b["bound_by"],
                       earlier_bound_ms=b["composition_bound_ms"],
                       rows_scanned=b["rows_scanned"],
                       rows_all=b["rows_all"])
            k1_ms = sum(measure.min_ms(
                lambda a=a, kw=kw: engine_fused.scan_rows(*a, **kw), dev)
                for a, kw in scans)
            correct &= same
            row.update(k1_ms=k1_ms, k1_calls=len(scans),
                       bound_share=row["bound_ms"] / ms, equal_to_plain=same)
            result[name] = row
            log(f"{name} b={args.b}: {ms:.4f} ms ({args.b / ms * 1e3:.0f} "
                f"rows/s), the composition it replaced "
                f"{row['parent_ms']:.4f} ms, {len(scans)} scan calls "
                f"{k1_ms:.4f} ms, launches {launches}, bound "
                f"{row['bound_ms']:.4f} ms "
                f"({row['bound_share']:.1%}; earlier count "
                f"{row['earlier_bound_ms']:.4f} ms), equal to the plain "
                f"version: {same}  [{card}]")
    print(json.dumps(dict(
        tool="kernel_bench", b=args.b, calls=result, correct=correct,
        device=card, build_s=build_s,
        first_use_s=sum(c["first_use_s"] for c in result.values()))),
        flush=True)
    return 0 if correct else 1


if __name__ == "__main__":
    sys.exit(main())
