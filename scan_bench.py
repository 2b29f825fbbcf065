#!/usr/bin/env python3
"""Time builds of the CUDA scan kernel (csrc/scan.cu) in turns on one card.

Run from the repository root on a machine with an NVIDIA H100:

    python3 scan_bench.py [--parent DIR] [--sweep] [--out FILE]

Builds this checkout's kernel; with ``--parent DIR`` also the kernel of the
tree at DIR (an earlier commit unpacked there: the same C entry point); with
``--sweep`` also this checkout's kernel at other candidate slots per lane
and register caps (``SCAN_MAX_K``, ``SCAN_MIN_BLOCKS``).  For each shape of
``SHAPES`` it holds every build bit-equal to the plain version on the card,
then times the builds in turns (in order, then reversed, ``ROUNDS`` times;
CUDA events, the mean of ``REPS`` launches) beside the shape's bound
(``chip_smoke.scan_bound``).  It prints a line per shape and build with the
card's name and power limit, and the JSON of every time as its last line
(also written to ``--out``).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
ROUNDS = 2
REPS = 10
# (label, seed, w, lmax, rows, lsteps, full): ``full_window_case`` (as on
# the main path, without its padding rows), else chip_smoke.random_case
SHAPES = [
    ("scene 1's largest", 30, 1536, 128, 65536, 112, True),
    ("close range 0", 31, 512, 128, 16384, 112, True),
    ("scene 2's largest", 32, 1536, 128, 16384, 112, True),
    ("a small close launch", 33, 2048, 128, 512, 112, True),
    ("K4's widest bucket, 256 reads", 34, 98304, 128, 512, 112, True),
    # chip_smoke.RANDOM_CASES 10-16: the extremes at their row counts
    ("w=8192, 24 rows", 10, 8192, 128, 24, 112, False),
    ("w=32768, 8 rows", 11, 32768, 128, 8, 112, False),
    ("w=65536, 4 rows", 12, 65536, 128, 4, 112, False),
    ("lmax 1024, 64 rows", 13, 2048, 1024, 64, 0, False),
    ("w=65536 lmax 1024, 2 rows", 14, 65536, 1024, 2, 0, False),
    ("w=98304, 2 rows", 15, 98304, 128, 2, 112, False),
    ("w=4096, 1280 rows", 16, 4096, 128, 1280, 112, False),
]
# the lines of nvcc's -Xptxas -v that are kept (per kernel instantiation)
PTXAS_KEYS = ("entry function", "registers", "spill")
# --sweep: (SCAN_MAX_K, SCAN_MIN_BLOCKS) beside this checkout's defaults
SWEEP = [(4, 24), (8, 24), (6, 16), (6, 32), (8, 16)]


def log(msg: str) -> None:
    print(msg, flush=True)


def start_build(source: str, out: str, defines=()):
    """nvcc of one scan source into ``out``, started (not waited for)."""
    from pindel_tpu_torch.ops import scan_cuda
    cmd = [scan_cuda.nvcc(), *scan_cuda.NVCC_FLAGS, "-Xptxas", "-v",
           *[f"-D{d}" for d in defines], "-o", out, source]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def full_window_case(seed, w, lmax, rows, dev):
    """Aligned inputs as the main path gives them: tiles and 100-base reads
    of A/C/G/T (no N), every window full (valid_w = w), every third read an
    exact hit at its window start."""
    from pindel_tpu_torch.testing.scan_cases import tile_width
    rng = np.random.default_rng(seed)
    tiles = rng.integers(0, 4, (rows, tile_width(w, lmax))).astype(np.int8)
    qq = rng.integers(0, 4, (rows, lmax)).astype(np.int8)
    valid_w = np.full(rows, w, np.int32)
    qlen = np.full(rows, 100, np.int32)
    thr = rng.integers(0, 12, rows).astype(np.int32)
    off = rng.integers(0, 128, rows).astype(np.int32)
    for i in range(0, rows, 3):
        qq[i, :100] = tiles[i, off[i]:off[i] + 100]
    return [torch.from_numpy(a).to(dev)
            for a in (tiles, qq, valid_w, qlen, thr, off)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=None,
                    help="another tree whose csrc/scan.cu is timed too")
    ap.add_argument("--sweep", action="store_true",
                    help="also time this kernel at the SWEEP settings")
    ap.add_argument("--out", default=None, help="write the JSON here too")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("scan_bench: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from chip_smoke import (card_line, random_case, row_classes,
                            scan_bound, time_ms)
    from pindel_tpu_torch.ops import scan_cuda
    from pindel_tpu_torch.ops.scan import scan_rows_ref

    card = card_line()
    own = scan_cuda.SOURCE
    sources = {"this": (own, ())}
    if args.parent:
        sources["parent"] = (os.path.join(args.parent, "pindel_tpu_torch",
                                          "csrc", "scan.cu"), ())
    if args.sweep:
        for k, blocks in SWEEP:
            sources[f"K{k} blocks{blocks}"] = (
                own, (f"SCAN_MAX_K={k}", f"SCAN_MIN_BLOCKS={blocks}"))
    result = dict(card=card, builds={}, shapes=[])
    libs = {}
    with tempfile.TemporaryDirectory(prefix="scan_bench_") as tmp:
        procs = {}
        for i, (name, (src, defines)) in enumerate(sources.items()):
            out = os.path.join(tmp, f"lib{i}.so")
            procs[name] = (out, start_build(src, out, defines))
        for name, (out, proc) in procs.items():
            _, err = proc.communicate()
            if proc.returncode != 0:
                print(f"scan_bench: nvcc failed for {name}:\n{err}",
                      file=sys.stderr)
                return 1
            ptxas = [line.strip() for line in err.splitlines()
                     if any(k in line for k in PTXAS_KEYS)]
            result["builds"][name] = dict(source=sources[name][0],
                                          defines=list(sources[name][1]),
                                          ptxas=ptxas)
            log(f"build {name}: {sources[name][1] or 'defaults'}")
            for line in ptxas:
                log(f"  ptxas: {line}")
            libs[name] = scan_cuda.load(out)

    dev = torch.device("cuda")
    names = list(libs)
    try:
        for label, seed, w, lmax, rows, lsteps, full in SHAPES:
            case = (full_window_case(seed, w, lmax, rows, dev) if full
                    else random_case(seed, w, lmax, rows, True, dev))
            kw = dict(w=w, lmax=lmax, mpm=3, lsteps=lsteps)
            want = scan_rows_ref(*case, **kw)
            for name in names:
                scan_cuda._LIB = libs[name]
                got = scan_cuda.scan_rows_cuda(*case, **kw)
                if any(not torch.equal(g, r) for g, r in zip(got, want)):
                    print(f"scan_bench: build {name} disagrees with the "
                          f"plain version on {label}", file=sys.stderr)
                    return 1
            del want
            seeds, sparse = row_classes(case, kw)
            bound, bound_by, _ = scan_bound(case, kw, seeds, sparse)
            times = {name: [] for name in names}
            for rnd in range(ROUNDS):
                for name in (names if rnd % 2 == 0 else names[::-1]):
                    scan_cuda._LIB = libs[name]
                    times[name].append(time_ms(
                        lambda: scan_cuda.scan_rows_cuda(*case, **kw), REPS))
            result["shapes"].append(dict(
                label=label, w=w, lmax=lmax, rows=rows, lsteps=lsteps or lmax,
                full_windows=full, sparse_rows=int(sparse.sum()),
                mean_seeds=float(seeds.double().mean()), bound_ms=bound,
                bound_by=bound_by, ms=times))
            for name in names:
                ms = sum(times[name]) / ROUNDS
                log(f"{label} (w={w} lmax={lmax} rows={rows}): {name} "
                    f"{' / '.join(f'{t:.4f}' for t in times[name])} ms, "
                    f"bound {bound:.4f} ms ({bound_by}), {bound / ms:.1%} "
                    f"of it, bit-equal to plain  [{card}]")
            del case
            torch.cuda.empty_cache()
    finally:
        scan_cuda._LIB = None
    line = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    log(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
