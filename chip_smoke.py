#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (pindel_tpu_torch) on one GPU.

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py [--profile-dir DIR]

Phases, in order; any failure exits non-zero:

1. environment: torch, CUDA and nvcc versions, the card's name and power
   limit, the host's CPU model and core count;
2. build: the CUDA scan kernel (csrc/scan.cu) from the checkout's sources;
3. kernel against its plain PyTorch version, both on the card, bit for bit,
   on random cases and the extremes (w = 32768 and 65536, lmax = 1024);
4. the CLI on small simulated scenes: reports byte-identical to the golden
   files that pindel_tpu's NumPy backend wrote for them
   (pindel_tpu_torch/testing/golden_reports.json, kept current by
   tests/test_torch_pipeline.py);
5. scene 1 of bench.py at full size (50,000 reads over a 6 Mb chromosome,
   -T 4): a first run that records every scan call the main path makes, a
   run with the plain scan in place of the kernel, then three timed runs
   whose reports must be byte-identical to the plain run's (median wall
   time, reads/s, fallback ratio, launches, phase timers); then every
   recorded scan call is held against the plain version and each shape is
   timed.

The script imports torch, numpy and pindel_tpu_torch, and no jax.
``--profile-dir`` also traces one scene-1 run with torch.profiler and
writes the kernel table there.  The last line of standard output is the
JSON result.
"""
from __future__ import annotations

import argparse
import json
import os
import platform
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
MAX_FALLBACK = 0.01
TIMED_RUNS = 3


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return res.stdout.strip().splitlines()[0]


def host_line() -> str:
    """The host's name, CPU (as far as /proc/cpuinfo names it) and cores."""
    fields = {}
    with open("/proc/cpuinfo") as fh:
        for line in fh:
            if not line.strip():
                break                       # the first processor only
            key, _, value = line.partition(":")
            fields[key.strip()] = value.strip()
    cpu = ", ".join(f"{k} {fields[k]}" for k in
                    ("vendor_id", "cpu family", "model", "model name",
                     "cpu MHz") if fields.get(k)) or "CPU not named"
    return (f"{platform.node()}: {cpu}; torch CPU capability "
            f"{torch.backends.cpu.get_cpu_capability()}; {os.cpu_count()} "
            f"cores, {len(os.sched_getaffinity(0))} usable")


# ------------------------------------------------------------ scan inputs
def random_case(seed, w, lmax, rows, aligned, device):
    """Random scan inputs (tiles, qq, valid_w, qlen, thr[, off]); aligned
    tiles are built as _scan_lanes builds them (T = 128 * (ceil((w + lmax)
    / 128) + 1), window start off in [0, 128)); every third row embeds an
    exact hit so real chains emit."""
    rng = np.random.default_rng(seed)
    t = 128 * (-(-(w + lmax) // 128) + 1) if aligned else w + lmax
    tiles = rng.integers(0, 5, (rows, t)).astype(np.int8)
    qq = rng.integers(0, 5, (rows, lmax)).astype(np.int8)
    qlen = rng.integers(20, lmax + 1, rows).astype(np.int32)
    valid_w = rng.integers(0, w + 1, rows).astype(np.int32)
    thr = rng.integers(0, 12, rows).astype(np.int32)
    off = (rng.integers(0, 128, rows) if aligned
           else np.zeros(rows, np.int64)).astype(np.int32)
    for i in range(0, rows, 3):
        n = int(qlen[i])
        qq[i, :n] = tiles[i, off[i]:off[i] + n]
    args = [tiles, qq, valid_w, qlen, thr] + ([off] if aligned else [])
    return [torch.from_numpy(a).to(device) for a in args]


RANDOM_CASES = [
    # (seed, w, lmax, rows, lsteps, aligned)
    (0, 128, 128, 64, 0, False), (1, 512, 128, 300, 0, False),
    (2, 2048, 128, 17, 0, False),
    (3, 128, 128, 192, 112, True), (4, 192, 128, 192, 64, True),
    (5, 512, 128, 192, 112, True), (6, 768, 128, 192, 128, True),
    (7, 1536, 128, 192, 112, True), (8, 256, 256, 192, 0, True),
    (9, 512, 256, 192, 144, True), (10, 8192, 128, 24, 112, True),
    # extremes: the widest window buckets and the longest reads
    (11, 32768, 128, 8, 112, True), (12, 65536, 128, 4, 112, True),
    (13, 2048, 1024, 64, 0, True), (14, 65536, 1024, 2, 0, True),
]


def compare(args, kw, scan_cuda, scan_rows_ref) -> int:
    """Kernel vs plain version on the same CUDA inputs; returns the max
    absolute difference (0 when bit-equal)."""
    got = scan_cuda.scan_rows_cuda(*args, **kw)
    torch.cuda.synchronize()
    want = scan_rows_ref(*args, **kw)
    torch.cuda.synchronize()
    err = 0
    for g, r in zip(got, want):
        err = max(err, int((g.long() - r.long()).abs().max().item()))
    return err


def time_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def run_cli(port_main, argv) -> float:
    """One run of the port's CLI; returns its wall seconds, card work
    included."""
    t0 = time.monotonic()
    rc = port_main(argv)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    if rc != 0:
        fail(f"CLI {argv} returned {rc}")
    return wall


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile-dir", default=None,
                    help="also trace a scene-1 run with torch.profiler and "
                         "write its kernel table here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this needs a CUDA card")
    sys.path.insert(0, REPO)
    from pindel_tpu_torch.__main__ import main as port_main
    from pindel_tpu_torch.ops import engine_fused, scan_cuda
    from pindel_tpu_torch.ops.scan import scan_rows_ref
    from pindel_tpu_torch.pipeline import g_fallback, g_timer
    from pindel_tpu_torch.testing.scenes import (SCENE1, SCENE1_FLAGS,
                                                 SMALL_SCENES, load_golden,
                                                 reports, write_scene)

    # ---- 1. environment
    card = card_line()
    name = torch.cuda.get_device_name(0)
    nvcc = subprocess.run([scan_cuda.nvcc(), "--version"],
                          capture_output=True, text=True, check=True)
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}  devices {torch.cuda.device_count()}")
    log("nvcc: " + nvcc.stdout.strip().splitlines()[-1])
    log(f"card: {card}")
    log(f"host: {host_line()}")

    # ---- 2. build
    t0 = time.monotonic()
    info = scan_cuda.build(force=True, ptxas_info=True)
    log(f"build: scan kernel built in {time.monotonic() - t0:.3f} s")
    for line in info.splitlines():
        if "registers" in line or "spill" in line:
            log("  ptxas: " + line.strip())

    dev = torch.device("cuda")
    max_err = 0
    # ---- 3. kernel vs plain: random cases and extremes
    for seed, w, lmax, rows, lsteps, aligned in RANDOM_CASES:
        case = random_case(seed, w, lmax, rows, aligned, dev)
        kw = dict(w=w, lmax=lmax, mpm=3, lsteps=lsteps)
        err = compare(case, kw, scan_cuda, scan_rows_ref)
        log(f"kernel vs plain: w={w} lmax={lmax} rows={rows} "
            f"lsteps={lsteps or lmax} aligned={aligned} max_abs_err={err}")
        max_err = max(max_err, err)
    if max_err:
        fail(f"kernel disagrees with its plain version (max {max_err})")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        # ---- 4. the CLI on small scenes vs the golden NumPy reports
        golden = load_golden()
        for scene, (scene_kw, flags, _fields) in SMALL_SCENES.items():
            d = os.path.join(work, scene)
            os.makedirs(d)
            fa, reads_txt, n = write_scene(d, **scene_kw)
            scan_cuda.LAUNCHES = 0
            run_cli(port_main, ["-f", fa, "-p", reads_txt,
                                "-o", os.path.join(d, "port"), "-s", *flags])
            launches = scan_cuda.LAUNCHES
            port = reports(os.path.join(d, "port"))
            want = golden[scene]
            if set(want) != set(port):
                fail(f"scene {scene}: report sets differ "
                     f"{sorted(set(want) ^ set(port))}")
            diff = [k for k in want if want[k] != port[k]]
            if diff:
                fail(f"scene {scene}: reports differ from numpy: {diff}")
            if not port["CloseEndMapped"]:
                fail(f"scene {scene}: no close end mapped")
            if launches == 0:
                fail(f"scene {scene}: the scan kernel never launched")
            if g_fallback.ratio() > MAX_FALLBACK:
                fail(f"scene {scene}: fallback ratio {g_fallback.ratio()}")
            log(f"small scene {scene} {flags}: {n} reads, {len(port)} "
                f"reports byte-identical to numpy, launches={launches}, "
                f"fallback {g_fallback.fallback}/{g_fallback.total}")

        # ---- 5. scene 1 at full size
        s1 = os.path.join(work, "scene1")
        os.makedirs(s1)
        t0 = time.monotonic()
        fa1, reads1, n1 = write_scene(s1, **SCENE1)
        log(f"scene 1: {n1} reads over {SCENE1['chrom_len']} bp, built in "
            f"{time.monotonic() - t0:.1f} s")
        base = ["-f", fa1, "-p", reads1, *SCENE1_FLAGS]

        def out(run: str) -> str:
            return os.path.join(s1, run)

        # 5a. first run (cold): record every scan call of the main path
        calls = []
        kernel_scan = engine_fused.scan_rows

        def recording(*a, **kw):
            calls.append(([x.clone() for x in a], dict(kw)))
            return kernel_scan(*a, **kw)

        engine_fused.scan_rows = recording
        first_s = run_cli(port_main, base + ["-o", out("rec")])
        # 5b. the plain scan in the kernel's place: the reference reports
        engine_fused.scan_rows = scan_rows_ref
        before = scan_cuda.LAUNCHES
        plain_s = run_cli(port_main, base + ["-o", out("plain")])
        engine_fused.scan_rows = kernel_scan
        if scan_cuda.LAUNCHES != before:
            fail("scene 1: the plain-scan run launched the kernel")
        want = reports(out("plain"))
        if b"ChrID" not in want.get("D", b""):
            fail("scene 1: no deletion reported")
        if reports(out("rec")) != want:
            fail("scene 1: the first kernel run's reports differ from the "
                 "plain-scan run's")
        log(f"scene 1: first run {first_s:.3f} s ({len(calls)} scan calls "
            f"recorded), plain-scan run {plain_s:.3f} s  [{card}]")

        # 5c. timed runs through the kernel
        runs = []
        for i in range(TIMED_RUNS):
            scan_cuda.LAUNCHES = 0
            torch.cuda.reset_peak_memory_stats()
            wall = run_cli(port_main, base + ["-o", out(f"run{i}")])
            launches = scan_cuda.LAUNCHES
            runs.append(dict(wall=wall, launches=launches,
                             phases=g_timer.items(),
                             fallback=(g_fallback.fallback, g_fallback.total,
                                       g_fallback.ratio()),
                             peak=torch.cuda.max_memory_allocated()))
            if launches == 0:
                fail(f"scene 1 run {i}: the scan kernel never launched")
            if g_fallback.ratio() > MAX_FALLBACK:
                fail(f"scene 1 run {i}: fallback ratio {g_fallback.ratio()}")
            if reports(out(f"run{i}")) != want:
                fail(f"scene 1 run {i}: reports differ from the plain-scan "
                     f"run's")
            log(f"scene 1 run {i}: wall {wall:.3f} s, {n1 / wall:.1f} "
                f"reads/s, scan launches {launches}  [{card}]")
        if len({r["launches"] for r in runs}) != 1:
            fail(f"scene 1: launch counts differ between runs "
                 f"{[r['launches'] for r in runs]}")
        walls = [r["wall"] for r in runs]
        med = runs[walls.index(statistics.median(walls))]
        fb, total, ratio = med["fallback"]
        log(f"scene 1: median wall {med['wall']:.3f} s of {TIMED_RUNS} "
            f"({n1 / med['wall']:.1f} reads/s), reports byte-identical to "
            f"the plain-scan run, fallback {fb}/{total} = {ratio:.6f}, scan "
            f"launches {med['launches']}, peak device memory "
            f"{med['peak'] / 2 ** 20:.1f} MiB  [{card}]")
        for pname, sec in sorted(med["phases"].items(),
                                 key=lambda kv: -kv[1]):
            log(f"  phase {pname:<52s} {sec:9.3f} s  [{card}]")

        # 5d. every recorded main-path call: kernel vs plain, time per shape
        timings = {}
        for cargs, kw in calls:
            err = compare(cargs, kw, scan_cuda, scan_rows_ref)
            max_err = max(max_err, err)
            rows, t = cargs[0].shape
            shape = (kw["w"], kw["lmax"], kw["lsteps"], rows)
            if shape in timings:
                continue
            ms = time_ms(lambda: scan_cuda.scan_rows_cuda(*cargs, **kw), 10)
            plain = time_ms(lambda: scan_rows_ref(*cargs, **kw), 2)
            timings[shape] = dict(rows=rows, lanes=t - kw["lmax"], ms=ms,
                                  plain_ms=plain)
            log(f"scan w={kw['w']} lmax={kw['lmax']} lsteps={kw['lsteps']} "
                f"rows={rows}: kernel {ms:.4f} ms, plain {plain:.3f} ms, "
                f"max_abs_err={err}  [{card}]")
        log(f"kernel vs plain on all {len(calls)} scene-1 scan calls: "
            f"max_abs_err={max_err}")
        if max_err:
            fail(f"kernel disagrees with its plain version on main-path "
                 f"inputs (max {max_err})")
        if not calls:
            fail("the main path made no scan call")
        del calls
        torch.cuda.empty_cache()

        if args.profile_dir:
            from torch.profiler import ProfilerActivity, profile
            os.makedirs(args.profile_dir, exist_ok=True)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                prof_wall = run_cli(port_main, base + ["-o", out("prof")])
            table = prof.key_averages().table(sort_by="cuda_time_total",
                                              row_limit=40)
            path = os.path.join(args.profile_dir, "scene1_profile.txt")
            with open(path, "w") as fh:
                fh.write(f"{card}\nwall under profiler {prof_wall:.3f} s\n")
                fh.write(table)
            log(f"profile: {path} (wall under profiler {prof_wall:.3f} s)")

    if "jax" in sys.modules:
        fail("jax was imported")
    main_shape = max(timings.values(), key=lambda t: t["rows"] * t["lanes"])
    log(f"scan timing reported at the main path's largest shape: "
        f"{main_shape['lanes']} lanes x {main_shape['rows']} rows")
    kernels = [dict(name="scan_rows", route="cuda",
                    source="pindel_tpu_torch/csrc/scan.cu",
                    replaces="pindel_tpu/ops/pallas_scan.py:76",
                    launches=med["launches"], max_abs_err=max_err,
                    ms=main_shape["ms"], plain_ms=main_shape["plain_ms"])]
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
