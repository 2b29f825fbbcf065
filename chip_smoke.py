#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (pindel_tpu_torch) on one GPU.

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py [--profile-dir DIR]

Phases, in order; any failure exits non-zero:

0. the port's imports load no module of the JAX package (``pindel_tpu``)
   and no jax (checked again at the end);
1. environment: torch, CUDA and nvcc versions, the card's name and power
   limit, the host's CPU model and core count;
2. build: the CUDA scan kernel (csrc/scan.cu) and the shard kernel of the
   window-parallel search (csrc/sharded_search.cu) from the checkout's
   sources, one nvcc for each, started together;
3. kernel against its plain PyTorch version, both on the card, bit for bit,
   on random cases and the extremes (w = 32768, 65536 and 98304, lmax =
   1024), then on rows built for each branch of the kernel
   (testing/scan_cases.py): 0, 1 and 2 seeds, q[0] = N, windows of 0 and
   1 lanes, seeds at the window's edges and at WE - 1, all-seeded rows at
   w = 1536 and 32768, many seeds with valid_w > w and with qlen above the
   dead level (lmax 1024), and the widest bucket (98304) with both branches
   in one call;
3b. the legacy per-lane backend (ops/engine_jax.py) on the card against the
   same backend on the CPU, on two-region BreakDancer-style lanes at the
   window buckets 2048, 8192 and 32768: equal anchors and mismatch counts;
   then the largest batch it takes in one call (8,192 reads x 4 lanes at
   w = 32768), timed, with its peak device memory and its bound
   (``legacy_bound``), and held against the CPU on a sample of its reads;
4. the CLI on small simulated pindel-text scenes: reports byte-identical to
   the golden files that pindel_tpu's NumPy backend wrote for them
   (pindel_tpu_torch/testing/golden_reports.json, kept current by
   tests/test_torch_pipeline.py and tests/test_torch_bam.py);
4b. the CLI on small BAM scenes (BAM + BreakDancer discovery, -q, -z, -g):
   reports byte-identical to the golden files, the scan kernel launched,
   the explicit-window kernel's rows above 0 where evidence windows guide
   the search, and the native BAM and RP libraries loaded from
   pindel_tpu_torch/build/native/;
5. scene 1 of bench.py at full size (50,000 reads over a 6 Mb chromosome,
   -T 4) and 6. scene 2 (BAM input with a BreakDancer calls file: 12,000
   read pairs over a 2 Mb chromosome, -T 4), each: a first run that
   records every scan call the main path makes, a run with the plain scan
   in place of the kernel, then three timed runs whose reports must be
   byte-identical to the plain run's (scene 2's also to the reference's
   sha256 digests in pindel_tpu_torch/testing/scene2_digests.json), with
   the median wall time, rate, fallback ratio, launches and phase timers;
   then every recorded scan call is held against the plain version, its
   rows are classed by seed count (the kernel walks only the seeded lanes
   of a row with two or more seeds, every lane of the others), each shape
   is timed, and each call's kernel time is split between the two
   branches' rows;
7. scenes 1 and 2 with ``--backend mesh`` (the data-parallel backend,
   parallel/mesh_fused.py), over all visible cards (the CLI) and over
   ``["cuda:0", "cuda:0"]`` (two shards on one card, through
   ``run_files``): for each device list a first run that records every
   shard's scan calls, each then held against the plain version on the
   card it ran on and each shard shape timed; then three timed runs of
   each list in turns with three fused runs (fused, mesh, mesh, then the
   reverse), every listed card launching the kernel, reports
   byte-identical to the kernel runs of 5 and 6 (scene 2's also to the
   digests), with the median wall time, rate, scan launches per card and
   phase timers of each;
8. multi-process window sharding (``--hosts``, parallel/multihost.py),
   through ``run_files_multihost`` in this process as rank 0 (its workers
   are fresh interpreters, each on the card ``rank_devices`` gives it):
   a. scene 1 at its own flags (two windows, 5 Mb and 1 Mb, one per rank)
      at ``--hosts 2``, once with ``--dist files`` and once with
      ``store``: reports byte-identical to the kernel runs of 5, rank 0's
      recorded scan calls held against the plain version on the card, and
      every rank that owned a window launched the kernel on its own card;
   b. scene 2 at ``--hosts 2`` (one window: rank 1 owns none): reports
      byte-identical to phase 6 and to the digests;
   c. timed runs in turns, median of three: scene 1 at ``-w 1`` (six
      windows) at ``--hosts`` 1, 2 and 3 (files), scene 2 at ``-w 0.5``
      (four windows) at ``--hosts`` 1 and 2 (store); the multi-process
      reports equal the one-process ones; the wall and rate of each, and
      each rank's devices, windows, launches, memory, wall and time from
      its spawn to its first shipped window;
9. the window-parallel search (K9, parallel/mesh.py), which no CLI reaches:
   a. the shard kernel against its plain twin, bit for bit, on every case
      of testing/shard_cases.py (DEAD and 2^30 representatives, clamped
      shard tiles, backward lanes, strict mismatches next to step 0,
      columns past 32768) and random rows, every shard at wp 1, 2, 4, 8;
   b. ``TorchShardedBackend`` under a ``Searcher`` on a small scene against
      the NumPy oracle, over ``["cuda:0"] * 8`` at (dp, wp) = (2, 4),
      (1, 8), (4, 2) and over every visible card;
   c. phase 3b's full batch at (1, 1) and (1, 4) over cuda:0: anchors
      equal to K8's, its sampled reads equal to the twin's; every kernel
      call held against the twin over all its rows, timed, with its bound
      (``shard_bound``), the wall, launches and peak memory;
   d. ``--backend numpy`` and ``--backend jax`` on the 16 small scenes
      against the golden reports.

The script imports torch, numpy and pindel_tpu_torch, and no jax.
``--profile-dir`` also traces one run of each full-size scene with
torch.profiler and writes the kernel tables there.  The last line of standard output is the
JSON result.
"""
from __future__ import annotations

import argparse
import concurrent.futures
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
# phase 7: the device lists of the mesh runs (None: every visible card)
MESH_LISTS = {"all": None, "cuda0x2": ["cuda:0", "cuda:0"]}
# phase 8c: (label, scene, extra flags, --dist, the --hosts values in turn)
HOSTS_TIMED = [("scene1", "scene 1", ["-w", "1"], "files", (1, 2, 3)),
               ("scene2", "scene 2", ["-w", "0.5"], "store", (1, 2))]
# the timer phases phase 8c prints for each rank
HOSTS_PHASES = ("Matching close ends", "multihost: wait for worker windows",
                "Searching far ends", "Searching and reporting variations")
# phase 9: the window-parallel search (K9).  int32 operations of the shard
# kernel (csrc/sharded_search.cu) as it does the work: per candidate of its
# columns the seed test (the lane and column split, the key, the tile
# position, the byte load, the valid-column and seed compares); per step
# that a seeded candidate walks (to the step that kills it, or the last):
# the tile byte load, the strict compare, the N compare, the xor and add to
# its count, the last-mismatch select, the death compare, the level slot's
# address, the count atomic, the key-level compare, the strict bit's compare
# and or, the key atomic
SHARD_SEED_OPS = 7
SHARD_STEP_OPS = 13
# the grids of the backend runs over ["cuda:0"] * 8, and the wp of the
# full-width runs over cuda:0 (dp = 1)
SHARD_GRIDS = [(2, 4), (1, 8), (4, 2)]
SHARD_FULL_WP = (1, 4)
SHARD_PLAIN_ROWS = 512      # rows per call of the plain twin at full width
# what each path of the kernels line gives of its scan calls
SCAN_KEYS = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "bound_dense_ms")


def reference_modules():
    """Loaded modules of the JAX package or of jax."""
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("pindel_tpu", "jax", "jaxlib"))


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
    # the widest bucket an evidence window can take (w + lmax <= spacer)
    (15, 98304, 128, 2, 112, True),
    # rows split between two warps: a launch that fills a 132-SM card at
    # two warps per row (on such a card cases 1, 10 and 13 give each warp
    # of a row one segment; cases 11, 12, 14 and 15 have eight warps stride
    # a row's 2,176-lane segments)
    (16, 4096, 128, 1280, 112, True),
]
# rows built for the kernel's branches: (label, seed, w, lmax, lsteps, kinds)
BRANCH_CASES = [
    ("every row kind", 20, 512, 128, 112, None),
    ("every row kind, lmax 256", 21, 512, 256, 0, None),
    ("all seeded", 22, 1536, 128, 112, ("all",) * 8 + ("random",) * 8),
    ("all seeded", 23, 32768, 128, 112, ("all", "all", "random", "seeds1")),
    ("widest bucket, both branches", 24, 98304, 128, 112,
     ("random", "all", "vw0", "seeds1", "seeds2", "q0_n", "wide")),
    # many seeds, but the seeded keys collide (valid_w > w) or pass the
    # dead level (qlen > dead): the kernel must walk every lane
    ("many seeds, valid_w > w", 25, 512, 128, 112,
     ("wide",) * 4 + ("random",) * 4),
    ("many seeds, qlen > dead", 26, 2048, 1024, 0,
     ("long",) * 4 + ("random",) * 4),
]
# two-region lanes for the legacy backend: scale -> window bucket
LEGACY_SCALES = {1: 2048, 8: 8192, 40: 32768}
# the largest batch the legacy path takes in one call (MAX_CHUNK reads x 4
# lanes at w = 32768), held against the CPU on LEGACY_SAMPLE of its reads
LEGACY_FULL_SCALE = 40
LEGACY_SAMPLE = 32
# int32 operations per candidate and step of the legacy scan (K8) as its
# torch statement does them (ops/engine_jax.py:_search_kernel): mismatch
# test, N flip, add, last-mismatch update, end capture, level (budget test,
# and, select), budget select and min, compare and count at the min, compare
# and count under the runner-up limit, argmax (convert and compare)
LEGACY_OPS = 17


def compare(args, kw, kernel, plain) -> int:
    """Kernel vs plain version on the same CUDA inputs; returns the max
    absolute difference (0 when bit-equal)."""
    got = kernel(*args, **kw)
    torch.cuda.synchronize()
    want = plain(*args, **kw)
    torch.cuda.synchronize()
    err = 0
    for g, r in zip(got, want):
        err = max(err, int((g.long() - r.long()).abs().max().item()))
    return err


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


def legacy_bound(chrom, lanes, w: int, lmax: int):
    """The least time the card could take for ``TorchLaneBackend.run`` over
    ``lanes`` at window bucket ``w`` and ``lmax``: LEGACY_OPS int32
    operations per seeded candidate (a valid offset whose reference base is
    the query's first, as the kernel's tile is read) and per step 1..qlen-1
    of its read, at PEAK_INT32_OPS, or the tiles and queries read and the
    packed output written once at PEAK_BYTES, whichever is longer.  Returns
    (ms, "operations" or "bytes", and the count from the shapes alone: every
    candidate of the [B, NL, W] state for lmax steps, in ms)."""
    from pindel_tpu_torch import dna
    seq = np.asarray(chrom.seq)
    nl = max(len(read_lanes) for read_lanes in lanes)
    ops = 0.0
    for read_lanes in lanes:
        steps = max(len(read_lanes[0].query) - 1, 0)
        for lane in read_lanes:
            valid = min(max(lane.end - lane.start, 0), w)
            if lane.forward:
                q0, ref = lane.query[0], seq[lane.start:lane.start + valid]
            else:
                q0, ref = lane.query[-1], seq[lane.end - valid:lane.end]
            if q0 != dna.N:
                ops += float(np.count_nonzero(ref == q0)) * steps * LEGACY_OPS
    b = len(lanes)
    nbytes = b * nl * (w + 2 * lmax) + b * (5 * lmax + 2)
    t_ops, t_bytes = ops / PEAK_INT32_OPS, nbytes / PEAK_BYTES
    dense = b * nl * w * lmax * LEGACY_OPS / PEAK_INT32_OPS
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes",
            max(dense, t_bytes) * 1e3)


def shard_work(cnt):
    """(seeded candidates, steps they walk) of one shard kernel call, from
    its counts: every live seeded candidate is at level 0 at step 0 and
    walks steps 1.. until the step that kills it or the last step."""
    alive = cnt[:, :, :-1].sum(dim=2, dtype=torch.int64)
    dead = cnt[:, :, -1].long()
    return (int(alive[:, 0].sum()),
            int(alive[:, 1:].sum()) + int((dead[:, -1] - dead[:, 0]).sum()))


def shard_bound(args, kw, out):
    """The least time the card could take for one shard kernel call: its
    int32 operations (SHARD_SEED_OPS per candidate of its columns,
    SHARD_STEP_OPS per step a seeded candidate walks, counted from this
    call's output) at PEAK_INT32_OPS, or its bytes (each lane's tile span
    of the chromosome and every other input read once, the partials written
    once) at PEAK_BYTES, whichever is longer.  Returns (ms, "operations" or
    "bytes", seeded candidates, walked steps)."""
    _chrom, slice_start, reverse, qq, valid_w, max_snp, tsec_minus = args
    b, nl = slice_start.shape
    cands = b * nl * kw["w_local"]
    seeded, walked = shard_work(out[0])
    ops = cands * SHARD_SEED_OPS + walked * SHARD_STEP_OPS
    nbytes = (b * nl * (kw["w_local"] + kw["lmax"])
              + sum(x.numel() * x.element_size()
                    for x in (slice_start, reverse, qq, valid_w, max_snp,
                              tsec_minus))
              + sum(o.numel() * o.element_size() for o in out))
    t_ops, t_bytes = ops / PEAK_INT32_OPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", seeded, walked)


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


def prefix_of(argv) -> str:
    """The output prefix (-o) of a CLI argument list."""
    return argv[argv.index("-o") + 1]


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
                    help="also trace a run of each full-size scene with "
                         "torch.profiler and write its kernel table here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this needs a CUDA card")
    sys.path.insert(0, REPO)
    from pindel_tpu_torch import native
    from pindel_tpu_torch.__main__ import build_parser, settings_from_args
    from pindel_tpu_torch.__main__ import main as port_main
    from pindel_tpu_torch.ops import (engine_fused, engine_jax, scan_cuda,
                                      sharded_search_cuda)
    from pindel_tpu_torch.ops.scan import scan_rows_ref
    from pindel_tpu_torch.testing.scan_cases import KINDS, branch_case
    from pindel_tpu_torch.pipeline import g_fallback, g_timer, run_files
    from pindel_tpu_torch.testing.scenes import (BAM_SCENES, SCENE1,
                                                 SCENE1_FLAGS, SCENE2,
                                                 SMALL_SCENES, bam_argv,
                                                 digests, legacy_anchors,
                                                 load_golden,
                                                 load_scene2_digests,
                                                 reports, sharded_anchors,
                                                 two_region_lanes,
                                                 write_scene)

    # ---- 0. the port stands on its own
    loaded = reference_modules()
    if loaded:
        fail(f"the port's imports loaded {loaded}")
    log("imports: no module of pindel_tpu or jax loaded")

    # ---- 1. environment
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    nvcc = subprocess.run([scan_cuda.nvcc(), "--version"],
                          capture_output=True, text=True, check=True)
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}  devices {torch.cuda.device_count()}")
    log("nvcc: " + nvcc.stdout.strip().splitlines()[-1])
    log(f"card: {card}")
    log(f"host: {host_line()}")

    # ---- 2. build: one nvcc per kernel source, all started together
    def timed_build(module):
        t0 = time.monotonic()
        info = module.build(force=True, ptxas_info=True)
        return info, time.monotonic() - t0

    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        builds = {name: pool.submit(timed_build, module) for name, module in
                  (("scan", scan_cuda), ("shard", sharded_search_cuda))}
        for name, future in builds.items():
            info, sec = future.result()
            log(f"build: {name} kernel built in {sec:.3f} s")
            for line in info.splitlines():
                if any(k in line for k in ("entry function", "registers",
                                           "spill")):
                    log("  ptxas: " + line.strip())

    dev = torch.device("cuda")
    max_err = 0
    # ---- 3. kernel vs plain: random cases and extremes
    for seed, w, lmax, rows, lsteps, aligned in RANDOM_CASES:
        case = random_case(seed, w, lmax, rows, aligned, dev)
        kw = dict(w=w, lmax=lmax, mpm=3, lsteps=lsteps)
        err = compare(case, kw, scan_cuda.scan_rows_cuda, scan_rows_ref)
        log(f"kernel vs plain: w={w} lmax={lmax} rows={rows} "
            f"lsteps={lsteps or lmax} aligned={aligned} max_abs_err={err}")
        max_err = max(max_err, err)
    if max_err:
        fail(f"kernel disagrees with its plain version (max {max_err})")
    for label, seed, w, lmax, lsteps, kinds in BRANCH_CASES:
        case = [torch.from_numpy(a).to(dev)
                for a in branch_case(seed, w, lmax, kinds or KINDS * 4)]
        kw = dict(w=w, lmax=lmax, mpm=3, lsteps=lsteps)
        seeds, sparse = row_classes(case, kw)
        err = compare(case, kw, scan_cuda.scan_rows_cuda, scan_rows_ref)
        log(f"kernel vs plain, {label}: w={w} lmax={lmax} rows="
            f"{len(seeds)} ({int(sparse.sum())} sparse, "
            f"{int((~sparse).sum())} dense, seeds per row "
            f"{int(seeds.min())}-{int(seeds.max())}) max_abs_err={err}")
        max_err = max(max_err, err)
        if err:
            fail(f"kernel disagrees with its plain version on {label} "
                 f"(max {err})")

    # ---- 3b. legacy per-lane backend: card against CPU
    for scale, bucket in LEGACY_SCALES.items():
        batch = two_region_lanes(scale, 12, scale)
        t0 = time.monotonic()
        on_card = legacy_anchors(batch, "cuda")
        torch.cuda.synchronize()
        t1 = time.monotonic()
        on_cpu = legacy_anchors(batch, "cpu")
        t2 = time.monotonic()
        if on_card != on_cpu:
            fail(f"legacy backend at w={bucket}: card and CPU disagree")
        hits = sum(bool(key) for key, _ in on_card)
        if hits == 0:
            fail(f"legacy backend at w={bucket}: no read found a far end")
        log(f"legacy backend w={bucket}: {len(on_card)} reads x 4 lanes, "
            f"{hits} with anchors, card equal to CPU; card {t1 - t0:.3f} s, "
            f"CPU {t2 - t1:.3f} s  [{card}]")

    # the same lanes at the size the path would really get
    n_full = engine_jax.TorchLaneBackend.MAX_CHUNK
    t0 = time.monotonic()
    chrom, lanes, ms, tm = two_region_lanes(LEGACY_FULL_SCALE, n_full,
                                            LEGACY_FULL_SCALE)
    log(f"legacy backend full batch: {n_full} reads x 4 lanes built in "
        f"{time.monotonic() - t0:.1f} s")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    g_timer.reset()
    t0 = time.monotonic()
    on_card = legacy_anchors((chrom, lanes, ms, tm), "cuda")
    torch.cuda.synchronize()
    card_s = legacy_card_s = time.monotonic() - t0
    peak = torch.cuda.max_memory_allocated() - base
    phases = g_timer.items()
    sample = range(0, n_full, n_full // LEGACY_SAMPLE + 1)   # both strands
    t0 = time.monotonic()
    on_cpu = legacy_anchors((chrom, [lanes[i] for i in sample],
                             [ms[i] for i in sample],
                             [tm[i] for i in sample]), "cpu")
    cpu_s = time.monotonic() - t0
    if [on_card[i] for i in sample] != on_cpu:
        fail(f"legacy backend full batch: card and CPU disagree on the "
             f"{len(sample)} sampled reads")
    hits = sum(bool(key) for key, _ in on_card)
    if hits == 0:
        fail("legacy backend full batch: no read found a far end")
    bound, bound_by, bound_shapes = legacy_bound(chrom, lanes, 32768, 128)
    log(f"legacy backend full batch w=32768: {n_full} reads x 4 lanes, "
        f"{hits} with anchors, card equal to CPU on {len(sample)} sampled "
        f"reads; card {card_s:.3f} s ({n_full / card_s:.1f} reads/s), CPU "
        f"{cpu_s:.3f} s for the sample, peak device memory above the "
        f"baseline {peak / 2 ** 20:.1f} MiB (row groups of "
        f"{engine_jax.TorchLaneBackend.ROW_ELEMS} candidates)  [{card}]")
    log(f"legacy backend full batch bound: {bound:.3f} ms ({bound_by}; "
        f"{LEGACY_OPS} int32 operations per seeded candidate and step), "
        f"{bound / (card_s * 1e3):.2%} of the card's {card_s:.3f} s; from the "
        f"shapes alone (every candidate of [B, NL, W] for lmax steps) "
        f"{bound_shapes:.3f} ms  [{card}]")
    for pname, sec in sorted(phases.items(), key=lambda kv: -kv[1]):
        log(f"  phase {pname:<52s} {sec:9.3f} s  [{card}]")
    # phase 9 holds the window-parallel search against K8 on this batch
    legacy_batch, legacy_on_card = (chrom, lanes, ms, tm), on_card
    del chrom, lanes, on_card
    torch.cuda.empty_cache()

    def check_run(label, launches, device_run=True):
        if device_run and launches == 0:
            fail(f"{label}: the scan kernel never launched")
        if device_run and g_fallback.ratio() > MAX_FALLBACK:
            fail(f"{label}: fallback ratio {g_fallback.ratio()}")

    def same_reports(label, want, port):
        if set(want) != set(port):
            fail(f"{label}: report sets differ "
                 f"{sorted(set(want) ^ set(port))}")
        diff = [k for k in want if want[k] != port[k]]
        if diff:
            fail(f"{label}: reports differ from numpy: {diff}")

    def reset_counts():
        scan_cuda.LAUNCHES = 0
        scan_cuda.LAUNCHES_BY_DEVICE.clear()
        sharded_search_cuda.LAUNCHES = 0
        sharded_search_cuda.LAUNCHES_BY_DEVICE.clear()
        engine_fused.FAR_WIN_ROWS = 0
        engine_jax.LEGACY_ROWS = 0

    def recorded(run):
        """``run()`` with every scan call of the main path recorded (on
        each shard's own card); returns its result and the calls."""
        calls = []
        kernel_scan = engine_fused.scan_rows

        def recording(*a, **kw):
            calls.append(([x.clone() for x in a], dict(kw)))
            return kernel_scan(*a, **kw)

        engine_fused.scan_rows = recording
        try:
            return run(), calls
        finally:
            engine_fused.scan_rows = kernel_scan

    def check_calls(label, calls, split=False):
        """Every recorded scan call against the plain version on the card
        it ran on, its row classes, and the kernel, plain and bound times of
        each shape (with ``split``, the kernel time of each call's sparse
        and dense rows, each subset timed as a call of its own); fails on
        any difference.  Returns the max error and the times at the largest
        shape."""
        if not calls:
            fail(f"{label}: the main path made no scan call")
        err_all = 0
        timings = {}
        split_ms = {"sparse": 0.0, "dense": 0.0}
        for cargs, kw in calls:
            with torch.cuda.device(cargs[0].device):
                err = compare(cargs, kw, scan_cuda.scan_rows_cuda,
                              scan_rows_ref)
                err_all = max(err_all, err)
                rows, t = cargs[0].shape
                seeds, sparse = row_classes(cargs, kw)
                classes = (f"rows with 0/1/>=2 seeds "
                           f"{int((seeds == 0).sum())}/"
                           f"{int((seeds == 1).sum())}/"
                           f"{int((seeds >= 2).sum())}, valid_w = 0 "
                           f"{int((cargs[2] == 0).sum())}, mean seeds "
                           f"{float(seeds.double().mean()):.1f}")
                if split:
                    parts = {}
                    for branch, mask in (("sparse", sparse),
                                         ("dense", ~sparse)):
                        idx = mask.nonzero().flatten()
                        sub = [x.index_select(0, idx).contiguous()
                               for x in cargs]
                        parts[branch] = (time_ms(
                            lambda: scan_cuda.scan_rows_cuda(*sub, **kw), 5)
                            if len(idx) else 0.0)
                        split_ms[branch] += parts[branch]
                    classes += (f"; kernel on the sparse rows "
                                f"{parts['sparse']:.4f} ms, on the dense "
                                f"rows {parts['dense']:.4f} ms")
                log(f"{label} scan call w={kw['w']} rows={rows}: {classes}, "
                    f"max_abs_err={err}  [{card}]")
                shape = (kw["w"], kw["lmax"], kw["lsteps"], rows)
                if shape in timings:
                    continue
                ms = time_ms(lambda: scan_cuda.scan_rows_cuda(*cargs, **kw),
                             10)
                plain = time_ms(lambda: scan_rows_ref(*cargs, **kw), 2)
                bound, bound_by, bound_dense = scan_bound(cargs, kw, seeds,
                                                          sparse)
            timings[shape] = dict(rows=rows, lanes=t - kw["lmax"], ms=ms,
                                  plain_ms=plain, bound_ms=bound,
                                  bound_by=bound_by,
                                  bound_dense_ms=bound_dense, w=kw["w"],
                                  lsteps=kw["lsteps"])
            log(f"{label} scan w={kw['w']} lmax={kw['lmax']} "
                f"lsteps={kw['lsteps']} rows={rows} on "
                f"{cargs[0].device}: kernel {ms:.4f} ms, plain "
                f"{plain:.3f} ms, bound {bound:.4f} ms ({bound_by}), "
                f"{bound / ms:.1%} of it, max_abs_err={err}  [{card}]")
        log(f"kernel vs plain on all {len(calls)} {label} scan calls: "
            f"max_abs_err={err_all}")
        if err_all:
            fail(f"{label}: kernel disagrees with its plain version on "
                 f"main-path inputs (max {err_all})")
        if split:
            total = split_ms["sparse"] + split_ms["dense"]
            log(f"{label}: kernel time over all calls split by branch: "
                f"sparse rows {split_ms['sparse']:.4f} ms, dense rows "
                f"{split_ms['dense']:.4f} ms ({split_ms['dense'] / total:.1%}"
                f")  [{card}]")
        main_shape = max(timings.values(),
                         key=lambda t: t["rows"] * t["lanes"])
        log(f"{label}: scan timing reported at the main path's largest "
            f"shape: {main_shape['lanes']} lanes x {main_shape['rows']} "
            f"rows, w={main_shape['w']} lsteps={main_shape['lsteps']}: "
            f"kernel {main_shape['ms']:.4f} ms, bound "
            f"{main_shape['bound_ms']:.4f} ms ({main_shape['bound_by']}, "
            f"seeded lanes of sparse rows, every lane of dense rows), "
            f"{main_shape['bound_ms'] / main_shape['ms']:.1%} of it; the "
            f"valid-lane count (every row's valid_w lanes) "
            f"{main_shape['bound_dense_ms']:.4f} ms  [{card}]")
        return dict(main_shape, max_abs_err=err_all)

    def full_scene(label, argv_of, n, unit, check_reports):
        """5/6: record, plain-scan, timed and per-call phases of one
        full-size scene; returns the median run and the scan checks."""
        # a. first run (cold): record every scan call of the main path
        first_s, calls = recorded(lambda: run_cli(port_main, argv_of("rec")))
        # b. the plain scan in the kernel's place: the reference reports
        kernel_scan = engine_fused.scan_rows
        engine_fused.scan_rows = scan_rows_ref
        before = scan_cuda.LAUNCHES
        plain_s = run_cli(port_main, argv_of("plain"))
        engine_fused.scan_rows = kernel_scan
        if scan_cuda.LAUNCHES != before:
            fail(f"{label}: the plain-scan run launched the kernel")
        want = reports(prefix_of(argv_of("plain")))
        check_reports(want)
        if reports(prefix_of(argv_of("rec"))) != want:
            fail(f"{label}: the first kernel run's reports differ from the "
                 "plain-scan run's")
        log(f"{label}: first run {first_s:.3f} s ({len(calls)} scan calls "
            f"recorded), plain-scan run {plain_s:.3f} s  [{card}]")

        # c. timed runs through the kernel
        runs = []
        for i in range(TIMED_RUNS):
            reset_counts()
            torch.cuda.reset_peak_memory_stats()
            argv = argv_of(f"run{i}")
            wall = run_cli(port_main, argv)
            runs.append(dict(wall=wall, launches=scan_cuda.LAUNCHES,
                             far_win_rows=engine_fused.FAR_WIN_ROWS,
                             legacy_rows=engine_jax.LEGACY_ROWS,
                             phases=g_timer.items(),
                             fallback=(g_fallback.fallback, g_fallback.total,
                                       g_fallback.ratio()),
                             peak=torch.cuda.max_memory_allocated()))
            check_run(f"{label} run {i}", scan_cuda.LAUNCHES)
            if reports(prefix_of(argv)) != want:
                fail(f"{label} run {i}: reports differ from the plain-scan "
                     "run's")
            log(f"{label} run {i}: wall {wall:.3f} s, {n / wall:.1f} "
                f"{unit}/s, scan launches {scan_cuda.LAUNCHES}  [{card}]")
        for key in ("launches", "far_win_rows", "legacy_rows"):
            if len({r[key] for r in runs}) != 1:
                fail(f"{label}: {key} differ between runs "
                     f"{[r[key] for r in runs]}")
        walls = [r["wall"] for r in runs]
        med = runs[walls.index(statistics.median(walls))]
        fb, total, ratio = med["fallback"]
        log(f"{label}: median wall {med['wall']:.3f} s of {TIMED_RUNS} "
            f"({n / med['wall']:.1f} {unit}/s), reports byte-identical to "
            f"the plain-scan run, fallback {fb}/{total} = {ratio:.6f}, scan "
            f"launches {med['launches']}, _far_win_kernel rows "
            f"{med['far_win_rows']}, legacy rows {med['legacy_rows']}, peak "
            f"device memory {med['peak'] / 2 ** 20:.1f} MiB  [{card}]")
        for pname, sec in sorted(med["phases"].items(),
                                 key=lambda kv: -kv[1]):
            log(f"  phase {pname:<52s} {sec:9.3f} s  [{card}]")

        # d. every recorded main-path call: kernel vs plain, time per shape
        scan = check_calls(label, calls, split=True)
        del calls
        torch.cuda.empty_cache()

        if args.profile_dir:
            from torch.profiler import ProfilerActivity, profile
            os.makedirs(args.profile_dir, exist_ok=True)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                prof_wall = run_cli(port_main, argv_of("prof"))
            table = prof.key_averages().table(sort_by="cuda_time_total",
                                              row_limit=40)
            path = os.path.join(args.profile_dir,
                                f"{label.replace(' ', '')}_profile.txt")
            with open(path, "w") as fh:
                fh.write(f"{card}\nwall under profiler {prof_wall:.3f} s\n")
                fh.write(table)
            log(f"profile: {path} (wall under profiler {prof_wall:.3f} s)")
        return dict({k: scan[k] for k in SCAN_KEYS},
                    launches=med["launches"],
                    far_win_rows=med["far_win_rows"], wall=med["wall"],
                    want=want)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        # ---- 4. the CLI on small text scenes vs the golden NumPy reports
        golden = load_golden()
        for scene, (scene_kw, flags, _fields) in SMALL_SCENES.items():
            d = os.path.join(work, scene)
            os.makedirs(d)
            fa, reads_txt, n = write_scene(d, **scene_kw)
            reset_counts()
            run_cli(port_main, ["-f", fa, "-p", reads_txt,
                                "-o", os.path.join(d, "port"), "-s", *flags])
            launches = scan_cuda.LAUNCHES
            port = reports(os.path.join(d, "port"))
            same_reports(f"scene {scene}", golden[scene], port)
            if not port["CloseEndMapped"]:
                fail(f"scene {scene}: no close end mapped")
            check_run(f"scene {scene}", launches)
            log(f"small scene {scene} {flags}: {n} reads, {len(port)} "
                f"reports byte-identical to numpy, launches={launches}, "
                f"fallback {g_fallback.fallback}/{g_fallback.total}")

        # ---- 4b. the CLI on small BAM scenes vs the golden NumPy reports
        for scene, spec in BAM_SCENES.items():
            d = os.path.join(work, scene)
            os.makedirs(d)
            argv = bam_argv(spec, spec.build(d), os.path.join(d, "port"))
            reset_counts()
            run_cli(port_main, argv)
            port = reports(os.path.join(d, "port"))
            same_reports(f"BAM scene {scene}", golden[scene], port)
            # -g genotypes on the host: no device search to check
            check_run(f"BAM scene {scene}", scan_cuda.LAUNCHES,
                      device_run="-g" not in spec.flags)
            if spec.far_win and engine_fused.FAR_WIN_ROWS == 0:
                fail(f"BAM scene {scene}: _far_win_kernel searched no read")
            log(f"small BAM scene {scene} {list(spec.flags)}: {len(port)} "
                f"reports byte-identical to numpy, launches="
                f"{scan_cuda.LAUNCHES}, _far_win_kernel rows "
                f"{engine_fused.FAR_WIN_ROWS}, legacy rows "
                f"{engine_jax.LEGACY_ROWS}, fallback "
                f"{g_fallback.fallback}/{g_fallback.total}")
        # BAM intake and RP discovery ran the port's native libraries, not
        # a Python re-statement
        missing = {"ptbam", "ptrp"} - set(native._LIBS)
        if missing:
            fail(f"BAM scenes: native libraries not loaded: {sorted(missing)}")
        where = {lib_name: lib._name
                 for lib_name, lib in native._LIBS.items()}
        outside = {lib_name: path for lib_name, path in where.items()
                   if not path.startswith(native.BUILD_DIR + os.sep)}
        if outside:
            fail(f"native libraries loaded from outside "
                 f"{native.BUILD_DIR}: {outside}")
        log(f"native libraries loaded from {native.BUILD_DIR}: "
            f"{sorted(where)}")

        # ---- 5. scene 1 at full size
        s1 = os.path.join(work, "scene1")
        os.makedirs(s1)
        t0 = time.monotonic()
        fa1, reads1, n1 = write_scene(s1, **SCENE1)
        log(f"scene 1: {n1} reads over {SCENE1['chrom_len']} bp, built in "
            f"{time.monotonic() - t0:.1f} s")

        def scene1_reports(want):
            if b"ChrID" not in want.get("D", b""):
                fail("scene 1: no deletion reported")

        def argv1(run):
            return ["-f", fa1, "-p", reads1, *SCENE1_FLAGS,
                    "-o", os.path.join(s1, run)]

        scene1 = full_scene("scene 1", argv1, n1, "reads", scene1_reports)
        max_err = max(max_err, scene1["max_abs_err"])

        # ---- 6. scene 2 at full size
        s2 = os.path.join(work, "scene2")
        os.makedirs(s2)
        t0 = time.monotonic()
        paths2 = SCENE2.build(s2)
        n2 = int(paths2["pairs"])
        log(f"scene 2: {n2} read pairs over 2000000 bp (BAM + BreakDancer "
            f"calls), built in {time.monotonic() - t0:.1f} s")
        want_digests = load_scene2_digests()

        def scene2_reports(want):
            if digests(want) != want_digests:
                fail("scene 2: the plain-scan run's reports differ from the "
                     "reference's digests")
            if b"ChrID" not in want.get("D", b""):
                fail("scene 2: no deletion reported")

        def argv2(run):
            return bam_argv(SCENE2, paths2, os.path.join(s2, run))

        scene2 = full_scene("scene 2", argv2, n2, "read pairs",
                            scene2_reports)
        if SCENE2.far_win and scene2["far_win_rows"] == 0:
            fail("scene 2: _far_win_kernel searched no read")
        max_err = max(max_err, scene2["max_abs_err"])

        # ---- 7. scenes 1 and 2 through the data-parallel mesh backend,
        # in turns with the fused backend (fused, mesh..., then reversed)
        def run_backend(argv, devices) -> float:
            """One run: the CLI (``fused``, or ``--backend mesh`` over
            every visible card), or run_files over an explicit device
            list; wall seconds."""
            if devices == "fused":
                return run_cli(port_main, argv)
            if devices is None:
                return run_cli(port_main, argv + ["--backend", "mesh"])
            args = build_parser().parse_args(argv)
            t0 = time.monotonic()
            run_files(args.fasta, args.pindel_file, args.output_prefix,
                      settings=settings_from_args(args), device="cuda",
                      bam_config=args.config, backend="mesh",
                      devices=devices)
            torch.cuda.synchronize()
            return time.monotonic() - t0

        def cards_of(devices):
            """The card indices a run over ``devices`` must launch on."""
            if devices == "fused":
                return {torch.cuda.current_device()}
            if devices is None:
                return set(range(torch.cuda.device_count()))
            return {torch.device(d).index for d in devices}

        configs = [("fused", "fused"), *MESH_LISTS.items()]
        mesh_paths = {}
        mesh_scans = {}
        for key, label, argv_of, n, unit, base in (
                ("scene1", "scene 1", argv1, n1, "reads", scene1),
                ("scene2", "scene 2", argv2, n2, "read pairs", scene2)):
            # a first run of each device list (its warm-up) records every
            # shard's scan calls, each held against the plain scan on the
            # card it ran on
            for cfg, devices in MESH_LISTS.items():
                mlabel = f"{label} mesh {cfg}"
                argv = argv_of(f"rec_{cfg}")
                _, calls = recorded(lambda: run_backend(argv, devices))
                if reports(prefix_of(argv)) != base["want"]:
                    fail(f"{mlabel} recorded run: reports differ from the "
                         "fused kernel runs'")
                ran_on = {c[0][0].device.index for c in calls}
                if ran_on != cards_of(devices):
                    fail(f"{mlabel}: scan calls ran on cards "
                         f"{sorted(ran_on)}, not {sorted(cards_of(devices))}")
                mesh_scans[key, cfg] = check_calls(mlabel, calls)
                max_err = max(max_err, mesh_scans[key, cfg]["max_abs_err"])
                del calls
                torch.cuda.empty_cache()
            runs = {cfg: [] for cfg, _ in configs}
            for i in range(TIMED_RUNS):
                for cfg, devices in (configs if i % 2 == 0
                                      else configs[::-1]):
                    mlabel = f"{label} {cfg} run {i}"
                    argv = argv_of(f"turns_{cfg}_{i}")
                    reset_counts()
                    wall = run_backend(argv, devices)
                    launches = scan_cuda.LAUNCHES
                    by_card = dict(sorted(
                        scan_cuda.LAUNCHES_BY_DEVICE.items()))
                    check_run(mlabel, launches)
                    if set(by_card) != cards_of(devices):
                        fail(f"{mlabel}: scan launches by card {by_card}, "
                             f"expected every card of "
                             f"{sorted(cards_of(devices))}")
                    got = reports(prefix_of(argv))
                    if got != base["want"]:
                        fail(f"{mlabel}: reports differ from the fused "
                             "kernel runs'")
                    if key == "scene2" and digests(got) != want_digests:
                        fail(f"{mlabel}: reports differ from the "
                             "reference's digests")
                    runs[cfg].append(dict(wall=wall, launches=launches,
                                           by_card=by_card,
                                           phases=g_timer.items()))
                    log(f"{mlabel}: wall {wall:.3f} s, {n / wall:.1f} "
                        f"{unit}/s, scan launches {launches} by card "
                        f"{by_card}  [{card}]")
            fused_med = statistics.median(r["wall"] for r in runs["fused"])
            for cfg, devices in configs:
                if len({str(r["by_card"]) for r in runs[cfg]}) != 1:
                    fail(f"{label} {cfg}: launches differ between runs")
                walls = [r["wall"] for r in runs[cfg]]
                med = runs[cfg][walls.index(statistics.median(walls))]
                log(f"{label} {cfg} ({devices}): median wall "
                    f"{med['wall']:.3f} s of {TIMED_RUNS} in turns "
                    f"({n / med['wall']:.1f} {unit}/s), reports "
                    f"byte-identical to the fused runs of phase 5/6, scan "
                    f"launches {med['launches']} by card {med['by_card']}  "
                    f"[{card}]")
                top = sorted(med["phases"].items(), key=lambda kv: -kv[1])
                for pname, sec in top[:8]:
                    log(f"  phase {pname:<52s} {sec:9.3f} s  [{card}]")
                if cfg != "fused":
                    scan = mesh_scans[key, cfg]
                    mesh_paths[f"{key}_mesh_{cfg}"] = dict(
                        {k: scan[k] for k in SCAN_KEYS},
                        launches=med["launches"],
                        launches_by_card={
                            str(k): v for k, v in med["by_card"].items()},
                        wall=med["wall"], fused_wall=fused_med)

        # ---- 8. multi-process window sharding, rank 0 in this process
        from pindel_tpu_torch.parallel import multihost

        def run_hosts(argv, hosts, dist) -> float:
            """One run of ``argv`` through run_files_multihost at ``hosts``
            ranks; wall seconds."""
            a = build_parser().parse_args(argv)
            torch.cuda.reset_peak_memory_stats()
            t0 = time.monotonic()
            multihost.run_files_multihost(
                a.fasta, a.pindel_file, a.output_prefix,
                settings_from_args(a), a.backend, hosts,
                pindel_config=a.pindel_config, bam_config=a.config,
                dist=dist, device=a.device)
            torch.cuda.synchronize()
            return time.monotonic() - t0

        def rank_records(label, hosts):
            """The ranks' records of the last run: every rank that owned a
            window launched the kernel on each card of its devices and on
            no other card; a rank without windows launched nothing.  At
            one rank, this process's counts since reset_counts()."""
            if hosts == 1:
                return [dict(rank=0, devices=["cuda:0"], windows=None,
                             launches_by_card={
                                 str(k): v for k, v in sorted(
                                     scan_cuda.LAUNCHES_BY_DEVICE.items())},
                             started_s=0.0, ready_s=0.0, first_window_s=None,
                             peak_alloc_mib=None, card_used_mib=None)]
            ranks = [dict(r) for r in multihost.LAST_RANKS]
            if [r["rank"] for r in ranks] != list(range(hosts)):
                fail(f"{label}: rank records {ranks}")
            for r in ranks:
                cards = {str(torch.device(d).index) for d in r["devices"]}
                got = r["launches_by_card"]
                if r["windows"] and (set(got) != cards
                                     or not all(got.values())):
                    fail(f"{label}: rank {r['rank']} owned windows "
                         f"{r['windows']} on {r['devices']} but launched "
                         f"the kernel {got} by card")
                if not r["windows"] and got:
                    fail(f"{label}: rank {r['rank']} owned no window but "
                         f"launched {got}")
            return ranks

        def log_ranks(label, ranks):
            for r in ranks:
                first = ("-" if r["first_window_s"] is None
                         else f"{r['first_window_s']:.3f} s")
                mem = ("" if r["peak_alloc_mib"] is None else
                       f", allocator peak {r['peak_alloc_mib']:.1f} MiB, card "
                       f"memory used at its end {r['card_used_mib']:.1f} MiB")
                wall = f"{r['wall_s']:.3f} s" if "wall_s" in r else "-"
                log(f"{label} rank {r['rank']}: devices {r['devices']}, "
                    f"windows {r['windows']}, scan launches by card "
                    f"{r['launches_by_card']}, wall {wall}, spawn to "
                    f"imports done {r['started_s']:.3f} s, to pipeline ready "
                    f"{r['ready_s']:.3f} s, to first shipped window "
                    f"{first}{mem}  [{card}]")

        def launches_of(ranks):
            return sum(sum(r["launches_by_card"].values()) for r in ranks)

        hosts_paths = {}
        # a. scene 1 at --hosts 2 over both transports, rank 0's scan
        # calls recorded
        for dist in ("files", "store"):
            label = f"scene 1 --hosts 2 --dist {dist}"
            argv = argv1(f"hosts2_{dist}")
            reset_counts()
            wall, calls = recorded(lambda: run_hosts(argv, 2, dist))
            if reports(prefix_of(argv)) != scene1["want"]:
                fail(f"{label}: reports differ from the kernel runs of "
                     "phase 5")
            ranks = rank_records(label, 2)
            if not all(r["windows"] for r in ranks):
                fail(f"{label}: a rank owned no window: {ranks}")
            log(f"{label}: wall {wall:.3f} s, {n1 / wall:.1f} reads/s, "
                f"reports byte-identical to phase 5, scan launches "
                f"{launches_of(ranks)}  [{card}]")
            log_ranks(label, ranks)
            scan = check_calls(f"{label} rank 0", calls)
            max_err = max(max_err, scan["max_abs_err"])
            del calls
            torch.cuda.empty_cache()
            hosts_paths[f"scene1_hosts2_{dist}"] = dict(
                {k: scan[k] for k in SCAN_KEYS}, launches=launches_of(ranks),
                launches_by_rank=[r["launches_by_card"] for r in ranks],
                wall=wall)

        # b. scene 2 at --hosts 2: one window, so rank 1 ships nothing
        label = "scene 2 --hosts 2 --dist files"
        argv = argv2("hosts2_files")
        reset_counts()
        wall = run_hosts(argv, 2, "files")
        got = reports(prefix_of(argv))
        if got != scene2["want"] or digests(got) != want_digests:
            fail(f"{label}: reports differ from phase 6 or the digests")
        ranks = rank_records(label, 2)
        if ranks[1]["windows"]:
            fail(f"{label}: rank 1 owned windows {ranks[1]['windows']}")
        log(f"{label}: wall {wall:.3f} s, {n2 / wall:.1f} read pairs/s, "
            f"reports byte-identical to phase 6 and the digests, scan "
            f"launches {launches_of(ranks)}  [{card}]")
        log_ranks(label, ranks)
        hosts_paths["scene2_hosts2_files"] = dict(
            launches=launches_of(ranks),
            launches_by_rank=[r["launches_by_card"] for r in ranks],
            wall=wall)

        # c. timed runs in turns at more windows
        for key, label, flags, dist, counts in HOSTS_TIMED:
            argv_of = argv1 if key == "scene1" else argv2
            n, unit = (n1, "reads") if key == "scene1" else (n2, "read pairs")
            runs = {h: [] for h in counts}
            want = None
            for i in range(TIMED_RUNS):
                for hosts in (counts if i % 2 == 0 else counts[::-1]):
                    hlabel = f"{label} {' '.join(flags)} --hosts {hosts}"
                    argv = argv_of(f"timed_h{hosts}_{i}") + flags
                    reset_counts()
                    wall = run_hosts(argv, hosts, dist)
                    got = reports(prefix_of(argv))
                    if want is None:
                        want = got          # the first run is --hosts 1
                    elif got != want:
                        fail(f"{hlabel} run {i}: reports differ from "
                             "--hosts 1")
                    ranks = rank_records(hlabel, hosts)
                    runs[hosts].append(dict(wall=wall, ranks=ranks,
                                            phases=g_timer.items()))
                    log(f"{hlabel} --dist {dist} run {i}: wall {wall:.3f} s, "
                        f"{n / wall:.1f} {unit}/s, scan launches "
                        f"{launches_of(ranks)}  [{card}]")
                    log_ranks(f"{hlabel} run {i}", ranks)
            for hosts in counts:
                walls = [r["wall"] for r in runs[hosts]]
                med = runs[hosts][walls.index(statistics.median(walls))]
                log(f"{label} {' '.join(flags)} --hosts {hosts} --dist "
                    f"{dist}: median wall {med['wall']:.3f} s of "
                    f"{TIMED_RUNS} in turns ({n / med['wall']:.1f} {unit}/s"
                    f"), reports equal to --hosts 1, scan launches "
                    f"{launches_of(med['ranks'])}  [{card}]")
                for r in med["ranks"]:
                    phases = r.get("phases") or med["phases"]
                    for pname in HOSTS_PHASES:
                        log(f"  rank {r['rank']} phase {pname:<40s} "
                            f"{phases.get(pname, 0.0):9.3f} s  [{card}]")
                hosts_paths[f"{key}_timed_hosts{hosts}"] = dict(
                    launches=launches_of(med["ranks"]), wall=med["wall"])

        # ---- 9. the window-parallel search (K9)
        from pindel_tpu_torch.config import Settings
        from pindel_tpu_torch.genome import Genome
        from pindel_tpu_torch.ops import sharded_search as sss
        from pindel_tpu_torch.parallel.mesh import TorchShardedBackend
        from pindel_tpu_torch.reads import read_pindel_file
        from pindel_tpu_torch.search import Searcher
        from pindel_tpu_torch.testing.shard_cases import CASES, shard_case

        def anchors(ups):
            return [(u.length_str, u.abs_loc, u.direction, u.strand,
                     u.mismatches) for u in ups]

        # a. the shard kernel against its plain twin: every edge case of
        # testing/shard_cases.py and random rows, every shard at wp = 1, 2,
        # 4 and 8
        k9_err = 0
        for name, seed in ([(c, 0) for c in CASES]
                           + [("random", s) for s in (1, 2, 3)]):
            arrays, st = shard_case(name, seed)
            (chrom_np, start_np, rev_np, qq_np, vw_np, _qlen, ms_np,
             tm_np) = arrays[:8]
            case = [torch.from_numpy(np.array(a)).to(dev) for a in
                    (chrom_np, start_np, rev_np, qq_np, vw_np, ms_np, tm_np)]
            errs = []
            for wp in (1, 2, 4, 8):
                wl = st["w_total"] // wp
                for k in range(wp):
                    errs.append(compare(case, dict(
                        off=k * wl, w_total=st["w_total"], w_local=wl,
                        lmax=st["lmax"], nl=st["nl"], mpm=st["mpm"],
                        t_levels=int(tm_np.max()),
                        s_levels=int(ms_np.max())),
                        sharded_search_cuda.shard_partials_cuda,
                        sss.shard_partials_ref))
            k9_err = max(k9_err, max(errs))
            log(f"shard kernel vs plain, case {name} seed {seed}: "
                f"{qq_np.shape[0]} rows x {st['nl']} lanes, w_total "
                f"{st['w_total']}, {len(errs)} shard calls at wp 1/2/4/8, "
                f"max_abs_err={max(errs)}")
        if k9_err:
            fail(f"shard kernel disagrees with its plain twin (max {k9_err})")

        # b. TorchShardedBackend under a Searcher on a small scene against
        # the NumPy oracle: three grids over cuda:0 x 8 and every card
        d9 = os.path.join(work, "k9")
        os.makedirs(d9)
        fa9, reads9, _n9 = write_scene(d9, **SMALL_SCENES["seed0"][0])
        settings9 = Settings()
        chrom9 = Genome.from_fasta(fa9).chromosomes[0]

        def search9(backend):
            reads = list(read_pindel_file(reads9))
            sr = Searcher(settings9, backend=backend)
            sr.map_close_ends(chrom9, reads)
            kept = sr.finalize_close_ends(reads)
            sr.search_far_ends(chrom9, kept)
            return [(r.name, anchors(r.up_close), anchors(r.up_far))
                    for r in kept]

        want9 = search9(None)
        if not any(far for _n, _c, far in want9):
            fail("K9 scene: the NumPy oracle found no far end")
        k9_launches = 0
        n_cards = torch.cuda.device_count()
        grids9 = [(f"cuda:0 x 8 at ({dp}, {wp})", ["cuda:0"] * 8, dp)
                  for dp, wp in SHARD_GRIDS]
        grids9.append((f"every card ({n_cards})",
                       [f"cuda:{i}" for i in range(n_cards)], None))
        for label, devs, dp in grids9:
            backend = TorchShardedBackend(settings9,
                                          settings9.max_mismatch(),
                                          chrom9.seq, devs, dp)
            reset_counts()
            t0 = time.monotonic()
            got = search9(backend)
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
            launches = sharded_search_cuda.LAUNCHES
            by_card = dict(sorted(
                sharded_search_cuda.LAUNCHES_BY_DEVICE.items()))
            if got != want9:
                fail(f"K9 backend over {label}: anchors differ from the "
                     "NumPy oracle")
            if set(by_card) != {torch.device(d).index for d in devs}:
                fail(f"K9 backend over {label}: launches by card {by_card}")
            k9_launches += launches
            log(f"K9 backend over {label}: {len(got)} reads, anchors equal "
                f"to the NumPy oracle, {launches} shard launches by card "
                f"{by_card}, {wall:.3f} s  [{card}]")

        # c. full width: phase 3b's batch (8,192 reads x 4 lanes, w =
        # 32768) at (1, 1) and (1, 4) over cuda:0, against K8's anchors
        # from phase 3b and, on its sampled reads, the plain twin
        chrom_l, lanes_l, ms_l, tm_l = legacy_batch
        sample = range(0, len(lanes_l), len(lanes_l) // LEGACY_SAMPLE + 1)
        k9_full = {}
        for wp in SHARD_FULL_WP:
            label = f"K9 full batch at (1, {wp}) over cuda:0"
            backend = TorchShardedBackend(settings9,
                                          settings9.max_mismatch(),
                                          chrom_l.seq, ["cuda:0"] * wp, 1)
            # a first run records the kernel's calls (inputs and outputs)
            calls = []
            real = sss.shard_partials

            def recording(*a, **kw):
                out = real(*a, **kw)
                calls.append(([x.clone() for x in a], dict(kw),
                              [o.clone() for o in out]))
                return out

            sss.shard_partials = recording
            try:
                backend.run(lanes_l, 10, ms_l, tm_l)
            finally:
                sss.shard_partials = real
            # the timed run: counts from 0
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            reset_counts()
            g_timer.reset()
            t0 = time.monotonic()
            res = backend.run(lanes_l, 10, ms_l, tm_l)
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
            launches = sharded_search_cuda.LAUNCHES
            peak = torch.cuda.max_memory_allocated() - base
            phases = g_timer.items()
            got = [(anchors(ups), full) for ups, full in res]
            if got != legacy_on_card:
                bad = sum(a != b for a, b in zip(got, legacy_on_card))
                fail(f"{label}: {bad} reads differ from K8's")
            on_cpu = sharded_anchors(
                (chrom_l, [lanes_l[i] for i in sample],
                 [ms_l[i] for i in sample], [tm_l[i] for i in sample]),
                ["cpu"] * wp, 1)
            if [got[i] for i in sample] != on_cpu:
                fail(f"{label}: the card and the plain twin disagree on the "
                     f"{len(sample)} sampled reads")
            k9_launches += launches
            # every recorded call: kernel time, the plain twin over all its
            # rows (in chunks, each held against the kernel's rows), bound
            shards = []
            for args, kw, out in calls:
                ms_k = time_ms(lambda: sharded_search_cuda.
                               shard_partials_cuda(*args, **kw), 5)
                rows = args[1].shape[0]
                plain_ms, err = 0.0, 0
                for lo in range(0, rows, SHARD_PLAIN_ROWS):
                    sub = [args[0]] + [x[lo:lo + SHARD_PLAIN_ROWS]
                                       for x in args[1:]]
                    start = torch.cuda.Event(enable_timing=True)
                    stop = torch.cuda.Event(enable_timing=True)
                    start.record()
                    want = sss.shard_partials_ref(*sub, **kw)
                    stop.record()
                    torch.cuda.synchronize()
                    plain_ms += start.elapsed_time(stop)
                    for w, o in zip(want, out):
                        o = o[lo:lo + SHARD_PLAIN_ROWS]
                        err = max(err, int((w.long() - o.long()).abs().max()))
                    del want
                bound, bound_by, seeded, walked = shard_bound(args, kw, out)
                shards.append(dict(ms=ms_k, plain_ms=plain_ms, err=err,
                                   bound_ms=bound, bound_by=bound_by))
                k9_err = max(k9_err, err)
                log(f"{label} shard off={kw['off']} w_local={kw['w_local']}"
                    f" rows={rows}: kernel {ms_k:.4f} ms, plain twin "
                    f"{plain_ms:.3f} ms, bound {bound:.4f} ms ({bound_by}; "
                    f"{seeded} seeded candidates walking {walked} steps, "
                    f"{SHARD_STEP_OPS} int32 operations per step, "
                    f"{SHARD_SEED_OPS} per candidate), {bound / ms_k:.1%} of "
                    f"it, max_abs_err={err}  [{card}]")
            del calls
            if k9_err:
                fail(f"{label}: shard kernel disagrees with its plain twin "
                     f"(max {k9_err})")
            hits = sum(bool(a) for a, _ in got)
            log(f"{label}: {len(got)} reads x 4 lanes, {hits} "
                f"with anchors, equal to K8 (phase 3b) and, on "
                f"{len(sample)} sampled reads, to the plain twin; wall "
                f"{wall:.3f} s (K8 {legacy_card_s:.3f} s), kernel "
                f"{sum(x['ms'] for x in shards):.4f} ms over {launches} "
                f"launches, peak device memory above the baseline "
                f"{peak / 2 ** 20:.1f} MiB  [{card}]")
            for pname, sec in sorted(phases.items(), key=lambda kv: -kv[1]):
                log(f"  phase {pname:<52s} {sec:9.3f} s  [{card}]")
            k9_full[wp] = dict(shards=shards, launches=launches, wall=wall)
            torch.cuda.empty_cache()

        # d. --backend numpy and jax on the 16 small scenes
        jax_rows = 0
        for name in ("numpy", "jax"):
            runs9 = [(scene, None) for scene in SMALL_SCENES] + [
                (scene, spec) for scene, spec in BAM_SCENES.items()]
            for scene, spec in runs9:
                d = os.path.join(work, f"{name}_{scene}")
                os.makedirs(d)
                prefix = os.path.join(d, "port")
                if spec is None:
                    scene_kw, flags, _fields = SMALL_SCENES[scene]
                    fa, reads_txt, _n = write_scene(d, **scene_kw)
                    argv = ["-f", fa, "-p", reads_txt, "-o", prefix, "-s",
                            *flags]
                else:
                    argv = bam_argv(spec, spec.build(d), prefix)
                reset_counts()
                run_cli(port_main, argv + ["--backend", name])
                same_reports(f"--backend {name} scene {scene}",
                             golden[scene], reports(prefix))
                if scan_cuda.LAUNCHES or sharded_search_cuda.LAUNCHES:
                    fail(f"--backend {name} scene {scene}: a kernel of "
                         "another backend launched")
                if name == "numpy" and engine_jax.LEGACY_ROWS:
                    fail(f"--backend numpy scene {scene}: the device "
                         "searched")
                jax_rows += engine_jax.LEGACY_ROWS
            log(f"--backend {name}: {len(runs9)} small scenes (8 text, 8 "
                "BAM) byte-identical to the golden reports"
                + (f", {jax_rows} reads searched by K8 on the card"
                   if name == "jax" else ", no device search"))
        if jax_rows == 0:
            fail("--backend jax searched no read on the card")

    loaded = reference_modules()
    if loaded:
        fail(f"a run loaded {loaded}")
    paths = {label: {k: v[k] for k in ("launches", *SCAN_KEYS, "wall")}
             for label, v in (("scene1", scene1), ("scene2", scene2))}
    paths.update(mesh_paths)
    paths.update(hosts_paths)
    # K1 at scene 1's largest main-path shape; launches over every path
    kernels = [dict(name="scan_rows", route="cuda",
                    source="pindel_tpu_torch/csrc/scan.cu",
                    replaces="pindel_tpu/ops/pallas_scan.py:76",
                    launches=sum(v["launches"] for v in paths.values()),
                    max_abs_err=max_err,
                    ms=scene1["ms"], plain_ms=scene1["plain_ms"],
                    bound_ms=scene1["bound_ms"],
                    bound_by=scene1["bound_by"],
                    bound_dense_ms=scene1["bound_dense_ms"], library_ms=None,
                    paths=paths)]
    # K9 at its largest shape (the full batch at wp = 1); launches over the
    # backend runs of phase 9b and the timed full-width runs of 9c
    top = k9_full[1]["shards"][0]
    kernels.append(dict(
        name="sharded_search", route="cuda",
        source="pindel_tpu_torch/csrc/sharded_search.cu",
        replaces="pindel_tpu/parallel/mesh.py:46", launches=k9_launches,
        max_abs_err=k9_err, ms=top["ms"], plain_ms=top["plain_ms"],
        bound_ms=top["bound_ms"], bound_by=top["bound_by"], library_ms=None,
        paths={f"full_wp{wp}": dict(
            launches=v["launches"], wall=v["wall"],
            ms=sum(x["ms"] for x in v["shards"]),
            plain_ms=sum(x["plain_ms"] for x in v["shards"]),
            bound_ms=sum(x["bound_ms"] for x in v["shards"]))
            for wp, v in k9_full.items()}))
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
