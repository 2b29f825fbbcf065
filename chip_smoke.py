#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (pindel_tpu_torch) on one GPU.

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py [--profile-dir DIR]

Phases, in order (each logs the command time at which it starts); any
failure exits non-zero:

0. the port's imports load no module of the JAX package (``pindel_tpu``)
   and no jax (checked again at the end);
1. environment: torch, CUDA and nvcc versions, the card's name and power
   limit, the host's CPU model and core count;
2. build: the CUDA scan kernel (csrc/scan.cu), the fused close/far/far_win
   kernels (csrc/fused_search.cu; both include csrc/scan_walk.cuh) and the
   shard kernel of the window-parallel search (csrc/sharded_search.cu),
   from the checkout's sources, one nvcc for each, started together, with
   ptxas's registers, shared memory and spills;
3. kernel against its plain PyTorch version, both on the card, bit for bit,
   on random cases and the extremes (w = 32768, 65536 and 98304, lmax =
   1024), then on rows built for each branch of the kernel
   (testing/scan_cases.py): 0, 1 and 2 seeds, q[0] = N, windows of 0 and
   1 lanes, seeds at the window's edges and at WE - 1, all-seeded rows at
   w = 1536 and 32768, many seeds with valid_w > w and with qlen above the
   dead level (lmax 1024), and the widest bucket (98304) with both branches
   in one call; then the bucket sweep of tests/test_pallas_onchip.py (every
   window bucket of W_BUCKETS by every lmax of BUCKET_LMAXES, 192 rows,
   testing/scan_cases.py:bucket_case), 18 cases;
3b. the legacy per-lane backend (K8, ops/engine_jax.py), which on a card
   runs its route through the shard kernel (``_route_kernel``): the
   route's packed buffer against the plain ``_search_kernel`` on the card,
   byte for byte, on testing/lane_cases.py's rows at the window buckets
   2048, 8192, 32768 and 65536 (where the int16 ``rep_w`` wraps) and nl 1,
   2 and 4, on rows under budgets at and past the DEAD level (127), and
   on two-region BreakDancer-style lanes at 2048, 8192 and 32768; the backend on the card against the plain one on the CPU on the
   same lanes (equal anchors and mismatch counts); then the largest batch
   it takes in one call (8,192 reads x 4 lanes at w = 32768) through the
   route and once through the plain loop on the card, both timed, equal,
   with their peak device memory, each with its own bound (``route_bound``
   as the route works, ``legacy_bound`` as the plain loop works), and held
   against the CPU on a sample of its reads;
4. the CLI on small simulated pindel-text scenes: reports byte-identical to
   the golden files that pindel_tpu's NumPy backend wrote for them
   (pindel_tpu_torch/testing/golden_reports.json, kept current by
   tests/test_torch_pipeline.py and tests/test_torch_bam.py);
4b. the CLI on small BAM scenes (BAM + BreakDancer discovery, -q, -z, -g):
   reports byte-identical to the golden files, the search kernels
   launched, the explicit-window kernel's rows above 0 where evidence
   windows guide the search and ``pt_far_win`` launched wherever they are,
   and the native BAM and RP libraries loaded from
   pindel_tpu_torch/build/native/; then the reference suite's scenes
   (testing/scenes.py:SUITE_SCENES: an interchromosomal BreakDancer call
   with and without -I, -c with and without coordinates, -j, -J, -j with
   -J, the TD depth filter at -x 4 with and without -N, the -r/-t flag
   tokens) through each backend SUITE_BACKENDS names (fused, and mesh, jax
   and numpy where it says so), every report equal to the golden files.
   On every CLI path (phases 4-8, 12, 13) the standalone scan kernel must
   launch no time: K1's walk runs inside the fused kernels;
5. scene 1 of bench.py at full size (50,000 reads over a 6 Mb chromosome,
   -T 4) and 6. scene 2 (BAM input with a BreakDancer calls file: 12,000
   read pairs over a 2 Mb chromosome, -T 4), each built by
   testing/scenes.py:SCENES and run through the recorded run
   (``scenes.run_scene``): a first run that records every search call the
   main path makes (K2, K3 and K4), a run with the plain versions in place
   of the kernels (the ``_ref`` bodies over the plain scan; no kernel
   launched), then three timed runs whose reports must be byte-identical
   to the plain run's; every run is held by the scene gate
   (``scenes.problems``: the reference's sha256 digests in
   pindel_tpu_torch/testing/scene{1,2}_digests.json, a non-empty ``_D``,
   a fallback ratio of at most 1%, K4 rows on scene 2 and ``pt_far_win``
   launched for them, and over the kernel runs the search kernels
   launched, equally often in each), with the median wall time, rate,
   fallback ratio, launches per kernel (``pt_close`` and ``pt_far`` must
   launch, ``pt_far_win`` once a K4 call, the standalone scan never), K4
   and legacy rows equal from run to run, and phase timers; then K1 at
   every
   recorded call's shapes (the scan calls the torch composition each
   fused kernel replaced makes for its recorded call) is held against the
   plain version, its rows are classed by seed count (the kernel walks
   only the seeded lanes of a row with two or more seeds, every lane of
   the others), each shape is timed, and each call's kernel time is split
   between the two branches' rows;
6b. ``pt_close``/``pt_far``/``pt_far_win`` (K2/K3/K4, csrc/fused_search.cu)
   bit-equal to the plain versions (``_close_kernel_ref``/
   ``_far_kernel_ref``/``_far_win_kernel_ref`` over the plain scan) at
   every fused call phases 5 and 6 recorded and on every case of
   testing/fused_cases.py (lmax 128 to 512, K4's windows past either end,
   empty and at the widest buckets); the largest call of each kernel and
   scene timed in turns with the composition it replaced (kernel,
   composition, composition, kernel; CUDA events) and once as the plain
   version, beside its bound (``measure.fused_bound``, with the earlier
   count);
7. scenes 1 and 2 with ``--backend mesh`` (the data-parallel backend,
   parallel/mesh_fused.py), over all visible cards (the CLI) and over
   ``["cuda:0", "cuda:0"]`` (two shards on one card, through
   ``run_files``): for each device list a first run that records every
   shard's search calls (each K2/K3/K4 shard call's fused kernel held
   against the composition it replaced, and the composition's K1 calls
   against the plain version on the card it ran on, each shape timed);
   then three timed runs of each list in turns with three fused runs
   (fused, mesh, mesh, then the reverse), every listed card launching
   the fused kernels, reports
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
   c. timed runs in turns, one of each: scene 1 at
      ``-w 1`` (six windows) at ``--hosts`` 1, 2 and 3 (files), scene 2 at
      ``-w 0.5`` (four windows) at ``--hosts`` 1 and 2 (store); the
      multi-process reports equal the one-process ones; the wall and rate of
      each, and each rank's devices, windows, launches, memory, wall and
      time from its spawn to its first shipped window;
9. the window-parallel search (K9, parallel/mesh.py), which no CLI reaches:
   a. the shard kernel against its plain twin, bit for bit, on every case
      of testing/shard_cases.py (DEAD and 2^30 representatives, clamped
      shard tiles, backward lanes, strict mismatches next to step 0,
      columns past 32768) and random rows, every shard at wp 1, 2, 4, 8,
      each also with its rows split over blocks and with its histograms in
      device memory; then testing/lane_cases.py:dead_level_case under
      budgets at and past the DEAD level (127), every shard against the
      twin and ``sharded_search`` over ``["cuda:0"] * 8`` against the
      twin over the CPU at three grids;
   b. ``TorchShardedBackend`` under a ``Searcher`` on a small scene against
      the NumPy oracle, over ``["cuda:0"] * 8`` at (dp, wp) = (2, 4),
      (1, 8), (4, 2) and over every visible card;
   c. phase 3b's full batch at (1, 1) and (1, 4) over cuda:0: anchors
      equal to K8's, its sampled reads equal to the twin's; every kernel
      call held against the twin over all its rows and timed, with its
      bound (``shard_bound``), the wall, launches and peak memory;
   d. ``--backend numpy`` and ``--backend jax`` on the 16 small scenes
      against the golden reports;
   e. the shard kernel against its twin on K8's small calls (the route's
      calls of phase 3b's 12-read batches), each timed;
10. scenes 1 and 2 at full size through ``--backend jax`` (K8 on the card,
   so every search through the route and the shard kernel): reports
   byte-identical to the fused runs of 5 and 6 (scene 2's also to the
   digests), the shard kernel launched, the plain ``_search_kernel`` never
   run on the card (``engine_jax.PLAIN_ON_CARD``), with the wall, the
   legacy rows and the launches; the largest shard call of each scene is
   held against the twin and timed;
11. the port's measurement tools, each in a fresh interpreter:
   ``python -m pindel_tpu_torch.tools.kernel_bench --per-round`` and
   ``multihost_bench --hosts 2``: each exits 0 with ``"correct": true`` on
   this card, its times positive, its build and first-use times logged and
   its JSON line printed on a line of its own;
12. scene 3 (testing/scenes.py:build_scene3: about 90,750 BAM read pairs
   with BreakDancer calls over 15 Mb, three 5 Mb windows, in the shape of
   the reference pindel's colousingbd15 run) once through the CLI on the
   card: K1 at every recorded call's shapes (the compositions', as in 5)
   held against the plain version (max_abs_err 0), each shape timed; the
   reports equal to the reference's digests (testing/scene3_digests.json);
   the scene gate over the recorded run (``scenes.problems`` over
   ``scenes.run_scene``: digests, a non-empty ``_D``, fallback at most 1%,
   three windows, the search kernels launched and ``_far_win_kernel`` rows
   above 0, ``pt_far_win`` launched for them);
   ``pt_far_win`` launched once a K4 call and the standalone scan never;
   the windows, K4 rows, legacy rows, shard kernel launches, search kernel
   launches and peak card memory printed, with each window's reads and
   times; then every K2/K3/K4 call of the run held against the plain
   versions and the largest of each timed as in 6b; the largest K4 call's
   critical path (``kernel_bench.tail_row``: the reads' widths and seeds,
   the widest 1%'s share of the operations, the widest read's floor, and
   (a) the whole call, (b) its widest read, (c) the call without its
   widest 1%, timed in turns);
13. scene 4 (testing/scenes.py:build_scene4: about 79,000 BAM read pairs
   over four chromosomes of 13.5 Mb in one BAM, chrE without reads, with
   interchromosomal BreakDancer calls, in the shape of a whole-genome
   run): ``scene4`` (-c ALL -I) once recorded and once with each region's
   device memory logged, ``scene4_bed`` (-j/-J: chr1 as two regions, chr3)
   and ``scene4_c`` (one -c region) through ``scenes.run_scene`` on the
   card, each held to the reference's digests (testing/scene4_digests.json)
   by ``scenes.problems`` (the windows, K4 rows, the reads the
   cross-chromosome route took on ``scene4``); ``_INT`` not empty on
   ``scene4``, ``_INT_final`` empty on the others; at the start of each
   region's window loop ``torch.cuda.memory_allocated()`` printed, no
   earlier region's backend alive and the memory no more than one
   chromosome's device state above the first region's; then ``scene4``
   through ``--backend mesh`` over ``["cuda:0", "cuda:0"]``, through
   ``--backend jax`` (the shard kernel launched, the plain
   ``_search_kernel`` never on the card) and at ``--hosts 2``, each held
   to the same digests; the standalone scan launched 0 times and
   ``pt_far_win`` once a K4 call; every K2/K3/K4 call of the recorded run
   held against the plain versions and the largest of each timed as in
   6b, and the largest K4 call's critical path as in 12.

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

from pindel_tpu_torch.testing import scenes
from pindel_tpu_torch.tools.measure import (PEAK_BYTES, PEAK_INT32_OPS,
                                            card_line, device_ms,
                                            fused_bound, region_log,
                                            row_classes, scan_bound)

REPO = os.path.dirname(os.path.abspath(__file__))
TIMED_RUNS = 3
HOSTS_TIMED_RUNS = 1        # phase 8c: each rank count, in turns
# phase 7: the device lists of the mesh runs (None: every visible card)
MESH_LISTS = {"all": None, "cuda0x2": ["cuda:0", "cuda:0"]}
# phase 8c: (label, scene, extra flags, --dist, the --hosts values in turn)
HOSTS_TIMED = [("scene1", "scene 1", ["-w", "1"], "files", (1, 2, 3)),
               ("scene2", "scene 2", ["-w", "0.5"], "store", (1, 2))]
# the timer phases phase 8c prints for each rank
HOSTS_PHASES = ("Matching close ends", "multihost: wait for worker windows",
                "Searching far ends", "Searching and reporting variations")
# phase 9: the window-parallel search (K9).  int32 operations of the shard
# kernel (csrc/sharded_search.cu) as it does the work since its redesign:
# per word of 4 columns the seed test (two word loads, the funnel shift, the
# byte compare, the mask, the multiply and shift that gather the 4 bits,
# the valid-column mask); per seeded candidate its first PATTERN_STEPS steps
# by pattern (three tile and three query word loads, four funnel shifts,
# two byte compares, two masks, two multiplies, two shifts and the or that
# build the 8-bit pattern, the bin's count and key atomics, the survivor's
# popc and compare); per step walked after those (to the step that kills a
# candidate, or the last): the tile byte load, the strict compare, the N
# compare, the xor and add to its count, the last-mismatch select, the
# death compare, the level slot's address, the count atomic, the key-level
# compare, the strict bit's compare and or, the key atomic
SHARD_SEED_OPS_PER_WORD = 8
SHARD_PATTERN_OPS = 24
SHARD_PATTERN_STEPS = 8
SHARD_STEP_OPS = 13
# the grids of the backend runs over ["cuda:0"] * 8, and the wp of the
# full-width runs over cuda:0 (dp = 1)
SHARD_GRIDS = [(2, 4), (1, 8), (4, 2)]
SHARD_FULL_WP = (1, 4)
SHARD_PLAIN_ROWS = 512      # rows per call of the plain twin at full width
# what each path of the kernels line gives of its scan calls
SCAN_KEYS = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "bound_dense_ms")
# phase 11: (name, module, arguments) of each tool, and each one's time
# limit in seconds
TOOLS = [("kernel_bench", "pindel_tpu_torch.tools.kernel_bench",
          ["--per-round"]),
         ("multihost_bench", "pindel_tpu_torch.tools.multihost_bench",
          ["--hosts", "2"])]
TOOL_TIMEOUT_S = 300


def reference_modules():
    """Loaded modules of the JAX package or of jax."""
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("pindel_tpu", "jax", "jaxlib"))


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


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
# testing/lane_cases.py batches for the route against the plain kernel:
# window buckets (65536: the int16 rep_w wrap), lanes per read, rows
LANE_BUCKETS = (2048, 8192, 32768, 65536)
LANE_NLS = (1, 2, 4)
LANE_ROWS = 64
# (max_snp, tsec_minus) of testing/lane_cases.py:dead_level_case's runs
DEAD_LEVEL_BUDGETS = ((130, 131), (3, 131), (131, 131))
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


def plain_in_row_groups(chrom, slice_start, *rest, w: int, lmax: int,
                        nl: int, mpm: int, bp_start: int):
    """``engine_jax._search_kernel`` (the plain loop) over a packed batch in
    the row groups the backend gives it on the CPU (at most ROW_ELEMS
    candidates), with ``_route_kernel``'s signature."""
    from pindel_tpu_torch.ops import engine_jax
    reverse, qq, valid_w, qlen, max_snp, tsec_minus, maxmm, max_allowed = \
        rest
    rows = [slice_start, reverse, qq, valid_w, qlen, max_snp, tsec_minus]
    step = max(1, engine_jax.TorchLaneBackend.ROW_ELEMS // (nl * w))
    parts = []
    for lo in range(0, qq.shape[0], step):
        x = [a[lo:lo + step] for a in rows]
        parts.append(engine_jax._search_kernel(
            chrom, *x, maxmm, max_allowed[lo:lo + step], w=w, lmax=lmax,
            nl=nl, mpm=mpm, bp_start=bp_start))
    return torch.cat(parts)


def route_bound(calls):
    """The least time the card could take for K8's route over the shard
    kernel ``calls`` (args, kw, out) one run made: each call's
    ``shard_bound``, then bytes at PEAK_BYTES for the rest of the route,
    each read or written once: the partials read by the merge, the
    representative's query and tile codes of every step (lmax - 1 each a
    row and length) read by the recount, and the packed [B, 5 * lmax + 2]
    int8 output written.  Returns (ms, the shard kernel's part in ms,
    "operations" or "bytes" for the kernel's part of the largest call)."""
    total = kernel = top = 0.0
    by = "bytes"
    for args, kw, out in calls:
        k_ms, k_by, *_ = shard_bound(args, kw, out)
        b, lmax = args[3].shape[0], kw["lmax"]
        rest = (sum(o.numel() * o.element_size() for o in out)
                + 2 * b * lmax * (lmax - 1) + b * (5 * lmax + 2))
        kernel += k_ms
        total += k_ms + rest / PEAK_BYTES * 1e3
        if k_ms > top:
            top, by = k_ms, k_by
    return total, kernel, by


def shard_work(cnt, after: int = 0):
    """(seeded candidates, steps they walk after step ``after``) of one
    shard kernel call, from its counts: every live seeded candidate is at
    level 0 at step 0 and walks steps 1.. until the step that kills it or
    the last step."""
    alive = cnt[:, :, :-1].sum(dim=2, dtype=torch.int64)
    dead = cnt[:, :, -1].long()
    after = min(after, cnt.shape[1] - 1)
    return (int(alive[:, 0].sum()),
            int(alive[:, after + 1:].sum())
            + int((dead[:, -1] - dead[:, after]).sum()))


def shard_bound(args, kw, out):
    """The least time the card could take for one shard kernel call: its
    int32 operations (SHARD_SEED_OPS_PER_WORD per 4 candidates of its
    columns, SHARD_PATTERN_OPS per seeded candidate, SHARD_STEP_OPS per step
    a seeded candidate walks after step SHARD_PATTERN_STEPS, counted from
    this call's output) at PEAK_INT32_OPS, or its bytes (each lane's tile
    span of the chromosome and every other input read once, the partials
    written once) at PEAK_BYTES, whichever is longer.  Returns (ms,
    "operations" or "bytes", seeded candidates, walked steps)."""
    _chrom, slice_start, reverse, qq, valid_w, max_snp, tsec_minus = args
    b, nl = slice_start.shape
    cands = b * nl * kw["w_local"]
    seeded, walked = shard_work(out[0])
    _seeded, walked_on = shard_work(out[0], SHARD_PATTERN_STEPS)
    ops = (cands * SHARD_SEED_OPS_PER_WORD / 4 + seeded * SHARD_PATTERN_OPS
           + walked_on * SHARD_STEP_OPS)
    nbytes = (b * nl * (kw["w_local"] + kw["lmax"])
              + sum(x.numel() * x.element_size()
                    for x in (slice_start, reverse, qq, valid_w, max_snp,
                              tsec_minus))
              + sum(o.numel() * o.element_size() for o in out))
    t_ops, t_bytes = ops / PEAK_INT32_OPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", seeded, walked)


def packed_args(chrom_t, maxmm_t, lanes, ms, tm, rate: float, w: int,
                lmax: int):
    """The ten device tensors of K8's packed kernel for a batch of lanes,
    packed as ``TorchLaneBackend.run`` packs them."""
    from pindel_tpu_torch.ops.engine_jax import pack_lanes
    nl = max(len(read_lanes) for read_lanes in lanes)
    slice_start, rev, qq, valid_w = pack_lanes(lanes, len(lanes), nl, w,
                                               lmax)[:4]
    qlen = np.array([len(read_lanes[0].query) for read_lanes in lanes],
                    np.int32)
    max_allowed = np.float32(qlen.astype(np.float64) * np.float64(rate))
    host = (slice_start, rev, qq, valid_w, qlen, np.array(ms, np.int32),
            np.array(tm, np.int32))
    dev = chrom_t.device
    return ([chrom_t] + [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                         for a in host]
            + [maxmm_t, torch.from_numpy(max_allowed).to(dev)]), nl


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


def run_tool(name: str, module: str, argv, card: str) -> dict:
    """``python -m module argv`` in a fresh interpreter from the checkout;
    fails unless it exits 0 within TOOL_TIMEOUT_S and prints a JSON line
    last.  Prints that line on a line of its own; returns it."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    t0 = time.monotonic()
    res = subprocess.run([sys.executable, "-m", module, *argv], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=TOOL_TIMEOUT_S)
    wall = time.monotonic() - t0
    if res.returncode != 0:
        sys.stderr.write(res.stderr[-6000:])
        fail(f"{name} ({module} {' '.join(argv)}) exited "
             f"{res.returncode}")
    line = json.loads(res.stdout.strip().splitlines()[-1])
    log(f"{name}: {module} {' '.join(argv)} exited 0 in {wall:.1f} s; "
        f"kernel and library builds {line['build_s']:.3f} s, first use "
        f"{line['first_use_s']}  [{card}]")
    log(json.dumps(line))
    if line.get("correct") is not True:
        fail(f"{name}: correct is {line.get('correct')}")
    if line.get("device") != card:
        fail(f"{name}: device {line.get('device')!r}, not {card!r}")
    return line


def run_counts(c) -> dict:
    """The launches of a recorded run (``scenes.run_scene``'s counters) by
    kernel: ``launches`` the standalone scan's, then the fused kernels'."""
    return dict(launches=c["scan_launches"],
                close_launches=c["close_launches"],
                far_launches=c["far_launches"],
                far_win_launches=c["far_win_launches"])


def check_tools(tools) -> None:
    """Phase 11's checks of the tools' lines: times positive, one launch a
    fused call, and the workers' start-up timed."""
    for call, c in tools["kernel_bench"]["calls"].items():
        # K2, K3 and K4: one fused launch, the composition timed beside it
        if not (c["ms"] > 0 and c["k1_ms"] > 0 and c["bound_ms"] > 0
                and c["launches"] == 1 and c["parent_ms"] > 0):
            fail(f"kernel_bench {call}: {c}")
    m = tools["multihost_bench"]
    workers = m["ranks"][1:]
    if not (m["t1"] > 0 and m["tN"] > 0 and m["speedup"] > 0 and workers
            and all(r["spawn_to_ready_s"] > 0 for r in workers)):
        fail(f"multihost_bench: {m}")
    log(f"phase 11: kernel_bench's {len(tools['kernel_bench']['calls'])} "
        f"calls one launch each; --hosts {m['hosts']} speedup "
        f"{m['speedup']:.3f}")


def tool_summary(tools) -> dict:
    """What the kernels line keeps of the tools' lines."""
    return dict(
        kernel_bench={k: {x: c[x] for x in ("ms", "parent_ms", "k1_ms",
                                            "bound_ms", "earlier_bound_ms",
                                            "launches")}
                      for k, c in tools["kernel_bench"]["calls"].items()},
        multihost_bench=dict(speedup=tools["multihost_bench"]["speedup"]))


def main() -> int:
    t_start = time.monotonic()

    def mark(phase: str) -> None:
        log(f"phase {phase} starts at {time.monotonic() - t_start:.1f} s of "
            "command time")

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
    from pindel_tpu_torch.ops import (engine_fused, engine_jax, fused_cuda,
                                      scan_cuda, sharded_search_cuda)
    from pindel_tpu_torch.ops import sharded_search as sss
    from pindel_tpu_torch.ops.scan import scan_rows_ref
    from pindel_tpu_torch.tools import kernel_bench
    from pindel_tpu_torch.testing.fused_cases import CASES as FUSED_CASES
    from pindel_tpu_torch.testing.fused_cases import fused_case
    from pindel_tpu_torch.testing.lane_cases import (dead_level_case,
                                                     lane_case)
    from pindel_tpu_torch.testing.scan_cases import (BUCKET_LMAXES,
                                                     BUCKET_ROWS, KINDS,
                                                     W_BUCKETS, branch_case,
                                                     bucket_case)
    from pindel_tpu_torch.pipeline import (g_fallback, g_timer, g_xchrom,
                                          run_files)
    from pindel_tpu_torch.testing.scenes import (BAM_SCENES, SCENE1,
                                                 SCENE4_DIGESTS,
                                                 SCENE4_RUNS, SMALL_SCENES,
                                                 SUITE_BACKENDS,
                                                 SUITE_SCENES, bam_argv,
                                                 digests, legacy_anchors,
                                                 load_digests, load_golden,
                                                 reports, sharded_anchors,
                                                 two_region_lanes,
                                                 write_scene)

    # ---- 0. the port stands on its own
    loaded = reference_modules()
    if loaded:
        fail(f"the port's imports loaded {loaded}")
    log("imports: no module of pindel_tpu or jax loaded")

    mark("1")
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

    mark("2")
    # ---- 2. build: one nvcc per kernel source, all started together
    def timed_build(module):
        t0 = time.monotonic()
        info = module.build(force=True, ptxas_info=True)
        return info, time.monotonic() - t0

    modules = [("scan", scan_cuda), ("fused", fused_cuda),
               ("shard", sharded_search_cuda)]
    with concurrent.futures.ThreadPoolExecutor(len(modules)) as pool:
        builds = {name: pool.submit(timed_build, module)
                  for name, module in modules}
        for name, future in builds.items():
            info, sec = future.result()
            log(f"build: {name} kernel built in {sec:.3f} s")
            for line in info.splitlines():
                if any(k in line for k in ("entry function", "registers",
                                           "spill")):
                    log("  ptxas: " + line.strip())

    dev = torch.device("cuda")
    max_err = 0
    mark("3")
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
    # the bucket sweep of tests/test_pallas_onchip.py
    for w in W_BUCKETS:
        for lmax in BUCKET_LMAXES:
            case = [torch.from_numpy(a).to(dev) for a in bucket_case(w, lmax)]
            kw = dict(w=w, lmax=lmax, mpm=3, lsteps=min(112, lmax))
            err = compare(case, kw, scan_cuda.scan_rows_cuda, scan_rows_ref)
            log(f"kernel vs plain, bucket sweep: w={w} lmax={lmax} rows="
                f"{BUCKET_ROWS} lsteps={kw['lsteps']} max_abs_err={err}")
            max_err = max(max_err, err)
            if err:
                fail(f"kernel disagrees with its plain version on the bucket "
                     f"sweep's case w={w} lmax={lmax} (max {err})")
    log(f"bucket sweep: {len(W_BUCKETS) * len(BUCKET_LMAXES)} cases, "
        "max_abs_err=0")

    mark("3b")
    # ---- 3b. legacy per-lane backend (K8): the route on the card
    from pindel_tpu_torch.config import Settings
    settings_l = Settings()
    lane_kw = dict(lmax=128, mpm=settings_l.min_perfect_match_around_bp)
    for w in LANE_BUCKETS:
        for nl in LANE_NLS:
            arrays = lane_case(w + nl, w=w, nl=nl, rows=LANE_ROWS)
            case = [torch.from_numpy(np.array(a)).to(dev) for a in arrays]
            kw = dict(lane_kw, w=w, nl=nl, bp_start=10)
            got = engine_jax._route_kernel(*case, **kw)
            want = engine_jax._search_kernel(*case, **kw)
            if not torch.equal(got, want):
                fail(f"K8 route at w={w} nl={nl}: packed buffer differs "
                     "from the plain kernel's on the card")
            emit, _mm, _lane, rep_w, _full = engine_jax.unpack_kernel_output(
                got.cpu().numpy(), 128)
            wraps = int((rep_w[emit] < 0).sum())
            if w == 65536 and not wraps:
                fail(f"K8 route at w={w} nl={nl}: no emission past the "
                     "int16 wrap")
            log(f"K8 route vs plain on the card, lane cases w={w} nl={nl}: "
                f"{LANE_ROWS} rows, packed buffers byte-identical, "
                f"{int(emit.sum())} emissions ({wraps} with a wrapped "
                "int16 rep_w)")
    # budgets at and past the DEAD level (-a 130, a budget table reaching
    # 127): the kernel keeps its histograms in device memory there
    past_dead = [(f"dead-level rows ms={ms} tm={tm}", dead_level_case(ms, tm))
                 for ms, tm in DEAD_LEVEL_BUDGETS]
    for ms, tm in ((3, 130), (130, 140)):
        arrays = list(lane_case(ms + tm, w=512, nl=2, rows=8, lmax=256))
        arrays[6] = np.full(8, ms, np.int32)
        arrays[7] = np.full(8, tm, np.int32)
        past_dead.append((f"lane case lmax=256 ms={ms} tm={tm}",
                          (arrays, dict(w=512, lmax=256, nl=2, mpm=3,
                                        bp_start=10))))
    for label, (arrays, kw) in past_dead:
        case = [torch.from_numpy(np.array(a)).to(dev) for a in arrays]
        got = engine_jax._route_kernel(*case, **kw)
        if not torch.equal(got, engine_jax._search_kernel(*case, **kw)):
            fail(f"K8 route, {label}: packed buffer differs from the plain "
                 "kernel's on the card")
        emit = engine_jax.unpack_kernel_output(got.cpu().numpy(),
                                               kw["lmax"])[0]
        log(f"K8 route vs plain on the card, {label}: packed buffers "
            f"byte-identical, {int(emit.sum())} emissions")
    # the route's shard calls on the small two-region batches (phase 9e
    # holds them against the twin and times them)
    small_calls = []
    small_launches = 0
    real_partials = sss.shard_partials

    def recording_partials(*a, **kw):
        small_calls.append(([x.clone() for x in a], dict(kw)))
        return real_partials(*a, **kw)

    for scale, bucket in LEGACY_SCALES.items():
        batch = two_region_lanes(scale, 12, scale)
        chrom_s, lanes_s, ms_s, tm_s = batch
        chrom_t = torch.from_numpy(np.array(chrom_s.seq, np.int8)).to(dev)
        maxmm_t = torch.from_numpy(
            np.array(settings_l.max_mismatch(), np.int32)).to(dev)
        case, nl = packed_args(chrom_t, maxmm_t, lanes_s, ms_s, tm_s,
                               settings_l.max_allowed_mismatch_rate, bucket,
                               128)
        kw = dict(lane_kw, w=bucket, nl=nl, bp_start=10)
        if not torch.equal(engine_jax._route_kernel(*case, **kw),
                           engine_jax._search_kernel(*case, **kw)):
            fail(f"K8 route at w={bucket}: packed buffer differs from the "
                 "plain kernel's on the card")
        sss.shard_partials = recording_partials
        sharded_search_cuda.LAUNCHES = 0
        try:
            t0 = time.monotonic()
            on_card = legacy_anchors(batch, "cuda")
            torch.cuda.synchronize()
            t1 = time.monotonic()
        finally:
            sss.shard_partials = real_partials
        small_launches += sharded_search_cuda.LAUNCHES
        if not sharded_search_cuda.LAUNCHES:
            fail(f"legacy backend at w={bucket}: the shard kernel never "
                 "launched")
        on_cpu = legacy_anchors(batch, "cpu")
        t2 = time.monotonic()
        if on_card != on_cpu:
            fail(f"legacy backend at w={bucket}: card and CPU disagree")
        hits = sum(bool(key) for key, _ in on_card)
        if hits == 0:
            fail(f"legacy backend at w={bucket}: no read found a far end")
        log(f"legacy backend w={bucket}: {len(on_card)} reads x 4 lanes, "
            f"{hits} with anchors, route's packed buffer byte-identical to "
            f"the plain kernel's on the card, card (route) equal to CPU "
            f"(plain); card {t1 - t0:.3f} s, CPU {t2 - t1:.3f} s  [{card}]")
        del chrom_t, case

    # the same lanes at the size the path would really get: the route, then
    # the plain loop once, both on the card
    n_full = engine_jax.TorchLaneBackend.MAX_CHUNK
    t0 = time.monotonic()
    chrom, lanes, ms, tm = two_region_lanes(LEGACY_FULL_SCALE, n_full,
                                            LEGACY_FULL_SCALE)
    log(f"legacy backend full batch: {n_full} reads x 4 lanes built in "
        f"{time.monotonic() - t0:.1f} s")
    legacy_full = {}
    route_calls = []

    def recording_route(*a, **kw):
        out = real_partials(*a, **kw)
        route_calls.append((a, dict(kw), out))
        return out

    route_kernel = engine_jax._route_kernel
    for search, kernel in (("route", route_kernel),
                           ("plain", plain_in_row_groups)):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        g_timer.reset()
        sharded_search_cuda.LAUNCHES = 0
        # the backend runs _route_kernel on the card; the plain loop takes
        # its place for the comparison
        engine_jax._route_kernel = kernel
        sss.shard_partials = recording_route
        try:
            t0 = time.monotonic()
            got = legacy_anchors((chrom, lanes, ms, tm), "cuda")
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
        finally:
            engine_jax._route_kernel = route_kernel
            sss.shard_partials = real_partials
        legacy_full[search] = dict(
            anchors=got, wall=wall, phases=g_timer.items(),
            peak=torch.cuda.max_memory_allocated() - base,
            launches=sharded_search_cuda.LAUNCHES)
    if legacy_full["route"]["launches"] != 1 or \
            legacy_full["plain"]["launches"]:
        fail(f"legacy backend full batch: shard kernel launches "
             f"{legacy_full['route']['launches']} through the route, "
             f"{legacy_full['plain']['launches']} through the plain loop")
    on_card = legacy_full["route"]["anchors"]
    if on_card != legacy_full["plain"]["anchors"]:
        bad = sum(a != b for a, b in zip(on_card,
                                         legacy_full["plain"]["anchors"]))
        fail(f"legacy backend full batch: the route and the plain loop "
             f"disagree on {bad} reads")
    legacy_card_s = legacy_full["route"]["wall"]
    legacy_plain_s = legacy_full["plain"]["wall"]
    search_s = {k: sum(sec for name, sec in v["phases"].items()
                       if name.startswith("device: kernel+xfer"))
                for k, v in legacy_full.items()}
    r_bound, r_kernel_bound, r_bound_by = route_bound(route_calls)
    del route_calls
    legacy_route = dict(launches=legacy_full["route"]["launches"],
                        wall=legacy_card_s, plain_wall=legacy_plain_s,
                        search_ms=search_s["route"] * 1e3,
                        plain_search_ms=search_s["plain"] * 1e3,
                        bound_ms=r_bound, bound_by=r_bound_by)
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
        f"{hits} with anchors; the route and the plain loop on the card "
        f"equal on every read, the CPU equal on {len(sample)} sampled "
        f"reads; route {legacy_card_s:.3f} s ({n_full / legacy_card_s:.1f} "
        f"reads/s, peak device memory above the baseline "
        f"{legacy_full['route']['peak'] / 2 ** 20:.1f} MiB), plain loop "
        f"{legacy_plain_s:.3f} s (peak "
        f"{legacy_full['plain']['peak'] / 2 ** 20:.1f} MiB, row groups of "
        f"{engine_jax.TorchLaneBackend.ROW_ELEMS} candidates), CPU "
        f"{cpu_s:.3f} s for the sample  [{card}]")
    log(f"legacy backend full batch, the route's bound: {r_bound:.4f} ms "
        f"({r_bound_by}; the shard kernel's {r_kernel_bound:.4f} ms, then "
        f"the partials read by the merge, the representatives' codes read "
        f"by the recount and the packed output written, once each), "
        f"{r_bound / legacy_route['search_ms']:.2%} of the route's search "
        f"phase ({legacy_route['search_ms']:.3f} ms: kernel, merge, "
        f"recount, rules, download)  [{card}]")
    log(f"legacy backend full batch, the plain loop's bound: {bound:.3f} ms "
        f"({bound_by}; {LEGACY_OPS} int32 operations per seeded candidate "
        f"and step of its read, as the plain loop works), "
        f"{bound / legacy_route['plain_search_ms']:.2%} of the plain loop's "
        f"search phase ({legacy_route['plain_search_ms']:.3f} ms); from the "
        f"shapes alone (every candidate of [B, NL, W] for lmax steps) "
        f"{bound_shapes:.3f} ms  [{card}]")
    for search in ("route", "plain"):
        for pname, sec in sorted(legacy_full[search]["phases"].items(),
                                 key=lambda kv: -kv[1]):
            log(f"  {search} phase {pname:<46s} {sec:9.3f} s  [{card}]")
    # phase 9 holds the window-parallel search against K8 on this batch
    legacy_batch, legacy_on_card = (chrom, lanes, ms, tm), on_card
    # the plain kernel's runs on the card so far were comparisons; no
    # later phase may add one
    log(f"phase 3b ran the plain _search_kernel {engine_jax.PLAIN_ON_CARD} "
        "times on the card, for its comparisons; the count starts again "
        "at 0 and must stay there")
    engine_jax.PLAIN_ON_CARD = 0
    del chrom, lanes, on_card, legacy_full
    torch.cuda.empty_cache()

    def check_run(label, launches, device_run=True):
        """scenes.problems' launch and fallback rules, for a CLI run that
        is not a scene's recorded run."""
        if device_run and launches == 0:
            fail(f"{label}: the search kernels never launched")
        if device_run and g_fallback.ratio() > scenes.MAX_FALLBACK:
            fail(f"{label}: fallback ratio {g_fallback.ratio()}")

    def gate(label, scene, runs, kernel=True):
        """``scenes.problems`` over a scene's recorded runs."""
        bad = scenes.problems(scene, runs, kernel)
        if bad:
            fail(f"{label}: {bad}")

    def same_reports(label, want, port):
        if set(want) != set(port):
            fail(f"{label}: report sets differ "
                 f"{sorted(set(want) ^ set(port))}")
        diff = [k for k in want if want[k] != port[k]]
        if diff:
            fail(f"{label}: reports differ from numpy: {diff}")

    def reset_counts():
        fused_cuda.reset_launches()     # the scan's counts and the fused's
        sharded_search_cuda.LAUNCHES = 0
        sharded_search_cuda.LAUNCHES_BY_DEVICE.clear()
        engine_fused.FAR_WIN_ROWS = 0
        engine_jax.LEGACY_ROWS = 0

    FUSED = ("_close_kernel", "_far_kernel", "_far_win_kernel")
    fused_kernels = {name: getattr(engine_fused, name) for name in FUSED}
    PLAIN = {"_close_kernel": engine_fused._close_kernel_ref,
             "_far_kernel": engine_fused._far_kernel_ref,
             "_far_win_kernel": engine_fused._far_win_kernel_ref}
    WRAPPER = {"_close_kernel": "pt_close", "_far_kernel": "pt_far",
               "_far_win_kernel": "pt_far_win"}

    def recorded(run):
        """``run()`` with every search call of the main path recorded (on
        each shard's own card): the fused calls (K2, K3, K4) as (name,
        chromcat, payload, maxmm, static).  Returns its result and the
        fused calls; K1's calls at the main path's shapes are those of the
        composition each fused kernel replaced (``composition_calls``)."""
        fused = []
        real = {name: getattr(engine_fused, name) for name in FUSED}

        def recording_call(name):
            def call(chromcat, payload, maxmm, **static):
                fused.append((name, chromcat, payload.clone(), maxmm,
                              dict(static)))
                return real[name](chromcat, payload, maxmm, **static)
            return call

        for name in FUSED:
            setattr(engine_fused, name, recording_call(name))
        try:
            result = run()
        finally:
            for name, fn in real.items():
                setattr(engine_fused, name, fn)
        return result, fused

    def composition_calls(fused):
        """The scan calls the torch composition (``_close_kernel_ref`` /
        ``_far_kernel_ref`` / ``_far_win_kernel_ref`` over K1) makes for
        each recorded fused call, on its card."""
        out = []
        kernel_scan = engine_fused.scan_rows

        def recording(*a, **kw):
            out.append(([x.clone() for x in a], dict(kw)))
            return kernel_scan(*a, **kw)

        engine_fused.scan_rows = recording
        try:
            with torch.inference_mode():
                for name, chromcat, payload, maxmm, static in fused:
                    with torch.cuda.device(payload.device):
                        PLAIN[name](chromcat, payload, maxmm, **static)
        finally:
            engine_fused.scan_rows = kernel_scan
        return out

    def plain_call(name, chromcat, payload, maxmm, static):
        """The plain version of a fused call: its ``_ref`` body over the
        plain scan, pure PyTorch on the card."""
        kernel_scan = engine_fused.scan_rows
        engine_fused.scan_rows = scan_rows_ref
        try:
            return PLAIN[name](chromcat, payload, maxmm, **static)
        finally:
            engine_fused.scan_rows = kernel_scan

    def launch_counts():
        """The search kernels' launches since reset_counts()."""
        return dict(scan=scan_cuda.LAUNCHES,
                    close=fused_cuda.LAUNCHES_BY_KERNEL["close"],
                    far=fused_cuda.LAUNCHES_BY_KERNEL["far"],
                    far_win=fused_cuda.LAUNCHES_BY_KERNEL["far_win"])

    def largest_k4_tail(label, fused):
        """``kernel_bench.tail_row`` of a run's largest K4 call: the reads'
        widths and seeds, the widest 1%'s share, the widest read's floor,
        and (a) the whole call, (b) its widest read, (c) the call without
        its widest 1%, timed in turns."""
        mine = [c for c in fused if c[0] == "_far_win_kernel"]
        _n, chromcat, payload, maxmm, static = max(
            mine, key=lambda c: c[2].shape[0])
        with torch.inference_mode():
            row = kernel_bench.tail_row(chromcat, payload, maxmm, static,
                                        dev)
        log(kernel_bench.tail_line(f"{label}'s largest K4 call", row, card))
        if not row["equal_to_plain"]:
            fail(f"{label}: K4 on its largest call's subsets disagrees with "
                 "the plain version")
        return row

    def check_path(label, k4_rows, k4_calls=None):
        """The launches of the last CLI run (counted from reset_counts() or
        from ``scenes.run_scene``'s start): K1's standalone scan never (its
        walk runs inside the fused kernels), ``pt_far_win`` wherever K4
        searched rows, once a K4 call (``k4_calls``, where the calls were
        counted)."""
        counts = launch_counts()
        if counts["scan"]:
            fail(f"{label}: the standalone scan launched {counts['scan']} "
                 "times on a CLI path")
        if k4_rows and not counts["far_win"]:
            fail(f"{label}: K4 searched {k4_rows} rows but pt_far_win never "
                 "launched")
        if k4_calls is not None and counts["far_win"] != k4_calls:
            fail(f"{label}: pt_far_win launched {counts['far_win']} times "
                 f"for {k4_calls} K4 calls")
        return counts

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

    def full_scene(label, scene, d):
        """5/6: recorded, plain, timed and per-call phases of one full-size
        ``scenes.Scene``, each run through ``scenes.run_scene`` under a
        prefix in ``d``; returns the median run and the scan checks."""
        def run(name):
            return scenes.run_scene(scene, os.path.join(d, name), dev)

        # a. first run (cold): record every search call of the main path
        first, fused = recorded(lambda: run("rec"))
        k4_calls = sum(c[0] == "_far_win_kernel" for c in fused)
        # b. the plain versions in the kernels' place (the _ref bodies over
        # the plain scan): the reference reports
        kernel_scan = engine_fused.scan_rows
        engine_fused.scan_rows = scan_rows_ref
        for name in FUSED:
            setattr(engine_fused, name, PLAIN[name])
        try:
            plain = run("plain")
        finally:
            engine_fused.scan_rows = kernel_scan
            for name in FUSED:
                setattr(engine_fused, name, fused_kernels[name])
        if plain["launches"]:
            fail(f"{label}: the plain run launched a kernel")
        gate(f"{label} plain run", scene, [plain], kernel=False)
        want = reports(os.path.join(d, "plain"))
        if reports(os.path.join(d, "rec")) != want:
            fail(f"{label}: the first kernel run's reports differ from the "
                 "plain run's")
        log(f"{label}: first run {first['wall']:.3f} s ({len(fused)} "
            f"K2/K3/K4 calls recorded, {k4_calls} of them K4's), plain run "
            f"{plain['wall']:.3f} s  [{card}]")

        # c. timed runs through the kernels
        runs = []
        for i in range(TIMED_RUNS):
            r = run(f"run{i}")
            c = r["counters"]
            if not (c["close_launches"] and c["far_launches"]):
                fail(f"{label} run {i}: pt_close/pt_far launches "
                     f"{run_counts(c)}")
            check_path(f"{label} run {i}", c["far_win_rows"], k4_calls)
            if reports(os.path.join(d, f"run{i}")) != want:
                fail(f"{label} run {i}: reports differ from the plain "
                     "run's")
            runs.append(r)
            log(f"{label} run {i}: wall {r['wall']:.3f} s, "
                f"{scene.n / r['wall']:.1f} {scene.unit}/s, launches "
                f"{run_counts(c)}  [{card}]")
        gate(label, scene, [first] + runs)
        for key in ("far_win_rows", "legacy_rows"):
            if len({r["counters"][key] for r in runs}) != 1:
                fail(f"{label}: {key} differ between runs "
                     f"{[r['counters'][key] for r in runs]}")
        walls = [r["wall"] for r in runs]
        med = runs[walls.index(statistics.median(walls))]
        c = med["counters"]
        log(f"{label}: median wall {med['wall']:.3f} s of {TIMED_RUNS} "
            f"({scene.n / med['wall']:.1f} {scene.unit}/s), reports "
            f"byte-identical to the plain run and the reference's digests, "
            f"fallback {med['fallback']:.6f}, launches {run_counts(c)}, "
            f"_far_win_kernel rows {c['far_win_rows']}, legacy rows "
            f"{c['legacy_rows']}, peak device memory {c['peak_mib']:.1f} MiB"
            f"  [{card}]")
        for pname, sec in sorted(med["phases"].items(),
                                 key=lambda kv: -kv[1]):
            log(f"  phase {pname:<52s} {sec:9.3f} s  [{card}]")

        log(f"{label}: standalone scan (scan_rows) launches on the path "
            f"{c['scan_launches']}, pt_far_win {c['far_win_launches']} for "
            f"{k4_calls} K4 calls  [{card}]")
        # d. K1 at every recorded call's shapes (as the compositions the
        # fused kernels replaced call it): kernel vs plain, time per shape
        scan = check_calls(label, composition_calls(fused), split=True)
        torch.cuda.empty_cache()

        if args.profile_dir:
            from torch.profiler import ProfilerActivity, profile
            os.makedirs(args.profile_dir, exist_ok=True)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                prof_wall = run_cli(port_main,
                                    scene.argv_of(os.path.join(d, "prof")))
            table = prof.key_averages().table(sort_by="cuda_time_total",
                                              row_limit=40)
            path = os.path.join(args.profile_dir,
                                f"{label.replace(' ', '')}_profile.txt")
            with open(path, "w") as fh:
                fh.write(f"{card}\nwall under profiler {prof_wall:.3f} s\n")
                fh.write(table)
            log(f"profile: {path} (wall under profiler {prof_wall:.3f} s)")
        return dict({k: scan[k] for k in SCAN_KEYS}, **run_counts(c),
                    far_win_rows=c["far_win_rows"], wall=med["wall"],
                    want=want, fused=fused)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        mark("4")
        # ---- 4. the CLI on small text scenes vs the golden NumPy reports
        golden = load_golden()
        for scene, (scene_kw, flags, _fields) in SMALL_SCENES.items():
            d = os.path.join(work, scene)
            os.makedirs(d)
            fa, reads_txt, n = write_scene(d, **scene_kw)
            reset_counts()
            run_cli(port_main, ["-f", fa, "-p", reads_txt,
                                "-o", os.path.join(d, "port"), "-s", *flags])
            launches = launch_counts()
            port = reports(os.path.join(d, "port"))
            same_reports(f"scene {scene}", golden[scene], port)
            if not port["CloseEndMapped"]:
                fail(f"scene {scene}: no close end mapped")
            check_run(f"scene {scene}", fused_cuda.search_launches())
            if not launches["close"]:
                fail(f"scene {scene}: pt_close never launched")
            check_path(f"scene {scene}", engine_fused.FAR_WIN_ROWS)
            log(f"small scene {scene} {flags}: {n} reads, {len(port)} "
                f"reports byte-identical to numpy, launches {launches}, "
                f"fallback {g_fallback.fallback}/{g_fallback.total}")

        mark("4b")
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
            check_run(f"BAM scene {scene}", fused_cuda.search_launches(),
                      device_run="-g" not in spec.flags)
            if spec.far_win and engine_fused.FAR_WIN_ROWS == 0:
                fail(f"BAM scene {scene}: _far_win_kernel searched no read")
            check_path(f"BAM scene {scene}", engine_fused.FAR_WIN_ROWS)
            log(f"small BAM scene {scene} {list(spec.flags)}: {len(port)} "
                f"reports byte-identical to numpy, launches "
                f"{launch_counts()}, _far_win_kernel rows "
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
        # the reference suite's scenes, through each backend named for them
        for scene, spec in SUITE_SCENES.items():
            d = os.path.join(work, scene)
            os.makedirs(d)
            built = spec.build(d)
            for backend in SUITE_BACKENDS[scene]:
                label = f"suite scene {scene} --backend {backend}"
                prefix = os.path.join(d, backend)
                reset_counts()
                engine_jax.PLAIN_ON_CARD = 0
                run_cli(port_main, bam_argv(spec, built, prefix)
                        + ["--backend", backend])
                port = reports(prefix)
                same_reports(label, golden[scene], port)
                fused_n = fused_cuda.search_launches()
                shard_n = sharded_search_cuda.LAUNCHES
                if backend in ("fused", "mesh"):
                    check_run(label, fused_n)
                    check_path(label, engine_fused.FAR_WIN_ROWS)
                elif backend == "jax" and (not shard_n or fused_n
                                           or engine_jax.PLAIN_ON_CARD):
                    fail(f"{label}: shard kernel launches {shard_n}, fused "
                         f"{fused_n}, plain _search_kernel on the card "
                         f"{engine_jax.PLAIN_ON_CARD}")
                elif backend == "numpy" and (fused_n or shard_n):
                    fail(f"{label}: the host oracle's run launched "
                         f"{fused_n} fused and {shard_n} shard kernels")
                # the interchromosomal call's windows: K4 on the partner
                # backend under fused, the oracle under the others
                want = ((g_xchrom.reads, 0) if backend == "fused"
                        else (0, g_xchrom.reads))
                if scene.startswith("bam_int") and (
                        (engine_fused.FAR_WIN_ROWS > 0)
                        != (backend == "fused")
                        or (g_xchrom.device, g_xchrom.oracle) != want):
                    fail(f"{label}: the interchromosomal call's windows sent "
                         f"{engine_fused.FAR_WIN_ROWS} rows to K4, "
                         f"{g_xchrom.oracle} reads to the oracle")
                log(f"{label} {list(spec.flags)}: {len(port)} reports "
                    f"byte-identical to numpy, launches {launch_counts()}, "
                    f"shard kernel {shard_n}, _far_win_kernel rows "
                    f"{engine_fused.FAR_WIN_ROWS}, fallback "
                    f"{g_fallback.fallback}/{g_fallback.total}")

        mark("5")
        # ---- 5. scene 1 at full size
        s1 = os.path.join(work, "scene1")
        os.makedirs(s1)
        t0 = time.monotonic()
        spec1 = scenes.make_scene1(s1)
        n1 = spec1.n
        log(f"scene 1: {n1} reads over {SCENE1['chrom_len']} bp, built in "
            f"{time.monotonic() - t0:.1f} s")

        def argv1(run):
            return spec1.argv_of(os.path.join(s1, run))

        scene1 = full_scene("scene 1", spec1, s1)
        max_err = max(max_err, scene1["max_abs_err"])

        mark("6")
        # ---- 6. scene 2 at full size
        s2 = os.path.join(work, "scene2")
        os.makedirs(s2)
        t0 = time.monotonic()
        spec2 = scenes.make_scene2(s2)
        n2 = spec2.n
        log(f"scene 2: {n2} read pairs over 2000000 bp (BAM + BreakDancer "
            f"calls), built in {time.monotonic() - t0:.1f} s")

        def argv2(run):
            return spec2.argv_of(os.path.join(s2, run))

        scene2 = full_scene("scene 2", spec2, s2)
        max_err = max(max_err, scene2["max_abs_err"])

        mark("6b")
        # ---- 6b. K2, K3 and K4 on the card: pt_close/pt_far/pt_far_win
        # bit-equal to the plain versions at every fused call of scenes 1
        # and 2 (phases 5 and 6 recorded them; scene 3's in phase 12) and on
        # the edge cases of testing/fused_cases.py; the largest call of each
        # timed in turns with the composition it replaced, beside its bound
        def check_fused(label, fused):
            err_all = 0
            out = {}
            with torch.inference_mode():
                for name, chromcat, payload, maxmm, static in fused:
                    with torch.cuda.device(payload.device):
                        got = fused_kernels[name](chromcat, payload, maxmm,
                                                  **static)
                        want = plain_call(name, chromcat, payload, maxmm,
                                          static)
                        err = int((got.long() - want.long()).abs().max()
                                  ) if got.numel() else 0
                    err_all = max(err_all, err)
                    log(f"{label} {name} call, {payload.shape[0]} reads: "
                        f"kernel vs plain max_abs_err={err}")
                if err_all:
                    fail(f"{label}: the fused kernels disagree with the plain "
                         f"versions (max {err_all})")
                for name in FUSED:
                    mine = [c for c in fused if c[0] == name]
                    if not mine:
                        continue
                    _n, chromcat, payload, maxmm, static = max(
                        mine, key=lambda c: c[2].shape[0])

                    def call():
                        return fused_kernels[name](chromcat, payload, maxmm,
                                                   **static)

                    def comp():
                        return PLAIN[name](chromcat, payload, maxmm, **static)

                    # in turns: kernel, composition, composition, kernel
                    t = [time_ms(f, 5) for f in (call, comp, comp, call)]
                    plain = time_ms(lambda: plain_call(
                        name, chromcat, payload, maxmm, static), 1)
                    b = fused_bound(name, chromcat, payload, maxmm, static)
                    row = dict(rows=int(payload.shape[0]), calls=len(mine),
                               ms=min(t[0], t[3]), parent_ms=min(t[1], t[2]),
                               plain_ms=plain, bound_ms=b["bound_ms"],
                               bound_by=b["bound_by"],
                               earlier_bound_ms=b["composition_bound_ms"],
                               rows_scanned=b["rows_scanned"],
                               rows_all=b["rows_all"], max_abs_err=err_all)
                    log(f"{label} {name} ({WRAPPER[name]}): largest of "
                        f"{len(mine)} calls, {payload.shape[0]} reads: kernel "
                        f"{row['ms']:.4f} ms ({t[0]:.4f}, {t[3]:.4f}), "
                        f"the composition it replaced "
                        f"{row['parent_ms']:.4f} ms ({t[1]:.4f}, "
                        f"{t[2]:.4f}), {row['parent_ms'] / row['ms']:.2f}"
                        f"x; plain {plain:.3f} ms; bound "
                        f"{row['bound_ms']:.4f} ms ({row['bound_by']}, "
                        f"{row['rows_scanned']} of {row['rows_all']} scan "
                        f"rows), {row['bound_ms'] / row['ms']:.1%} of "
                        f"it; the earlier count "
                        f"{row['earlier_bound_ms']:.4f} ms  [{card}]")
                    out[name] = row
            torch.cuda.empty_cache()
            return out

        whole = {"scene1": check_fused("scene 1", scene1.pop("fused")),
                 "scene2": check_fused("scene 2", scene2.pop("fused"))}
        edge_err = dict.fromkeys(FUSED, 0)
        with torch.inference_mode():
            for case in FUSED_CASES:
                name, chrom_c, maxmm_c, payload_c, static = fused_case(case)
                args_c = (engine_fused._chrom_cat(
                    torch.from_numpy(chrom_c).to(dev)),
                    torch.from_numpy(payload_c).to(dev),
                    torch.from_numpy(maxmm_c.copy()).to(dev))
                got = fused_kernels[name](*args_c, **static)
                want = plain_call(name, *args_c, static)
                err = int((got.long() - want.long()).abs().max())
                edge_err[name] = max(edge_err[name], err)
                log(f"edge case {case} ({WRAPPER[name]}, "
                    f"{payload_c.shape[0]} reads, lmax {static['lmax']}): "
                    f"kernel vs plain max_abs_err={err}")
        if any(edge_err.values()):
            fail(f"the fused kernels disagree with the plain versions on the "
                 f"edge cases (max by kernel {edge_err})")
        # engine_fused._Download allocates a pinned host buffer per call:
        # its host time at the largest K2 output (PyTorch's caching host
        # allocator hands back freed blocks)
        rows = max(w["_close_kernel"]["rows"] for w in whole.values())
        t0 = time.perf_counter()
        for _ in range(200):
            torch.empty((rows, 6), dtype=torch.int32, pin_memory=True)
        pin_us = (time.perf_counter() - t0) / 200 * 1e6
        log(f"_Download: a pinned [{rows}, 6] int32 buffer takes "
            f"{pin_us:.1f} us of host time to allocate, after the first  "
            f"[{card}]")

        mark("7")
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
            # shard's search calls: each K2/K3/K4 shard call's fused kernel
            # held against the composition it replaced, and the
            # composition's K1 calls against the plain scan, on the card it
            # ran on (so, through them, against the plain version)
            for cfg, devices in MESH_LISTS.items():
                mlabel = f"{label} mesh {cfg}"
                argv = argv_of(f"rec_{cfg}")
                _, fused = recorded(lambda: run_backend(argv, devices))
                calls = composition_calls(fused)
                if reports(prefix_of(argv)) != base["want"]:
                    fail(f"{mlabel} recorded run: reports differ from the "
                         "fused kernel runs'")
                ran_on = {c[2].device.index for c in fused}
                if ran_on != cards_of(devices):
                    fail(f"{mlabel}: fused calls ran on cards "
                         f"{sorted(ran_on)}, not {sorted(cards_of(devices))}")
                mesh_scans[key, cfg] = check_calls(mlabel, calls)
                max_err = max(max_err, mesh_scans[key, cfg]["max_abs_err"])
                ferr = 0
                with torch.inference_mode():
                    for name, chromcat, payload, maxmm, static in fused:
                        with torch.cuda.device(payload.device):
                            got = fused_kernels[name](
                                chromcat, payload, maxmm, **static)
                            want = PLAIN[name](chromcat, payload, maxmm,
                                               **static)
                            ferr = max(ferr, int(
                                (got.long() - want.long()).abs().max()))
                by_name = {WRAPPER[n]: sum(c[0] == n for c in fused)
                           for n in FUSED}
                log(f"{mlabel}: the fused kernels on {len(fused)} shard calls "
                    f"({by_name}) against the composition: "
                    f"max_abs_err={ferr}")
                if ferr:
                    fail(f"{mlabel}: the fused kernels disagree (max {ferr})")
                del calls, fused
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
                    kernels = launch_counts()
                    by_card = dict(sorted(
                        fused_cuda.LAUNCHES_BY_DEVICE.items()))
                    check_run(mlabel, fused_cuda.search_launches())
                    check_path(mlabel, engine_fused.FAR_WIN_ROWS)
                    if set(by_card) != cards_of(devices):
                        fail(f"{mlabel}: fused kernel launches by card "
                             f"{by_card}, expected every card of "
                             f"{sorted(cards_of(devices))}")
                    got = reports(prefix_of(argv))
                    if got != base["want"]:
                        fail(f"{mlabel}: reports differ from the fused "
                             "kernel runs'")
                    if key == "scene2" and digests(got) != spec2.want:
                        fail(f"{mlabel}: reports differ from the "
                             "reference's digests")
                    runs[cfg].append(dict(wall=wall, launches=launches,
                                           kernels=kernels, by_card=by_card,
                                           phases=g_timer.items()))
                    log(f"{mlabel}: wall {wall:.3f} s, {n / wall:.1f} "
                        f"{unit}/s, launches {kernels}, fused kernels by "
                        f"card {by_card}  [{card}]")
            fused_med = statistics.median(r["wall"] for r in runs["fused"])
            for cfg, devices in configs:
                if len({str(r["by_card"]) for r in runs[cfg]}) != 1:
                    fail(f"{label} {cfg}: launches differ between runs")
                walls = [r["wall"] for r in runs[cfg]]
                med = runs[cfg][walls.index(statistics.median(walls))]
                log(f"{label} {cfg} ({devices}): median wall "
                    f"{med['wall']:.3f} s of {TIMED_RUNS} in turns "
                    f"({n / med['wall']:.1f} {unit}/s), reports "
                    f"byte-identical to the fused runs of phase 5/6, "
                    f"launches {med['kernels']}, fused kernels by card "
                    f"{med['by_card']}  [{card}]")
                top = sorted(med["phases"].items(), key=lambda kv: -kv[1])
                for pname, sec in top[:8]:
                    log(f"  phase {pname:<52s} {sec:9.3f} s  [{card}]")
                if cfg != "fused":
                    scan = mesh_scans[key, cfg]
                    mesh_paths[f"{key}_mesh_{cfg}"] = dict(
                        {k: scan[k] for k in SCAN_KEYS},
                        launches=med["launches"],
                        close_launches=med["kernels"]["close"],
                        far_launches=med["kernels"]["far"],
                        far_win_launches=med["kernels"]["far_win"],
                        fused_launches_by_card={
                            str(k): v for k, v in med["by_card"].items()},
                        wall=med["wall"], fused_wall=fused_med)

        mark("8")
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
                                     fused_cuda.search_launches_by_device()
                                     .items())},
                             launches_by_kernel=launch_counts(),
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
                    f"windows {r['windows']}, search kernel launches by card "
                    f"{r['launches_by_card']}, wall {wall}, spawn to "
                    f"imports done {r['started_s']:.3f} s, to pipeline ready "
                    f"{r['ready_s']:.3f} s, to first shipped window "
                    f"{first}{mem}  [{card}]")

        def launches_of(ranks, kernel="scan"):
            return sum(r["launches_by_kernel"].get(kernel, 0) for r in ranks)

        def counts_of(ranks, label=None):
            """A path's launches per kernel (``launches``: K1's standalone
            scan's, which must be 0 where ``label`` names the path)."""
            counts = dict(launches=launches_of(ranks),
                          close_launches=launches_of(ranks, "close"),
                          far_launches=launches_of(ranks, "far"),
                          far_win_launches=launches_of(ranks, "far_win"))
            if label is not None and counts["launches"]:
                fail(f"{label}: the standalone scan launched "
                     f"{counts['launches']} times on a CLI path")
            return counts

        hosts_paths = {}
        # a. scene 1 at --hosts 2 over both transports, rank 0's scan
        # calls recorded
        for dist in ("files", "store"):
            label = f"scene 1 --hosts 2 --dist {dist}"
            argv = argv1(f"hosts2_{dist}")
            reset_counts()
            wall, fused = recorded(lambda: run_hosts(argv, 2, dist))
            calls = composition_calls(fused)
            if reports(prefix_of(argv)) != scene1["want"]:
                fail(f"{label}: reports differ from the kernel runs of "
                     "phase 5")
            ranks = rank_records(label, 2)
            if not all(r["windows"] for r in ranks):
                fail(f"{label}: a rank owned no window: {ranks}")
            log(f"{label}: wall {wall:.3f} s, {n1 / wall:.1f} reads/s, "
                f"reports byte-identical to phase 5, launches "
                f"{counts_of(ranks, label)}  [{card}]")
            log_ranks(label, ranks)
            scan = check_calls(f"{label} rank 0", calls)
            max_err = max(max_err, scan["max_abs_err"])
            del calls
            torch.cuda.empty_cache()
            hosts_paths[f"scene1_hosts2_{dist}"] = dict(
                {k: scan[k] for k in SCAN_KEYS}, **counts_of(ranks),
                launches_by_rank=[r["launches_by_card"] for r in ranks],
                wall=wall)

        # b. scene 2 at --hosts 2: one window, so rank 1 ships nothing
        label = "scene 2 --hosts 2 --dist files"
        argv = argv2("hosts2_files")
        reset_counts()
        wall = run_hosts(argv, 2, "files")
        got = reports(prefix_of(argv))
        if got != scene2["want"] or digests(got) != spec2.want:
            fail(f"{label}: reports differ from phase 6 or the digests")
        ranks = rank_records(label, 2)
        if ranks[1]["windows"]:
            fail(f"{label}: rank 1 owned windows {ranks[1]['windows']}")
        if not counts_of(ranks, label)["far_win_launches"]:
            fail(f"{label}: pt_far_win never launched")
        log(f"{label}: wall {wall:.3f} s, {n2 / wall:.1f} read pairs/s, "
            f"reports byte-identical to phase 6 and the digests, "
            f"launches {counts_of(ranks)}  [{card}]")
        log_ranks(label, ranks)
        hosts_paths["scene2_hosts2_files"] = dict(
            **counts_of(ranks),
            launches_by_rank=[r["launches_by_card"] for r in ranks],
            wall=wall)

        # c. timed runs in turns at more windows
        for key, label, flags, dist, counts in HOSTS_TIMED:
            argv_of = argv1 if key == "scene1" else argv2
            n, unit = (n1, "reads") if key == "scene1" else (n2, "read pairs")
            runs = {h: [] for h in counts}
            want = None
            for i in range(HOSTS_TIMED_RUNS):
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
                        f"{n / wall:.1f} {unit}/s, launches "
                        f"{counts_of(ranks, hlabel)}  [{card}]")
                    log_ranks(f"{hlabel} run {i}", ranks)
            for hosts in counts:
                walls = [r["wall"] for r in runs[hosts]]
                med = runs[hosts][walls.index(statistics.median_low(walls))]
                log(f"{label} {' '.join(flags)} --hosts {hosts} --dist "
                    f"{dist}: median (low) wall {med['wall']:.3f} s of "
                    f"{HOSTS_TIMED_RUNS} in turns ({n / med['wall']:.1f} "
                    f"{unit}/s"
                    f"), reports equal to --hosts 1, launches "
                    f"{counts_of(med['ranks'])}  [{card}]")
                for r in med["ranks"]:
                    phases = r.get("phases") or med["phases"]
                    for pname in HOSTS_PHASES:
                        log(f"  rank {r['rank']} phase {pname:<40s} "
                            f"{phases.get(pname, 0.0):9.3f} s  [{card}]")
                hosts_paths[f"{key}_timed_hosts{hosts}"] = dict(
                    **counts_of(med["ranks"]), wall=med["wall"])

        mark("9")
        # ---- 9. the window-parallel search (K9)
        from pindel_tpu_torch.genome import Genome
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
            # as the kernel chooses, then with each row split over up to 8
            # blocks, then with the histograms in device memory
            modes = ((sharded_search_cuda.MIN_COLS,
                      sharded_search_cuda.MAX_SMEM),
                     (64, sharded_search_cuda.MAX_SMEM),
                     (sharded_search_cuda.MIN_COLS, 0))
            for min_cols, max_smem in modes:
                saved = (sharded_search_cuda.MIN_COLS,
                         sharded_search_cuda.MAX_SMEM)
                sharded_search_cuda.MIN_COLS = min_cols
                sharded_search_cuda.MAX_SMEM = max_smem
                try:
                    for wp in (1, 2, 4, 8):
                        wl = st["w_total"] // wp
                        for k in range(wp):
                            errs.append(compare(case, dict(
                                off=k * wl, w_total=st["w_total"],
                                w_local=wl, lmax=st["lmax"], nl=st["nl"],
                                mpm=st["mpm"], t_levels=int(tm_np.max()),
                                s_levels=int(ms_np.max())),
                                sharded_search_cuda.shard_partials_cuda,
                                sss.shard_partials_ref))
                finally:
                    (sharded_search_cuda.MIN_COLS,
                     sharded_search_cuda.MAX_SMEM) = saved
            k9_err = max(k9_err, max(errs))
            log(f"shard kernel vs plain, case {name} seed {seed}: "
                f"{qq_np.shape[0]} rows x {st['nl']} lanes, w_total "
                f"{st['w_total']}, {len(errs)} shard calls at wp 1/2/4/8 "
                f"(rows whole, split, histograms in device memory), "
                f"max_abs_err={max(errs)}")
        # testing/lane_cases.py:dead_level_case under budgets at and past
        # the DEAD level: every shard at wp 1, 2, 4 and 8 against the twin,
        # and the whole search over cuda:0 x 8 against it over the CPU
        from pindel_tpu_torch.parallel.mesh import make_grid, sharded_search
        for ms, tm in DEAD_LEVEL_BUDGETS:
            arrays, st = dead_level_case(ms, tm)
            case = [torch.from_numpy(np.array(arrays[j])).to(dev)
                    for j in (0, 1, 2, 3, 4, 6, 7)]
            t_levels, s_levels = sss.levels(ms, tm, st["lmax"])
            errs = []
            for wp in (1, 2, 4, 8):
                wl = st["w"] // wp
                for k in range(wp):
                    errs.append(compare(case, dict(
                        off=k * wl, w_total=st["w"], w_local=wl,
                        lmax=st["lmax"], nl=st["nl"], mpm=st["mpm"],
                        t_levels=t_levels, s_levels=s_levels),
                        sharded_search_cuda.shard_partials_cuda,
                        sss.shard_partials_ref))
            static = dict(w_total=st["w"], lmax=st["lmax"], nl=st["nl"],
                          mpm=st["mpm"], bp_start=st["bp_start"])
            for dp9, wp9 in SHARD_GRIDS:
                on_card = sharded_search(
                    *arrays, grid=make_grid(["cuda:0"] * 8, dp9), **static)
                on_cpu = sharded_search(
                    *arrays, grid=make_grid(["cpu"] * 8, dp9), **static)
                if not all(np.array_equal(a, b)
                           for a, b in zip(on_card, on_cpu)):
                    fail(f"K9 on dead-level rows ms={ms} tm={tm} at ({dp9}, "
                         f"{wp9}): the card's outputs differ from the twin's")
            k9_err = max(k9_err, max(errs))
            log(f"shard kernel vs plain, dead-level rows ms={ms} tm={tm} "
                f"(T={t_levels}, S={s_levels}): {len(errs)} shard calls at "
                f"wp 1/2/4/8, max_abs_err={max(errs)}; sharded_search over "
                f"cuda:0 x 8 at {SHARD_GRIDS} equal to the twin's over the "
                f"CPU")
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

        def shard_ms(args, kw):
            """The shard kernel's device ms on one call."""
            return device_ms(lambda: sharded_search_cuda.shard_partials_cuda(
                *args, **kw), 10)

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
                ms_k = shard_ms(args, kw)
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
                    f"{SHARD_SEED_OPS_PER_WORD} int32 operations per 4 "
                    f"candidates, {SHARD_PATTERN_OPS} per seeded candidate, "
                    f"{SHARD_STEP_OPS} per step walked after step "
                    f"{SHARD_PATTERN_STEPS}), {bound / ms_k:.1%} of it, "
                    f"max_abs_err={err}  [{card}]")
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
        jax_rows = jax_small_launches = 0
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
                if fused_cuda.search_launches():
                    fail(f"--backend {name} scene {scene}: a search kernel "
                         "of another backend launched")
                if name == "numpy" and (engine_jax.LEGACY_ROWS
                                        or sharded_search_cuda.LAUNCHES):
                    fail(f"--backend numpy scene {scene}: the device "
                         "searched")
                if name == "jax" and engine_jax.LEGACY_ROWS and \
                        not sharded_search_cuda.LAUNCHES:
                    fail(f"--backend jax scene {scene}: K8 searched without "
                         "the shard kernel")
                if engine_jax.PLAIN_ON_CARD:
                    fail(f"--backend {name} scene {scene}: the plain "
                         "_search_kernel ran on the card")
                jax_rows += engine_jax.LEGACY_ROWS
                if name == "jax":
                    jax_small_launches += sharded_search_cuda.LAUNCHES
            log(f"--backend {name}: {len(runs9)} small scenes (8 text, 8 "
                "BAM) byte-identical to the golden reports"
                + (f", {jax_rows} reads searched by K8 on the card through "
                   f"{jax_small_launches} shard kernel launches"
                   if name == "jax" else ", no device search"))
        if jax_rows == 0:
            fail("--backend jax searched no read on the card")

        # e. K8's small calls (the route's shard calls of phase 3b's 12-read
        # batches): this kernel against the twin, each call timed
        small = []
        for args, kw in small_calls:
            out = sharded_search_cuda.shard_partials_cuda(*args, **kw)
            want = sss.shard_partials_ref(*args, **kw)
            err = max(int((a.long() - b.long()).abs().max())
                      for a, b in zip(out, want))
            k9_err = max(k9_err, err)
            ms_k = shard_ms(args, kw)
            bound, bound_by, seeded, walked = shard_bound(args, kw, out)
            small.append(dict(w=kw["w_local"], rows=args[1].shape[0],
                              ms=ms_k, bound_ms=bound))
            log(f"K8 small call w={kw['w_local']} rows={args[1].shape[0]} "
                f"nl={kw['nl']} (blocks per row "
                f"{sharded_search_cuda.row_splits(args[1].shape[0], kw['w_local'])}"
                f"): kernel {ms_k:.4f} ms, bound {bound:.4f} ms ({bound_by}; "
                f"{seeded} seeded candidates walking {walked} steps), "
                f"max_abs_err={err}  [{card}]")
        if k9_err:
            fail(f"K8 small calls: shard kernel disagrees with its twin "
                 f"(max {k9_err})")
        del small_calls

        mark("10")
        # ---- 10. scenes 1 and 2 through --backend jax: K8 on the card, so
        # every search through the route and the shard kernel
        jax_paths = {}
        for key, label, argv_of, n, unit, base in (
                ("scene1", "scene 1", argv1, n1, "reads", scene1),
                ("scene2", "scene 2", argv2, n2, "read pairs", scene2)):
            argv = argv_of("jax") + ["--backend", "jax"]
            largest = {"size": -1, "calls": 0}

            def recording_calls(*a, **kw):
                # keeps the largest call (rows x lanes x columns)
                out = real_partials(*a, **kw)
                size = a[1].shape[0] * kw["nl"] * kw["w_local"]
                largest["calls"] += 1
                if size > largest["size"]:
                    largest.update(size=size, call=(
                        [a[0]] + [x.clone() for x in a[1:]], dict(kw),
                        [o.clone() for o in out]))
                return out

            reset_counts()
            g_timer.reset()
            sss.shard_partials = recording_calls
            try:
                wall = run_cli(port_main, argv)
            finally:
                sss.shard_partials = real_partials
            launches = sharded_search_cuda.LAUNCHES
            rows = engine_jax.LEGACY_ROWS
            phases = g_timer.items()
            got = reports(prefix_of(argv))
            if got != base["want"]:
                fail(f"{label} --backend jax: reports differ from the fused "
                     "kernel runs'")
            if key == "scene2" and digests(got) != spec2.want:
                fail(f"{label} --backend jax: reports differ from the "
                     "reference's digests")
            if launches == 0:
                fail(f"{label} --backend jax: the shard kernel never "
                     "launched")
            if engine_jax.PLAIN_ON_CARD:
                fail(f"{label} --backend jax: the plain _search_kernel ran "
                     f"{engine_jax.PLAIN_ON_CARD} times on the card")
            if fused_cuda.search_launches():
                fail(f"{label} --backend jax: a fused-path kernel launched")
            log(f"{label} --backend jax: wall {wall:.3f} s, {n / wall:.1f} "
                f"{unit}/s, reports byte-identical to the fused runs of "
                f"phase 5/6{' and the digests' if key == 'scene2' else ''}, "
                f"legacy rows {rows}, shard kernel launches {launches}, "
                f"plain _search_kernel on the card 0  [{card}]")
            for pname, sec in sorted(phases.items(),
                                     key=lambda kv: -kv[1])[:10]:
                log(f"  phase {pname:<52s} {sec:9.3f} s  [{card}]")
            # the largest call: against the twin, timed
            args, kw, out = largest.pop("call")
            want = sss.shard_partials_ref(*args, **kw)
            err = max(int((a.long() - b.long()).abs().max())
                      for a, b in zip(out, want))
            k9_err = max(k9_err, err)
            ms_k = shard_ms(args, kw)
            bound, bound_by, _seeded, _walked = shard_bound(args, kw, out)
            log(f"{label} --backend jax: largest of {largest['calls']} shard "
                f"calls, {args[1].shape[0]} rows x {kw['nl']} lanes, w="
                f"{kw['w_local']}: kernel {ms_k:.4f} ms, plain twin equal "
                f"(max_abs_err={err}), bound {bound:.4f} ms ({bound_by}), "
                f"{bound / ms_k:.1%} of it  [{card}]")
            if err:
                fail(f"{label} --backend jax: shard kernel disagrees with "
                     f"its twin (max {err})")
            jax_paths[f"{key}_jax"] = dict(
                launches=launches, wall=wall, legacy_rows=rows,
                largest=dict(rows=int(args[1].shape[0]), nl=kw["nl"],
                             w=kw["w_local"], ms=ms_k, bound_ms=bound))
            del args, want, out
            torch.cuda.empty_cache()

    mark("11")
    # ---- 11. the measurement tools, each in a fresh interpreter
    torch.cuda.empty_cache()
    tools = {name: run_tool(name, module, argv, card)
               for name, module, argv in TOOLS}
    check_tools(tools)

    mark("12")
    # ---- 12. scene 3 once through the CLI: three windows of BAM pairs with
    # BreakDancer calls, every scan call held against the plain version
    with tempfile.TemporaryDirectory(prefix="chip_smoke_scene3_") as s3:
        t0 = time.monotonic()
        scene3_spec = scenes.make_scene3(s3)
        log(f"scene 3: {scene3_spec.n} read pairs over 15000000 bp (BAM + "
            f"BreakDancer calls, -w 5), built in "
            f"{time.monotonic() - t0:.1f} s")
        engine_jax.PLAIN_ON_CARD = 0
        run3, fused3 = recorded(lambda: scenes.run_scene(
            scene3_spec, os.path.join(s3, "run"), dev))
        c3 = run3["counters"]
        k4_calls3 = sum(c[0] == "_far_win_kernel" for c in fused3)
        gate("scene 3", scene3_spec, [run3])
        check_path("scene 3", c3["far_win_rows"], k4_calls3)
        if engine_jax.PLAIN_ON_CARD:
            fail(f"scene 3: the plain _search_kernel ran "
                 f"{engine_jax.PLAIN_ON_CARD} times on the card")
        log(f"scene 3: wall {run3['wall']:.3f} s (first use), "
            f"{scene3_spec.n / run3['wall']:.1f} read pairs/s, reports "
            f"equal to the reference's digests, fallback "
            f"{run3['fallback']:.6f}, windows {c3['windows']} (visited "
            f"{c3['windows_visited']}), search kernel launches "
            f"{c3['launches']} (standalone scan {c3['scan_launches']}, "
            f"pt_close/pt_far/pt_far_win {c3['fused_launches']}: "
            f"{c3['close_launches']}/{c3['far_launches']}/"
            f"{c3['far_win_launches']} for {k4_calls3} K4 calls), "
            f"_far_win_kernel rows {c3['far_win_rows']}, legacy rows "
            f"{c3['legacy_rows']}, shard kernel launches "
            f"{c3['shard_launches']}, peak card memory "
            f"{c3['peak_mib']:.1f} MiB (the recorded payloads "
            f"included)  [{card}]")
        for w in c3["by_window"]:
            log(f"  scene 3 window {w['index']} [{w['start']}, {w['end']}):"
                f" {w['reads']} reads, read in at {w['read_s']:.3f} s, "
                f"staged at {w.get('staged_s', float('nan')):.3f} s, "
                f"reported at {w.get('done_s', float('nan')):.3f} s")
        for pname, sec in sorted(run3["phases"].items(),
                                 key=lambda kv: -kv[1])[:12]:
            log(f"  phase {pname:<52s} {sec:9.3f} s  [{card}]")
        scan3 = check_calls("scene 3", composition_calls(fused3))
        max_err = max(max_err, scan3["max_abs_err"])
        torch.cuda.empty_cache()
        # K2, K3 and K4 at every call of scene 3 against the plain
        # versions, the largest of each timed, as 6b
        whole["scene3"] = check_fused("scene 3", fused3)
        k4_tail = {"scene3": largest_k4_tail("scene 3", fused3)}
        del fused3
    scene3 = dict({k: scan3[k] for k in SCAN_KEYS}, **run_counts(c3),
                  wall=run3["wall"],
                  far_win_rows=c3["far_win_rows"],
                  legacy_rows=c3["legacy_rows"],
                  windows=c3["windows"], peak_mib=c3["peak_mib"])

    mark("13")
    # ---- 13. scene 4: four chromosomes in one BAM (chrE without reads),
    # interchromosomal BreakDancer calls (-I) and regions (-j/-J, -c)
    from pindel_tpu_torch.testing.scenes import build_scene4
    want4 = load_digests(SCENE4_DIGESTS)

    def check_regions(label, rows, chroms):
        """One backend a region, none outliving it, and the card's memory
        at each region's start no more than one chromosome's state above
        the first region's."""
        if [r["chrom"] for r in rows] != chroms:
            fail(f"{label}: regions {[r['chrom'] for r in rows]}, not "
                 f"{chroms}")
        state = max(r["state_bytes"] for r in rows)
        for r in rows:
            log(f"{label} region on {r['chrom']}: memory allocated at its "
                f"window loop's start {r['allocated'] / 2 ** 20:.1f} MiB, "
                f"its device state {r['state_bytes'] / 2 ** 20:.1f} MiB, "
                f"backends alive {r['alive']}  [{card}]")
            if r["alive"] != 1:
                fail(f"{label}: {r['alive']} backends alive at the start of "
                     f"the region on {r['chrom']}")
            if r["allocated"] > rows[0]["allocated"] + state:
                fail(f"{label}: {r['allocated']} bytes allocated at the "
                     f"region on {r['chrom']}, more than one chromosome's "
                     f"state ({state}) above the first region's "
                     f"{rows[0]['allocated']}")

    scene4_paths = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_scene4_") as s4:
        t0 = time.monotonic()
        paths4 = build_scene4(s4)
        n4 = int(paths4["pairs"])
        log(f"scene 4: {n4} read pairs over 13500000 bp of four chromosomes "
            f"({paths4['events']} local events, "
            f"{paths4['translocation_reads']} translocation reads, "
            f"{paths4['ctx_reads']} reads near a CTX call's breakpoints), "
            f"built in {time.monotonic() - t0:.1f} s")
        windows4 = {"scene4": 5, "scene4_bed": 3, "scene4_c": 1}
        regions4 = {"scene4": ["chr1", "chr2", "chr3", "chrE"],
                    "scene4_bed": ["chr1", "chr1", "chr3"],
                    "scene4_c": ["chr2"]}
        specs4 = {name: scenes.bam_scene(
            name, paths4, n4, want4[name], windows=windows4[name],
            spec=SCENE4_RUNS[name],
            oracle_reads=int(paths4["ctx_reads"]) if name == "scene4"
            else None) for name in SCENE4_RUNS}

        def scene4_run(name, prefix):
            """A recorded run of ``name`` under ``prefix``, gated."""
            r = scenes.run_scene(specs4[name], os.path.join(s4, prefix), dev)
            gate(f"{name} {prefix}", specs4[name], [r])
            return r

        # a. scene4 recorded (first use), then again with the region log;
        # K4 launched once a K4 call in each
        engine_jax.PLAIN_ON_CARD = 0
        run4, fused4 = recorded(lambda: scene4_run("scene4", "rec"))
        k4_calls4 = sum(c[0] == "_far_win_kernel" for c in fused4)
        check_path("scene 4 recorded", run4["counters"]["far_win_rows"],
                   k4_calls4)
        with region_log() as rows4:
            warm4 = scene4_run("scene4", "warm")
        check_path("scene 4 warm", warm4["counters"]["far_win_rows"],
                   k4_calls4)
        if engine_jax.PLAIN_ON_CARD:
            fail(f"scene 4: the plain _search_kernel ran "
                 f"{engine_jax.PLAIN_ON_CARD} times on the card")
        c4 = warm4["counters"]
        log(f"scene 4 (-c ALL -I): walls {run4['wall']:.3f} s (first use), "
            f"{warm4['wall']:.3f} s ({n4 / warm4['wall']:.1f} read pairs/s), "
            f"reports equal to the reference's digests, windows "
            f"{c4['windows']} (visited {c4['windows_visited']}), search "
            f"kernel launches {c4['launches']} (standalone scan "
            f"{c4['scan_launches']}, pt_close/pt_far/pt_far_win "
            f"{c4['close_launches']}/{c4['far_launches']}/"
            f"{c4['far_win_launches']} for {k4_calls4} K4 calls), "
            f"_far_win_kernel rows {c4['far_win_rows']}, legacy rows "
            f"{c4['legacy_rows']}, shard kernel launches "
            f"{c4['shard_launches']}, reads across chromosomes "
            f"{c4['oracle_reads']} (at most {paths4['ctx_reads']}; K4 on "
            f"a partner backend {c4['xchrom_device']}, oracle "
            f"{c4['xchrom_oracle']}), peak card memory "
            f"{c4['peak_mib']:.1f} MiB  [{card}]")
        for w in c4["by_window"]:
            log(f"  scene 4 window {w['index']} [{w['start']}, {w['end']}):"
                f" {w['reads']} reads, read in at {w['read_s']:.3f} s, "
                f"staged at {w.get('staged_s', float('nan')):.3f} s, "
                f"reported at {w.get('done_s', float('nan')):.3f} s")
        for pname, sec in sorted(warm4["phases"].items(),
                                 key=lambda kv: -kv[1])[:12]:
            log(f"  phase {pname:<52s} {sec:9.3f} s  [{card}]")
        check_regions("scene 4", rows4, regions4["scene4"])
        got4 = reports(os.path.join(s4, "warm"))
        if not (b"Anchor + chr1" in got4["INT"] and got4["INT_final"]):
            fail("scene 4: _INT or _INT_final is empty")
        scene4_paths["scene4"] = dict(
            run_counts(c4), wall=warm4["wall"], first_wall=run4["wall"],
            far_win_rows=c4["far_win_rows"], legacy_rows=c4["legacy_rows"],
            oracle_reads=c4["oracle_reads"], windows=c4["windows"],
            peak_mib=c4["peak_mib"],
            region_allocated_mib=[r["allocated"] / 2 ** 20 for r in rows4])

        # b. the BED regions and the -c region
        for name in ("scene4_bed", "scene4_c"):
            with region_log() as rows:
                r = scene4_run(name, name)
            c = r["counters"]
            got = reports(os.path.join(s4, name))
            if got.get("INT") or got["INT_final"] != b"":
                fail(f"{name}: _INT or _INT_final is not empty without -I")
            check_path(name, c["far_win_rows"])
            log(f"{name} {list(SCENE4_RUNS[name].flags)}: wall "
                f"{r['wall']:.3f} s, reports equal to the reference's "
                f"digests, windows {c['windows']}, launches "
                f"{launch_counts()}, _far_win_kernel rows "
                f"{c['far_win_rows']}, legacy rows {c['legacy_rows']}, "
                f"reads across chromosomes {c['oracle_reads']}, "
                f"peak card memory {c['peak_mib']:.1f} MiB  [{card}]")
            check_regions(name, rows, regions4[name])
            scene4_paths[name] = dict(run_counts(c), wall=r["wall"],
                                      windows=c["windows"],
                                      peak_mib=c["peak_mib"])

        # c. scene4 through the mesh over cuda:0 twice, --backend jax and
        # --hosts 2, each held to the same digests
        def argv4(prefix):
            return bam_argv(SCENE4_RUNS["scene4"], paths4,
                            os.path.join(s4, prefix))

        label = "scene 4 --backend mesh over cuda:0 x2"
        reset_counts()
        wall = run_backend(argv4("mesh"), MESH_LISTS["cuda0x2"])
        if digests(reports(os.path.join(s4, "mesh"))) != want4["scene4"]:
            fail(f"{label}: reports differ from the reference's digests")
        check_run(label, fused_cuda.search_launches())
        check_path(label, engine_fused.FAR_WIN_ROWS)
        log(f"{label}: wall {wall:.3f} s, reports equal to the digests, "
            f"launches {launch_counts()}, by card "
            f"{dict(fused_cuda.LAUNCHES_BY_DEVICE)}  [{card}]")
        scene4_paths["scene4_mesh_cuda0x2"] = dict(
            launches=scan_cuda.LAUNCHES,
            close_launches=fused_cuda.LAUNCHES_BY_KERNEL["close"],
            far_launches=fused_cuda.LAUNCHES_BY_KERNEL["far"],
            far_win_launches=fused_cuda.LAUNCHES_BY_KERNEL["far_win"],
            wall=wall)

        label = "scene 4 --backend jax"
        reset_counts()
        engine_jax.PLAIN_ON_CARD = 0
        wall = run_cli(port_main, argv4("jax") + ["--backend", "jax"])
        if digests(reports(os.path.join(s4, "jax"))) != want4["scene4"]:
            fail(f"{label}: reports differ from the reference's digests")
        if not sharded_search_cuda.LAUNCHES or engine_jax.PLAIN_ON_CARD \
                or fused_cuda.search_launches():
            fail(f"{label}: shard kernel launches "
                 f"{sharded_search_cuda.LAUNCHES}, plain _search_kernel on "
                 f"the card {engine_jax.PLAIN_ON_CARD}, fused launches "
                 f"{fused_cuda.search_launches()}")
        log(f"{label}: wall {wall:.3f} s, reports equal to the digests, "
            f"legacy rows {engine_jax.LEGACY_ROWS}, shard kernel launches "
            f"{sharded_search_cuda.LAUNCHES}  [{card}]")
        k9_scene4 = dict(launches=sharded_search_cuda.LAUNCHES, wall=wall,
                         legacy_rows=engine_jax.LEGACY_ROWS)

        label = "scene 4 --hosts 2 --dist files"
        reset_counts()
        wall = run_hosts(argv4("hosts2"), 2, "files")
        if digests(reports(os.path.join(s4, "hosts2"))) != want4["scene4"]:
            fail(f"{label}: reports differ from the reference's digests")
        ranks = rank_records(label, 2)
        if not all(r["windows"] for r in ranks):
            fail(f"{label}: a rank owned no window: {ranks}")
        counts = counts_of(ranks, label)
        if not counts["far_win_launches"]:
            fail(f"{label}: pt_far_win never launched")
        log(f"{label}: wall {wall:.3f} s, reports equal to the digests, "
            f"launches {counts}  [{card}]")
        log_ranks(label, ranks)
        scene4_paths["scene4_hosts2_files"] = dict(
            **counts, launches_by_rank=[r["launches_by_card"]
                                        for r in ranks], wall=wall)

        # d. K2, K3 and K4 at every call of the recorded run against the
        # plain versions, the largest of each timed, as 6b
        whole["scene4"] = check_fused("scene 4", fused4)
        k4_tail["scene4"] = largest_k4_tail("scene 4", fused4)
        del fused4
        torch.cuda.empty_cache()

    loaded = reference_modules()
    if loaded:
        fail(f"a run loaded {loaded}")
    if engine_jax.PLAIN_ON_CARD:
        fail(f"the plain _search_kernel ran on the card "
             f"{engine_jax.PLAIN_ON_CARD} times outside phase 3b's "
             "comparisons")
    paths = {label: {k: v[k] for k in ("launches", "close_launches",
                                       "far_launches", "far_win_launches",
                                       *SCAN_KEYS, "wall")}
             for label, v in (("scene1", scene1), ("scene2", scene2))}
    paths["scene3"] = scene3
    paths.update(scene4_paths)
    paths.update(mesh_paths)
    paths.update(hosts_paths)
    # K1 at scene 1's largest shape (its largest K2 call's, as the
    # composition calls it).  On the main path K1's walk (csrc/
    # scan_walk.cuh) runs inside pt_close, pt_far and pt_far_win, and the
    # standalone scan kernel launches on no path (checked 0 on each):
    # launches counts the launches of the kernels that run the walk over
    # every path, standalone_launches the scan kernel's own
    fused_launches = {short: sum(v.get(f"{short}_launches", 0)
                                 for v in paths.values())
                      for short in ("close", "far", "far_win")}
    standalone = sum(v["launches"] for v in paths.values())
    if standalone:
        fail(f"the standalone scan launched {standalone} times on the paths")
    kernels = [dict(name="scan_rows", route="cuda",
                    source="pindel_tpu_torch/csrc/scan.cu",
                    walk_source="pindel_tpu_torch/csrc/scan_walk.cuh",
                    replaces="pindel_tpu/ops/pallas_scan.py:76",
                    launches=sum(fused_launches.values()),
                    standalone_launches=standalone,
                    walk_launches_by_kernel={
                        f"pt_{k}": v for k, v in fused_launches.items()},
                    max_abs_err=max_err,
                    ms=scene1["ms"], plain_ms=scene1["plain_ms"],
                    bound_ms=scene1["bound_ms"],
                    bound_by=scene1["bound_by"],
                    bound_dense_ms=scene1["bound_dense_ms"], library_ms=None,
                    paths=paths, whole_calls=whole,
                    tools=tool_summary(tools))]
    # K9 at its largest shape (the full batch at wp = 1), which is also
    # K8's largest batch through the route; launches over the route's full
    # batch (3b), the K9 backend runs (9b), the timed full-width runs (9c),
    # --backend jax on the small scenes (9d) and on scenes 1 and 2 (10)
    top = k9_full[1]["shards"][0]
    k9_paths = {f"full_wp{wp}": dict(
        launches=v["launches"], wall=v["wall"],
        ms=sum(x["ms"] for x in v["shards"]),
        plain_ms=sum(x["plain_ms"] for x in v["shards"]),
        bound_ms=sum(x["bound_ms"] for x in v["shards"]))
        for wp, v in k9_full.items()}
    k9_paths["k9_backend_small_scene"] = dict(
        launches=k9_launches - sum(v["launches"] for v in k9_full.values()))
    k9_paths["k8_route_full_batch"] = legacy_route
    k9_paths["k8_small_calls"] = dict(launches=small_launches, calls=small)
    k9_paths["backend_jax_small_scenes"] = dict(launches=jax_small_launches)
    k9_paths.update(jax_paths)
    k9_paths["scene3_legacy_lanes"] = dict(launches=c3["shard_launches"],
                                           legacy_rows=c3["legacy_rows"])
    k9_paths["scene4_jax"] = k9_scene4
    kernels.append(dict(
        name="sharded_search", route="cuda",
        source="pindel_tpu_torch/csrc/sharded_search.cu",
        replaces="pindel_tpu/parallel/mesh.py:46",
        also_replaces="pindel_tpu/ops/engine_jax.py:48",
        launches=sum(v["launches"] for v in k9_paths.values()),
        max_abs_err=k9_err, ms=top["ms"], plain_ms=top["plain_ms"],
        bound_ms=top["bound_ms"], bound_by=top["bound_by"],
        library_ms=None, paths=k9_paths))
    # K2, K3 and K4 at the largest call of each over scenes 1-4 (phases 6b,
    # 12 and 13), timed in turns with the composition they replaced
    # (parent_ms); launches over every path
    for kname, short, line in (("_close_kernel", "close", 513),
                               ("_far_kernel", "far", 626),
                               ("_far_win_kernel", "far_win", 713)):
        rows = {scene: w[kname] for scene, w in whole.items() if kname in w}
        top = max(rows.values(), key=lambda r: r["rows"])
        entry = dict(
            name=f"pt_{short}", route="cuda",
            source="pindel_tpu_torch/csrc/fused_search.cu",
            replaces=f"pindel_tpu/ops/engine_fused.py:{line}",
            launches=fused_launches[short],
            max_abs_err=max([edge_err[kname]] + [r["max_abs_err"]
                                                 for r in rows.values()]),
            ms=top["ms"], parent_ms=top["parent_ms"],
            plain_ms=top["plain_ms"], bound_ms=top["bound_ms"],
            bound_by=top["bound_by"], share=top["bound_ms"] / top["ms"],
            earlier_bound_ms=top["earlier_bound_ms"], library_ms=None,
            calls=rows)
        if short == "far_win":
            # the critical path of scenes 3 and 4's largest K4 calls
            entry["tail"] = k4_tail
        kernels.append(entry)
    mark("end")
    log(json.dumps({"kernels": kernels}))
    log(f"chip_smoke: total command time {time.monotonic() - t_start:.1f} s")
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
