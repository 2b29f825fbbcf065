"""Benchmark of the port: split-reads/s on scene 1 and read pairs/s on
scenes 2, 3 and 4, through the port's CLI on the card, gated on the
reference's reports.

    python -m pindel_tpu_torch.bench [--runs 5] [--device cuda|cpu]
                                     [--scenes scene1,scene2,scene3,scene4]

The counterpart of the repository's ``bench.py``, with the same scenes
(``testing/scenes.py``: ``SCENE1`` at ``SCENE1_FLAGS``, 50,000 pindel-text
reads over 6 Mb; ``SCENE2``, 12,000 BAM read pairs over 2 Mb with a
BreakDancer calls file; ``SCENE3``, about 90,750 BAM read pairs with
BreakDancer calls over 15 Mb, three 5 Mb windows, in the shape of the
reference pindel's ``colousingbd15`` run; ``SCENE4``, about 79,000 BAM read
pairs over four chromosomes of 13.5 Mb in one BAM, one of them without
reads, with interchromosomal BreakDancer calls, at ``-c ALL -I``: five
windows) run through ``python -m pindel_tpu_torch --backend fused``;
``--scenes`` runs a subset, in that order.  Scene generation and the
builds of the search kernels and the native libraries are set-up; each
scene then takes
one untimed run (its first use), then ``--runs`` timed runs, each wall
read after ``torch.cuda.synchronize()``.  A scene whose first run fails
its gate is not timed.

The gate: every run's reports must equal the JAX package's reports on the
same scene, held as sha256 digests (``testing/scene{1,2,3}_digests.json``);
the ``_D`` report must not be empty, at most ``MAX_FALLBACK`` of the reads
may take the host oracle, the search kernels' launches (the scan's and
the fused kernels': close, far and far_win) must be equal from run to run,
and on a card they must have launched and, on the BreakDancer scenes,
``_far_win_kernel`` (K4) must have searched rows, through ``pt_far_win``.
Scenes 3 and 4 must also span their three and five windows, and on scene
4 the cross-chromosome route (``Searcher._far_round``) must have taken
reads (``measure.oracle_reads``: K4 on a partner backend in a fused
run, the NumPy oracle otherwise), no more than the reads anchored near a
breakpoint of the scene's CTX calls.  A failed
gate prints ``"value": 0.0`` and ``"correct": false`` and exits 1,
whichever scene failed.  There is no ``vs_baseline``: ``bench.py`` times
the reference pindel compiled from a C++ checkout that is not part of this
repository, and the port's gate is the JAX package's reports instead.

Progress goes to standard error.  The last line of standard output is one
JSON object: ``metric``, ``value`` (the median rate of the first scene
run, scene 1's unless ``--scenes`` leaves it out), ``unit``, ``runs`` (the
walls), ``best`` (the rate of the fastest run), ``spread`` ((max - min) /
median of the walls), ``fallback_ratio``; for every other scene
``sceneN_value``, ``sceneN_unit``, ``sceneN_runs``, ``sceneN_spread``,
``sceneN_fallback_ratio``, ``sceneN_pairs``, ``sceneN_windows`` (the
windows over the chromosomes' bases; the window loop also visits an empty
window at a chromosome's end when its length is a multiple of the
window, as the reference's does), ``sceneN_far_win_rows`` (K4's rows) and
``sceneN_oracle_reads`` (reads the cross-chromosome route took);
``correct``, ``layers`` (each scene's
coarse timer phases of its last timed run; they overlap, so they are
phases, not shares of the wall), ``launches`` (the search kernels'
launches in each scene's last run), ``counters`` (each scene's last run:
search kernel launches, the scan's and each fused kernel's apart, windows
visited and with bases, ``_far_win_kernel`` rows, legacy per-lane rows,
reads the cross-chromosome route took and of them those K4 searched on a
partner backend and those the oracle searched (``profiling.g_xchrom``),
shard kernel launches, peak
card memory in MiB, and per window its reads and the seconds at which it
was read in, staged and reported), ``device`` (the card's name and power limit), and the set-up
times (``build_s``, ``scene_build_s``, ``first_use_s``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import sys
import tempfile
import time
from typing import Callable, Dict, List, Optional

import torch

from pindel_tpu_torch.__main__ import main as port_main
from pindel_tpu_torch.ops import (engine_fused, engine_jax, fused_cuda,
                                  scan_cuda, sharded_search_cuda)
from pindel_tpu_torch.parallel.multihost import build_libraries
from pindel_tpu_torch.pipeline import resolve_device
from pindel_tpu_torch.profiling import g_fallback, g_timer, g_xchrom
from pindel_tpu_torch.testing.scenes import (SCENE1, SCENE1_DIGESTS,
                                             SCENE1_FLAGS, SCENE2,
                                             SCENE2_DIGESTS, SCENE3,
                                             SCENE3_DIGESTS, SCENE4,
                                             SCENE4_DIGESTS, BamScene,
                                             bam_argv, digests, load_digests,
                                             reports, write_scene)
from pindel_tpu_torch.tools import measure

METRIC = "split-reads/s"
RUNS = 5
# a larger share of reads re-run on the host oracle is a silent speed cliff
MAX_FALLBACK = 0.01


@dataclasses.dataclass
class Scene:
    """A benchmark scene: its name, unit, size, its CLI run (output prefix
    -> arguments, ``--device`` left out), the sha256 of the reference's
    reports, by suffix, whether a kernel run must send rows through
    ``_far_win_kernel`` (BreakDancer calls), the windows over its
    chromosomes' bases it must span, and the most reads the
    cross-chromosome route may take, which must take at least one (None:
    neither checked)."""

    name: str
    unit: str
    n: int
    argv_of: Callable[[str], List[str]]
    want: Dict[str, str]
    far_win: bool = False
    windows: Optional[int] = None
    oracle_reads: Optional[int] = None


def text_scene(name: str, fa: str, reads_txt: str, n: int,
               want: Dict[str, str]) -> Scene:
    """A pindel-text scene run at scene 1's flags."""
    return Scene(name, "reads", n,
                 lambda prefix: ["-f", fa, "-p", reads_txt, *SCENE1_FLAGS,
                                 "--backend", "fused", "-o", prefix], want)


def bam_scene(name: str, paths: Dict[str, str], n: int,
              want: Dict[str, str], windows: Optional[int] = None,
              spec: BamScene = SCENE2,
              oracle_reads: Optional[int] = None) -> Scene:
    """A BAM + BreakDancer scene of ``n`` read pairs (``paths`` as
    ``spec.build`` gives them) run at ``spec``'s flags (scene 2's by
    default)."""
    return Scene(name, "read pairs", n,
                 lambda prefix: bam_argv(spec, paths, prefix)
                 + ["--backend", "fused"], want, far_win=True,
                 windows=windows, oracle_reads=oracle_reads)


def build_scene1(d: str) -> Scene:
    fa, reads_txt, n = write_scene(d, **SCENE1)
    return text_scene("scene1", fa, reads_txt, n,
                      load_digests(SCENE1_DIGESTS))


def build_scene2(d: str) -> Scene:
    paths = SCENE2.build(d)
    return bam_scene("scene2", paths, int(paths["pairs"]),
                     load_digests(SCENE2_DIGESTS))


def build_scene3(d: str) -> Scene:
    paths = SCENE3.build(d)
    return bam_scene("scene3", paths, int(paths["pairs"]),
                     load_digests(SCENE3_DIGESTS), windows=3)


def build_scene4(d: str) -> Scene:
    paths = SCENE4.build(d)
    return bam_scene("scene4", paths, int(paths["pairs"]),
                     load_digests(SCENE4_DIGESTS)["scene4"], windows=5,
                     spec=SCENE4, oracle_reads=int(paths["ctx_reads"]))


# the scenes in the order they run: the first gives the metric
SCENES = {"scene1": build_scene1, "scene2": build_scene2,
          "scene3": build_scene3, "scene4": build_scene4}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run(scene: Scene, prefix: str, dev) -> dict:
    """One CLI run of ``scene`` on ``dev``: its wall (device work
    included), the digests of its reports, whether ``_D`` is empty, the
    search kernels' launches, the fallback ratio, the timer phases and the
    run's ``counters``."""
    fused_cuda.reset_launches()
    sharded_search_cuda.LAUNCHES = 0
    engine_fused.FAR_WIN_ROWS = 0
    engine_jax.LEGACY_ROWS = 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    with measure.window_log() as windows, measure.oracle_reads() as oracle:
        t0 = time.monotonic()
        rc = port_main(scene.argv_of(prefix) + ["--device", str(dev)])
        measure.sync(dev)
        wall = time.monotonic() - t0
    if rc != 0:
        raise RuntimeError(f"{scene.name}: the CLI returned {rc}")
    got = reports(prefix)
    counters = dict(
        launches=fused_cuda.search_launches(),
        scan_launches=scan_cuda.LAUNCHES,
        fused_launches=fused_cuda.LAUNCHES,
        close_launches=fused_cuda.LAUNCHES_BY_KERNEL["close"],
        far_launches=fused_cuda.LAUNCHES_BY_KERNEL["far"],
        far_win_launches=fused_cuda.LAUNCHES_BY_KERNEL["far_win"],
        windows=sum(w["start"] < w["end"] for w in windows),
        windows_visited=len(windows),
        far_win_rows=engine_fused.FAR_WIN_ROWS,
        legacy_rows=engine_jax.LEGACY_ROWS,
        oracle_reads=oracle["reads"],
        xchrom_device=g_xchrom.device,
        xchrom_oracle=g_xchrom.oracle,
        shard_launches=sharded_search_cuda.LAUNCHES,
        peak_mib=(torch.cuda.max_memory_allocated(dev) / 2 ** 20
                  if dev.type == "cuda" else None),
        by_window=windows)
    return dict(wall=wall, digests=digests(got), d_empty=not got.get("D"),
                launches=fused_cuda.search_launches(),
                fallback=g_fallback.ratio(),
                phases=g_timer.items(), counters=counters)


def problems(scene: Scene, runs: List[dict], kernel: bool) -> List[str]:
    """What fails the gate over ``runs`` of ``scene``; ``kernel``: the runs
    must have launched the search kernels (a fused run on a card)."""
    out = []
    for i, r in enumerate(runs):
        if r["digests"] != scene.want:
            diff = sorted(k for k in set(r["digests"]) | set(scene.want)
                          if r["digests"].get(k) != scene.want.get(k))
            out.append(f"{scene.name} run {i}: reports differ from the "
                       f"reference's: {diff}")
        if r["d_empty"]:
            out.append(f"{scene.name} run {i}: the _D report is empty")
        if r["fallback"] > MAX_FALLBACK:
            out.append(f"{scene.name} run {i}: fallback ratio "
                       f"{r['fallback']} above {MAX_FALLBACK}")
        c = r.get("counters", {})
        if scene.windows is not None and c.get("windows") != scene.windows:
            out.append(f"{scene.name} run {i}: {c.get('windows')} windows, "
                       f"not {scene.windows}")
        if kernel and scene.far_win and not c.get("far_win_rows"):
            out.append(f"{scene.name} run {i}: _far_win_kernel searched "
                       "no row")
        if kernel and c.get("far_win_rows") and not c.get(
                "far_win_launches"):
            out.append(f"{scene.name} run {i}: K4 rows "
                       f"{c['far_win_rows']} but pt_far_win never launched")
        if scene.oracle_reads is not None and not (
                0 < c.get("oracle_reads", 0) <= scene.oracle_reads):
            out.append(f"{scene.name} run {i}: {c.get('oracle_reads')} "
                       "reads taken across chromosomes, not "
                       f"1 to {scene.oracle_reads}")
    launches = {r["launches"] for r in runs}
    if len(launches) != 1:
        out.append(f"{scene.name}: search kernel launches differ between "
                   "runs: "
                   f"{[r['launches'] for r in runs]}")
    if kernel and 0 in launches:
        out.append(f"{scene.name}: the search kernels never launched")
    return out


def coarse(phases: Dict[str, float]) -> Dict[str, float]:
    """The coarse timer phases (the reference's; sub-phases have a ':')."""
    return {k: v for k, v in phases.items() if ":" not in k}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m pindel_tpu_torch.bench",
        description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=RUNS,
                    help=f"timed runs of each scene (default {RUNS})")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--scenes", default=",".join(SCENES),
                    help="comma-separated scenes to run, in this order "
                         f"(default {','.join(SCENES)})")
    args = ap.parse_args(argv)
    if args.runs < 1:
        ap.error("--runs must be at least 1")
    chosen = [key for key in SCENES if key in args.scenes.split(",")]
    unknown = set(args.scenes.split(",")) - set(SCENES)
    if unknown or not chosen:
        ap.error(f"--scenes takes {', '.join(SCENES)}, not {args.scenes}")
    dev = resolve_device(args.device)
    card = measure.device_line(dev)
    log(f"device: {card}")

    t0 = time.monotonic()
    build_libraries([str(dev)])
    build_s = time.monotonic() - t0
    log(f"kernel and native library builds (or loads): {build_s:.3f} s")

    out = {}
    failed = []
    with tempfile.TemporaryDirectory(prefix="pindel_tpu_torch_bench_") as work:
        for key in chosen:
            build = SCENES[key]
            d = os.path.join(work, key)
            os.makedirs(d)
            t0 = time.monotonic()
            scene = build(d)
            built = time.monotonic() - t0
            log(f"{key}: {scene.n} {scene.unit}, built in {built:.3f} s")
            first = run(scene, os.path.join(d, "first"), dev)
            log(f"{key}: first use {first['wall']:.3f} s")
            kernel = dev.type == "cuda"
            timed = []
            if not problems(scene, [first], kernel):
                timed = [run(scene, os.path.join(d, f"run{i}"), dev)
                         for i in range(args.runs)]
            bad = problems(scene, [first] + timed, kernel)
            timed = timed or [first]
            walls = [r["wall"] for r in timed]
            med = statistics.median(walls)
            failed += bad
            for line in bad:
                log(f"GATE FAILED: {line}")
            c = timed[-1]["counters"]
            log(f"{key}: walls {walls}, median {med:.3f} s, "
                f"{scene.n / med:.1f} {scene.unit}/s, search kernel launches "
                f"{c['launches']}, fallback {timed[-1]['fallback']}, "
                f"windows {c['windows']} (visited {c['windows_visited']}), "
                f"_far_win_kernel rows {c['far_win_rows']}, legacy rows "
                f"{c['legacy_rows']}, reads across chromosomes "
                f"{c['oracle_reads']} (K4 {c['xchrom_device']}, oracle "
                f"{c['xchrom_oracle']}), shard launches "
                f"{c['shard_launches']}, "
                f"peak card memory {c['peak_mib']} MiB  [{card}]")
            for w in c["by_window"]:
                log(f"  window {w['index']} [{w['start']}, {w['end']}): "
                    f"{w['reads']} reads, read in at {w['read_s']:.3f} s, "
                    f"staged at {w.get('staged_s', float('nan')):.3f} s, "
                    f"reported at {w.get('done_s', float('nan')):.3f} s")
            out[key] = dict(scene=scene, walls=walls, median=med,
                            last=timed[-1], built=built,
                            first=first["wall"])

    s1 = out[chosen[0]]
    correct = not failed

    def rate(s):
        return s["scene"].n / s["median"] if correct else 0.0

    def spread(s):
        return (max(s["walls"]) - min(s["walls"])) / s["median"]

    result = {
        "metric": (METRIC if chosen[0] == "scene1"
                   else s1["scene"].unit.replace(" ", "-") + "/s"),
        "value": rate(s1),
        "unit": f"{s1['scene'].unit}/s",
        "runs": s1["walls"],
        "best": s1["scene"].n / min(s1["walls"]) if correct else 0.0,
        "spread": spread(s1),
        "fallback_ratio": s1["last"]["fallback"],
    }
    for key, s in out.items():
        if key == "scene1":
            continue
        c = s["last"]["counters"]
        result.update({
            f"{key}_value": rate(s),
            f"{key}_unit": f"{s['scene'].unit}/s",
            f"{key}_runs": s["walls"],
            f"{key}_spread": spread(s),
            f"{key}_fallback_ratio": s["last"]["fallback"],
            f"{key}_pairs": s["scene"].n,
            f"{key}_windows": c["windows"],
            f"{key}_far_win_rows": c["far_win_rows"],
            f"{key}_oracle_reads": c["oracle_reads"]})
    result.update({
        "correct": correct,
        "layers": {k: coarse(v["last"]["phases"]) for k, v in out.items()},
        "launches": {k: v["last"]["launches"] for k, v in out.items()},
        "counters": {k: v["last"]["counters"] for k, v in out.items()},
        "device": card,
        "reads": s1["scene"].n,
        "build_s": build_s,
        "scene_build_s": {k: v["built"] for k, v in out.items()},
        "first_use_s": {k: v["first"] for k, v in out.items()},
    })
    print(json.dumps(result), flush=True)
    return 0 if correct else 1


if __name__ == "__main__":
    sys.exit(main())
