"""Benchmark of the port: split-reads/s on scene 1 and read pairs/s on
scene 2, through the port's CLI on the card, gated on the reference's
reports.

    python -m pindel_tpu_torch.bench [--runs 5] [--device cuda|cpu]

The counterpart of the repository's ``bench.py``, with the same scenes
(``testing/scenes.py``: ``SCENE1`` at ``SCENE1_FLAGS``, 50,000 pindel-text
reads over 6 Mb; ``SCENE2``, 12,000 BAM read pairs over 2 Mb with a
BreakDancer calls file) run through ``python -m pindel_tpu_torch
--backend fused``.  Scene generation and the builds of the scan kernel and
the native libraries are set-up; each scene then takes one untimed run
(its first use), then ``--runs`` timed runs, each wall read after
``torch.cuda.synchronize()``.

The gate: every run's reports must equal the JAX package's reports on the
same scene, held as sha256 digests (``testing/scene1_digests.json``,
``testing/scene2_digests.json``); scene 1's ``_D`` report must not be
empty, and at most ``MAX_FALLBACK`` of the reads may take the host oracle.
A failed gate prints ``"value": 0.0`` and ``"correct": false`` and exits 1,
whichever scene failed.  There is no ``vs_baseline``: ``bench.py`` times
the reference pindel compiled from a C++ checkout that is not part of this
repository, and the port's gate is the JAX package's reports instead.

Progress goes to standard error.  The last line of standard output is one
JSON object: ``metric``, ``value`` (scene 1's median rate), ``unit``,
``runs`` (the walls), ``best`` (the rate of the fastest run), ``spread``
((max - min) / median of the walls), ``fallback_ratio``, ``scene2_value``,
``scene2_runs``, ``scene2_fallback_ratio``, ``correct``, ``layers`` (each
scene's coarse timer phases of its last timed run; they overlap, so they
are phases, not shares of the wall), ``launches`` (the scan kernel's
launches in each scene's last run), ``device`` (the card's name and power
limit), and the set-up times (``build_s``, ``scene_build_s``,
``first_use_s``).
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
from typing import Callable, Dict, List

from pindel_tpu_torch.__main__ import main as port_main
from pindel_tpu_torch.ops import scan_cuda
from pindel_tpu_torch.parallel.multihost import build_libraries
from pindel_tpu_torch.pipeline import resolve_device
from pindel_tpu_torch.profiling import g_fallback, g_timer
from pindel_tpu_torch.testing.scenes import (SCENE1, SCENE1_DIGESTS,
                                             SCENE1_FLAGS, SCENE2,
                                             SCENE2_DIGESTS, bam_argv,
                                             digests, load_digests, reports,
                                             write_scene)
from pindel_tpu_torch.tools import measure

METRIC = "split-reads/s"
RUNS = 5
# a larger share of reads re-run on the host oracle is a silent speed cliff
MAX_FALLBACK = 0.01


@dataclasses.dataclass
class Scene:
    """A benchmark scene: its name, unit, size, its CLI run (output prefix
    -> arguments, ``--device`` left out) and the sha256 of the reference's
    reports, by suffix."""

    name: str
    unit: str
    n: int
    argv_of: Callable[[str], List[str]]
    want: Dict[str, str]


def text_scene(name: str, fa: str, reads_txt: str, n: int,
               want: Dict[str, str]) -> Scene:
    """A pindel-text scene run at scene 1's flags."""
    return Scene(name, "reads", n,
                 lambda prefix: ["-f", fa, "-p", reads_txt, *SCENE1_FLAGS,
                                 "--backend", "fused", "-o", prefix], want)


def bam_scene(name: str, paths: Dict[str, str], n: int,
              want: Dict[str, str]) -> Scene:
    """A BAM + BreakDancer scene of ``n`` read pairs (``paths`` as
    ``SCENE2.build`` gives them) run at scene 2's flags."""
    return Scene(name, "read pairs", n,
                 lambda prefix: bam_argv(SCENE2, paths, prefix)
                 + ["--backend", "fused"], want)


def build_scene1(d: str) -> Scene:
    fa, reads_txt, n = write_scene(d, **SCENE1)
    return text_scene("scene1", fa, reads_txt, n,
                      load_digests(SCENE1_DIGESTS))


def build_scene2(d: str) -> Scene:
    paths = SCENE2.build(d)
    return bam_scene("scene2", paths, int(paths["pairs"]),
                     load_digests(SCENE2_DIGESTS))


# the scenes in the order they run: scene 1 gives the metric
SCENES = {"scene1": build_scene1, "scene2": build_scene2}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run(scene: Scene, prefix: str, dev) -> dict:
    """One CLI run of ``scene`` on ``dev``: its wall (device work
    included), the digests of its reports, whether ``_D`` is empty, the
    scan kernel's launches, the fallback ratio and the timer phases."""
    scan_cuda.LAUNCHES = 0
    t0 = time.monotonic()
    rc = port_main(scene.argv_of(prefix) + ["--device", str(dev)])
    measure.sync(dev)
    wall = time.monotonic() - t0
    if rc != 0:
        raise RuntimeError(f"{scene.name}: the CLI returned {rc}")
    got = reports(prefix)
    return dict(wall=wall, digests=digests(got), d_empty=not got.get("D"),
                launches=scan_cuda.LAUNCHES, fallback=g_fallback.ratio(),
                phases=g_timer.items())


def problems(scene: Scene, runs: List[dict], kernel: bool) -> List[str]:
    """What fails the gate over ``runs`` of ``scene``; ``kernel``: the runs
    must have launched the scan kernel (a fused run on a card)."""
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
    launches = {r["launches"] for r in runs}
    if len(launches) != 1:
        out.append(f"{scene.name}: scan launches differ between runs: "
                   f"{[r['launches'] for r in runs]}")
    if kernel and 0 in launches:
        out.append(f"{scene.name}: the scan kernel never launched")
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
    args = ap.parse_args(argv)
    if args.runs < 1:
        ap.error("--runs must be at least 1")
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
        for key, build in SCENES.items():
            d = os.path.join(work, key)
            os.makedirs(d)
            t0 = time.monotonic()
            scene = build(d)
            built = time.monotonic() - t0
            log(f"{key}: {scene.n} {scene.unit}, built in {built:.3f} s")
            first = run(scene, os.path.join(d, "first"), dev)
            log(f"{key}: first use {first['wall']:.3f} s")
            timed = [run(scene, os.path.join(d, f"run{i}"), dev)
                     for i in range(args.runs)]
            walls = [r["wall"] for r in timed]
            med = statistics.median(walls)
            bad = problems(scene, [first] + timed, dev.type == "cuda")
            failed += bad
            for line in bad:
                log(f"GATE FAILED: {line}")
            log(f"{key}: walls {walls}, median {med:.3f} s, "
                f"{scene.n / med:.1f} {scene.unit}/s, scan launches "
                f"{timed[-1]['launches']}, fallback {timed[-1]['fallback']}"
                f"  [{card}]")
            out[key] = dict(scene=scene, walls=walls, median=med,
                            last=timed[-1], built=built,
                            first=first["wall"])

    s1, s2 = out["scene1"], out["scene2"]
    correct = not failed

    def rate(s):
        return s["scene"].n / s["median"] if correct else 0.0

    result = {
        "metric": METRIC,
        "value": rate(s1),
        "unit": "reads/s",
        "runs": s1["walls"],
        "best": s1["scene"].n / min(s1["walls"]) if correct else 0.0,
        "spread": (max(s1["walls"]) - min(s1["walls"])) / s1["median"],
        "fallback_ratio": s1["last"]["fallback"],
        "scene2_value": rate(s2),
        "scene2_unit": "read pairs/s",
        "scene2_runs": s2["walls"],
        "scene2_fallback_ratio": s2["last"]["fallback"],
        "correct": correct,
        "layers": {k: coarse(v["last"]["phases"]) for k, v in out.items()},
        "launches": {k: v["last"]["launches"] for k, v in out.items()},
        "device": card,
        "reads": s1["scene"].n,
        "scene2_pairs": s2["scene"].n,
        "build_s": build_s,
        "scene_build_s": {k: v["built"] for k, v in out.items()},
        "first_use_s": {k: v["first"] for k, v in out.items()},
    }
    print(json.dumps(result), flush=True)
    return 0 if correct else 1


if __name__ == "__main__":
    sys.exit(main())
