"""Profile a benchmark scene: run the port warm with the fine-grained timer
registry, trace the last run with ``torch.profiler`` and, optionally,
cProfile.

    python -m pindel_tpu_torch.tools.profile_bench [--scene 1|2|3]
        [--backend fused] [--runs 2] [--threads 1] [--cprofile]
        [--sort cumulative] [--trace DIR] [--device cuda|cpu]

The counterpart of ``tools/profile_bench.py``.  The scene (``bench.py``'s
scene 1 or 2, or the port's scene 3, built by ``pindel_tpu_torch.bench``)
is written under the
system's temporary directory.  Each run goes through the port's CLI with
the scene's flags, ``-T THREADS``, ``--backend BACKEND`` and ``--profile``;
its reports are held against the reference's digests as the bench holds
them.  The last run's full timer report is printed; that run is traced
with ``torch.profiler`` (and profiled with cProfile under ``--cprofile``),
and the script prints its device-busy share (the union of the trace's
device intervals over the run's wall) and the device kernels with the most
time, and the last run's counters (``bench.run``: windows, K4 rows,
legacy rows, shard kernel launches, peak card memory, per-window times);
``--trace DIR`` writes the Chrome trace there.

Progress and reports go to standard error; the last line of standard
output is one JSON object: the walls, the last run's coarse and fine
phases, device seconds, busy share, top kernels, search kernel launches,
``counters``, ``correct``, ``device`` (the card's name and power limit) and ``build_s``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time

from pindel_tpu_torch import bench
from pindel_tpu_torch.parallel.multihost import build_libraries
from pindel_tpu_torch.pipeline import BACKENDS, resolve_device
from pindel_tpu_torch.profiling import g_timer
from pindel_tpu_torch.tools import measure

TOP_KERNELS = 10


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m pindel_tpu_torch.tools.profile_bench",
        description=__doc__.splitlines()[0])
    ap.add_argument("--scene", type=int, choices=(1, 2, 3), default=1)
    ap.add_argument("--backend", default="fused", choices=BACKENDS)
    ap.add_argument("--cprofile", action="store_true",
                    help="also run cProfile over the last run")
    ap.add_argument("--runs", type=int, default=2,
                    help="runs; the last one is traced (default 2)")
    ap.add_argument("--threads", type=int, default=1,
                    help="host worker threads, -T (default 1)")
    ap.add_argument("--sort", default="cumulative",
                    help="cProfile sort key (default cumulative)")
    ap.add_argument("--trace", default=None, metavar="DIR",
                    help="write the last run's Chrome trace into DIR")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    if args.runs < 1:
        ap.error("--runs must be at least 1")
    dev = resolve_device(args.device)
    card = measure.device_line(dev)
    t0 = time.monotonic()
    build_libraries([str(dev)])
    build_s = time.monotonic() - t0
    log(f"device: {card}; kernel and native library builds (or loads) "
        f"{build_s:.3f} s")

    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    runs = []
    with tempfile.TemporaryDirectory(prefix="pindel_tpu_torch_profile_") as d:
        key = f"scene{args.scene}"
        scene = bench.SCENES[key](d)
        extra = ["-T", str(args.threads), "--backend", args.backend,
                 "--profile"]
        scene = dataclasses.replace(
            scene, argv_of=lambda prefix, base=scene.argv_of:
            base(prefix) + extra)
        log(f"{key}: {scene.n} {scene.unit}, flags {scene.argv_of('OUT')}")
        for i in range(args.runs - 1):
            runs.append(bench.run(scene, os.path.join(d, f"run{i}"), dev))
            log(f"run {i}: {runs[-1]['wall']:.3f} s")
        prof_c = None
        if args.cprofile:
            import cProfile
            prof_c = cProfile.Profile()
        with profile(activities=activities) as prof:
            if prof_c is not None:
                prof_c.enable()
            runs.append(bench.run(scene, os.path.join(d, "traced"), dev))
            if prof_c is not None:
                prof_c.disable()
    last = runs[-1]
    bad = bench.problems(scene, runs, dev.type == "cuda"
                         and args.backend in ("fused", "mesh"))
    for line in bad:
        log(f"GATE FAILED: {line}")
    log(f"traced run: {last['wall']:.3f} s; timer report:\n"
        + g_timer.report())
    if prof_c is not None:
        import pstats
        pstats.Stats(prof_c, stream=sys.stderr).sort_stats(
            args.sort).print_stats(35)
    device_s, busy = measure.device_busy(prof, last["wall"])
    top = measure.top_device_kernels(prof, TOP_KERNELS)
    log(f"device time {device_s:.6f} s of the traced run's "
        f"{last['wall']:.3f} s: busy share "
        + ("not measured (no device)" if busy is None else f"{busy:.4%}")
        + f"  [{card}]")
    for name, calls, ms in top:
        log(f"  {ms:12.4f} ms {calls:6d} calls  {name[:100]}")
    counters = last["counters"]
    log("counters of the traced run: " + ", ".join(
        f"{k} {v}" for k, v in counters.items() if k != "by_window"))
    if args.trace:
        os.makedirs(args.trace, exist_ok=True)
        path = os.path.join(args.trace, f"trace_{key}.json")
        prof.export_chrome_trace(path)
        log(f"Chrome trace: {path}")
    print(json.dumps(dict(
        tool="profile_bench", scene=key, backend=args.backend,
        runs=[r["wall"] for r in runs], wall=last["wall"],
        layers=bench.coarse(last["phases"]), phases=last["phases"],
        device_s=device_s, busy_share=busy,
        top_kernels=[dict(name=n, calls=c, ms=ms) for n, c, ms in top],
        launches=last["launches"], counters=counters,
        fallback_ratio=last["fallback"],
        correct=not bad, device=card, build_s=build_s,
        first_use_s=runs[0]["wall"])), flush=True)
    return 0 if not bad else 1


if __name__ == "__main__":
    sys.exit(main())
