"""The span tree of whole passes of the port's CLI, and what recording it
costs: passes run in this process in turns with recording off, recording
on (as ``--profile`` does) and under ``torch.profiler`` (host and device),
after one untimed pass.

    python -m pindel_tpu_torch.tools.span_report --cell colo15_text.sample
        [--seed 1] [--rounds 2] [--device cuda] [--out DIR]
    python -m pindel_tpu_torch.tools.span_report [--rounds 2] -- <CLI args>

``--cell`` builds the sample of a cell of the repository's benchmark
(``BENCHMARK.json``, its configuration's generator under ``benchmark/gen``)
from ``--seed`` under the system's temporary directory and runs the cell's
flags over it; otherwise the arguments after ``--`` are the CLI's, without
``-o``.  Each round runs off, on, profiled, profiled, on, off.  The last
profiled pass's span tree (total and self seconds per path of span names,
``Timer.report``), its root's self share on the main thread, the largest
distance between a span mapped onto the profiler's clock and its range, and
the sums the benchmark's span and counter readers take (``coverage_s``,
``entry_s``, ``device_wait_s``, ``oracle_read_pct``, ``upload_mb``,
``xchrom_s``, ``xchrom_oracle_reads``, ``interchrom_s``), the pass's
reference reads (``coverage_reads``, ``coverage_counted``: handed to the
coverage update, and counted there), the reads the cross-chromosome
route took (``xchrom_reads``) and the pass's BAM record loads
(``bam_loads``, ``bam_records``, ``bam_file_records``: ``g_bam``) go to
standard error; the last line
of standard output is one JSON object with them, every pass's wall by mode,
and ``device`` (the card's name and power limit).  ``--out DIR`` also writes
the tree there.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time

import torch

from pindel_tpu_torch.__main__ import main as port_main
from pindel_tpu_torch.ops import fused_cuda
from pindel_tpu_torch.profiling import (PREFIX, ROOT, g_bam, g_coverage,
                                        g_fallback, g_timer, g_xchrom)
from pindel_tpu_torch.tools import measure

ROOT_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
ENTRY = ("entry: reference", "entry: inputs", "entry: chromosome",
         "entry: region", "entry: finish")
WAITS = ("fused: close wait", "fused: far wait", "fused: bdwin wait")
ORDER = ("off", "on", "profiled", "profiled", "on", "off")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def cell_argv(name: str, seed: int, d: str) -> list:
    """The CLI arguments of one pass of benchmark cell ``name`` over the
    sample built from ``seed`` under ``d``."""
    bench = os.path.join(ROOT_DIR, "benchmark")
    with open(os.path.join(ROOT_DIR, "BENCHMARK.json")) as fh:
        spec = json.load(fh)
    work = {w["name"]: w for w in spec["workloads"]}[name]
    cfg_file = {c["name"]: c["file"] for c in spec["configs"]}[
        work["config"]]
    with open(os.path.join(ROOT_DIR, cfg_file)) as fh:
        config = json.load(fh)
    sys.path.insert(0, bench)
    try:
        from gen import samples
        sample = samples.build(config["generator"], seed, d)
    finally:
        sys.path.remove(bench)
    return sample.argv + list(config["flags"])


def one_pass(argv: list, prefix: str, mode: str, dev) -> dict:
    fused_cuda.reset_launches()
    args = argv + ["-o", prefix] + (["--profile"] if mode == "on" else [])
    prof = None
    t = time.monotonic()
    if mode == "profiled":
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            rc = port_main(args)
    else:
        rc = port_main(args)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.monotonic() - t
    if rc != 0:
        raise RuntimeError(f"a {mode} pass returned {rc}")
    return dict(wall=wall, prof=prof)


def clock_error_us(prof) -> float:
    """The largest distance (us) by which a main-thread span mapped onto
    the profiler's clock leaves its range, or its end misses the range's
    (the k-th span of a name against the k-th range of that name)."""
    spans = g_timer.spans(prof)
    main = [s for s in spans if not s.parent][0].thread
    ranges = {}
    for e in prof.events():
        if e.name.startswith(PREFIX) and e.device_type.name == "CPU":
            ranges.setdefault(e.name[len(PREFIX):], []).append(
                (e.time_range.start, e.time_range.end))
    mine = {}
    for s in sorted(spans, key=lambda s: s.start):
        if s.thread == main and s.name in ranges:
            mine.setdefault(s.name, []).append(s)
    worst = 0.0
    for name, got in mine.items():
        for s, (lo, hi) in zip(got, sorted(ranges[name])):
            worst = max(worst, lo - s.start, abs(hi - s.end))
    return worst


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    cli = argv[argv.index("--") + 1:] if "--" in argv else []
    own = argv[:argv.index("--")] if "--" in argv else argv
    ap = argparse.ArgumentParser(
        prog="python -m pindel_tpu_torch.tools.span_report",
        description=__doc__.splitlines()[0])
    ap.add_argument("--cell", default=None)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, metavar="DIR")
    args = ap.parse_args(own)
    if bool(args.cell) == bool(cli):
        ap.error("give --cell or the CLI's arguments after --, not both")
    dev = torch.device(args.device)
    card = measure.device_line(dev)
    with tempfile.TemporaryDirectory(prefix="pindel_span_report_") as d:
        t = time.monotonic()
        base = (cell_argv(args.cell, args.seed, d) if args.cell else cli)
        base = base + ["--device", str(dev)]
        log(f"sample in {time.monotonic() - t:.3f} s; device {card}")
        walls = {"off": [], "on": [], "profiled": []}
        one_pass(base, os.path.join(d, "warmup"), "off", dev)
        last = None
        for r in range(args.rounds):
            for k, mode in enumerate(ORDER):
                p = one_pass(base, os.path.join(d, f"r{r}_{k}_{mode}"),
                             mode, dev)
                walls[mode].append(p["wall"])
                log(f"round {r} {mode}: {p['wall']:.4f} s")
                if mode == "profiled":
                    last = dict(clock=clock_error_us(p["prof"]),
                                tree=g_timer.tree(),
                                report=g_timer.report(),
                                items=g_timer.items(),
                                fallback=(g_fallback.fallback,
                                          g_fallback.total),
                                coverage=(g_coverage.reads,
                                          g_coverage.counted),
                                xchrom=(g_xchrom.reads, g_xchrom.oracle),
                                bam=(g_bam.loads, g_bam.records,
                                     g_bam.file_records),
                                upload=fused_cuda.UPLOAD_BYTES)
    log(last["report"])
    root = [row for row in last["tree"] if row[0] == 0 and row[1] == ROOT][0]
    items = last["items"]
    fb, total = last["fallback"]
    out = dict(
        tool="span_report", cell=args.cell, seed=args.seed, walls=walls,
        medians={m: statistics.median(w) for m, w in walls.items()},
        root_s=root[2], root_self_s=root[3], root_self_share=root[3]
        / root[2], clock_error_us=last["clock"],
        coverage_s=items.get("coverage: reference reads"),
        entry_s=sum(items.get(n, 0.0) for n in ENTRY),
        device_wait_s=sum(items.get(n, 0.0) for n in WAITS),
        oracle_read_pct=100.0 * fb / total if total else None,
        upload_mb=last["upload"] / 1e6,
        xchrom_s=items.get("search: cross-chromosome"),
        xchrom_reads=last["xchrom"][0],
        xchrom_oracle_reads=last["xchrom"][1],
        interchrom_s=items.get("window: interchromosomal"),
        coverage_reads=last["coverage"][0],
        coverage_counted=last["coverage"][1],
        bam_loads=last["bam"][0], bam_records=last["bam"][1],
        bam_file_records=last["bam"][2], tree=[list(row) for row in last["tree"]], device=card)
    cost = {m: out["medians"][m] / out["medians"]["off"] - 1
            for m in ("on", "profiled")}
    out["cost"] = cost
    log(f"root self {root[3]:.4f} s of {root[2]:.4f} s "
        f"({100 * out['root_self_share']:.2f}%); spans on the profiler's "
        f"clock within {out['clock_error_us']:.1f} us; pass medians "
        f"{out['medians']} (cost {cost}); coverage_s {out['coverage_s']}, "
        f"entry_s {out['entry_s']:.4f}, device_wait_s "
        f"{out['device_wait_s']:.4f}, oracle_read_pct "
        f"{out['oracle_read_pct']}, upload_mb {out['upload_mb']:.3f}, "
        f"xchrom_s {out['xchrom_s']}, xchrom_reads {out['xchrom_reads']}, "
        f"xchrom_oracle_reads {out['xchrom_oracle_reads']}, interchrom_s "
        f"{out['interchrom_s']}, coverage_reads {out['coverage_reads']}, "
        f"coverage_counted {out['coverage_counted']}, bam_loads "
        f"{out['bam_loads']}, bam_records {out['bam_records']}, "
        f"bam_file_records {out['bam_file_records']}  [{card}]")
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        name = f"span_tree_{args.cell or 'cli'}_{args.seed}.txt"
        with open(os.path.join(args.out, name), "w") as fh:
            fh.write(last["report"] + "\n")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
