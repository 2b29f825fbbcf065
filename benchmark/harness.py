"""The benchmark of ``pindel_tpu_torch``: one cell, one seed, one window.

A cell names a configuration (``configs/<name>.json``: the deployment, the
sample generator's parameters and the CLI flags) and a traffic mix
(``traffic/<name>.json``).  Passes are offered in a closed loop, one client
(one sample, one card, one job after another); a traffic file gives only
``warmup_passes``, the untimed passes before the window, and a file with
any other key is refused.  A run

1. generates the sample from ``--seed`` (``gen/<kind>.py``, the layout the
   configuration's generator names) under ``TMPDIR`` and runs the
   traffic's warm-up passes, untimed (set-up:
   imports, builds or loads of the kernels and native libraries,
   generation, warm-up; ``setup_s`` is from the process's start);
2. runs whole passes of the port's CLI entry, ``pindel_tpu_torch.__main__.
   main``, back to back in this process (a closed loop: one sample, one
   card, one job after another), each into its own output prefix, until
   ``--seconds`` have passed; the pass in flight then is finished and
   counted; ``pairs_per_s`` is the input pairs of every window pass over
   the time from the window's start to the end of its last pass;
3. with ``--trace 1`` runs the same window under ``torch.profiler`` and
   reports the per-layer metrics (``metrics/<name>.py``) instead;
4. reads the card's peak memory, frees the program's state, runs the plain
   reference (``refpindel``) once over the same files and judges every
   pass's reports against it (``judge.py``).

The last line of standard output is the result; each number compared is
printed beside its limit as the last lines of standard error.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import importlib.util
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
from typing import Dict, List, Optional

import torch

import bounds
import judge
import tracing
from gen import samples

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "pindel_tpu")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


# ----------------------------------------------------------------- files
def load_spec(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        return json.load(fh)


def load_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


TRAFFIC_KEYS = {"warmup_passes"}


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    per_layer: List[tuple]        # (BENCHMARK.json's entry, its reader)
    generator: object             # the module gen/<kind>.py


def check_traffic(name: str, traffic: dict) -> dict:
    if set(traffic) != TRAFFIC_KEYS:
        raise ValueError(f"traffic {name!r} has keys {sorted(traffic)}; "
                         f"the harness reads {sorted(TRAFFIC_KEYS)} alone")
    n = traffic["warmup_passes"]
    if not isinstance(n, int) or isinstance(n, bool) or n < 1:
        raise ValueError(f"traffic {name!r}: warmup_passes is a whole "
                         f"number from 1, not {n!r}")
    return traffic


def cell_of(spec: dict, name: str, root: str = ROOT,
            bench_dir: str = HERE) -> Cell:
    """The cell ``name`` of ``spec`` with its configuration, its traffic mix
    and the per-layer metrics it reports."""
    work = {w["name"]: w for w in spec["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has "
                       f"{', '.join(sorted(work))}")
    w = work[name]
    cfg = {c["name"]: c for c in spec["configs"]}[w["config"]]
    config = load_json(os.path.join(root, cfg["file"]))
    traffic = check_traffic(w["traffic"], load_json(os.path.join(
        bench_dir, "traffic", w["traffic"] + ".json")))
    per_layer = [(m, metric_reader(m["name"], bench_dir))
                 for m in spec["per_layer"]
                 if name in m.get("workloads", [name])]
    generator = samples.load(config["generator"],
                             os.path.join(bench_dir, "gen"))
    return Cell(name, config, traffic, w["chips"], per_layer, generator)


def metric_reader(name: str, bench_dir: str = HERE):
    """The module ``metrics/<name>.py``: its ``read(run)`` gives the
    metric, or None where the run holds nothing to read."""
    path = os.path.join(bench_dir, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ------------------------------------------------------------------ a run
@dataclasses.dataclass
class Pass:
    wall: float
    phases: Dict[str, float]
    ok: bool
    launches: Dict[str, int]


@dataclasses.dataclass
class Run:
    """What the per-layer readers read."""

    cell: Cell
    input_format: str             # "text" or "bam"
    passes: List[Pass]            # the window's
    window_s: float
    trace: Optional[dict] = None  # tracing.reduce's, with "bounds"

    def phase_per_pass(self, *names: str) -> Optional[float]:
        """The mean over the window's passes of the sum of the program's
        ``g_timer`` phases ``names``; None where no pass has any."""
        if not any(n in p.phases for p in self.passes for n in names):
            return None
        return statistics.fmean(sum(p.phases.get(n, 0.0) for n in names)
                                for p in self.passes)


def power_limit() -> str:
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return "unknown"
    return res.stdout.strip().splitlines()[0] if res.stdout.strip() \
        else "unknown"


def forbidden_modules() -> List[str]:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def run(cell: Cell, seed: int, seconds: float, trace: bool, t0: float,
        device: str = "cuda") -> dict:
    """One run of ``cell``; returns the result's fields and what was
    compared.  ``device="cpu"`` is for the CPU tests (no timing there is a
    device number)."""
    from pindel_tpu_torch.__main__ import main as port_main
    from pindel_tpu_torch.ops import fused_cuda
    from pindel_tpu_torch.profiling import g_timer

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    work = tempfile.mkdtemp(prefix="pindel_bench_")
    try:
        sample_dir = os.path.join(work, "sample")
        os.makedirs(sample_dir)
        t_gen = time.monotonic()
        sample = cell.generator.build(cell.config["generator"], seed,
                                      sample_dir)
        log(f"sample: {sample.pairs} pairs, generated in "
            f"{time.monotonic() - t_gen:.3f} s")
        input_format = "bam" if "-i" in sample.argv else "text"
        flags = list(cell.config["flags"]) + ["--device", str(dev)]
        prefixes: List[str] = []

        def one_pass(tag: str) -> Pass:
            d = os.path.join(work, tag)
            os.makedirs(d)
            prefix = os.path.join(d, "out")
            prefixes.append(prefix)
            fused_cuda.reset_launches()
            t = time.monotonic()
            try:
                ok = port_main(sample.argv + flags + ["-o", prefix]) == 0
            except Exception:           # a pass that fails is counted
                log(f"pass {tag} raised:\n{traceback.format_exc()}")
                ok = False
            if on_card:
                torch.cuda.synchronize(dev)
            wall = time.monotonic() - t
            return Pass(wall, g_timer.items(), ok,
                        dict(fused_cuda.LAUNCHES_BY_KERNEL))

        for i in range(cell.traffic["warmup_passes"]):
            p = one_pass(f"warmup{i}")
            log(f"warm-up pass {i}: {p.wall:.3f} s, ok {p.ok}")
        setup_s = time.monotonic() - t0
        log(f"setup_s {setup_s:.3f}")

        calls = tracing.Calls()
        passes: List[Pass] = []
        with Instruments(trace, calls) as prof:
            w0 = time.monotonic()
            with torch.profiler.record_function(tracing.WINDOW_RANGE):
                while not passes or time.monotonic() - w0 < seconds:
                    calls.armed = trace and not passes
                    passes.append(one_pass(f"pass{len(passes)}"))
                    calls.armed = False
                    if not passes[-1].ok:     # the run is not correct
                        break
            window_s = time.monotonic() - w0
        bad_modules = forbidden_modules()
        for i, p in enumerate(passes):
            coarse = {k: round(v, 4) for k, v in p.phases.items()
                      if ":" not in k}
            fine = {k: round(v, 3) for k, v in p.phases.items() if ":" in k}
            log(f"pass {i}: wall {p.wall:.4f} s, ok {p.ok}, launches "
                f"{p.launches}, phases {coarse}, sub-phases {fine}")
        memory_peak = (torch.cuda.max_memory_allocated(dev) if on_card
                       else 0)
        n_ok = sum(p.ok for p in passes)
        out = dict(attempted=len(passes), failed=len(passes) - n_ok,
                   setup_s=setup_s, window_s=window_s,
                   pairs=sample.pairs,
                   pairs_per_s=sample.pairs * n_ok / window_s,
                   memory_peak_bytes=memory_peak, bad_modules=bad_modules)
        log(f"window: {len(passes)} passes in {window_s:.4f} s, "
            f"{out['pairs_per_s']:.1f} pairs/s")

        result_run = Run(cell, input_format, passes, window_s)
        if trace:
            result_run.trace = trace_numbers(prof, calls, len(passes))
            out["trace"] = result_run.trace
            out["per_layer"] = {}
            for m, reader in cell.per_layer:
                value = reader.read(result_run)
                if value is not None:
                    out["per_layer"][m["name"]] = (value, m["unit"])
        del prof, calls, result_run
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()

        t_ref = time.monotonic()
        ref_prefix = os.path.join(work, "reference", "out")
        os.makedirs(os.path.dirname(ref_prefix))
        reference(sample.argv + flags + ["-o", ref_prefix])
        out["reference_s"] = time.monotonic() - t_ref
        verdict = judge.judge(prefixes, ref_prefix)
        out.update(verdict)
        out["correct"] = (judge.correct(verdict)
                          and out["failed"] == 0
                          and all(p.ok for p in passes))
        return out
    finally:
        shutil.rmtree(work, ignore_errors=True)


class Instruments:
    """The traced window's instruments (the search calls' inputs, the
    program's phases as profiler ranges, the profiler), or none; yields the
    profiler."""

    def __init__(self, trace: bool, calls: tracing.Calls):
        self.trace, self.calls = trace, calls
        self.stack = contextlib.ExitStack()

    def __enter__(self):
        if not self.trace:
            return None
        from torch.profiler import ProfilerActivity, profile
        self.stack.enter_context(self.calls.attached())
        self.stack.enter_context(tracing.phases_as_ranges())
        return self.stack.enter_context(profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]))

    def __exit__(self, *exc):
        return self.stack.__exit__(*exc)


def trace_numbers(prof, calls: tracing.Calls, n_passes: int) -> dict:
    """The trace's reductions and the bounds of the first traced pass's
    search calls."""
    t = time.monotonic()
    window = tracing.window_bounds(prof)
    reduced = tracing.reduce(prof, window)
    reduced["window_s"] = (window[1] - window[0]) / 1e6
    reduced["passes"] = n_passes
    per_kernel: Dict[str, dict] = {}
    names = {v: k for k, v in bounds.KERNELS.items()}
    for name, args, static in calls.calls:
        b = bounds.call_bound(name, *args, static)
        k = per_kernel.setdefault(names[name], dict(
            seconds=0.0, ops=0.0, bytes=0.0, calls=0, by=[]))
        k["seconds"] += b["seconds"]
        k["ops"] += b["ops"]
        k["bytes"] += b["bytes"]
        k["calls"] += 1
        k["by"].append(b["bound_by"])
    reduced["bounds"] = per_kernel
    one_pass = {k: (v["seconds"], v["calls"], sorted(set(v["by"])))
                for k, v in per_kernel.items()}
    log(f"trace: {reduced['device_events']} device events, busy "
        f"{reduced['busy_s']:.6f} s of {reduced['window_s']:.4f} s; "
        f"kernels {reduced['by_kernel']} in {reduced['kernel_calls']} "
        f"calls; bounds of one pass (s, calls, bound by) {one_pass}; "
        f"read in {time.monotonic() - t:.3f} s")
    return reduced


def reference(argv: List[str]) -> None:
    from refpindel import cli
    rc = cli.main(argv)
    if rc != 0:
        raise RuntimeError(f"the plain reference returned {rc}")


# ---------------------------------------------------------------- the CLI
def result_line(cell: Cell, out: dict, trace: bool, device: dict,
                spec: dict) -> dict:
    if trace:
        metrics = {k: {"value": v, "unit": u}
                   for k, (v, u) in out["per_layer"].items()}
    else:
        metrics = {}
        for m in spec["end_to_end"]:
            if cell.name in m.get("workloads", [cell.name]):
                metrics[m["name"]] = {"value": out[m["name"]],
                                      "unit": m["unit"]}
    line = {"correct": out["correct"], "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics, "device": device}
    if trace:
        t = out["trace"]
        line["breakdown"] = {
            "device_ops": tracing.top(t["by_op"]),
            "idle_gaps": tracing.top(t["idle"])}
    line["compared"] = {
        "report_files_differing": {
            "value": out["report_files_differing"],
            "limit": judge.LIMIT},
        "report_lines_differing": {
            "value": out["report_lines_differing"],
            "limit": judge.LIMIT},
        "failed_passes": {"value": out["failed"], "limit": 0}}
    return line


def main(argv=None, t0: float = None) -> int:
    t0 = time.monotonic() if t0 is None else t0
    ap = argparse.ArgumentParser(prog="python3 benchmark/run.py",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = load_spec()
    cell = cell_of(spec, args.workload)

    if not torch.cuda.is_available():
        log("no card: torch.cuda.is_available() is false")
        return 3
    if torch.cuda.device_count() < cell.chips:
        log(f"{args.workload} needs {cell.chips} cards, "
            f"{torch.cuda.device_count()} visible")
        return 3
    out = run(cell, args.seed, args.seconds, bool(args.trace), t0)
    if out["bad_modules"]:
        log(f"modules of JAX or the JAX package loaded: "
            f"{out['bad_modules']}")
        return 4
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips, "memory_peak_bytes": out[
                  "memory_peak_bytes"], "power_limit": power_limit()}
    if args.trace:
        device["busy_s"] = out["trace"]["busy_s"]
        device["window_s"] = out["trace"]["window_s"]
    line = result_line(cell, out, bool(args.trace), device, spec)
    log(f"reference: {out['reference_s']:.3f} s, {out['reference_lines']} "
        f"lines ({out['reference_bytes']} bytes) in "
        f"{out['reference_files']}; differing lines per pass "
        f"{out['per_pass']}, suffixes {out['suffixes_differing']}")
    for name, c in line["compared"].items():
        log(f"compared {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps(line), flush=True)
    return 0
