"""The control of ``correct``: the plain reference put in the program's
place with one guarantee of the configuration broken, judged as a run's
passes are judged.

The configurations state no precision; their guarantee that a read maps
with up to its length's budget of mismatches (pindel's table) is the one
broken: the control searches with every budget one lower, the approximate
search a faster program might be tempted into.  For each seed it builds the
cell's sample, runs the reference and the control over it, and prints
``report_files_differing`` and ``report_lines_differing`` of the control
against the reference (the numbers a run compares, whose limits are 0).

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3
                                 [--device cuda]

Run on the card at the cell's own size; ``tests/test_bench_control.py``
runs it on the CPU at a small size.  The benchmark's own runs do not run
it.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

import harness
import judge


@contextlib.contextmanager
def budgets_one_lower():
    """The reference's mismatch budget table, every length's one lower (not
    below 0)."""
    from refpindel.config import Settings
    real = Settings.max_mismatch

    def lower(self):
        return np.maximum(real(self) - 1, 0).astype(np.int32)

    Settings.max_mismatch = lower
    try:
        yield
    finally:
        Settings.max_mismatch = real


def control(cell: harness.Cell, seed: int, device: str) -> dict:
    """The control's reading on one seed: its differing report lines
    against the reference, and both sides' times."""
    work = tempfile.mkdtemp(prefix="pindel_control_")
    try:
        sample_dir = os.path.join(work, "sample")
        os.makedirs(sample_dir)
        sample = cell.generator.build(cell.config["generator"], seed,
                                      sample_dir)
        flags = list(cell.config["flags"]) + ["--device", device]
        prefixes = {}
        times = {}
        for side in ("reference", "control"):
            d = os.path.join(work, side)
            os.makedirs(d)
            prefixes[side] = os.path.join(d, "out")
            t = time.monotonic()
            with (budgets_one_lower() if side == "control"
                  else contextlib.nullcontext()):
                harness.reference(sample.argv + flags
                                  + ["-o", prefixes[side]])
            times[side] = time.monotonic() - t
        verdict = judge.judge([prefixes["control"]], prefixes["reference"])
        return dict(seed=seed, pairs=sample.pairs,
                    report_lines_differing=verdict[
                        "report_lines_differing"],
                    report_files_differing=verdict[
                        "report_files_differing"],
                    suffixes_differing=verdict["suffixes_differing"],
                    reference_lines=verdict["reference_lines"],
                    reference_s=times["reference"],
                    control_s=times["control"])
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 benchmark/control.py",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = harness.cell_of(harness.load_spec(), args.workload)
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        row = control(cell, seed, args.device)
        rows.append(row)
        print(json.dumps(row), file=sys.stderr, flush=True)
    print(json.dumps(dict(
        workload=args.workload, device=args.device,
        least_lines=min(r["report_lines_differing"] for r in rows),
        least_files=min(r["report_files_differing"] for r in rows),
        rows=rows)))
    return 0


if __name__ == "__main__":
    sys.path.append(harness.ROOT)
    sys.exit(main())
