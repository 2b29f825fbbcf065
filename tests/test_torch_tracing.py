"""The port's spans and counters: every span name is in one catalogue and
carries no parameter, parents enclose their children, work of the ``-T``
pool has a parent, the root's self time is reported, recording is off by
default and changes no report, spans lie on a ``torch.profiler``'s clock,
``fused_cuda.UPLOAD_BYTES`` counts what the backends send their device, and
the benchmark's five readers of them read what they should.

Runs the small pindel-text scene and the ``bam_bd_bigdel`` BAM scene
through the port's CLI on the CPU (a few seconds each)."""
import importlib.util
import os
import sys
import threading

import numpy as np
import pytest
import torch

from pindel_tpu_torch import profiling
from pindel_tpu_torch.__main__ import main as port_main
from pindel_tpu_torch.ops import engine_fused, engine_jax, fused_cuda
from pindel_tpu_torch.profiling import PREFIX, ROOT, g_fallback, g_timer
from pindel_tpu_torch.testing.scenes import (BAM_SCENES, bam_argv,
                                             build_bigdel, reports,
                                             write_scene)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "benchmark")

# every span the port emits (PERF.md section 3 names the reader of each)
CATALOGUE = {
    ROOT, "entry: reference", "entry: inputs", "entry: chromosome",
    "entry: region", "entry: finish",
    "Reading in reads", "intake: index pindel text",
    "intake: parse pindel text", "intake: index reads",
    "intake: bam index", "intake: bam decode", "intake: bam objects",
    "bd: rp discovery", "bd: update", "bd: update_bd", "bd: apply delta",
    "bd: load region", "coverage: reference reads",
    "window: bookkeeping", "window: close-end report",
    "window: interchromosomal",
    "Matching close ends", "search: consume close", "search: finalize close",
    "fused: pack close", "fused: dispatch close", "fused: close wait",
    "fused: decode close", "fused: close decode join", "fused: pack far",
    "fused: dispatch far",
    "fused: far wait", "fused: decode far", "fused: pack bdwin",
    "fused: bdwin wait", "fused: decode bdwin",
    "Searching far ends", "Searching and reporting variations",
    "svs: detect D", "svs: report D", "svs: detect DI", "svs: report DI",
    "svs: detect TD", "svs: report TD", "svs: detect TD_NT",
    "svs: detect INV", "svs: report INV", "svs: detect INV_NT",
    "svs: detect SI", "svs: report SI", "svs: LI",
    "li: alloc", "li: pileup", "li: prevb", "li: scan", "li: assign+write",
    "device: pack lanes", "device: kernel+xfer", "device: decode emissions",
    "sharded: pack lanes", "sharded: search+xfer",
    "sharded: decode emissions", "multihost: wait for worker windows",
}
# spans the copied modules time with ``add`` at the interval's end: they
# open no profiler range
ADDED = {"search: consume close", "search: finalize close", "li: scan",
         "li: assign+write"}
# the two runs' flags: -T 2 puts the close decode on the pool
TEXT_FLAGS = ["-s", "-l", "-k", "-T", "2", "--device", "cpu"]
BAM_FLAGS = ["-T", "2", "--device", "cpu"]


class Uploads:
    """Sums what the backends hand their device, beside the counter."""

    def __init__(self, monkeypatch):
        self.nbytes = 0
        launch = engine_fused.TorchFusedBackend._launch
        state = engine_fused.device_state_from_numpy
        search = engine_jax.TorchLaneBackend._search

        def counted_launch(backend, kernel, payload, static):
            self.nbytes += payload.nbytes
            return launch(backend, kernel, payload, static)

        def counted_state(chrom_codes, maxmm, device):
            self.nbytes += (np.require(chrom_codes, np.int8).nbytes
                            + np.require(maxmm, np.int32).nbytes)
            return state(chrom_codes, maxmm, device)

        def counted_search(backend, *arrays, **static):
            self.nbytes += sum(a.nbytes for a in arrays)
            return search(backend, *arrays, **static)

        monkeypatch.setattr(engine_fused.TorchFusedBackend, "_launch",
                            counted_launch)
        monkeypatch.setattr(engine_fused, "device_state_from_numpy",
                            counted_state)
        monkeypatch.setattr(engine_jax.TorchLaneBackend, "_search",
                            counted_search)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """The two scenes' inputs: (argv without -o and --profile, name)."""
    d = tmp_path_factory.mktemp("tracing")
    text_dir, bam_dir = d / "text", d / "bam"
    text_dir.mkdir()
    bam_dir.mkdir()
    fa, reads_txt, _n = write_scene(str(text_dir), seed=0)
    text = ["-f", fa, "-p", reads_txt] + TEXT_FLAGS
    bam = bam_argv(BAM_SCENES["bam_bd_bigdel"], build_bigdel(str(bam_dir)),
                   str(bam_dir / "PREFIX")) + BAM_FLAGS
    return d, {"text": text, "bam": bam}


def run_scene(scenes, name: str, tag: str, profile: bool) -> str:
    """One CLI run of scene ``name`` under a prefix of its own."""
    d, argv = scenes
    prefix = str(d / f"{name}_{tag}")
    args = [a.replace(str(d / "bam" / "PREFIX"), prefix)
            for a in argv[name]] + ["-o", prefix]
    if profile:
        args.append("--profile")
    assert port_main(args) == 0
    return prefix


@pytest.fixture(scope="module")
def recorded(scenes):
    """Each scene run with --profile: (its spans, its span tree, its
    report, the bytes the backends handed their device, UPLOAD_BYTES)."""
    out = {}
    for name in ("text", "bam"):
        mp = pytest.MonkeyPatch()
        try:
            uploads = Uploads(mp)
            fused_cuda.reset_launches()
            prefix = run_scene(scenes, name, "recorded", profile=True)
            out[name] = dict(spans=g_timer.spans(), tree=g_timer.tree(),
                             report=g_timer.report(), prefix=prefix,
                             expected=uploads.nbytes,
                             counted=fused_cuda.UPLOAD_BYTES)
        finally:
            mp.undo()
    return out


def test_span_names_are_catalogued_and_fixed(recorded):
    names = {s.name for r in recorded.values() for s in r["spans"]}
    assert names <= CATALOGUE, names - CATALOGUE
    assert not [n for n in CATALOGUE if "=" in n]
    fused = {n for n in CATALOGUE if n.startswith("fused: ")}
    assert len(fused) == 12 and fused <= names, fused - names


def test_parents_enclose_children(recorded):
    for name, r in recorded.items():
        spans = r["spans"]
        by_id = {s.id: s for s in spans}
        assert len(by_id) == len(spans)
        roots = [s for s in spans if not s.parent]
        assert [s.name for s in roots] == [ROOT], name
        main = roots[0].thread
        pool = [s for s in spans if s.thread != main]
        assert pool, f"{name}: nothing ran on the -T pool"
        for s in spans:
            assert s.start <= s.end
            if not s.parent:
                continue
            parent = by_id[s.parent]      # pool spans have a parent too
            assert parent.start <= s.start and s.end <= parent.end, (
                name, s, parent)


def test_root_self_time_is_reported(recorded):
    for r in recorded.values():
        root = [row for row in r["tree"] if row[0] == 0]
        assert len(root) == 1 and root[0][1] == ROOT
        _depth, _name, total, own, calls, _same = root[0]
        assert calls == 1 and 0 <= own < total
        assert r["report"].startswith("Span tree")
        assert "root self time %.3fs" % own in r["report"]
        # self times never exceed totals
        assert all(0 <= row[3] <= row[2] + 1e-9 for row in r["tree"])


def test_recording_off_keeps_nothing_and_changes_no_report(
        scenes, recorded, monkeypatch):
    opened = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: opened.append(name))
    monkeypatch.setattr(g_timer, "_range", lambda name: opened.append(name))
    for name in ("text", "bam"):
        prefix = run_scene(scenes, name, "off", profile=False)
        assert not g_timer.recording
        assert g_timer.spans() == [] and g_timer.tree() == []
        assert not opened
        assert reports(prefix) == reports(recorded[name]["prefix"])
        assert ROOT in g_timer.items()
        assert g_timer.report(coarse_only=True).startswith("Timer report")


def test_spans_lie_on_the_profilers_clock(scenes):
    from torch.profiler import ProfilerActivity, profile
    assert not profiling.profiler_active()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert profiling.profiler_active()
        run_scene(scenes, "text", "profiled", profile=False)
    assert not profiling.profiler_active()
    assert g_timer.recording
    spans = g_timer.spans(prof)
    main = [s for s in spans if not s.parent][0].thread
    ranges = {}
    for e in prof.events():
        if e.name.startswith(PREFIX) and e.device_type.name == "CPU":
            ranges.setdefault(e.name[len(PREFIX):], []).append(
                (e.time_range.start, e.time_range.end))
    phases = [s for s in spans if s.thread == main and s.name not in ADDED]
    assert len(phases) > 20
    by_name = {}
    for s in sorted(phases, key=lambda s: s.start):
        by_name.setdefault(s.name, []).append(s)
    for name, mine in by_name.items():
        theirs = sorted(ranges[name])
        assert len(theirs) == len(mine), name
        for s, (lo, hi) in zip(mine, theirs):
            # the span's buffered times fall inside its range, within 1 ms
            assert lo - 1e3 <= s.start <= s.end <= hi + 1e3, (s, lo, hi)


def test_upload_bytes_count_payloads_and_state(recorded):
    for r in recorded.values():
        assert r["counted"] == r["expected"] > 0
    fused_cuda.count_upload(5)
    assert fused_cuda.UPLOAD_BYTES > 0
    fused_cuda.reset_launches()
    assert fused_cuda.UPLOAD_BYTES == 0


def test_sums_hold_under_threads():
    """Phases of many threads at once lose no sum and no span."""
    timer = profiling.Timer()
    timer.reset(record=True)
    n_threads, n_phases = 16, 300
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with timer.phase(ROOT):
            def work():
                for _ in range(n_phases):
                    with timer.phase("x"):
                        pass
                    timer.add("y", 1.0)
            threads = [threading.Thread(target=timer.bind(work))
                       for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    items = timer.items()
    assert items["y"] == n_threads * n_phases
    spans = timer.spans()
    root = [s for s in spans if s.name == ROOT][0]
    xs = [s for s in spans if s.name == "x"]
    assert len(xs) == n_threads * n_phases
    assert all(s.parent == root.id for s in xs)
    assert items["x"] == pytest.approx(sum(s.end - s.start for s in xs) / 1e9)


# ------------------------------------------------- the benchmark's readers
def reader(name: str):
    """``benchmark/metrics/<name>.py``, loaded by path as the harness
    loads it."""
    spec = importlib.util.spec_from_file_location(
        "metric_" + name, os.path.join(BENCH, "metrics", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def harness():
    """The benchmark's harness module (for its ``Run`` and ``Pass``)."""
    sys.path.insert(0, BENCH)
    before = set(sys.modules)
    try:
        spec = importlib.util.spec_from_file_location(
            "bench_harness", os.path.join(BENCH, "harness.py"))
        mod = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = mod      # its dataclasses look it up
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(BENCH)
        # the benchmark's own modules (bounds, judge, tracing, gen) leave
        # the module table, so no later test finds them by those names
        for name in set(sys.modules) - before:
            path = getattr(sys.modules[name], "__file__", None) or ""
            if path.startswith(BENCH + os.sep):
                del sys.modules[name]
    return mod


def hand_run(harness, *phases):
    passes = [harness.Pass(wall=1.0, phases=p, ok=True, launches={})
              for p in phases]
    return harness.Run(cell=None, input_format="bam", passes=passes,
                       window_s=float(len(passes)))


def test_readers_read_the_spans(harness):
    run = hand_run(harness, {
        "coverage: reference reads": 2.0, "entry: reference": 0.5,
        "entry: inputs": 0.25, "entry: chromosome": 0.125,
        "entry: region": 0.0625, "entry: finish": 0.0625,
        "fused: close wait": 0.01, "fused: far wait": 0.02,
        "fused: bdwin wait": 0.03, "Matching close ends": 9.0}, {
        "coverage: reference reads": 4.0, "entry: reference": 1.0,
        "fused: close wait": 0.03})
    assert reader("coverage_s").read(run) == pytest.approx(3.0)
    assert reader("entry_s").read(run) == pytest.approx((1.0 + 1.0) / 2)
    assert reader("device_wait_s").read(run) == pytest.approx(
        (0.06 + 0.03) / 2)
    # a program without these spans (the parent's) gives nothing
    bare = hand_run(harness, {"Matching close ends": 1.0,
                              "fused: close wait w=1536/4608 b=8": 0.1})
    for name in ("coverage_s", "entry_s", "device_wait_s"):
        assert reader(name).read(bare) is None


def test_readers_read_the_counters(harness, monkeypatch):
    run = hand_run(harness, {"run: pass": 1.0})
    monkeypatch.setattr(g_fallback, "total", 400)
    monkeypatch.setattr(g_fallback, "fallback", 6)
    assert reader("oracle_read_pct").read(run) == pytest.approx(1.5)
    monkeypatch.setattr(g_fallback, "total", 0)
    monkeypatch.setattr(g_fallback, "fallback", 0)
    assert reader("oracle_read_pct").read(run) is None
    monkeypatch.setattr(fused_cuda, "UPLOAD_BYTES", 12_345_678)
    assert reader("upload_mb").read(run) == pytest.approx(12.345678)
    monkeypatch.delattr(fused_cuda, "UPLOAD_BYTES")
    assert reader("upload_mb").read(run) is None

