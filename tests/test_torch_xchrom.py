"""The cross-chromosome route (``Searcher._far_round``) on the CPU: reads
whose far-end windows lie on another chromosome than the device
backend's run through ``_far_win_kernel`` (its plain version here) on that
chromosome's partner backend, with the NumPy oracle's anchors, and the
rest on the oracle, counted by ``profiling.g_xchrom``; a backend without
partners (mesh) keeps the oracle; a rerun under one prefix
reports its interchromosomal calls once; the benchmark's readers of the
route and its ``wgs_ctx`` layout, whose work does not move with the seed.
"""
import collections
import gzip
import importlib.util
import os
import struct
import sys

import numpy as np
import pytest
import torch

from pindel_tpu_torch import dna, profiling
from pindel_tpu_torch.__main__ import main as port_main
from pindel_tpu_torch.config import Settings
from pindel_tpu_torch.genome import SPACER, Genome
from pindel_tpu_torch.ops import engine_fused
from pindel_tpu_torch.ops.engine_fused import TorchFusedBackend
from pindel_tpu_torch.parallel.mesh_fused import TorchMeshBackend
from pindel_tpu_torch.pipeline import make_backend_factory
from pindel_tpu_torch.profiling import g_xchrom
from pindel_tpu_torch.reads import SplitRead
from pindel_tpu_torch.search import Searcher
from pindel_tpu_torch.testing.scenes import (SUITE_SCENES, bam_argv,
                                             load_golden, reports)
from pindel_tpu_torch.testing.simulate import random_seq, rc

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "benchmark")
CPU = torch.device("cpu")


def cross_reads(seed: int, n_reads: int = 36):
    """Split reads of a region on ``chrA`` whose heads copy either strand
    of ``chrB`` (some with a substitution), each with far-end regions in
    the style of ``scenes.two_region_lanes``: one window on ``chrB`` around
    its copy (K4's shape), that window and one on ``chrA`` (two
    chromosomes), or that window and a second one on ``chrB`` (two
    windows); returns (chrA, reads, regions)."""
    rng = np.random.default_rng(seed)
    genome = Genome()
    home = genome.add("chrA", random_seq(rng, 30_000))
    other = genome.add("chrB", random_seq(rng, 50_000))
    reads, regions = [], []
    for i in range(n_reads):
        n = int(rng.integers(40, 101))
        c = 2_000 + int(rng.integers(0, 45_000 - n))
        k = int(rng.integers(25, n - 10))
        head = dna.decode(other.seq[SPACER + c:SPACER + c + k])
        seq = list((rc(head) if i % 2 else head) + random_seq(rng, n - k))
        if i % 3 == 0:
            j = int(rng.integers(0, k))
            seq[j] = "A" if seq[j] != "A" else "C"
        r = SplitRead(name=f"@x{i}", matched_d="+", tag="S1")
        r.set_seq("".join(seq))
        reads.append(r)
        center = SPACER + c
        window = (other, center - 211, center + 187)
        regions.append([[window], [window],
                        [window, (home, SPACER + 1_000, SPACER + 1_400)],
                        [window, (other, center + 301, center + 1_007)]
                        ][i % 4])
    return home, reads, regions


def anchors(reads):
    return [([(u.length_str, u.abs_loc, u.direction, u.strand,
               u.mismatches) for u in r.up_far], r.far_end_mismatch)
            for r in reads]


def oracle_anchors(seed: int):
    _home, reads, regions = cross_reads(seed)
    Searcher(Settings())._far_round(reads, regions)
    return anchors(reads)


@pytest.mark.parametrize("seed", [3, 17, 2147483901])
def test_route_anchors_equal_the_oracles(seed):
    """Reads in K4's shape on ``chrB`` run on ``chrB``'s partner backend,
    made once; the two-chromosome and two-window reads on the oracle; every
    read's far-end anchors are the oracle's."""
    settings = Settings()
    home, reads, regions = cross_reads(seed)
    made = []

    def partner(chrom):
        made.append(chrom.name)
        return TorchFusedBackend(settings, settings.max_mismatch(),
                                 chrom.seq, chrom_name=chrom.name,
                                 device=CPU)

    backend = TorchFusedBackend(settings, settings.max_mismatch(), home.seq,
                                chrom_name="chrA", device=CPU,
                                partner_factory=partner)
    g_xchrom.reset()
    rows = engine_fused.FAR_WIN_ROWS
    Searcher(settings, backend=backend)._far_round(reads, regions)
    shaped = sum(len(regs) == 1 for regs in regions)
    assert made == ["chrB"]
    assert (g_xchrom.reads, g_xchrom.device, g_xchrom.oracle) == (
        len(reads), shaped, len(reads) - shaped)
    assert engine_fused.FAR_WIN_ROWS - rows == shaped
    got = anchors(reads)
    assert sum(bool(ups) for ups, _mm in got[::4]) > 3
    assert got == oracle_anchors(seed)


def test_backends_without_partners_keep_the_oracle():
    """The mesh backend has no partners and sends every cross-chromosome
    read to the oracle, with the oracle's anchors; every fused backend the
    pipeline's factory makes has them, through that same factory."""
    settings = Settings()
    home, reads, regions = cross_reads(5)
    backend = TorchMeshBackend(settings, settings.max_mismatch(), home.seq,
                               [CPU], chrom_name="chrA")
    g_xchrom.reset()
    rows = engine_fused.FAR_WIN_ROWS
    Searcher(settings, backend=backend)._far_round(reads, regions)
    assert (g_xchrom.reads, g_xchrom.device, g_xchrom.oracle) == (
        len(reads), 0, len(reads))
    assert engine_fused.FAR_WIN_ROWS == rows
    assert anchors(reads) == oracle_anchors(5)
    factory = make_backend_factory(settings, CPU, "fused")
    assert factory(home).partner_factory is factory


def test_rerun_under_one_prefix_reports_once(tmp_path):
    """Two runs of the interchromosomal scene under one prefix leave one
    run's reports, ``_INT`` and ``_INT_final`` included."""
    scene = SUITE_SCENES["bam_int_I"]
    built = scene.build(str(tmp_path))
    prefix = str(tmp_path / "again")
    argv = bam_argv(scene, built, prefix) + ["--device", "cpu"]
    for _ in range(2):
        assert port_main(argv) == 0
    want = load_golden()["bam_int_I"]
    assert reports(prefix) == want and want["INT_final"]


# ------------------------------------------------- the benchmark's parts
@pytest.fixture(scope="module")
def bench():
    """The benchmark's harness and ``wgs_ctx`` layout, loaded by path as
    the harness loads them; the benchmark's modules leave the module table
    afterwards."""
    sys.path.insert(0, BENCH)
    before = set(sys.modules)
    try:
        mods = {}
        for name, path in (("bench_harness", "harness.py"),
                           ("bench_wgs_ctx", "gen/wgs_ctx.py")):
            spec = importlib.util.spec_from_file_location(
                name, os.path.join(BENCH, path))
            mod = importlib.util.module_from_spec(spec)
            sys.modules[name] = mod       # its dataclasses look it up
            spec.loader.exec_module(mod)
            mods[name] = mod
    finally:
        sys.path.remove(BENCH)
        for name in set(sys.modules) - before:
            path = getattr(sys.modules[name], "__file__", None) or ""
            if path.startswith(BENCH + os.sep):
                del sys.modules[name]
    return mods


def reader(name: str):
    spec = importlib.util.spec_from_file_location(
        "metric_" + name, os.path.join(BENCH, "metrics", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_readers_of_the_route(bench, monkeypatch):
    """The readers of the route and of ``-I``'s reports read their spans
    and the counter, and give nothing on a program without them (the
    route's on the parent's)."""
    harness = bench["bench_harness"]
    passes = [harness.Pass(wall=1.0, phases=p, ok=True, launches={})
              for p in ({"search: cross-chromosome": 0.25,
                         "window: interchromosomal": 1.0},
                        {"search: cross-chromosome": 0.75,
                         "window: interchromosomal": 2.0})]
    run = harness.Run(cell=None, input_format="bam", passes=passes,
                      window_s=2.0)
    monkeypatch.setattr(g_xchrom, "reads", 384)
    monkeypatch.setattr(g_xchrom, "device", 384)
    monkeypatch.setattr(g_xchrom, "oracle", 0)
    assert reader("xchrom_s").read(run) == pytest.approx(0.5)
    assert reader("interchrom_s").read(run) == pytest.approx(1.5)
    assert reader("xchrom_oracle_reads").read(run) == 0.0
    bare = harness.Run(cell=None, input_format="bam", passes=[harness.Pass(
        wall=1.0, phases={"Matching close ends": 1.0}, ok=True,
        launches={})], window_s=1.0)
    monkeypatch.delattr(profiling, "g_xchrom")
    for name in ("xchrom_s", "xchrom_oracle_reads", "interchrom_s"):
        assert reader(name).read(bare) is None


def bam_records(path: str):
    """(reference id, position, flag) of every record of a BAM."""
    data = gzip.decompress(open(path, "rb").read())
    (l_text,) = struct.unpack_from("<i", data, 4)
    at = 8 + l_text
    (n_ref,) = struct.unpack_from("<i", data, at)
    at += 4
    for _ in range(n_ref):
        (l_name,) = struct.unpack_from("<i", data, at)
        at += 8 + l_name
    out = []
    while at < len(data):
        size, tid, pos = struct.unpack_from("<iii", data, at)
        (flag,) = struct.unpack_from("<H", data, at + 18)
        out.append((tid, pos, flag))
        at += 4 + size
    return out


CUT = dict(chroms=[["chr1", 600_000], ["chr2", 400_000], ["chr3", 300_000],
                   ["chrE", 50_000]], window=200_000, translocations=2,
           proper_pair_depth=5)


def test_wgs_ctx_work_does_not_move_with_the_seed(bench, tmp_path):
    """``wgs4_ctx``'s layout cut to 1.35 Mb, at three seeds: other bytes,
    the same pairs, the BAM sorted with no mapped read on ``chrE``, and
    within ``ctx_reach`` of a CTX breakpoint the translocation reads
    alone, counted from the BAM itself."""
    import json
    with open(os.path.join(BENCH, "configs", "wgs4_ctx.json")) as fh:
        g = dict(json.load(fh)["generator"], **CUT)
    seen = []
    for seed in (1, 2147483901, 2 ** 31 + 77):
        d = tmp_path / str(seed)
        d.mkdir()
        sample = bench["bench_wgs_ctx"].build(g, seed, str(d))
        recs = bam_records(sample.files["bam"])
        assert len(recs) == 2 * sample.pairs
        assert recs == sorted(recs, key=lambda r: r[:2])
        assert not [r for r in recs if r[0] == 3 and not r[2] & 0x4]
        with open(sample.files["bd"]) as fh:
            ctx = [ln.split("\t") for ln in fh if "\tCTX\t" in ln]
        names = [c for c, _n in g["chroms"]]
        ends = [(names.index(c[0]), int(c[1])) for c in ctx] + \
            [(names.index(c[3]), int(c[4])) for c in ctx]
        near = collections.Counter(
            tid for tid, pos, flag in recs if not flag & 0x4 and any(
                tid == t and abs(pos - bp) <= g["ctx_reach"]
                for t, bp in ends))
        seen.append((sample.pairs, len(ctx), dict(near),
                     open(sample.files["bam"], "rb").read()))
    (pairs, calls, near, bam), *others = seen
    assert calls == 4 and near == {0: 32, 1: 32}
    for o in others:
        assert o[:3] == (pairs, calls, near) and o[3] != bam


def test_route_span_holds_its_k4_calls(tmp_path):
    """Under ``--profile`` the route is one span, ``search:
    cross-chromosome``, and the partner backend's K4 call is its child."""
    from pindel_tpu_torch.profiling import g_timer
    scene = SUITE_SCENES["bam_int_I"]
    built = scene.build(str(tmp_path))
    argv = bam_argv(scene, built, str(tmp_path / "profiled"))
    assert port_main(argv + ["--device", "cpu", "--profile"]) == 0
    spans = g_timer.spans()
    by_id = {s.id: s for s in spans}
    route = [s for s in spans if s.name == "search: cross-chromosome"]
    waits = [s for s in spans if s.name == "fused: bdwin wait"]
    assert route and waits
    assert all(by_id[s.parent].name == "search: cross-chromosome"
               for s in waits)
    assert g_timer.items()["search: cross-chromosome"] > 0
    assert g_xchrom.device == g_xchrom.reads > 0
