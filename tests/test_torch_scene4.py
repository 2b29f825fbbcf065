"""Scene 4 (``testing/scenes.py:build_scene4``: one BAM over four
chromosomes, one of them without reads, with interchromosomal
BreakDancer calls) on the CPU, cut to 540 kb at ``-w 0.2``
(``SCENE4_CUT``): the port's fused backend through ``scenes.run_scene`` on
the three runs (``-c ALL -I``, the BED regions of ``-j``/``-J``, one ``-c``
region) against the reference's digests of the cut scene, each region's
backend freed before the next one's window loop, ``build_scene4``'s plan
and the gate (``scenes.problems``) on a wrong scene-4 digest.  The reference digests of the
full and the cut scene (``testing/scene4_digests.json``) are written by
``PYTHONPATH=. python tests/test_torch_scene4.py --write-scene4-digests``
(``python -m pindel_tpu --backend numpy``); slow tests check the full
scene's with the JAX package's fused backend and the cut scene's with its
numpy one, and tests/test_torch_scene4_backends.py the cut scene's with
its fused one.  The port's other backends and ``--hosts 2`` on the cut
scene are in tests/test_torch_scene4_{backends,jax,numpy,hosts}.py, each
under two minutes on the CPU alone."""
import dataclasses
import json
import os
import sys

import pytest
import torch

from pindel_tpu_torch.bam import BamReader
from pindel_tpu_torch.regions import Fai, SearchRegion, build_include_bed
from pindel_tpu_torch.testing import scenes
from pindel_tpu_torch.testing.scenes import SCENE4_RUNS, bam_argv
from pindel_tpu_torch.tools import measure

# one intra-op thread: the test workers share the machine's cores, and
# torch's per-op thread pool oversubscribes them (the scan is many small ops)
torch.set_num_threads(1)

SCENE4_COMMAND = ("PYTHONPATH=. python tests/test_torch_scene4.py "
                  "--write-scene4-digests")
CUT_FLAGS = ["-w", "0.2"]
CPU = torch.device("cpu")
# the cut scene's windows over bases, and its BED regions, by run
CUT_WINDOWS = {"scene4": 5, "scene4_bed": 3, "scene4_c": 1}
CUT_REGIONS = {"scene4": ["chr1", "chr2", "chr3", "chrE"],
               "scene4_bed": ["chr1", "chr1", "chr3"],
               "scene4_c": ["chr2"]}


def reference_reports(argv, backend: str):
    """``python -m pindel_tpu <argv> --backend <backend>``'s reports."""
    from pindel_tpu.__main__ import main as reference_main
    assert reference_main(argv + ["--backend", backend]) == 0
    return scenes.reports(argv[argv.index("-o") + 1])


def reference_digests(d: str, backend: str, cut: int = 1):
    """run name -> the digests of the JAX package's reports on scene 4
    (the cut scene at -w 0.2 with ``cut``), each run under a prefix of its
    own (``_INT`` is appended to, never truncated, as the reference's
    is)."""
    paths = scenes.build_scene4(d, cut=cut)
    flags = CUT_FLAGS if cut > 1 else []
    return {name: scenes.digests(reference_reports(
        bam_argv(spec, paths, os.path.join(d, f"{name}_{backend}")) + flags,
        backend)) for name, spec in SCENE4_RUNS.items()}


def cut_digests():
    """run name -> the reference's digests on the cut scene."""
    with open(scenes.SCENE4_DIGESTS) as fh:
        return json.load(fh)["cut"]


def cut_scene(name, paths, want):
    """The ``scenes.Scene`` of run ``name`` of the cut scene, at -w 0.2;
    the run with -I is held to the bound on the route's reads."""
    scene = scenes.bam_scene(
        name, paths, int(paths["pairs"]), want, windows=CUT_WINDOWS[name],
        spec=SCENE4_RUNS[name],
        oracle_reads=int(paths["ctx_reads"]) if name == "scene4" else None)
    return dataclasses.replace(
        scene, argv_of=lambda prefix, base=scene.argv_of:
        base(prefix) + CUT_FLAGS)


@pytest.fixture(scope="module")
def cut(tmp_path_factory):
    """The cut scene, and each run of it through ``scenes.run_scene`` on
    the CPU (fused), with its reports and its region log."""
    d = str(tmp_path_factory.mktemp("scene4_cut"))
    paths = scenes.build_scene4(d, cut=scenes.SCENE4_CUT)
    want = cut_digests()
    runs = {}
    for name in SCENE4_RUNS:
        scene = cut_scene(name, paths, want[name])
        prefix = os.path.join(d, name)
        with measure.region_log() as regions:
            run = scenes.run_scene(scene, prefix, CPU)
        runs[name] = dict(scene=scene, run=run, got=scenes.reports(prefix),
                          regions=regions)
    return dict(d=d, paths=paths, runs=runs)


@pytest.mark.parametrize("name", list(SCENE4_RUNS))
def test_port_matches_reference(cut, name):
    """The port's reports on each run equal the reference's, the gate
    passes, and the run spans its windows with evidence windows
    through K4; ``-I`` fills ``_INT`` from the reads the cross-chromosome
    route searched, all of them by K4 on a partner backend (none on the
    oracle), and without it ``_INT_final`` is written and empty."""
    r = cut["runs"][name]
    assert scenes.digests(r["got"]) == r["scene"].want
    assert not scenes.problems(r["scene"], [r["run"]], kernel=False)
    c = r["run"]["counters"]
    assert c["windows"] == CUT_WINDOWS[name]
    assert c["far_win_rows"] > 0
    assert r["run"]["fallback"] <= scenes.MAX_FALLBACK
    if name == "scene4":
        assert b"Anchor + chr1" in r["got"]["INT"]
        assert b"Anchor + chr2" in r["got"]["INT"]
        assert b"chr1\tpos" in r["got"]["INT_final"]
        assert 0 < c["oracle_reads"] <= int(cut["paths"]["ctx_reads"])
        assert c["xchrom_device"] == c["oracle_reads"]
        assert c["xchrom_oracle"] == 0
        # chrE's window is visited and reads nothing
        empty = [w["reads"] for w in c["by_window"]
                 if (w["start"], w["end"]) == (0, 20_000)]
        assert empty == [0]
    else:
        assert not r["got"].get("INT") and r["got"]["INT_final"] == b""


@pytest.mark.parametrize("name", list(SCENE4_RUNS))
def test_region_backends_freed(cut, name):
    """A backend per BED region, and none outlives its region: when a
    region's window loop starts, the earlier regions' backends (their
    chromosome on the device) are gone, and so are the partner backends
    they made for the cross-chromosome route (``-c ALL -I`` made some
    before its last region)."""
    rows = cut["runs"][name]["regions"]
    assert [r["chrom"] for r in rows] == CUT_REGIONS[name]
    assert [r["alive"] for r in rows] == [1] * len(rows)
    assert [r["states_alive"] for r in rows] == [1] * len(rows)
    assert all(r["state_bytes"] > 0 and r["allocated"] is None
               for r in rows)
    if name == "scene4":
        assert rows[-1]["states_made"] > len(rows)


def test_build_scene4_plan(tmp_path):
    """``build_scene4`` is deterministic for its seed and gives the planned
    shape: four references in the BAM's header, ``chrE`` without a
    record, local events at one per 20 kb of chr1-chr3 (their first 100
    kb kept clear) with a DEL and an INV starting 2 kb before chr1's
    window boundary, two translocations a pair with 16 reads and a CTX
    line each, and the BED run's regions: chr1 in two, chr3 whole."""
    a, b = tmp_path / "a", tmp_path / "b"
    a.mkdir()
    b.mkdir()
    pa = scenes.build_scene4(str(a), cut=scenes.SCENE4_CUT)
    pb = scenes.build_scene4(str(b), cut=scenes.SCENE4_CUT)
    for name in ("ref.fa", "scene4.bd", "scene4.bam", "include.bed",
                 "exclude.bed", "reads_chr1.txt"):
        assert (a / name).read_bytes() == (b / name).read_bytes()
    counts = ("pairs", "events", "discordant", "translocation_reads",
              "ctx_reads", "region")
    assert {k: pa[k] for k in counts} == {k: pb[k] for k in counts}
    lens = [n // scenes.SCENE4_CUT for _, n in scenes.SCENE4_CHROMS]
    reader = BamReader(str(a / "scene4.bam"), streamed=False)
    assert reader.ref_names == ["chr1", "chr2", "chr3", "chrE"]
    with open(pa["bd"]) as fh:
        lines = [ln.split("\t") for ln in fh.read().splitlines()[1:]]
    local = [ln for ln in lines if ln[6] != "CTX"]
    ctx = [ln for ln in lines if ln[6] == "CTX"]
    assert len(local) == int(pa["events"]) == sum(
        n // 20_000 // 5 * 5 for n in lens[:3])
    window = scenes.SCENE4_WINDOW // scenes.SCENE4_CUT
    at = [ln for ln in local if ln[0] == "chr1"
          and int(ln[1]) == window - 2_000]
    assert [ln[6] for ln in at] == ["DEL", "INV"]
    assert all(int(ln[4]) > window for ln in at)      # across the boundary
    assert [(ln[0], ln[3]) for ln in ctx] == \
        [("chr1", "chr2")] * 2 + [("chr2", "chr3")] * 2
    assert int(pa["translocation_reads"]) == 4 * 16
    # every translocation read, and the reads near either breakpoint
    assert int(pa["ctx_reads"]) > 4 * 16
    assert pa["region"] == f"chr2:{lens[1] // 4}-{lens[1] * 3 // 4}"
    fai = Fai.read(pa["fa"] + ".fai")
    assert fai.names == reader.ref_names and fai.sizes == lens
    regions = build_include_bed(SearchRegion.parse("ALL", fai), fai,
                                pa["bed_inc"], pa["bed_exc"])
    assert [r[0] for r in regions] == ["chr1", "chr1", "chr3"]
    assert tuple(regions[2][1:]) == (1, lens[2])
    for name, length in zip(reader.ref_names, lens):
        sr, rr = reader.collect_sr(name, 0, length, 500, "S1", length,
                                   min_anchor_quality=0, nm=2,
                                   max_mismatch_rate=0.02)
        assert bool(sr or rr) == (name != "chrE"), name


def test_bench_gate_fails_on_a_scene4_digest(cut, tmp_path):
    """The gate over a recorded run of the cut scene's ``-c ALL -I`` run
    with its ``_INT`` digest wrong fails on that report alone, and the run
    still counts the scene's pairs, its five windows, its K4 rows and the
    reads the cross-chromosome route took."""
    r = cut["runs"]["scene4"]
    wrong = dataclasses.replace(r["scene"],
                                want=dict(r["scene"].want, INT="0" * 64))
    run = scenes.run_scene(wrong, str(tmp_path / "wrong"), CPU)
    c = run["counters"]
    assert wrong.n == int(cut["paths"]["pairs"])
    assert wrong.unit == "read pairs"
    assert c["windows"] == 5 and c["far_win_rows"] > 0
    assert 0 < c["oracle_reads"] <= int(cut["paths"]["ctx_reads"])
    assert scenes.problems(wrong, [run], kernel=False) == [
        "scene4 run 0: reports differ from the reference's: ['INT']"]


@pytest.mark.slow
def test_scene4_reference_digests(tmp_path):
    """The committed digests of the full scene are those of the reference's
    reports (the JAX package's fused backend on the CPU here, which writes
    the same reports as its NumPy backend in a fraction of the time)."""
    assert reference_digests(str(tmp_path), "fused") == \
        scenes.load_digests(scenes.SCENE4_DIGESTS)


@pytest.mark.slow
def test_scene4_cut_digests_numpy(tmp_path):
    """The committed digests of the cut scene are a fresh run of the JAX
    package's numpy backend (tests/test_torch_scene4_backends.py holds
    them to its fused backend in the tier-1 run)."""
    assert reference_digests(str(tmp_path), "numpy", scenes.SCENE4_CUT) \
        == cut_digests()


if __name__ == "__main__":
    if sys.argv[1:] != ["--write-scene4-digests"]:
        sys.exit(f"usage: {SCENE4_COMMAND}")
    import tempfile
    with tempfile.TemporaryDirectory() as full, \
            tempfile.TemporaryDirectory() as cut_dir:
        data = dict(command=SCENE4_COMMAND,
                    reports=reference_digests(full, "numpy"),
                    cut=reference_digests(cut_dir, "numpy",
                                          scenes.SCENE4_CUT))
    with open(scenes.SCENE4_DIGESTS, "w") as fh:
        json.dump(data, fh, indent=1)
        fh.write("\n")
