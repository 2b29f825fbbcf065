"""Scene 3 (``testing/scenes.py:build_scene3``, the shape of the reference
pindel's ``colousingbd15`` run: BAM pairs with BreakDancer calls over
three windows) on the CPU, cut to 600 kb at ``-w 0.2`` (three windows, two
boundary events each, at the full scene's density): the port's reports
byte-identical to the JAX package's ``fused`` backend, ``build_scene3``'s
plan, and the bench's gate on a wrong scene-3 digest.  The full scene's
reference digests (``testing/scene3_digests.json``) are checked by a slow
test and rewritten with ``PYTHONPATH=. python tests/test_torch_scene3.py
--write-scene3-digests`` (``python -m pindel_tpu --backend numpy``)."""
import dataclasses
import json
import os
import sys

import pytest
import torch

from pindel_tpu.__main__ import main as reference_main
from pindel_tpu_torch import bench
from pindel_tpu_torch.testing import scenes
from pindel_tpu_torch.testing.scenes import SCENE2, SCENE3, bam_argv

# one intra-op thread: the test workers share the machine's cores, and
# torch's per-op thread pool oversubscribes them (the scan is many small ops)
torch.set_num_threads(1)

SCENE3_COMMAND = ("PYTHONPATH=. python tests/test_torch_scene3.py "
                  "--write-scene3-digests")
CUT_LEN = 600_000
CUT_FLAGS = ["-w", "0.2"]
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def one_thread_workers(monkeypatch):
    """Worker processes inherit the environment: one torch thread each."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def cut_scene(paths, want):
    """The bench's scene 3 on the cut scene's ``paths``, at ``-w 0.2``."""
    scene = bench.bam_scene("scene3", paths, int(paths["pairs"]), want,
                            windows=3)
    return dataclasses.replace(
        scene, argv_of=lambda prefix, base=scene.argv_of:
        base(prefix) + CUT_FLAGS)


def reference_reports(argv, backend: str = "fused"):
    """``python -m pindel_tpu <argv> --backend <backend>``'s reports."""
    assert reference_main(argv + ["--backend", backend]) == 0
    return scenes.reports(argv[argv.index("-o") + 1])


@pytest.fixture(scope="module")
def cut(tmp_path_factory):
    """The cut scene, the JAX package's fused reports on it, and one run
    of it through the port's bench (the port's CLI on the CPU)."""
    d = str(tmp_path_factory.mktemp("scene3_cut"))
    paths = scenes.build_scene3(d, chrom_len=CUT_LEN)
    want = reference_reports(bam_argv(SCENE3, paths, os.path.join(d, "jax"))
                             + CUT_FLAGS)
    scene = cut_scene(paths, scenes.digests(want))
    port = bench.run(scene, os.path.join(d, "port"), CPU)
    return dict(d=d, paths=paths, want=want, scene=scene, port=port,
                got=scenes.reports(os.path.join(d, "port")))


def test_port_matches_jax_fused(cut):
    """The port's reports on the cut scene equal the JAX package's, and
    the run spans three windows with evidence windows through K4."""
    assert cut["got"] == cut["want"]
    assert cut["want"]["D"] and cut["want"]["INV"] and cut["want"]["RP"]
    c = cut["port"]["counters"]
    # the window loop also visits the empty window at the chromosome's end
    # (LoopingSearchWindow.finished), as the reference's does
    assert (c["windows"], c["windows_visited"]) == (3, 4)
    assert [(w["start"], w["end"]) for w in c["by_window"]] == [
        (0, 200_000), (200_000, 400_000), (400_000, 600_000),
        (600_000, 600_000)]
    assert all(w["reads"] for w in c["by_window"][:3])
    assert all(w["read_s"] <= w["staged_s"] <= w["done_s"]
               for w in c["by_window"])
    assert c["far_win_rows"] > 0 and c["legacy_rows"] == 0
    assert cut["port"]["fallback"] <= bench.MAX_FALLBACK
    assert not bench.problems(cut["scene"], [cut["port"]], kernel=False)


def test_boundary_events_reported(cut):
    """The deletions planted 2 kb before each window boundary, 4 kb long,
    are in the port's _D report across the boundary."""
    starts = [int(line.split("\tBP ")[1].split("\t")[0])
              for line in cut["got"]["D"].decode().splitlines()
              if f"\tD {scenes.SCENE3_BOUNDARY_SIZE}\t" in line]
    for b in (200_000, 400_000):
        assert any(abs(x - (b - 2_000)) <= 5 for x in starts), (b, starts)


def test_build_scene3_plan(tmp_path):
    """``build_scene3`` is deterministic for its seed and gives the planned
    shape: one event per 20 kb, two at each window boundary starting 2 kb
    before it, discordant pairs for every DEL of 1 kb and more, one
    BreakDancer line per event."""
    a, b = tmp_path / "a", tmp_path / "b"
    a.mkdir()
    b.mkdir()
    pa = scenes.build_scene3(str(a), chrom_len=CUT_LEN)
    pb = scenes.build_scene3(str(b), chrom_len=CUT_LEN)
    for name in ("ref.fa", "scene3.bd", "scene3.bam", "scene3_reads.txt"):
        assert (a / name).read_bytes() == (b / name).read_bytes()
    assert {k: pa[k] for k in ("pairs", "events", "discordant")} == \
        {k: pb[k] for k in ("pairs", "events", "discordant")}
    with open(pa["bd"]) as fh:
        lines = [ln.split("\t") for ln in fh.read().splitlines()[1:]]
    assert len(lines) == int(pa["events"]) == CUT_LEN // 20_000
    starts = [int(ln[1]) for ln in lines]
    assert starts == sorted(starts) and starts[0] == 50_000
    for b_ in (CUT_LEN // 3, 2 * CUT_LEN // 3):
        at = [ln for ln in lines if int(ln[1]) == b_ - 2_000]
        assert [ln[6] for ln in at] == ["DEL", "INV"]
        assert all(int(ln[4]) > b_ for ln in at)     # spans the boundary
    big_dels = sum(ln[6] == "DEL" and int(ln[7]) >= 1_000 for ln in lines)
    assert big_dels >= 2 and int(pa["discordant"]) == 8 * big_dels
    # 40 split reads an event and 4 noise pairs a kb, less the reads
    # text_to_bam drops at the chromosome's ends, and the discordant pairs
    split_and_noise = int(pa["pairs"]) - int(pa["discordant"])
    assert 0.98 * (40 * len(lines) + 4 * CUT_LEN // 1000) <= \
        split_and_noise <= 40 * len(lines) + 4 * CUT_LEN // 1000


def test_bench_gate_fails_on_a_scene3_digest(cut, tmp_path, monkeypatch,
                                             capsys):
    """``python -m pindel_tpu_torch.bench --device cpu`` with the cut scene
    as scene 3 and one of its digests wrong exits 1 with ``"correct":
    false``; scenes 1 and 2 (small ones, with the JAX package's digests)
    pass their gates."""
    text_dir, bam_dir = tmp_path / "text", tmp_path / "bam"
    text_dir.mkdir()
    bam_dir.mkdir()
    fa, reads_txt, n = scenes.write_scene(str(text_dir), seed=0)
    want1 = reference_reports(["-f", fa, "-p", reads_txt,
                               *scenes.SCENE1_FLAGS,
                               "-o", str(text_dir / "ref")])
    paths2 = scenes.build_bigdel(str(bam_dir))
    want2 = reference_reports(bam_argv(SCENE2, paths2,
                                       str(bam_dir / "ref")))
    wrong = dict(cut["scene"].want, D="0" * 64)
    small = dict(
        scene1=bench.text_scene("scene1", fa, reads_txt, n,
                                scenes.digests(want1)),
        scene2=bench.bam_scene("scene2", paths2, int(paths2["pairs"]),
                               scenes.digests(want2)),
        scene3=cut_scene(cut["paths"], wrong))
    monkeypatch.setattr(bench, "SCENES", {
        key: (lambda d, key=key: small[key]) for key in small})
    assert bench.main(["--device", "cpu", "--runs", "1"]) == 1
    out = capsys.readouterr()
    line = json.loads(out.out.strip().splitlines()[-1])
    assert line["correct"] is False
    assert line["value"] == line["scene2_value"] == \
        line["scene3_value"] == 0.0
    assert line["scene3_pairs"] == int(cut["paths"]["pairs"])
    assert line["scene3_windows"] == 3
    assert set(line["launches"]) == {"scene1", "scene2", "scene3"}
    failed = [ln for ln in out.err.splitlines() if "GATE FAILED" in ln]
    assert failed and all("scene3" in ln and "['D']" in ln
                          for ln in failed)


def scene3_reports(d: str, backend: str):
    """The JAX package's reports on the full scene 3."""
    paths = SCENE3.build(d)
    return reference_reports(
        bam_argv(SCENE3, paths, os.path.join(d, backend)), backend)


@pytest.mark.slow
def test_scene3_reference_digests(tmp_path):
    """The committed digests are those of the reference's reports (the
    JAX package's fused backend on the CPU here, which writes the same
    reports as its NumPy backend in a fraction of the time)."""
    assert scenes.digests(scene3_reports(str(tmp_path), "fused")) == \
        scenes.load_digests(scenes.SCENE3_DIGESTS)


if __name__ == "__main__":
    if sys.argv[1:] != ["--write-scene3-digests"]:
        sys.exit(f"usage: {SCENE3_COMMAND}")
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        scenes.save_digests(scenes.SCENE3_DIGESTS,
                            scene3_reports(d, "numpy"), SCENE3_COMMAND)
