"""RP discovery on BAM input takes each window's discordant pairs at
read-in: ``Pipeline._window_reads_bam`` runs the native RP walk
(``BamReader.rp_pairs``) right after the split-read channel, while the
window is resident, and the window's RP step builds the ``RPRead`` lists
from those arrays (``BamReader.rp_reads``).  So a pass decodes each
window once (``profiling.g_bam``), on the deep pipeline and on the
one-deep path of a spool alike, and writes the same ``_RP`` bytes.

Scene 3 cut to 300 kb at ``-w 0.1``: three windows with discordant pairs
(the events at the window boundaries), and the loop's empty fourth window
at the contig's end, which the window cache serves."""
import os
import shutil
import sys
import threading

import pytest
import torch

from pindel_tpu_torch import pipeline
from pindel_tpu_torch.__main__ import main as port_main
from pindel_tpu_torch.bam import BamReader
from pindel_tpu_torch.parallel.multihost import WindowSpool
from pindel_tpu_torch.profiling import BamStats, g_bam, g_timer
from pindel_tpu_torch.testing import scenes
from pindel_tpu_torch.tools import measure

torch.set_num_threads(1)

LENGTH = 300_000
WINDOW = 100_000
WINDOWS = [(s, s + WINDOW) for s in range(0, LENGTH, WINDOW)]
FLAGS = ["-w", "0.1", "--device", "cpu", "--profile"]


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """The cut scene, and a second BAM configuration that names a copy of
    its BAM as a second sample, so that ``-T`` reads the two entries on
    its pool."""
    d = str(tmp_path_factory.mktemp("rp_intake"))
    paths = scenes.build_scene3(d, chrom_len=LENGTH)
    with open(paths["cfg"]) as fh:
        bam, insert, _tag = fh.read().split()
    copy = os.path.join(d, "scene3_copy.bam")
    shutil.copy(bam, copy)
    two = os.path.join(d, "two.cfg")
    with open(two, "w") as fh:
        fh.write(f"{bam}\t{insert}\tS1\n{copy}\t{insert}\tS2\n")
    return dict(d=d, paths=paths, bam=bam, insert=int(insert),
                cfgs={1: paths["cfg"], 2: two})


def run_pass(scene, entries: int, one_deep: bool, monkeypatch):
    """One CLI pass over the scene with ``entries`` BAM entries, on the
    one-deep path of a one-rank spool where ``one_deep``: (its reports,
    the windows it read in, g_bam's loads, records and file records, its
    spans)."""
    d = scene["d"]
    name = f"e{entries}_{'one' if one_deep else 'deep'}"
    if one_deep:
        real = pipeline._run_pass
        spool_dir = os.path.join(d, "spool_" + name)
        os.makedirs(spool_dir)
        monkeypatch.setattr(pipeline, "_run_pass", lambda *a: real(
            *a[:-1], WindowSpool(spool_dir, 0, 1)))
    paths = dict(scene["paths"], cfg=scene["cfgs"][entries])
    prefix = os.path.join(d, name)
    argv = scenes.bam_argv(scenes.SCENE3, paths, prefix) + FLAGS
    with measure.window_log() as windows:
        assert port_main(argv) == 0
    monkeypatch.undo()
    return dict(reports=scenes.reports(prefix), windows=windows,
                g_bam=(g_bam.loads, g_bam.records, g_bam.file_records),
                spans=g_timer.spans())


@pytest.fixture(scope="module")
def passes(scene):
    mp = pytest.MonkeyPatch()
    return {(entries, one_deep): run_pass(scene, entries, one_deep, mp)
            for entries in (1, 2) for one_deep in (False, True)}


@pytest.mark.parametrize("window", range(len(WINDOWS)))
def test_read_in_pairs_build_collect_rps_lists(scene, window):
    """The RP lists built from the pairs taken after the window's
    split-read read-in equal those of ``collect_rp`` alone on a fresh
    reader, element for element and in order; the walk decodes nothing
    again."""
    start, end = WINDOWS[window]
    insert = scene["insert"]
    reader = BamReader(scene["bam"])
    for s, e in WINDOWS[:window + 1]:
        reader.collect_sr("chr20", s, e, insert, "S1", LENGTH)
    loads = g_bam.loads
    pairs = reader.rp_pairs("chr20", start, end, insert)
    assert g_bam.loads == loads
    same, inter = reader.rp_reads("chr20", insert, "S1", pairs)
    alone = BamReader(scene["bam"]).collect_rp("chr20", start, end, insert,
                                               "S1")
    assert len(pairs) == len(same) + len(inter) > 0
    assert (same, inter) == alone
    assert all(r.pos_a <= r.pos_b for r in same)


@pytest.mark.parametrize("entries", [1, 2])
def test_deep_pass_decodes_each_window_once(passes, entries):
    """A deep-pipeline pass loads each window of each BAM once: as many
    loads as windows with a range, the last, empty one served by the
    cache, and about the files' records."""
    got = passes[(entries, False)]
    ranged = [w for w in got["windows"] if w["end"] > w["start"]]
    assert len(ranged) == len(WINDOWS) < len(got["windows"])
    loads, records, file_records = got["g_bam"]
    assert loads == entries * len(ranged)
    assert file_records <= records <= 1.05 * file_records
    assert got["reports"]["RP"]


@pytest.mark.parametrize("entries", [1, 2])
def test_one_deep_path_writes_the_same_rp(passes, entries):
    """The one-deep path of a spool reads the same windows with the same
    loads and writes the same ``_RP`` bytes, and every other report."""
    deep, one = passes[(entries, False)], passes[(entries, True)]
    assert one["g_bam"] == deep["g_bam"]
    assert one["reports"]["RP"] == deep["reports"]["RP"]
    assert one["reports"] == deep["reports"]


@pytest.mark.parametrize("one_deep", [False, True])
@pytest.mark.parametrize("entries", [1, 2])
def test_rp_walk_is_timed_under_read_in(passes, entries, one_deep):
    """``intake: bam rp`` runs under "Reading in reads", once a window and
    BAM entry; ``bd: rp discovery`` holds no BAM query."""
    spans = passes[(entries, one_deep)]["spans"]
    by_id = {s.id: s for s in spans}

    def ancestors(s):
        while s.parent:
            s = by_id[s.parent]
            yield s.name

    walks = [s for s in spans if s.name == "intake: bam rp"]
    windows = len(passes[(entries, one_deep)]["windows"])
    assert len(walks) == entries * windows
    assert all("Reading in reads" in ancestors(s) for s in walks)
    under_rp = [s for s in spans if "bd: rp discovery" in ancestors(s)]
    assert not [s for s in under_rp if s.name.startswith("intake: ")]
    assert [s for s in spans if s.name == "bd: rp discovery"]


def test_bam_stats_count_from_pool_threads():
    """The ``-T`` pool's readers count loads from its threads: no update
    is lost."""
    stats = BamStats()
    threads, each = 16, 2_000
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=lambda: [
            stats.loaded(3) for _ in range(each)]) for _ in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(interval)
    assert (stats.loads, stats.records) == (threads * each,
                                            3 * threads * each)
