"""The port's reference-read coverage: the BAM reader hands a window's
reference reads over as arrays, one ``bam.RefReads`` a BAM entry, and
``Pipeline._update_ref_coverage`` counts them with a difference array.
Both are held to the JAX package's objects and slice loop, and the
per-sample coverage columns of a BAM run's reports to the JAX package's
reports byte for byte."""
import os
import sys
import types

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

from bamwriter import (FLAG_PAIRED, FLAG_READ2, FLAG_REVERSE,  # noqa: E402
                       BamRecord, write_bam)
from test_bam_channel import _pair, _scene_bam_and_text  # noqa: E402

from pindel_tpu.bam import BamReader as ReferenceReader  # noqa: E402
from pindel_tpu.bam import RefRead  # noqa: E402
from pindel_tpu.pipeline import Pipeline as ReferencePipeline  # noqa: E402
from pindel_tpu_torch.bam import BamReader, RefReads  # noqa: E402
from pindel_tpu_torch.pipeline import Pipeline  # noqa: E402
from pindel_tpu_torch.profiling import g_coverage  # noqa: E402
from pindel_tpu_torch.testing.scenes import reports  # noqa: E402

torch.set_num_threads(1)

START, END = 1_000, 6_000


def reads_of(tag, pos, length, seed=0):
    """One BAM entry's reference reads, as the port's reader gives them."""
    pos = np.asarray(pos, np.int64)
    mq = np.random.default_rng(seed).integers(0, 61, len(pos))
    return RefReads(tag, pos, mq.astype(np.int32),
                    np.asarray(length, np.int32))


def objects(parts):
    """The reads of ``parts`` as the JAX package's RefRead objects."""
    return [RefRead(int(p), int(q), int(n), part.tag) for part in parts
            for p, q, n in zip(part.pos, part.mq, part.length)]


def case_two_tags(rng):
    # two entries, their tags out of sorted order, reads all over the
    # window and past it
    return [reads_of(tag, rng.integers(START - 300, END + 100, n),
                     rng.integers(0, 150, n), seed)
            for seed, (tag, n) in enumerate([("S2", 700), ("S1", 900)])]


def case_shared_tag(rng):
    # two entries of one sample, as two BAMs of one tag: their counts add
    return [reads_of("S1", rng.integers(START, END - 150, n),
                     rng.integers(0, 150, n), seed)
            for seed, n in enumerate([400, 500])]


def case_straddling(rng):
    pos = [START - 1, START, START, END - 100, END - 99, END - 101, END - 50]
    return [reads_of("S1", pos, [100, 100, 2, 100, 100, 100, 60])]


def case_short(rng):
    pos = rng.integers(START, END - 3, 300)
    return [reads_of("S1", pos, np.resize([1, 2, 3], 300)),
            reads_of("S2", pos[::-1], np.resize([3, 2, 1], 300), 1)]


def case_none(rng):
    return []


def case_at_end(rng):
    return [reads_of("S1", [END - 100], [100])]


CASES = {"two_tags_unsorted": case_two_tags, "shared_tag": case_shared_tag,
         "straddling": case_straddling,
         "lengths_1_2_3": case_short, "no_reads": case_none,
         "one_read_at_end": case_at_end}


def coverage(update, reads, samples):
    """What ``update`` leaves in ``state.ref_coverage`` over the window."""
    state = types.SimpleNamespace(ref_coverage=None,
                                  sorted_samples=lambda: sorted(samples))
    update(types.SimpleNamespace(state=state), reads,
           types.SimpleNamespace(current_start=START, current_end=END))
    return state.ref_coverage


@pytest.mark.parametrize("case", sorted(CASES))
def test_update_is_the_reference_slice_loop(case):
    """The difference array against the JAX package's slice a read, bit for
    bit, and the counter's reads and counted reads."""
    parts = CASES[case](np.random.default_rng(7))
    refs = objects(parts)
    g_coverage.reset()
    got = coverage(Pipeline._update_ref_coverage, parts, ["S2", "S1"])
    want = coverage(ReferencePipeline._update_ref_coverage, refs,
                    ["S2", "S1"])
    assert got.dtype == want.dtype == np.int32
    assert got.shape == want.shape == (END - START + 1, 2)
    assert np.array_equal(got, want)
    assert g_coverage.reads == len(refs)
    assert g_coverage.counted == sum(
        r.pos >= START and r.pos + r.read_length <= END
        and r.read_length > 2 for r in refs)
    if case == "two_tags_unsorted":
        assert got.any(axis=0).all()


@pytest.mark.parametrize("inside", [True, False], ids=["inside", "outside"])
def test_tag_missing_from_the_samples(inside):
    """A read of a tag the samples lack fails as the reference's lookup
    does when it lies inside the window, and is passed over outside it."""
    pos = START + 10 if inside else END - 10
    parts = [reads_of("S1", [START + 5], [100]), reads_of("S9", [pos], [100])]
    refs = objects(parts)
    if inside:
        for update, arg in ((Pipeline._update_ref_coverage, parts),
                            (ReferencePipeline._update_ref_coverage, refs)):
            with pytest.raises(KeyError, match="S9"):
                coverage(update, arg, ["S1"])
    else:
        assert np.array_equal(
            coverage(Pipeline._update_ref_coverage, parts, ["S1"]),
            coverage(ReferencePipeline._update_ref_coverage, refs, ["S1"]))


def coverage_scene(tmp_path):
    """The seed-4 scene's pairs of ``test_bam_channel`` plus clean proper
    pairs tiling the genome, in one coordinate-sorted BAM: (directory,
    fasta, pindel-text file of the scene's reads, bam config of the BAM),
    as ``test_bam_ref_coverage_columns`` builds it."""
    d, fa, _bam, txt, _cfg = _scene_bam_and_text(tmp_path, seed=4)
    from pindel_tpu.testing.simulate import standard_scene
    ref, _, _ = standard_scene(seed=4, chrom_len=60_000,
                               kinds=["DEL", "SI", "DEL", "DI", "INV",
                                      "TD"],
                               reads_per_event=8, n_noise=6)
    recs = []
    lines = open(txt).read().splitlines()
    for i in range(0, len(lines), 3):
        name, seq, meta = lines[i], lines[i + 1], lines[i + 2].split()
        dstr, pos, mq = meta[0], int(meta[2]), int(meta[3])
        anchor_pos = pos if dstr == "+" else pos - 100
        recs.extend(_pair(name[1:-2], anchor_pos, seq, ref,
                          anchor_reverse=(dstr == "-"), mapq=mq))
    for start in range(0, 59_600, 200):
        recs.append(BamRecord(
            f"pp{start}", FLAG_PAIRED, 0, start, 60, [(100, "M")],
            0, start + 300, 400, ref[start:start + 100], tags={"NM": 0}))
        recs.append(BamRecord(
            f"pp{start}", FLAG_PAIRED | FLAG_REVERSE | FLAG_READ2,
            0, start + 300, 60, [(100, "M")], 0, start, -400,
            ref[start + 300:start + 400], tags={"NM": 0}))
    bam = os.path.join(d, "cov.bam")
    write_bam(bam, [("chrT", len(ref))], sorted(recs, key=lambda r: r.pos))
    cfg = os.path.join(d, "cov.cfg")
    with open(cfg, "w") as fh:
        fh.write(f"{bam}\t500\tS1\n")
    return d, fa, txt, cfg


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return coverage_scene(tmp_path_factory.mktemp("coverage"))


def test_collect_sr_arrays_are_the_reference_objects(scene):
    """The reader's arrays against the JAX package's RefRead list field by
    field, window by window; arrays taken from one call stay as they were
    after the reader's next call."""
    _d, _fa, _txt, cfg = scene
    with open(cfg) as fh:
        bam = fh.read().split()[0]
    port, ref = BamReader(bam), ReferenceReader(bam)
    kept = []
    for start, end in [(0, 60_000), (0, 20_000), (20_000, 45_000),
                       (45_000, 60_000), (59_990, 60_000)]:
        _sr, got = port.collect_sr("chrT", start, end, 500, "S1", 60_000)
        _sr, want = ref.collect_sr("chrT", start, end, 500, "S1", 60_000)
        assert got.pos.dtype == np.int64 and got.length.dtype == np.int32
        assert [(r.pos, r.mq, r.read_length, r.tag) for r in got] == \
            [(r.pos, r.mq, r.read_length, r.tag) for r in want]
        kept.append((got, [a.copy() for a in (got.pos, got.mq,
                                               got.length)]))
    assert len(kept[0][0]) > 400
    for got, copies in kept:
        for a, b in zip((got.pos, got.mq, got.length), copies):
            assert np.array_equal(a, b)


def test_cli_coverage_columns_are_the_jax_packages(scene):
    """The port's CLI (fused, on the CPU) over the BAM writes real coverage
    numbers in the sample columns and the JAX package's reports byte for
    byte; the counter saw the BAM's reference reads, and none on
    pindel-text input."""
    from pindel_tpu.__main__ import main as reference_main
    from pindel_tpu_torch.__main__ import main as port_main
    d, fa, txt, cfg = scene
    port, jax = os.path.join(d, "port"), os.path.join(d, "jax")
    assert port_main(["-f", fa, "-i", cfg, "-o", port, "--backend",
                      "fused", "--device", "cpu"]) == 0
    reads, counted = g_coverage.reads, g_coverage.counted
    assert reference_main(["-f", fa, "-i", cfg, "-o", jax, "--backend",
                           "fused"]) == 0
    got, want = reports(port), reports(jax)
    assert got == want and got["D"]
    columns = [line.split("\tS1 ")[1].split()[:2]
               for line in got["D"].decode().splitlines()
               if "\tS1 " in line]
    assert columns and any(int(c) > 0 for col in columns for c in col)
    assert 0 < counted <= reads
    assert port_main(["-f", fa, "-p", txt, "-o", os.path.join(d, "text"),
                      "--device", "cpu"]) == 0
    assert (g_coverage.reads, g_coverage.counted) == (0, 0)
