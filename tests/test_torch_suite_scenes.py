"""The reference suite's scenes that no other port scene covers
(``testing/scenes.py:SUITE_SCENES``), on the CPU: the interchromosomal
scene of tests/test_interchromosomal.py with and without ``-I``, the
region scenes of tests/test_regions.py (``-c`` with coordinates and
without, ``-j``, ``-J``, ``-j`` with ``-J``), the TD depth-filter scene of
tests/test_depth_filter.py at ``-x 4`` with and without ``-N``, and the
flag-token scenes of tests/test_cli_flags.py.  Each runs through the
port's CLI on the backends ``SUITE_BACKENDS`` names, and every report file
must equal the golden files (``testing/golden_reports.json``, which
chip_smoke.py holds the card to); a second test holds the golden files
to a fresh ``python -m pindel_tpu --backend numpy`` run, so a stale file
cannot pass.  The last test reads a BAM of three chromosomes, one of them
without records, through the port's streamed reader, its whole-file
reader and the JAX package's reader
(tests/test_bam_streaming.py::test_streamed_multi_chromosome)."""
import os

import numpy as np
import pytest
import torch

from pindel_tpu.__main__ import main as reference_main
from pindel_tpu_torch.__main__ import main as port_main
from pindel_tpu_torch.ops import engine_fused
from pindel_tpu_torch.profiling import g_xchrom
from pindel_tpu_torch.testing.bamwriter import pair, write_bam
from pindel_tpu_torch.testing.scenes import (SUITE_BACKENDS, SUITE_SCENES,
                                             bam_argv, load_golden,
                                             on_reference, reports)
from pindel_tpu_torch.testing.simulate import random_seq

# one intra-op thread: the test workers share the machine's cores, and
# torch's per-op thread pool oversubscribes them (the scan is many small ops)
torch.set_num_threads(1)

CASES = [(name, backend) for name, backends in SUITE_BACKENDS.items()
         for backend in backends]


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """name -> the scene's built inputs, each in a directory of its own."""
    out = {}
    for name, scene in SUITE_SCENES.items():
        out[name] = scene.build(str(tmp_path_factory.mktemp(name)))
    return out


def scene_checks(name: str, got) -> None:
    """What each scene is there to show, on its reports."""
    if name == "bam_int_I":
        assert b"Anchor + chrA" in got["INT"] and b"chrB" in got["INT"]
        assert b"chrA" in got["INT_final"] and b"chrB" in got["INT_final"]
    elif name == "bam_int":
        assert got.get("INT", b"") == b"" and got["INT_final"] == b""
    elif name == "depth_td":
        assert b"\tTD " in got["TD"]            # the TD is called ...
    elif name == "depth_td_N":
        assert b"\tTD " not in got["TD"]        # ... and -N filters it out
    elif name == "flags_r_false_t_0":
        assert got["INV"] == b"" and got["TD"] == b""
    elif name == "flags_r_yes_t_true":
        assert got["INV"] != b""
    elif name.startswith("regions_"):
        assert b"ChrID" in got["D"]


@pytest.mark.parametrize("name,backend", CASES)
def test_suite_scene_matches_golden(tmp_path, built, name, backend):
    """The port's reports equal the golden files, byte for byte."""
    want = load_golden()[name]
    prefix = str(tmp_path / "port")
    engine_fused.FAR_WIN_ROWS = 0
    assert port_main(bam_argv(SUITE_SCENES[name], built[name], prefix)
                     + ["--backend", backend, "--device", "cpu"]) == 0
    got = reports(prefix)
    assert set(got) == set(want)
    for suffix, data in want.items():
        assert got[suffix] == data, f"_{suffix} differs"
    scene_checks(name, got)
    if name.startswith("bam_int"):
        # the call's windows lie on the other chromosome: the fused
        # backend searches its reads with _far_win_kernel on that
        # chromosome's partner backend; mesh and jax send them to the
        # oracle, and numpy searches everything there
        if backend == "fused":
            assert engine_fused.FAR_WIN_ROWS > 0
            assert g_xchrom.device == g_xchrom.reads > 0
            assert g_xchrom.oracle == 0
        else:
            assert engine_fused.FAR_WIN_ROWS == 0
            assert g_xchrom.device == 0
            assert g_xchrom.oracle == g_xchrom.reads
            assert (g_xchrom.reads > 0) == (backend != "numpy")


@pytest.mark.parametrize("name", list(SUITE_SCENES))
def test_golden_equals_fresh_reference(tmp_path, built, name):
    """``python -m pindel_tpu --backend numpy`` writes the golden files."""
    prefix = str(tmp_path / "numpy")
    assert reference_main(bam_argv(SUITE_SCENES[name], built[name], prefix)
                          + ["--backend", "numpy"]) == 0
    assert reports(prefix) == load_golden()[name], (
        "golden_reports.json is stale: rewrite it with PYTHONPATH=. "
        "python tests/test_torch_pipeline.py --write-golden")


def collect(reader, chrom: str, length: int, windows):
    """Every window's split reads, reference reads and RP pairs."""
    sr, rr, rp = [], [], []
    for s, e in windows:
        a, b = reader.collect_sr(chrom, s, e, 500, "S1", length,
                                 min_anchor_quality=0, nm=2,
                                 max_mismatch_rate=0.02)
        sr.append([(r.name, r.seq, r.matched_d, r.matched_rel_pos, r.ms)
                   for r in a])
        rr.append([(x.pos, x.read_length) for x in b])
        c, _inter = reader.collect_rp(chrom, s, e, 500, "S1",
                                      min_anchor_quality=0)
        rp.append([(x.pos_a, x.pos_b, x.da, x.db) for x in c])
    return sr, rr, rp


def test_streamed_multi_chromosome(tmp_path):
    """Across tid boundaries (``chrB`` has no record) and back to an
    earlier chromosome, the port's streamed reader equals its whole-file
    reader and the JAX package's streamed reader, window by window."""
    from pindel_tpu.bam import BamReader as ReferenceReader
    from pindel_tpu_torch.bam import BamReader
    rng = np.random.default_rng(5)
    refs = {"chrA": random_seq(rng, 40_000), "chrC": random_seq(rng, 30_000)}
    names = ["chrA", "chrB", "chrC"]
    lens = {"chrA": 40_000, "chrB": 5_000, "chrC": 30_000}
    recs = []
    for tid, name in enumerate(names):
        if name not in refs:
            continue
        ref = refs[name]
        for k in range(60):
            pos = 500 + k * ((len(ref) - 1200) // 60)
            recs.extend(on_reference(tid, pair(
                f"r{name}{k}", pos, ref[pos + 150:pos + 250], ref)))
    bam = str(tmp_path / "multi.bam")
    write_bam(bam, [(n, lens[n]) for n in names], recs)
    whole = BamReader(bam, streamed=False)
    stream = BamReader(bam, streamed=True)
    reference = ReferenceReader(bam, streamed=True)
    assert stream.ref_names == reference.ref_names == names
    visits = [(name, s) for name in names
              for s in range(0, lens[name], 8_000)] + [("chrA", 0)]
    for name, s in visits:
        window = [(s, min(s + 8_000, lens[name]))]
        got = collect(stream, name, lens[name], window)
        assert got == collect(whole, name, lens[name], window), (name, s)
        assert got == collect(reference, name, lens[name], window), (name, s)
        if name == "chrB":
            assert got == ([[]], [[]], [[]])
        else:
            assert got[0][0] or got[1][0]
