"""The plain reference (``refpindel``) writes the reports the JAX package
wrote, held as data: on the CPU for the repository's small scenes (the
text and BAM + BreakDancer scenes of ``golden_reports.json``, the cut scene
4's digests in ``scene4_digests.json``), built with the port's test
builders; on a card for scenes 1 and 3, the cells' own layouts at full
size, built with the benchmark's generators.  Its parts that restate the
port's native code are held to that code on the CPU."""
import hashlib
import json
import os

import pytest

from pindel_tpu_torch.testing import scenes
from refpindel import cli

GOLDEN = scenes.load_golden()
# discovery runs only: the reference has no -q, -z, -g or -N
BAM = {name: s for name, s in {**scenes.BAM_SCENES,
                               **scenes.SUITE_SCENES}.items()
       if not set(s.flags) & {"-q", "-z", "-g", "-N"}}


def run_reference(argv):
    assert cli.main(argv + ["--backend", "fused", "--device", "cpu"]) == 0


@pytest.mark.parametrize("name", list(scenes.SMALL_SCENES))
def test_text_scene(tmp_path, name):
    scene_kw, flags, _fields = scenes.SMALL_SCENES[name]
    fa, reads, _n = scenes.write_scene(str(tmp_path), **scene_kw)
    prefix = str(tmp_path / "ref")
    run_reference(["-f", fa, "-p", reads, "-s", *flags, "-o", prefix])
    assert scenes.reports(prefix) == GOLDEN[name]


@pytest.mark.parametrize("name", sorted(BAM))
def test_bam_scene(tmp_path, name):
    scene = BAM[name]
    paths = scene.build(str(tmp_path))
    prefix = str(tmp_path / "ref")
    run_reference(scenes.bam_argv(scene, paths, prefix))
    assert scenes.reports(prefix) == GOLDEN[name]


@pytest.fixture(scope="module")
def scene4_cut(tmp_path_factory):
    d = tmp_path_factory.mktemp("scene4")
    return str(d), scenes.build_scene4(str(d), cut=scenes.SCENE4_CUT)


@pytest.mark.parametrize("name", sorted(scenes.SCENE4_RUNS))
def test_scene4_cut(scene4_cut, name):
    d, paths = scene4_cut
    with open(scenes.SCENE4_DIGESTS) as fh:
        want = json.load(fh)["cut"][name]
    prefix = os.path.join(d, name)
    run_reference(scenes.bam_argv(scenes.SCENE4_RUNS[name], paths, prefix)
                  + ["-w", "0.2"])
    got = {k: hashlib.sha256(v).hexdigest()
           for k, v in scenes.reports(prefix).items()}
    assert got == want


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_numpy_packer_writes_the_ports_bytes(seed):
    """The reference's NumPy payload packer against the port's native one,
    on random reads (every base letter, either case, other bytes as N),
    padding rows and lengths up to ``lmax``."""
    import numpy as np

    from pindel_tpu_torch.ops import engine_fused as port
    from refpindel.ops import engine_fused as ref

    rng = np.random.default_rng(seed)
    lmax, nb, b = 128, 37, 40
    lens = rng.integers(1, lmax + 1, nb)
    letters = np.frombuffer(b"ACGTacgtNnRx", np.uint8)
    blob = bytes(letters[rng.integers(0, len(letters), int(lens.sum()))])
    offs = np.zeros(nb + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    meta = rng.integers(-2 ** 31, 2 ** 31, (b, 3)).astype(np.int32)
    off, ln = offs[:nb].copy(), lens.astype(np.int64)
    pairs = [
        (port._native_pack_close(blob, offs, nb, b, lmax, meta),
         ref._pack_close(blob, offs, nb, b, lmax, meta)),
        (port._native_pack_far(blob, offs, nb, b, lmax, meta),
         ref._pack_far(blob, offs, nb, b, lmax, meta)),
        (port._native_codes(blob, offs, nb, b, lmax),
         ref._codes(blob, offs, nb, b, lmax)),
        (port._native_pack_close_at(blob, off, ln, nb, b, lmax, meta),
         ref._pack_close_at(blob, off, ln, nb, b, lmax, meta)),
        (port._native_codes_at(blob, off, ln, nb, b, lmax),
         ref._codes_at(blob, off, ln, nb, b, lmax)),
    ]
    for want, got in pairs:
        assert got.dtype == want.dtype and got.shape == want.shape
        assert np.array_equal(got, want)


@pytest.mark.parametrize("final", [True, False])
def test_python_text_scan_is_the_ports(tmp_path, final):
    """The reference's Python record scanner against the port's native
    one, on a scene's reads with malformed meta lines, CRs, trailing
    non-alphanumerics and a cut last record mixed in."""
    import numpy as np

    from pindel_tpu_torch import textindex as port
    from refpindel import textindex as ref

    _fa, reads, _n = scenes.write_scene(str(tmp_path), seed=5)
    data = open(reads, "rb").read()
    data += (b"@odd/1\nACGTN..\r\n+\tchrT  17 60 500 S2 extra\n"
             b"@short/1\nACGT\n- chrT 12\n@bad/1\nAC\nx chrT 1 2 3 T\n"
             b"@neg/1\nACGT!\n-\tchrQ\t-5\t+3\t7\tS1\r\n@cut/1\nACG")
    a = port._pt_scan(data, final)
    b = ref._pt_scan(data, final)
    assert a[0] == b[0] and a[1] == b[1] and a[3:] == b[3:]
    for x, y in zip(a[2], b[2]):
        assert x.dtype == y.dtype and np.array_equal(x, y)


def reader_outputs(reader, chrom, start, end, biol_size):
    """What a window query gives, as plain values."""
    sr, ref = reader.collect_sr(chrom, start, end, 500, "S1", biol_size,
                                min_anchor_quality=0, nm=2,
                                max_mismatch_rate=0.02)
    same, inter = reader.collect_rp(chrom, start, end, 500, "S1",
                                    min_anchor_quality=0)
    return ([(r.name, r.frag_name, r.matched_d, r.matched_rel_pos, r.ms,
              r.insert_size, r.tag, r.seq) for r in sr],
            [(r.pos, r.mq, r.read_length, r.tag) for r in ref],
            [vars(r) for r in same], [vars(r) for r in inter])


@pytest.fixture(scope="module")
def bams(tmp_path_factory):
    """The bam_bd cell's layout at 300 kb with its proper pairs, and the
    cut scene 4 (four chromosomes, pairs across them)."""
    from gen import samples
    from small import small_cell
    d = tmp_path_factory.mktemp("bams")
    cell = small_cell("colo15_bam_bd.sample")
    deep = samples.build(cell.config["generator"], 4242, str(d))
    d4 = tmp_path_factory.mktemp("scene4_bam")
    s4 = scenes.build_scene4(str(d4), cut=scenes.SCENE4_CUT)
    with open(s4["cfg"]) as fh:
        bam4 = fh.read().split()[0]
    return [deep.files["bam"], bam4]


@pytest.mark.parametrize("which", [0, 1], ids=["bam_bd_deep", "scene4_cut"])
def test_numpy_bam_reader_gives_the_ports_reads(bams, which):
    """The reference's BAM reader (Python and NumPy) against the port's C++
    reader: split reads, reference reads and discordant pairs of every
    window of every chromosome, in order."""
    from pindel_tpu_torch.bam import BamReader as PortReader
    from refpindel.bam import BamReader
    mine, port = BamReader(bams[which]), PortReader(bams[which])
    assert mine.ref_names == port.ref_names
    n_sr = n_ref = n_rp = 0
    for name, length in zip(mine.ref_names, mine.ref_lens):
        step = max(length // 3, 1)
        for start in range(0, length, step):
            end = min(start + step, length)
            got = reader_outputs(mine, name, start, end, length)
            want = reader_outputs(port, name, start, end, length)
            assert got == want, (name, start, end)
            n_sr += len(got[0])
            n_ref += len(got[1])
            n_rp += len(got[2]) + len(got[3])
    assert n_sr and n_ref and n_rp


# the cells' own layouts at full size: scene 1 (the text cell's generator
# at scene 1's sizes, seed 1234) and scene 3 (the bam_bd cell's layout
# without its proper pairs, seed 2009), against the digests of the reports
# that the JAX package's NumPy backend wrote for them
FULL = {
    "scene1": ("colo15_text", scenes.SCENE1["seed"],
               dict(chrom=scenes.SCENE1["chrom"],
                    chrom_len=scenes.SCENE1["chrom_len"],
                    events_per_kind=60, n_noise=scenes.SCENE1["n_noise"]),
               scenes.SCENE1_DIGESTS),
    "scene3": ("colo15_bam_bd", 2009, dict(proper_pair_depth=0),
               scenes.SCENE3_DIGESTS),
}


@pytest.mark.skipif(not __import__("torch").cuda.is_available(),
                    reason="the full-size scenes take the plain search's "
                           "compositions on a card; on a CPU they take "
                           "tens of minutes and gigabytes")
@pytest.mark.parametrize("name", sorted(FULL))
def test_full_size_scene_is_the_jax_packages(tmp_path, name):
    from gen import samples
    config, seed, sizes, digests = FULL[name]
    with open(os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "configs", config + ".json")) as fh:
        cfg = json.load(fh)
    g = dict(cfg["generator"], **sizes)
    sample = samples.build(g, seed, str(tmp_path))
    prefix = str(tmp_path / "ref")
    flags = [f for f in cfg["flags"] if f not in ("--backend", "fused")]
    assert cli.main(sample.argv + flags + ["-o", prefix, "--backend",
                                           "fused", "--device",
                                           "cuda"]) == 0
    got = {k: hashlib.sha256(v).hexdigest()
           for k, v in scenes.reports(prefix).items()}
    with open(digests) as fh:
        want = json.load(fh)["reports"]
    assert got == want


@pytest.mark.parametrize("seed", [4242, 2 ** 31 + 99])
@pytest.mark.parametrize("workload", ["colo15_bam_bd.sample",
                                      "colo15_text.sample"])
def test_cells_cut_are_the_jax_packages(tmp_path, workload, seed):
    """The cells' own layouts, the BAM one with its 30x of proper pairs,
    cut to the tests' size: the reference's reports are those the JAX
    package's fused backend writes on the CPU, byte for byte."""
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    pytest.importorskip("jax")
    from pindel_tpu.__main__ import main as jax_main

    import judge
    from small import small_cell
    cell = small_cell(workload)
    sample = cell.generator.build(cell.config["generator"], seed,
                                  str(tmp_path))
    flags = [f for f in cell.config["flags"] if f not in ("--backend",
                                                         "fused")]
    run_reference(sample.argv + flags + ["-o", str(tmp_path / "ref")])
    assert jax_main(sample.argv + flags + ["-o", str(tmp_path / "jax"),
                                           "--backend", "fused"]) == 0
    verdict = judge.judge([str(tmp_path / "jax")], str(tmp_path / "ref"))
    assert verdict["reference_lines"] > 0
    assert judge.correct(verdict), verdict
