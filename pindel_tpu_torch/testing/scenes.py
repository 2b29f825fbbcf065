"""The scenes the port is checked on, shared by the tests/test_torch_*.py
files and chip_smoke.py.

``SMALL_SCENES`` are simulated pindel-text scenes and ``BAM_SCENES``
simulated BAM scenes (BAM + BreakDancer discovery, ``-q``, ``-z``, ``-g``),
all small enough for the NumPy reference.  ``golden_reports.json`` holds,
for each of them, the report files that ``pindel_tpu``'s NumPy backend
writes with the scene's flags: the GPU machine has no jax, so the port's
reports are compared there with these bytes.  tests/test_torch_pipeline.py
and tests/test_torch_bam.py keep them equal to the JAX package's output;
``PYTHONPATH=. python tests/test_torch_pipeline.py --write-golden`` rewrites
them.  ``SCENE1`` and ``SCENE2`` are scenes 1 and 2 of bench.py, and
``SCENE3`` the port's scene 3 (three windows of BAM pairs with BreakDancer
calls, ``build_scene3``); their reference reports are too large for the
JSON, so ``scene1_digests.json``, ``scene2_digests.json`` and
``scene3_digests.json`` hold their sha256 (rewritten by ``PYTHONPATH=.
python tests/test_torch_bench.py --write-scene1-digests``, ``PYTHONPATH=.
python tests/test_torch_bam.py --write-scene2-digests`` and ``PYTHONPATH=.
python tests/test_torch_scene3.py --write-scene3-digests``).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Callable, Dict, List, Tuple

import numpy as np

from pindel_tpu_torch.testing.bamwriter import (FLAG_MREVERSE, FLAG_MUNMAP,
                                                FLAG_PAIRED, FLAG_READ1,
                                                FLAG_READ2, FLAG_REVERSE,
                                                FLAG_UNMAP, BamRecord,
                                                make_fai, pair, write_bam)
from pindel_tpu_torch.testing.simulate import (Event, SimReads, Simulator,
                                               random_seq, rc,
                                               standard_scene, write_fasta)

_HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(_HERE, "golden_reports.json")
SCENE1_DIGESTS = os.path.join(_HERE, "scene1_digests.json")
SCENE2_DIGESTS = os.path.join(_HERE, "scene2_digests.json")
SCENE3_DIGESTS = os.path.join(_HERE, "scene3_digests.json")

# name -> (standard_scene arguments, CLI flags besides -s, the same flags as
# Settings fields)
SMALL_SCENES = {
    "seed0": (dict(seed=0), [], {}),
    "seed1": (dict(seed=1), [], {}),
    "seed2": (dict(seed=2), [], {}),
    # the INV/TD-heavy and LI scenes of test_golden_vs_reference.py
    "seed10_inv_td": (dict(seed=10, chrom_len=80_000, reads_per_event=10,
                           kinds=["INV", "TD", "INV", "TD", "INV", "TD",
                                  "DI"]), [], {}),
    "seed11_inv_td": (dict(seed=11, chrom_len=80_000, reads_per_event=10,
                           kinds=["INV", "TD", "INV", "TD", "INV", "TD",
                                  "DI"]), [], {}),
    "seed20_li": (dict(seed=20, chrom_len=60_000, reads_per_event=10,
                       kinds=["LI", "DEL", "LI", "SI", "LI"]),
                  ["-l"], dict(analyze_li=True)),
    "seed21_li": (dict(seed=21, chrom_len=60_000, reads_per_event=10,
                       kinds=["LI", "DEL", "LI", "SI", "LI"]),
                  ["-l"], dict(analyze_li=True)),
    "seed0_only_close": (dict(seed=0), ["-S"],
                         dict(report_only_close_mapped_reads=True)),
}

# scene 1 of bench.py: 50,000 reads of 100 bp, insert 500, over a 6 Mb
# chromosome
SCENE1 = dict(seed=1234, chrom_len=6_000_000,
              kinds=["DEL", "SI", "DI", "INV", "TD"] * 60,
              reads_per_event=60, n_noise=32_000, chrom="chrB")
SCENE1_FLAGS = ["-l", "-k", "-s", "-T", "4"]


def write_scene(d: str, chrom: str = "chrT", **scene_kw):
    """Writes ``d/ref.fa`` and ``d/reads.txt``; returns their paths and the
    number of reads."""
    ref, _events, reads = standard_scene(chrom=chrom, **scene_kw)
    fa = os.path.join(d, "ref.fa")
    write_fasta(fa, [(chrom, ref)])
    reads_txt = os.path.join(d, "reads.txt")
    reads.write(reads_txt)
    return fa, reads_txt, len(reads.names)


# ------------------------------------------------------------ BAM scenes
def _write_ref(d: str, chrom: str, ref: str) -> str:
    fa = os.path.join(d, "ref.fa")
    write_fasta(fa, [(chrom, ref)])
    make_fai(fa)
    return fa


def _write_cfg(d: str, bam: str, insert_size: int = 500) -> str:
    cfg = os.path.join(d, "bam.cfg")
    with open(cfg, "w") as fh:
        fh.write(f"{bam}\t{insert_size}\tS1\n")
    return cfg


def text_to_bam(ref: str, chrom: str, txt: str, bam: str,
                extra=()) -> int:
    """Pindel-text reads -> a coordinate-sorted BAM of anchored pairs (the
    mapped anchor and the unmapped split mate), as bench.py's scene 2 and
    tests/test_breakdancer.py build it, plus the ``extra`` records; returns
    the number of pairs."""
    with open(txt) as fh:
        lines = fh.read().splitlines()
    recs = list(extra)
    for i in range(0, len(lines), 3):
        name, seq, meta = lines[i], lines[i + 1], lines[i + 2].split()
        dstr, pos, mq = meta[0], int(meta[2]), int(meta[3])
        anchor_pos = pos if dstr == "+" else pos - 100
        if anchor_pos < 0 or anchor_pos + 100 > len(ref):
            continue
        recs.extend(pair(name[1:-2], anchor_pos, seq, ref,
                         anchor_reverse=(dstr == "-"), mapq=mq))
    recs.sort(key=lambda r: r.pos)
    write_bam(bam, [(chrom, len(ref))], recs)
    return len(recs) // 2


def build_seed3(d: str) -> Dict[str, str]:
    """tests/test_bam_channel.py's scene (seed 3) as a BAM."""
    ref, _events, sim = standard_scene(
        seed=3, chrom_len=60_000,
        kinds=["DEL", "SI", "DEL", "DI", "INV", "TD"],
        reads_per_event=8, n_noise=6)
    txt = os.path.join(d, "reads.txt")
    sim.write(txt)
    bam = os.path.join(d, "reads.bam")
    text_to_bam(ref, "chrT", txt, bam)
    return dict(fa=_write_ref(d, "chrT", ref), cfg=_write_cfg(d, bam))


def _bigdel_reads(d: str) -> Tuple[str, str]:
    """tests/test_breakdancer.py's reads: a 6 kb deletion at 20 kb, beyond
    the -x 2 geometric far-end ladder, and a 100 bp one at 40 kb; returns
    the reference and the pindel-text file."""
    rng = np.random.default_rng(8)
    ref = random_seq(rng, 60_000)
    sim = Simulator(rng)
    out = SimReads([], [], [])
    for ev in (Event("DEL", "chrT", 20_000, size=6000),
               Event("DEL", "chrT", 40_000, size=100)):
        sim.reads_for_event(ref, "chrT", ev, 10, out)
    sim.ref_noise_reads(ref, "chrT", 6, out)
    txt = os.path.join(d, "reads.txt")
    out.write(txt)
    return ref, txt


def build_bigdel(d: str) -> Dict[str, str]:
    """tests/test_breakdancer.py's scene as a BAM, with the BreakDancer
    calls file naming both deletions (the 6 kb one is findable only
    through the calls' windows) and an SV list for -g; ``pairs`` is the
    number of read pairs."""
    ref, txt = _bigdel_reads(d)
    bam = os.path.join(d, "reads.bam")
    pairs = text_to_bam(ref, "chrT", txt, bam)
    bd = os.path.join(d, "calls.bd")
    with open(bd, "w") as fh:
        fh.write("#header line\n")
        fh.write("chrT\t20000\t20+20-\tchrT\t26000\t18+19-\tDEL\t6000\t99\n")
        # a malformed-looking but >=6-field numeric line is accepted
        fh.write("chrT\t39900\t5\tchrT\t40600\t6\n")
    svs = os.path.join(d, "svs.txt")
    with open(svs, "w") as fh:
        fh.write("DEL chrT 20000 50 chrT 26000 50\n"
                 "DEL chrT 40000 50 chrT 40100 50\n")
    return dict(fa=_write_ref(d, "chrT", ref), cfg=_write_cfg(d, bam),
                bd=bd, svs=svs, pairs=str(pairs))


def build_rp_bigdel(d: str) -> Dict[str, str]:
    """``build_bigdel``'s reads plus eight discordant pairs whose mates
    flank the 6 kb deletion (both mapped, 6.3-6.5 kb apart): RP discovery
    turns them into an evidence window, so the deletion is found without a
    BreakDancer file."""
    ref, txt = _bigdel_reads(d)
    rng = np.random.default_rng(1)
    extra = []
    for k in range(8):
        a = 19_700 + int(rng.integers(0, 200))
        b = 26_000 + int(rng.integers(0, 200))
        tlen = b + 100 - a
        extra += [
            BamRecord(f"rp{k}", FLAG_PAIRED | FLAG_READ1 | FLAG_MREVERSE, 0,
                      a, 60, [(100, "M")], 0, b, tlen, ref[a:a + 100],
                      tags={"NM": 0}),
            BamRecord(f"rp{k}", FLAG_PAIRED | FLAG_READ2 | FLAG_REVERSE, 0,
                      b, 60, [(100, "M")], 0, a, -tlen, ref[b:b + 100],
                      tags={"NM": 0})]
    bam = os.path.join(d, "reads.bam")
    text_to_bam(ref, "chrT", txt, bam, extra)
    return dict(fa=_write_ref(d, "chrT", ref), cfg=_write_cfg(d, bam))


def build_dd(d: str) -> Dict[str, str]:
    """tests/test_dd.py's scene: a 500 bp segment from 20 kb copied to
    5 kb, paired reads from the ALT haplotype (insert 300)."""
    p, length, donor = 5000, 500, 20000
    read, frag = 100, 300
    rng = np.random.default_rng(42)
    ref = "".join(rng.choice(list("ACGT"), size=40_000))
    alt = ref[:p] + ref[donor:donor + length] + ref[p:]

    def project(start):
        """ALT coordinate -> (ref pos, mapped) for a read-long read."""
        if start + read <= p:
            return start, True
        if start >= p and start + read <= p + length:
            return donor + (start - p), True
        if start >= p + length:
            return start - length, True
        return -1, False

    records = []
    for f in range(4500, 5500, 10):
        r1_seq = alt[f:f + read]
        r2_frag = alt[f + frag - read:f + frag]
        p1, m1 = project(f)
        p2, m2 = project(f + frag - read)
        if not m1 and not m2:
            continue
        name = f"dd_{f}"
        pos1 = p1 if m1 else p2
        pos2 = p2 if m2 else p1
        isize = 0
        if m1 and m2:
            isize = (max(p1, p2) + read) - min(p1, p2)
        f1 = FLAG_PAIRED | FLAG_READ1
        f2 = FLAG_PAIRED | FLAG_READ2
        if m2:
            f2 |= FLAG_REVERSE
            f1 |= FLAG_MREVERSE
        if not m1:
            f1 |= FLAG_UNMAP
            f2 |= FLAG_MUNMAP
        if not m2:
            f2 |= FLAG_UNMAP
            f1 |= FLAG_MUNMAP
        records.append(BamRecord(
            name, f1, 0, pos1, 60 if m1 else 0,
            [(read, "M")] if m1 else [], 0, pos2,
            isize if m1 and m2 and p1 <= p2 else -isize,
            r1_seq, tags={"NM": 0} if m1 else {}))
        # mapped reverse reads store the reference-forward sequence;
        # unmapped reads store the raw sequenced (RC) bases
        records.append(BamRecord(
            name, f2, 0, pos2, 60 if m2 else 0,
            [(read, "M")] if m2 else [], 0, pos1,
            -isize if m1 and m2 and p1 <= p2 else isize,
            r2_frag if m2 else rc(r2_frag),
            tags={"NM": 0} if m2 else {}))
    records.sort(key=lambda r: (r.tid, r.pos))
    bam = os.path.join(d, "dd.bam")
    write_bam(bam, [("chrT", len(ref))], records)
    return dict(fa=_write_ref(d, "chrT", ref), cfg=_write_cfg(d, bam, 300))


def build_assembly(d: str) -> Dict[str, str]:
    """tests/test_assembly.py's end-to-end scene: six staggered split
    reads across a 500 bp deletion at 20 kb, and the SV list naming it."""
    rng = np.random.default_rng(9)
    ref = random_seq(rng, 40_000)
    bp, size = 20_000, 500
    recs = []
    for k in range(6):
        flank = 30 + k * 8            # staggered: assembled span >= 130
        frag = ref[bp - flank: bp] + ref[bp + size: bp + size + 100 - flank]
        gap = 80 + k * 5
        anchor_pos = bp - flank - gap - 100
        recs.extend(pair(f"a{k}", anchor_pos, rc(frag), ref))
    recs.sort(key=lambda r: r.pos)
    bam = os.path.join(d, "reads.bam")
    write_bam(bam, [("chrT", len(ref))], recs)
    svs = os.path.join(d, "svs.txt")
    with open(svs, "w") as fh:
        fh.write(f"D chrT {bp} 30 chrT {bp + size} 30\n")
    return dict(fa=_write_ref(d, "chrT", ref), cfg=_write_cfg(d, bam),
                svs=svs)


@dataclasses.dataclass(frozen=True)
class BamScene:
    """A BAM scene: its build function (directory -> input paths), the CLI flags
    of its run besides -f/-i/-o (``{bd}``, ``{svs}`` and ``{prefix}`` in a
    flag stand for the built paths and the output prefix), and whether
    evidence windows (BreakDancer calls or RP discovery) must send reads
    through ``_far_win_kernel``."""

    build: Callable[[str], Dict[str, str]]
    flags: Tuple[str, ...]
    far_win: bool = False


BAM_SCENES = {
    # RP discovery on (-R is the default for BAM input)
    "bam_seed3": BamScene(build_seed3, ("-s",)),
    # 20 kb windows: RP -> BD state passes along three windows and more
    "bam_seed3_w002": BamScene(build_seed3, ("-s", "-w", "0.02")),
    "bam_bd_bigdel": BamScene(build_bigdel, ("-s", "-b", "{bd}", "-Q",
                                             "{prefix}_BDQ"), far_win=True),
    "bam_bd_bigdel_nobd": BamScene(build_bigdel, ("-s",)),
    # discordant pairs found by RP discovery guide the search; their
    # evidence spans two 20 kb windows
    "bam_rp_bigdel_w002": BamScene(build_rp_bigdel, ("-s", "-w", "0.02"),
                                   far_win=True),
    "dd_q": BamScene(build_dd, ("-q", "--MIN_DD_MAP_DISTANCE", "1000")),
    "assembly_z": BamScene(build_assembly, ("-z", "{svs}")),
    "genotype_g": BamScene(build_bigdel, ("-g", "{svs}")),
}


def bam_argv(scene: BamScene, paths: Dict[str, str],
             prefix: str) -> List[str]:
    """The CLI arguments of one run of ``scene`` (flags of both CLIs)."""
    fill = dict(paths, prefix=prefix)
    return (["-f", paths["fa"], "-i", paths["cfg"], "-o", prefix]
            + [f.format(**fill) for f in scene.flags])


# scene 2 of bench.py: BAM input with a BreakDancer calls file; 100 events
# (DEL/SI/DI/INV/TD) x 40 split reads + 8,000 noise pairs over 2 Mb
SCENE2_FLAGS = ("-b", "{bd}", "-s", "-T", "4")


def build_scene2(d: str) -> Dict[str, str]:
    """bench.py's ``build_scene2``: the simulated reads as anchored BAM
    pairs (insert 500) and a BreakDancer line per planted event."""
    rng = np.random.default_rng(4321)
    chrom_len, n_events = 2_000_000, 100
    ref = random_seq(rng, chrom_len)
    sim = Simulator(rng)
    out = SimReads([], [], [])
    kinds = ["DEL", "SI", "DI", "INV", "TD"] * (n_events // 5)
    step = (chrom_len - 100_000) // len(kinds)
    bd_lines = ["#chr1\tpos1\tori1\tchr2\tpos2\tori2\ttype\tsize\tscore"]
    for i, kind in enumerate(kinds):
        pos = 50_000 + i * step
        size = int(rng.integers(60, 2500)) if kind != "SI" else \
            int(rng.integers(3, 20))
        sim.reads_for_event(ref, "chrB", Event(kind, "chrB", pos, size=size),
                            40, out)
        bd_lines.append(f"chrB\t{pos}\t20+20-\tchrB\t{pos + size}"
                        f"\t18+19-\t{kind}\t{size}\t99")
    sim.ref_noise_reads(ref, "chrB", 8_000, out)
    bd = os.path.join(d, "bench2.bd")
    with open(bd, "w") as fh:
        fh.write("\n".join(bd_lines) + "\n")
    txt = os.path.join(d, "bench2_reads.txt")
    out.write(txt)
    bam = os.path.join(d, "bench2.bam")
    pairs = text_to_bam(ref, "chrB", txt, bam)
    return dict(fa=_write_ref(d, "chrB", ref), cfg=_write_cfg(d, bam),
                bd=bd, pairs=str(pairs))


SCENE2 = BamScene(build_scene2, SCENE2_FLAGS, far_win=True)

# scene 3: the shape of the reference's colousingbd15 acceptance run,
# BreakDancer calls over a 15 Mb region (three windows at the default -w 5)
SCENE3_LEN = 15_000_000
SCENE3_BOUNDARY_SIZE = 4_000


def scene3_events(chrom_len: int, rng: np.random.Generator):
    """Scene 3's event plan: one event every ~19.9 kb from 50 kb (one per
    20 kb of chromosome), kinds DEL, SI, DI, INV, TD in turn, sizes drawn
    from ``rng`` as ``build_scene2`` draws them; the two events nearest
    each window boundary (a third and two thirds of ``chrom_len``) become
    a DEL and an INV of ``SCENE3_BOUNDARY_SIZE`` bp that start 2 kb before
    it.  Returns (kind, pos, size) triples in position order and the
    boundaries."""
    n_events = chrom_len // 20_000
    kinds = ["DEL", "SI", "DI", "INV", "TD"] * (n_events // 5)
    step = (chrom_len - 100_000) / len(kinds)
    bounds = [chrom_len * k // 3 for k in (1, 2)]
    plan = []
    for i, kind in enumerate(kinds):
        size = int(rng.integers(60, 2500)) if kind != "SI" else \
            int(rng.integers(3, 20))
        plan.append([kind, 50_000 + int(i * step), size])
    for b in bounds:
        near = sorted(range(len(plan)), key=lambda i: abs(plan[i][1] - b))[:2]
        for kind, i in zip(("DEL", "INV"), sorted(near)):
            plan[i] = [kind, b - 2_000, SCENE3_BOUNDARY_SIZE]
    plan.sort(key=lambda e: e[1])
    return [tuple(e) for e in plan], bounds


def _local_event_reads(sim: Simulator, ref: str, chrom: str, kind: str,
                       pos: int, size: int, n_reads: int, out: SimReads,
                       margin: int = 20_000) -> None:
    """``sim.reads_for_event`` on the reference around the event only: the
    same reads, names and draws as on the whole reference, without copying
    a long chromosome for every event's ALT haplotype."""
    lo = max(pos - margin, 0)
    local = SimReads([], [], [])
    sim.reads_for_event(ref[lo:pos + size + margin], chrom,
                        Event(kind, chrom, pos - lo, size=size), n_reads,
                        local)
    head = f"sim_{kind}_{pos - lo}_"
    for name, seq, meta in zip(local.names, local.seqs, local.metas):
        assert name.startswith(head)
        out.names.append(f"sim_{kind}_{pos}_{name[len(head):]}")
        out.seqs.append(seq)
        out.metas.append((meta[0], meta[1], meta[2] + lo, *meta[3:]))


def build_scene3(d: str, chrom_len: int = SCENE3_LEN) -> Dict[str, str]:
    """Scene 3, ``scene3_colo15``: BAM read pairs with a BreakDancer calls
    file over three windows, in the shape of the reference pindel's
    ``colousingbd15`` acceptance run (COLO-829 chr20 reads with
    BreakDancer calls over a 15 Mb region; pindel 0.2.5b9 Makefile:58-59)
    at scene 2's read density, run at ``SCENE2_FLAGS`` and the CLI's
    default 5 Mb window.

    ``chr20`` is ``chrom_len`` bases of random sequence (seed 2009).  The
    events are ``scene3_events``'s plan, each with 40 split reads from
    scene 2's generator written as anchored BAM pairs (``text_to_bam``:
    anchor mapped, split mate unmapped, insert 500); each DEL of at least
    1 kb also gets eight discordant pairs whose mapped mates flank it, as
    ``build_rp_bigdel`` builds them, so RP discovery adds evidence
    windows, the boundary DELs' across two windows.  4 reference-matching
    pairs per kb of chromosome are noise (60,000 at 15 Mb), and the
    BreakDancer file has one line per event in scene 2's format.

    Cuts against the source: the sequence is random (no repeats, no N
    gaps); the read density is scene 2's, since COLO-829's read file is
    not in the repository; there are no properly-paired background pairs
    (a real BAM is mostly proper pairs, which intake reads and discards);
    the region is 15 Mb, the source's own, not the 64.4 Mb of chr20.  The
    source reads pindel-format input, with which ``-b`` is inert in both
    packages, so the reads come as BAM pairs, as in scene 2.  The tests
    cut ``chrom_len`` to 600 kb and run it at ``-w 0.2``: three windows,
    two boundary events each, at the same density.  ``pairs`` is the
    number of read pairs, ``events`` of events, ``discordant`` of
    discordant pairs."""
    chrom = "chr20"
    rng = np.random.default_rng(2009)
    ref = random_seq(rng, chrom_len)
    plan, _bounds = scene3_events(chrom_len, rng)
    sim = Simulator(rng)
    out = SimReads([], [], [])
    bd_lines = ["#chr1\tpos1\tori1\tchr2\tpos2\tori2\ttype\tsize\tscore"]
    extra = []
    for i, (kind, pos, size) in enumerate(plan):
        _local_event_reads(sim, ref, chrom, kind, pos, size, 40, out)
        bd_lines.append(f"{chrom}\t{pos}\t20+20-\t{chrom}\t{pos + size}"
                        f"\t18+19-\t{kind}\t{size}\t99")
        if kind != "DEL" or size < 1_000:
            continue
        for k in range(8):
            a = pos - 300 + int(rng.integers(0, 200))
            b = pos + size + int(rng.integers(0, 200))
            tlen = b + 100 - a
            extra += [
                BamRecord(f"rp{i}_{k}", FLAG_PAIRED | FLAG_READ1
                          | FLAG_MREVERSE, 0, a, 60, [(100, "M")], 0, b,
                          tlen, ref[a:a + 100], tags={"NM": 0}),
                BamRecord(f"rp{i}_{k}", FLAG_PAIRED | FLAG_READ2
                          | FLAG_REVERSE, 0, b, 60, [(100, "M")], 0, a,
                          -tlen, ref[b:b + 100], tags={"NM": 0})]
    sim.ref_noise_reads(ref, chrom, chrom_len * 4 // 1000, out)
    bd = os.path.join(d, "scene3.bd")
    with open(bd, "w") as fh:
        fh.write("\n".join(bd_lines) + "\n")
    txt = os.path.join(d, "scene3_reads.txt")
    out.write(txt)
    bam = os.path.join(d, "scene3.bam")
    pairs = text_to_bam(ref, chrom, txt, bam, extra)
    return dict(fa=_write_ref(d, chrom, ref), cfg=_write_cfg(d, bam),
                bd=bd, pairs=str(pairs), events=str(len(plan)),
                discordant=str(len(extra) // 2))


SCENE3 = BamScene(build_scene3, SCENE2_FLAGS, far_win=True)


def two_region_lanes(seed: int, n_reads: int, scale: int):
    """A batch for the legacy per-lane backend: split reads whose head is
    copied from a random chromosome (every other one from the reverse
    strand, some with a substitution), each with the two far-end regions of
    tests/test_engine_jax.py:67-80 around its copy, widened ``scale``
    times; returns (chromosome, lanes, max_snps, tsec_minus)."""
    from pindel_tpu_torch import dna
    from pindel_tpu_torch.config import Settings
    from pindel_tpu_torch.genome import SPACER, Genome
    from pindel_tpu_torch.reads import SplitRead
    from pindel_tpu_torch.search import far_end_lanes
    rng = np.random.default_rng(seed)
    genome = Genome()
    chrom = genome.add("chrT", random_seq(rng, 40_000 + 1100 * scale))
    settings = Settings()
    maxmm = settings.max_mismatch()
    lanes, ms = [], []
    for i in range(n_reads):
        n = int(rng.integers(40, 101))
        c = 250 * scale + int(rng.integers(0, 40_000 - n))
        # a split read: its head copies either strand of the chromosome
        # (the forward lane finds the one, the backward lane the other),
        # its tail does not
        k = int(rng.integers(25, n - 10))
        head = dna.decode(chrom.seq[SPACER + c:SPACER + c + k])
        seq = list((rc(head) if i % 2 else head) + random_seq(rng, n - k))
        if i % 3 == 0:
            j = int(rng.integers(0, k))
            seq[j] = "A" if seq[j] != "A" else "C"
        r = SplitRead(name=f"@l{i}", matched_d="+", tag="S1")
        r.set_seq("".join(seq))
        center = SPACER + c
        lanes.append(far_end_lanes(r, [
            (chrom, center - 211 * scale, center + 187 * scale),
            (chrom, center + 301 * scale, center + 1007 * scale)]))
        ms.append(int(maxmm[n]))
    return chrom, lanes, ms, [m + settings.additional_mismatch for m in ms]


def legacy_anchors(batch, device) -> List[Tuple[list, int]]:
    """``TorchLaneBackend.run`` over a ``two_region_lanes`` batch on
    ``device``: per read its anchors as (length, position, direction,
    strand, mismatches) tuples and its whole-read mismatch count."""
    from pindel_tpu_torch.config import Settings
    from pindel_tpu_torch.ops.engine_fused import device_state_from_numpy
    from pindel_tpu_torch.ops.engine_jax import TorchLaneBackend
    chrom, lanes, ms, tm = batch
    settings = Settings()
    backend = TorchLaneBackend(
        settings, device_state_from_numpy(chrom.seq, settings.max_mismatch(),
                                          device), chrom.name)
    return [([(u.length_str, u.abs_loc, u.direction, u.strand, u.mismatches)
              for u in ups], full_mm)
            for ups, full_mm in backend.run(lanes, 10, ms, tm)]


def sharded_anchors(batch, devices, dp: int = None):
    """``TorchShardedBackend.run`` (the window-parallel search, K9) over a
    ``two_region_lanes`` batch on the grid over ``devices``, in
    ``legacy_anchors``'s form."""
    from pindel_tpu_torch.config import Settings
    from pindel_tpu_torch.parallel.mesh import TorchShardedBackend
    chrom, lanes, ms, tm = batch
    settings = Settings()
    backend = TorchShardedBackend(settings, settings.max_mismatch(),
                                  chrom.seq, devices, dp)
    return [([(u.length_str, u.abs_loc, u.direction, u.strand, u.mismatches)
              for u in ups], full_mm)
            for ups, full_mm in backend.run(lanes, 10, ms, tm)]


def digests(files: Dict[str, bytes]) -> Dict[str, str]:
    return {suffix: hashlib.sha256(raw).hexdigest()
            for suffix, raw in sorted(files.items())}


def load_digests(path: str) -> Dict[str, str]:
    """The reference's report digests in ``path`` (``SCENE1_DIGESTS``,
    ``SCENE2_DIGESTS``), by suffix."""
    with open(path) as fh:
        return json.load(fh)["reports"]


def save_digests(path: str, files: Dict[str, bytes], command: str) -> None:
    with open(path, "w") as fh:
        json.dump(dict(command=command, reports=digests(files)), fh,
                  indent=1)
        fh.write("\n")


def reports(prefix: str) -> Dict[str, bytes]:
    """The report files a run wrote under ``prefix``, by suffix."""
    d, base = os.path.split(prefix)
    out = {}
    for name in sorted(os.listdir(d)):
        if name.startswith(base + "_"):
            with open(os.path.join(d, name), "rb") as fh:
                out[name[len(base) + 1:]] = fh.read()
    return out


def load_golden() -> Dict[str, Dict[str, bytes]]:
    with open(GOLDEN) as fh:
        data = json.load(fh)
    return {scene: {suffix: text.encode("ascii")
                    for suffix, text in files.items()}
            for scene, files in data.items()}


def save_golden(golden: Dict[str, Dict[str, bytes]]) -> None:
    data = {scene: {suffix: raw.decode("ascii")
                    for suffix, raw in sorted(files.items())}
            for scene, files in sorted(golden.items())}
    with open(GOLDEN, "w") as fh:
        json.dump(data, fh, indent=1)
        fh.write("\n")
