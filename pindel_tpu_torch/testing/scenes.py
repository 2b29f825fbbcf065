"""The scenes the port is checked on, shared by the tests/test_torch_*.py
files and chip_smoke.py.

``SMALL_SCENES`` are simulated pindel-text scenes, ``BAM_SCENES``
simulated BAM scenes (BAM + BreakDancer discovery, ``-q``, ``-z``, ``-g``)
and ``SUITE_SCENES`` those of the reference's own tests that no other
scene covers (interchromosomal calls, regions, the depth filter, flag
tokens), all small enough for the NumPy reference.
``golden_reports.json`` holds, for each of them, the report files that ``pindel_tpu``'s NumPy backend
writes with the scene's flags: the GPU machine has no jax, so the port's
reports are compared there with these bytes.  tests/test_torch_pipeline.py
and tests/test_torch_bam.py keep them equal to the JAX package's output;
``PYTHONPATH=. python tests/test_torch_pipeline.py --write-golden`` rewrites
them.  ``SCENE1`` and ``SCENE2`` are scenes 1 and 2 of bench.py, and
``SCENE3`` the port's scene 3 (three windows of BAM pairs with BreakDancer
calls, ``build_scene3``) and ``SCENE4_RUNS`` scene 4's three runs (four
chromosomes in one BAM, ``build_scene4``); their reference reports are too
large for the JSON, so ``scene1_digests.json`` to ``scene4_digests.json``
hold their sha256 (rewritten by ``PYTHONPATH=. python
tests/test_torch_bench.py --write-scene1-digests``, ``PYTHONPATH=. python
tests/test_torch_bam.py --write-scene2-digests``, ``PYTHONPATH=. python
tests/test_torch_scene3.py --write-scene3-digests`` and ``PYTHONPATH=.
python tests/test_torch_scene4.py --write-scene4-digests``).

``SCENES`` builds scenes 1-4 at full size as ``Scene`` objects;
``run_scene`` is the one recorded run of a scene through the port's CLI
(its wall, report digests and counters) and ``problems`` the one gate over
such runs, which chip_smoke.py, the scene tests and
``tools/kernel_bench`` share.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Callable, Dict, List, Optional, Tuple

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
SCENE4_DIGESTS = os.path.join(_HERE, "scene4_digests.json")

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
    recs = list(extra) + text_records(ref, txt)
    recs.sort(key=lambda r: r.pos)
    write_bam(bam, [(chrom, len(ref))], recs)
    return len(recs) // 2


def text_records(ref: str, txt: str, tid: int = 0) -> List[BamRecord]:
    """The anchored pairs of ``text_to_bam`` for the pindel-text reads in
    ``txt`` on reference ``tid`` (``ref``), in file order; reads whose
    anchor would leave the chromosome are dropped."""
    with open(txt) as fh:
        lines = fh.read().splitlines()
    recs = []
    for i in range(0, len(lines), 3):
        name, seq, meta = lines[i], lines[i + 1], lines[i + 2].split()
        dstr, pos, mq = meta[0], int(meta[2]), int(meta[3])
        anchor_pos = pos if dstr == "+" else pos - 100
        if anchor_pos < 0 or anchor_pos + 100 > len(ref):
            continue
        recs.extend(on_reference(tid, pair(
            name[1:-2], anchor_pos, seq, ref, anchor_reverse=(dstr == "-"),
            mapq=mq)))
    return recs


def on_reference(tid: int, recs) -> List[BamRecord]:
    """``recs`` (records of one pair, or any on reference 0) moved to
    reference ``tid`` of a multi-reference BAM, mates included."""
    if tid == 0:
        return list(recs)
    return [dataclasses.replace(r, tid=tid, mate_tid=tid) for r in recs]


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
    """The CLI arguments of one run of ``scene`` (flags of both CLIs): the
    BAM configuration (``-i``), or pindel-text reads (``-p``) where the
    build gave ``reads`` and no ``cfg``."""
    fill = dict(paths, prefix=prefix)
    reads = (["-i", paths["cfg"]] if "cfg" in paths
             else ["-p", paths["reads"]])
    return (["-f", paths["fa"], *reads, "-o", prefix]
            + [f.format(**fill) for f in scene.flags])


# ------------------------------------------------ the reference suite's scenes
def build_interchrom(d: str) -> Dict[str, str]:
    """tests/test_interchromosomal.py's scene: a translocation joins
    chrA:10000 to chrB:20000; eight split reads anchored on chrA upstream
    of it, and an interchromosomal BreakDancer call (CTX) naming both
    ends."""
    rng = np.random.default_rng(12)
    ref_a = random_seq(rng, 30_000)
    ref_b = random_seq(rng, 30_000)
    fa = os.path.join(d, "ref.fa")
    write_fasta(fa, [("chrA", ref_a), ("chrB", ref_b)])
    make_fai(fa)
    bp_a, bp_b = 10_000, 20_000
    recs = []
    for k in range(8):
        # chrA's left flank, then chrB from its breakpoint on
        flank = int(rng.integers(40, 60))
        frag = ref_a[bp_a - flank: bp_a] + ref_b[bp_b: bp_b + 100 - flank]
        gap = int(rng.integers(60, 300))
        recs.extend(pair(f"t{k}", bp_a - flank - gap - 100, rc(frag), ref_a))
    recs.sort(key=lambda r: r.pos)
    bam = os.path.join(d, "reads.bam")
    write_bam(bam, [("chrA", len(ref_a)), ("chrB", len(ref_b))], recs)
    bd = os.path.join(d, "calls.bd")
    with open(bd, "w") as fh:
        fh.write(f"chrA\t{bp_a}\t8+0-\tchrB\t{bp_b}\t0+8-\tCTX\t-1\t99\n")
    return dict(fa=fa, cfg=_write_cfg(d, bam), bd=bd)


def _text_scene(d: str, **scene_kw) -> Dict[str, str]:
    """``standard_scene(**scene_kw)`` on ``chrT`` with a .fai, as pindel-text
    reads."""
    ref, _events, sim = standard_scene(**scene_kw)
    fa = _write_ref(d, "chrT", ref)
    reads = os.path.join(d, "reads.txt")
    sim.write(reads)
    return dict(fa=fa, reads=reads)


def build_regions(d: str) -> Dict[str, str]:
    """tests/test_regions.py's scene (seed 1, 60 kb) and its BED files:
    ``inc``/``exc`` of its -j and -J tests, ``inc2``/``exc2`` of its -j
    with -J test (overlapping records and one with reversed
    coordinates)."""
    paths = _text_scene(d, seed=1, chrom_len=60_000)
    beds = dict(inc="chrT\t1\t25000\nchrT\t30000\t59000\n",
                exc="chrT\t20000\t32000\n",
                inc2="chrT\t1\t30000\nchrT\t25000\t59000\n"
                     "chrT\t40000\t35000\n",
                exc2="chrT\t10000\t12000\nchrT\t58000\t59500\n")
    for key, text in beds.items():
        paths[key] = os.path.join(d, f"{key}.bed")
        with open(paths[key], "w") as fh:
            fh.write(text)
    return paths


def build_flags(d: str, seed: int) -> Dict[str, str]:
    """tests/test_cli_flags.py's scene: INV and TD events among others
    (50 kb, 12 reads an event)."""
    return _text_scene(d, seed=seed, chrom_len=50_000,
                       kinds=["DEL", "INV", "TD", "SI", "INV", "TD"],
                       reads_per_event=12, n_noise=8)


def build_td_depth(d: str) -> Dict[str, str]:
    """tests/test_depth_filter.py's scene: a 3 kb tandem duplication at
    5-8 kb evidenced by split reads at the copy junction, over concordant
    reference pairs every 150 bp (insert 300) whose coverage is not
    doubled inside the copy, so ``-N``'s relative-coverage test drops the
    TD that the run without ``-N`` reports."""
    s, e, read, frag = 5000, 8000, 100, 300
    rng = np.random.default_rng(7)
    ref = "".join(rng.choice(list("ACGT"), size=40_000))
    alt = ref[:e] + ref[s:e] + ref[e:]

    def fragment(name, p1, seq1, p2, seq2, m1, m2):
        # read 1 forward, read 2 reverse; unmapped reads keep the raw
        # sequenced (reverse-complement) bases
        isize = (p2 + read) - p1 if (m1 and m2) else 0
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
        pos1 = p1 if m1 else p2
        pos2 = p2 if m2 else p1
        return [
            BamRecord(name, f1, 0, pos1, 60 if m1 else 0,
                      [(read, "M")] if m1 else [], 0, pos2, isize, seq1,
                      tags={"NM": 0} if m1 else {}),
            BamRecord(name, f2, 0, pos2, 60 if m2 else 0,
                      [(read, "M")] if m2 else [], 0, pos1, -isize,
                      seq2 if m2 else rc(seq2),
                      tags={"NM": 0} if m2 else {})]

    records = []
    for g in range(0, len(ref) - frag, 150):
        records += fragment(f"bg_{g}", g, ref[g:g + read],
                            g + frag - read, ref[g + frag - read:g + frag],
                            True, True)
    for f in range(e - 280, e - 240, 10):     # read 2 straddles the junction
        records += fragment(f"tdA_{f}", f, alt[f:f + read], f + frag - read,
                            alt[f + frag - read:f + frag], True, False)
    for f in range(e - 40, e, 10):            # read 1 straddles it
        p2 = f + frag - read                  # inside the second copy
        records += fragment(f"tdB_{f}", f, alt[f:f + read],
                            s + (p2 - e), alt[p2:p2 + read], False, True)
    records.sort(key=lambda r: (r.tid, r.pos))
    fa = os.path.join(d, "ref.fa")
    with open(fa, "w") as fh:
        fh.write(">chrT\n")
        for i in range(0, len(ref), 70):
            fh.write(ref[i:i + 70] + "\n")
    make_fai(fa)
    bam = os.path.join(d, "td.bam")
    write_bam(bam, [("chrT", len(ref))], records)
    open(bam + ".bai", "w").close()
    return dict(fa=fa, cfg=_write_cfg(d, bam, frag))


# the reference suite's scenes the port's other scenes do not cover
# (tests/test_interchromosomal.py, test_regions.py, test_depth_filter.py,
# test_cli_flags.py), and the backends each runs through on the CPU and on
# the card.  The interchromosomal call's windows lie on the other
# chromosome, so the search sends its reads down the cross-chromosome
# route (search.py:_far_round): _far_win_kernel on the other chromosome's
# partner backend under --backend fused, the NumPy oracle otherwise
SUITE_SCENES = {
    "bam_int_I": BamScene(build_interchrom, ("-b", "{bd}", "-I")),
    "bam_int": BamScene(build_interchrom, ("-b", "{bd}")),
    "regions_c_coords": BamScene(build_regions, ("-s", "-c",
                                                 "chrT:1000-30000")),
    "regions_c_chrom": BamScene(build_regions, ("-s", "-c", "chrT")),
    "regions_j": BamScene(build_regions, ("-s", "-j", "{inc}")),
    "regions_J": BamScene(build_regions, ("-s", "-J", "{exc}")),
    "regions_jJ": BamScene(build_regions, ("-s", "-j", "{inc2}", "-J",
                                           "{exc2}")),
    "depth_td": BamScene(build_td_depth, ("-x", "4")),
    "depth_td_N": BamScene(build_td_depth, ("-x", "4", "-N")),
    "flags_r_false_t_0": BamScene(lambda d: build_flags(d, 77), (
        "-c", "ALL", "-r", "false", "-t", "0")),
    "flags_r_yes_t_true": BamScene(lambda d: build_flags(d, 78), (
        "-c", "ALL", "-r", "yes", "-t", "true")),
}
SUITE_BACKENDS = {
    "bam_int_I": ("fused", "mesh", "jax", "numpy"),
    "bam_int": ("fused", "mesh", "jax", "numpy"),
    "regions_c_coords": ("fused", "numpy"),
    "regions_c_chrom": ("fused", "numpy"),
    "regions_j": ("fused", "numpy"),
    "regions_J": ("fused", "numpy"),
    "regions_jJ": ("fused", "numpy"),
    "depth_td": ("fused", "numpy"),
    "depth_td_N": ("fused", "numpy"),
    "flags_r_false_t_0": ("fused",),
    "flags_r_yes_t_true": ("fused",),
}


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


def scene3_events(chrom_len: int, rng: np.random.Generator,
                  bounds: List[int] = None):
    """Scene 3's event plan: one event every ~19.9 kb from 50 kb (one per
    20 kb of chromosome), kinds DEL, SI, DI, INV, TD in turn, sizes drawn
    from ``rng`` as ``build_scene2`` draws them; the two events nearest
    each window boundary (``bounds``; by default a third and two thirds
    of ``chrom_len``) become a DEL and an INV of ``SCENE3_BOUNDARY_SIZE``
    bp that start 2 kb before it.  Returns (kind, pos, size) triples in
    position order and the boundaries."""
    n_events = chrom_len // 20_000
    kinds = ["DEL", "SI", "DI", "INV", "TD"] * (n_events // 5)
    step = (chrom_len - 100_000) / len(kinds)
    if bounds is None:
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


def flanking_pairs(prefix: str, ref: str, pos: int, size: int,
                   rng: np.random.Generator) -> List[BamRecord]:
    """Eight discordant pairs whose mapped mates flank the deletion of
    ``size`` bp at ``pos`` (as ``build_rp_bigdel`` builds them), on
    reference 0."""
    extra = []
    for k in range(8):
        a = pos - 300 + int(rng.integers(0, 200))
        b = pos + size + int(rng.integers(0, 200))
        tlen = b + 100 - a
        extra += [
            BamRecord(f"{prefix}_{k}", FLAG_PAIRED | FLAG_READ1
                      | FLAG_MREVERSE, 0, a, 60, [(100, "M")], 0, b,
                      tlen, ref[a:a + 100], tags={"NM": 0}),
            BamRecord(f"{prefix}_{k}", FLAG_PAIRED | FLAG_READ2
                      | FLAG_REVERSE, 0, b, 60, [(100, "M")], 0, a,
                      -tlen, ref[b:b + 100], tags={"NM": 0})]
    return extra


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
        if kind == "DEL" and size >= 1_000:
            extra += flanking_pairs(f"rp{i}", ref, pos, size, rng)
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

# scene 4: a whole-genome-shaped BAM run, four chromosomes in one BAM (the
# last one without reads), scene 3's local events on the first three and
# translocations between them, run with -c ALL -I, with BED regions
# (-j/-J) and with one -c region
SCENE4_CHROMS = (("chr1", 6_000_000), ("chr2", 4_000_000),
                 ("chr3", 3_000_000), ("chrE", 500_000))
SCENE4_WINDOW = 5_000_000
# translocations of each chromosome pair (chr1 -> chr2, chr2 -> chr3) and
# the split reads of each
SCENE4_TRANSLOCATIONS = 12
SCENE4_TRANSLOCATION_READS = 16
# how far from either breakpoint of a CTX call a read's anchor may lie and
# the call's windows still reach it (the BreakDancer window's 200 bp, the
# insert and a read: a read anchored near the second breakpoint is searched
# on the first one's chromosome too)
SCENE4_CTX_REACH = 1_000
# the tests' cut: every length and coordinate divided by SCENE4_CUT, run at
# -w 0.2, with SCENE4_CUT_TRANSLOCATIONS translocations a pair
SCENE4_CUT = 25
SCENE4_CUT_TRANSLOCATIONS = 2


def _gap_middles(plan, n: int, phase: int) -> List[int]:
    """``n`` positions midway between consecutive events of ``plan`` (the
    end of one, the start of the next), spread over the chromosome;
    ``phase`` 1 and 3 give two sets that do not meet."""
    out = []
    for k in range(n):
        i = (4 * k + phase) * (len(plan) - 1) // (4 * n)
        _kind, pos, size = plan[i]
        out.append((pos + size + plan[i + 1][1]) // 2)
    return out


def build_scene4(d: str, cut: int = 1) -> Dict[str, str]:
    """Scene 4, ``scene4_wgs``: one BAM over four chromosomes, sorted by
    (reference, position), with a BreakDancer calls file that holds
    interchromosomal (CTX) lines, in the shape of a whole-genome pindel
    run (``-c ALL`` over every contig, pindel.cpp:1601-1716).

    The chromosomes are ``SCENE4_CHROMS`` of random sequence (seed 2013);
    ``chrE`` has no read.  Each of ``chr1``-``chr3`` gets
    ``scene3_events``'s plan at scene 3's density (40 split reads an event
    as anchored pairs, eight discordant pairs for each DEL of 1 kb and
    more, a BreakDancer line an event), ``chr1``'s with a DEL and an INV
    across its 5 Mb window boundary, and 4 reference pairs a kb.
    ``SCENE4_TRANSLOCATIONS`` translocations join ``chr1`` to ``chr2`` and
    as many ``chr2`` to ``chr3``, each midway between two local events on
    either side: ``SCENE4_TRANSLOCATION_READS`` split reads anchored
    upstream of the breakpoint whose other part lies on the other
    chromosome (tests/test_interchromosomal.py's reads) and a CTX line.

    ``cut`` divides every length and coordinate (the tests take
    ``SCENE4_CUT``, with ``SCENE4_CUT_TRANSLOCATIONS`` translocations a
    pair, at ``-w 0.2``).  Besides the inputs it writes the runs' BED
    files: ``bed_inc`` (``-j``: the first 7/12 of ``chr1``, a record
    overlapping its end, one with reversed coordinates inside them, and
    ``chr3`` whole) and ``bed_exc`` (``-J``: a stretch of ``chr1`` with
    events in it), so ``chr1`` is searched as two regions and ``chr2``
    not at all; ``region`` is the ``-c`` region, the middle half of
    ``chr2``.  ``pairs`` is the number of read pairs, ``events`` of local
    events, ``discordant`` of discordant pairs, ``translocation_reads``
    of translocation split reads and ``ctx_reads`` of the reads anchored
    within ``SCENE4_CTX_REACH`` of either breakpoint of a CTX call (the
    most reads whose far-end search can reach another chromosome: the
    translocation reads and the reads anchored near a call's second
    breakpoint)."""
    rng = np.random.default_rng(2013)
    chroms = [(name, length // cut) for name, length in SCENE4_CHROMS]
    window = SCENE4_WINDOW // cut
    n_trans = SCENE4_TRANSLOCATIONS if cut == 1 else \
        SCENE4_CUT_TRANSLOCATIONS
    refs = {name: random_seq(rng, length) for name, length in chroms}
    tids = {name: tid for tid, (name, _) in enumerate(chroms)}
    sim = Simulator(rng)
    bd_lines = ["#chr1\tpos1\tori1\tchr2\tpos2\tori2\ttype\tsize\tscore"]
    recs: List[BamRecord] = []
    plans = {}
    discordant = 0
    for name, length in chroms[:3]:
        ref = refs[name]
        bounds = list(range(window, length, window))
        plan, _bounds = scene3_events(length, rng, bounds)
        plans[name] = plan
        out = SimReads([], [], [])
        for i, (kind, pos, size) in enumerate(plan):
            _local_event_reads(sim, ref, name, kind, pos, size, 40, out)
            bd_lines.append(f"{name}\t{pos}\t20+20-\t{name}\t{pos + size}"
                            f"\t18+19-\t{kind}\t{size}\t99")
            if kind == "DEL" and size >= 1_000:
                extra = flanking_pairs(f"rp_{name}_{i}", ref, pos, size, rng)
                discordant += len(extra) // 2
                recs.extend(on_reference(tids[name], extra))
        sim.ref_noise_reads(ref, name, length * 4 // 1000, out)
        txt = os.path.join(d, f"reads_{name}.txt")
        out.write(txt)
        recs.extend(text_records(ref, txt, tids[name]))
    trans_reads = 0
    ends = []               # both breakpoints of every CTX call
    for a, b in (("chr1", "chr2"), ("chr2", "chr3")):
        ref_a, ref_b = refs[a], refs[b]
        for k, (bp_a, bp_b) in enumerate(zip(
                _gap_middles(plans[a], n_trans, 1),
                _gap_middles(plans[b], n_trans, 3))):
            for j in range(SCENE4_TRANSLOCATION_READS):
                # a's left flank, then b from its breakpoint on
                flank = int(rng.integers(40, 60))
                frag = ref_a[bp_a - flank: bp_a] + \
                    ref_b[bp_b: bp_b + 100 - flank]
                gap = int(rng.integers(60, 300))
                recs.extend(on_reference(tids[a], pair(
                    f"t_{a}_{b}_{k}_{j}", bp_a - flank - gap - 100,
                    rc(frag), ref_a)))
                trans_reads += 1
            n = SCENE4_TRANSLOCATION_READS
            bd_lines.append(f"{a}\t{bp_a}\t{n}+0-\t{b}\t{bp_b}\t0+{n}-"
                            f"\tCTX\t-1\t99")
            ends += [(tids[a], bp_a), (tids[b], bp_b)]
    recs.sort(key=lambda r: (r.tid, r.pos))
    ctx_reads = sum(not r.flag & FLAG_UNMAP and any(
        r.tid == tid and abs(r.pos - bp) <= SCENE4_CTX_REACH
        for tid, bp in ends) for r in recs)
    fa = os.path.join(d, "ref.fa")
    write_fasta(fa, [(name, refs[name]) for name, _ in chroms])
    make_fai(fa)
    bam = os.path.join(d, "scene4.bam")
    write_bam(bam, chroms, recs)
    bd = os.path.join(d, "scene4.bd")
    with open(bd, "w") as fh:
        fh.write("\n".join(bd_lines) + "\n")
    len1, len2, len3 = (length for _, length in chroms[:3])
    bed_inc = os.path.join(d, "include.bed")
    with open(bed_inc, "w") as fh:
        fh.write(f"chr1\t1\t{len1 * 7 // 12}\n"
                 f"chr1\t{len1 // 2}\t{len1 * 7 // 10}\n"
                 f"chr1\t{len1 * 8 // 15}\t{len1 * 7 // 15}\n"
                 f"chr3\t1\t{len3}\n")
    bed_exc = os.path.join(d, "exclude.bed")
    with open(bed_exc, "w") as fh:
        fh.write(f"chr1\t{len1 // 4}\t{len1 // 4 + 400_000 // cut}\n")
    return dict(fa=fa, cfg=_write_cfg(d, bam), bd=bd, bed_inc=bed_inc,
                bed_exc=bed_exc, region=f"chr2:{len2 // 4}-{len2 * 3 // 4}",
                pairs=str(len(recs) // 2),
                events=str(sum(len(p) for p in plans.values())),
                discordant=str(discordant),
                translocation_reads=str(trans_reads),
                ctx_reads=str(ctx_reads))


# scene 4's three runs, each at scene 2's flags and the CLI's default -w 5
# (the tests add -w 0.2 on the cut scene)
SCENE4_RUNS = {
    "scene4": BamScene(build_scene4, SCENE2_FLAGS + ("-c", "ALL", "-I"),
                       far_win=True),
    "scene4_bed": BamScene(build_scene4, SCENE2_FLAGS + (
        "-j", "{bed_inc}", "-J", "{bed_exc}"), far_win=True),
    "scene4_c": BamScene(build_scene4, SCENE2_FLAGS + ("-c", "{region}"),
                         far_win=True),
}
SCENE4 = SCENE4_RUNS["scene4"]


# ------------------------------------------ the recorded run and its gate
# a larger share of reads re-run on the host oracle is a silent speed cliff
MAX_FALLBACK = 0.01


@dataclasses.dataclass
class Scene:
    """A built scene as ``run_scene`` runs it: its name, unit, size, its
    CLI run (output prefix -> arguments, ``--device`` left out), the sha256
    of the reference's reports, by suffix, whether a kernel run must send
    rows through ``_far_win_kernel`` (BreakDancer calls), the windows over
    its chromosomes' bases it must span, and the most reads the
    cross-chromosome route may take, which must take at least one (None:
    neither checked)."""

    name: str
    unit: str
    n: int
    argv_of: Callable[[str], List[str]]
    want: Dict[str, str]
    far_win: bool = False
    windows: Optional[int] = None
    oracle_reads: Optional[int] = None


def text_scene(name: str, fa: str, reads_txt: str, n: int,
               want: Dict[str, str]) -> Scene:
    """A pindel-text scene run at scene 1's flags."""
    return Scene(name, "reads", n,
                 lambda prefix: ["-f", fa, "-p", reads_txt, *SCENE1_FLAGS,
                                 "--backend", "fused", "-o", prefix], want)


def bam_scene(name: str, paths: Dict[str, str], n: int,
              want: Dict[str, str], windows: Optional[int] = None,
              spec: BamScene = SCENE2,
              oracle_reads: Optional[int] = None) -> Scene:
    """A BAM + BreakDancer scene of ``n`` read pairs (``paths`` as
    ``spec.build`` gives them) run at ``spec``'s flags (scene 2's by
    default)."""
    return Scene(name, "read pairs", n,
                 lambda prefix: bam_argv(spec, paths, prefix)
                 + ["--backend", "fused"], want, far_win=True,
                 windows=windows, oracle_reads=oracle_reads)


def make_scene1(d: str) -> Scene:
    fa, reads_txt, n = write_scene(d, **SCENE1)
    return text_scene("scene1", fa, reads_txt, n,
                      load_digests(SCENE1_DIGESTS))


def make_scene2(d: str) -> Scene:
    paths = SCENE2.build(d)
    return bam_scene("scene2", paths, int(paths["pairs"]),
                     load_digests(SCENE2_DIGESTS))


def make_scene3(d: str) -> Scene:
    paths = SCENE3.build(d)
    return bam_scene("scene3", paths, int(paths["pairs"]),
                     load_digests(SCENE3_DIGESTS), windows=3)


def make_scene4(d: str) -> Scene:
    paths = SCENE4.build(d)
    return bam_scene("scene4", paths, int(paths["pairs"]),
                     load_digests(SCENE4_DIGESTS)["scene4"], windows=5,
                     spec=SCENE4, oracle_reads=int(paths["ctx_reads"]))


# scenes 1-4 at full size, each built under a directory
SCENES = {"scene1": make_scene1, "scene2": make_scene2,
          "scene3": make_scene3, "scene4": make_scene4}


def run_scene(scene: Scene, prefix: str, dev) -> dict:
    """One recorded CLI run of ``scene`` on ``dev`` (a torch device): its
    wall (device work included), the digests of its reports, whether
    ``_D`` is empty, the search kernels' launches, the fallback ratio, the
    timer phases and the run's ``counters``: launches (the scan's and
    each fused kernel's apart), windows visited and with bases (and per
    window its reads and the seconds at which it was read in, staged and
    reported), ``_far_win_kernel`` rows, legacy per-lane rows, the reads
    the cross-chromosome route took and of them those K4 searched on a
    partner backend and those the oracle searched, shard kernel launches
    and peak card memory in MiB.  The kernels' counts are reset at its
    start and hold the run's counts after it."""
    import time

    import torch

    from pindel_tpu_torch.__main__ import main as port_main
    from pindel_tpu_torch.ops import (engine_fused, engine_jax, fused_cuda,
                                      scan_cuda, sharded_search_cuda)
    from pindel_tpu_torch.profiling import g_fallback, g_timer, g_xchrom
    from pindel_tpu_torch.tools import measure
    fused_cuda.reset_launches()
    sharded_search_cuda.LAUNCHES = 0
    engine_fused.FAR_WIN_ROWS = 0
    engine_jax.LEGACY_ROWS = 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    with measure.window_log() as windows, measure.oracle_reads() as oracle:
        t0 = time.monotonic()
        rc = port_main(scene.argv_of(prefix) + ["--device", str(dev)])
        measure.sync(dev)
        wall = time.monotonic() - t0
    if rc != 0:
        raise RuntimeError(f"{scene.name}: the CLI returned {rc}")
    got = reports(prefix)
    counters = dict(
        launches=fused_cuda.search_launches(),
        scan_launches=scan_cuda.LAUNCHES,
        fused_launches=fused_cuda.LAUNCHES,
        close_launches=fused_cuda.LAUNCHES_BY_KERNEL["close"],
        far_launches=fused_cuda.LAUNCHES_BY_KERNEL["far"],
        far_win_launches=fused_cuda.LAUNCHES_BY_KERNEL["far_win"],
        windows=sum(w["start"] < w["end"] for w in windows),
        windows_visited=len(windows),
        far_win_rows=engine_fused.FAR_WIN_ROWS,
        legacy_rows=engine_jax.LEGACY_ROWS,
        oracle_reads=oracle["reads"],
        xchrom_device=g_xchrom.device,
        xchrom_oracle=g_xchrom.oracle,
        shard_launches=sharded_search_cuda.LAUNCHES,
        peak_mib=(torch.cuda.max_memory_allocated(dev) / 2 ** 20
                  if dev.type == "cuda" else None),
        by_window=windows)
    return dict(wall=wall, digests=digests(got), d_empty=not got.get("D"),
                launches=fused_cuda.search_launches(),
                fallback=g_fallback.ratio(),
                phases=g_timer.items(), counters=counters)


def problems(scene: Scene, runs: List[dict], kernel: bool) -> List[str]:
    """What fails the gate over ``runs`` (``run_scene``'s) of ``scene``;
    ``kernel``: the runs must have launched the search kernels (a fused run
    on a card).  Every run: reports equal to the reference's digests, a
    non-empty ``_D``, at most MAX_FALLBACK of the reads on the host oracle,
    the scene's windows, K4 rows on a BreakDancer scene's kernel run,
    ``pt_far_win`` launched wherever K4 searched rows, and the reads the
    cross-chromosome route took within the scene's bound; over the runs,
    equal search kernel launches, and on a kernel run more than none."""
    out = []
    for i, r in enumerate(runs):
        if r["digests"] != scene.want:
            diff = sorted(k for k in set(r["digests"]) | set(scene.want)
                          if r["digests"].get(k) != scene.want.get(k))
            out.append(f"{scene.name} run {i}: reports differ from the "
                       f"reference's: {diff}")
        if r["d_empty"]:
            out.append(f"{scene.name} run {i}: the _D report is empty")
        if r["fallback"] > MAX_FALLBACK:
            out.append(f"{scene.name} run {i}: fallback ratio "
                       f"{r['fallback']} above {MAX_FALLBACK}")
        c = r.get("counters", {})
        if scene.windows is not None and c.get("windows") != scene.windows:
            out.append(f"{scene.name} run {i}: {c.get('windows')} windows, "
                       f"not {scene.windows}")
        if kernel and scene.far_win and not c.get("far_win_rows"):
            out.append(f"{scene.name} run {i}: _far_win_kernel searched "
                       "no row")
        if kernel and c.get("far_win_rows") and not c.get(
                "far_win_launches"):
            out.append(f"{scene.name} run {i}: K4 rows "
                       f"{c['far_win_rows']} but pt_far_win never launched")
        if scene.oracle_reads is not None and not (
                0 < c.get("oracle_reads", 0) <= scene.oracle_reads):
            out.append(f"{scene.name} run {i}: {c.get('oracle_reads')} "
                       "reads taken across chromosomes, not "
                       f"1 to {scene.oracle_reads}")
    launches = {r["launches"] for r in runs}
    if len(launches) != 1:
        out.append(f"{scene.name}: search kernel launches differ between "
                   f"runs: {[r['launches'] for r in runs]}")
    if kernel and 0 in launches:
        out.append(f"{scene.name}: the search kernels never launched")
    return out


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
