"""The ``bam_bd`` layout: ``build_scene3``'s layout at a configuration's
sizes, as one BAM with a BreakDancer calls file.

``event_plan``'s events, ``reads_per_event`` split reads each as anchored
BAM pairs (mapped anchor, unmapped split mate), ``rp_pairs`` discordant
pairs around each DEL of ``rp_min_size`` bases or more, ``noise_per_kb``
reference-matching anchored pairs per kb, and a BreakDancer line an event:
scene 3's bytes at scene 3's sizes and seed.  On top of them
``proper_pair_depth`` is the coverage by proper pairs: both mates mapped
over the reference, 100M, NM 0, fragments of about ``insert_size`` bases,
as most of a sequenced sample's BAM is; intake reads them, keeps them as
reference-supporting reads and passes them to no search.
"""
from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

from gen.bamwriter import (FLAG_MREVERSE, FLAG_PAIRED, FLAG_READ1,
                           FLAG_READ2, FLAG_REVERSE, BamRecord)
from gen.samples import Sample, text_to_bam, write_cfg, write_ref
from gen.simulate import Event, SimReads, Simulator, random_seq

PARAMS = ("chrom", "chrom_len", "windows", "event_spacing", "boundary_size",
          "reads_per_event", "rp_min_size", "rp_pairs", "noise_per_kb",
          "insert_size", "proper_pair_depth")

READ_LEN = 100
FLAG_PROPER = 0x2
# a proper pair's records at a time, so the packed rows are made in pieces
CHUNK = 1 << 19


def event_plan(g: dict, rng: np.random.Generator) -> List[Tuple]:
    """One event every ``event_spacing`` bases from 50 kb, kinds DEL, SI,
    DI, INV, TD in turn, sizes drawn from ``rng``; the two events nearest
    each window boundary become a DEL and an INV of ``boundary_size``
    bases that start 2 kb before it.  (kind, pos, size) in position
    order."""
    chrom_len, windows = g["chrom_len"], g["windows"]
    n_events = chrom_len // g["event_spacing"]
    kinds = ["DEL", "SI", "DI", "INV", "TD"] * (n_events // 5)
    step = (chrom_len - 100_000) / len(kinds)
    bounds = [chrom_len * k // windows for k in range(1, windows)]
    plan = []
    for i, kind in enumerate(kinds):
        size = int(rng.integers(60, 2500)) if kind != "SI" else \
            int(rng.integers(3, 20))
        plan.append([kind, 50_000 + int(i * step), size])
    for b in bounds:
        near = sorted(range(len(plan)), key=lambda i: abs(plan[i][1] - b))[:2]
        for kind, i in zip(("DEL", "INV"), sorted(near)):
            plan[i] = [kind, b - 2_000, g["boundary_size"]]
    plan.sort(key=lambda e: e[1])
    return [tuple(e) for e in plan]


def flanking_pairs(prefix: str, ref: str, pos: int, size: int, n: int,
                   rng: np.random.Generator) -> List[BamRecord]:
    """``n`` discordant pairs whose mapped mates flank the deletion of
    ``size`` bases at ``pos``."""
    extra = []
    for k in range(n):
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


def record_dtype(name_len: int) -> np.dtype:
    """A proper-pair mate's BAM record (``BamRecord.pack``'s layout: bin 0,
    one cigar op, qualities absent, one ``NM:i`` tag), packed."""
    return np.dtype([
        ("block_size", "<i4"), ("refid", "<i4"), ("pos", "<i4"),
        ("l_read_name", "u1"), ("mapq", "u1"), ("bin", "<u2"),
        ("n_cigar", "<u2"), ("flag", "<u2"), ("l_seq", "<i4"),
        ("next_refid", "<i4"), ("next_pos", "<i4"), ("tlen", "<i4"),
        ("name", "u1", (name_len + 1,)), ("cigar", "<u4"),
        ("seq", "u1", (READ_LEN // 2,)), ("qual", "u1", (READ_LEN,)),
        ("tag", "u1", (3,)), ("nm", "<i4")])


def proper_pairs(ref: str, n: int, insert_size: int,
                 rng: np.random.Generator):
    """``n`` proper pairs drawn from ``rng`` over ``ref``, packed: (their
    mates' positions, sorted, and one record a row in that order).  Pair
    ``i`` is named ``pp<i>``; its fragment length is normal about
    ``insert_size`` with a tenth of it as deviation, held to [2 reads,
    2 inserts]."""
    chrom_len = len(ref)
    frag = np.clip(np.rint(rng.normal(insert_size, insert_size / 10, n)),
                   2 * READ_LEN, 2 * insert_size).astype(np.int64)
    a = rng.integers(0, chrom_len - frag + 1)
    b = a + frag - READ_LEN
    pos = np.concatenate([a, b])
    order = np.argsort(pos, kind="stable")
    width = len(str(max(n - 1, 0)))
    dt = record_dtype(2 + width)
    nt16 = np.zeros(256, np.uint8)
    for code, base in ((1, "A"), (2, "C"), (4, "G"), (8, "T")):
        nt16[ord(base)] = code
    codes = nt16[np.frombuffer(ref.encode(), np.uint8)]
    reads = np.lib.stride_tricks.sliding_window_view(codes, READ_LEN)
    rows = np.empty(2 * n, dt)
    for lo in range(0, 2 * n, CHUNK):
        idx = order[lo:lo + CHUNK]
        first = idx < n
        pair_id = np.where(first, idx, idx - n)
        r = rows[lo:lo + CHUNK]
        r["block_size"] = dt.itemsize - 4
        r["refid"] = 0
        r["pos"] = pos[idx]
        r["l_read_name"] = 3 + width
        r["mapq"] = 60
        r["bin"] = 0
        r["n_cigar"] = 1
        r["flag"] = np.where(
            first, FLAG_PAIRED | FLAG_PROPER | FLAG_READ1 | FLAG_MREVERSE,
            FLAG_PAIRED | FLAG_PROPER | FLAG_READ2 | FLAG_REVERSE)
        r["l_seq"] = READ_LEN
        r["next_refid"] = 0
        r["next_pos"] = np.where(first, b[pair_id], a[pair_id])
        r["tlen"] = np.where(first, 1, -1) * (frag[pair_id])
        name = r["name"]
        name[:, 0] = ord("p")
        name[:, 1] = ord("p")
        for k in range(width):
            name[:, 2 + k] = 48 + pair_id // 10 ** (width - 1 - k) % 10
        name[:, -1] = 0
        r["cigar"] = (READ_LEN << 4) | 0
        s = reads[pos[idx]]
        r["seq"] = (s[:, 0::2] << 4) | s[:, 1::2]
        r["qual"] = 0xFF
        r["tag"] = np.frombuffer(b"NMi", np.uint8)
        r["nm"] = 0
    return pos[order], rows.view(np.uint8).reshape(2 * n, dt.itemsize)


def build(g: dict, seed: int, d: str) -> Sample:
    chrom, chrom_len = g["chrom"], g["chrom_len"]
    rng = np.random.default_rng(seed)
    ref = random_seq(rng, chrom_len)
    plan = event_plan(g, rng)
    sim = Simulator(rng, insert_size=g["insert_size"])
    out = SimReads([], [], [])
    bd_lines = ["#chr1\tpos1\tori1\tchr2\tpos2\tori2\ttype\tsize\tscore"]
    extra = []
    for i, (kind, pos, size) in enumerate(plan):
        sim.reads_for_event(ref, chrom, Event(kind, chrom, pos, size=size),
                            g["reads_per_event"], out)
        bd_lines.append(f"{chrom}\t{pos}\t20+20-\t{chrom}\t{pos + size}"
                        f"\t18+19-\t{kind}\t{size}\t99")
        if kind == "DEL" and size >= g["rp_min_size"]:
            extra += flanking_pairs(f"rp{i}", ref, pos, size, g["rp_pairs"],
                                    rng)
    sim.ref_noise_reads(ref, chrom, chrom_len * g["noise_per_kb"] // 1000,
                        out)
    n_proper = chrom_len * g["proper_pair_depth"] // (2 * READ_LEN)
    bulk = (proper_pairs(ref, n_proper, g["insert_size"], rng)
            if n_proper else None)
    bd = os.path.join(d, "calls.bd")
    with open(bd, "w") as fh:
        fh.write("\n".join(bd_lines) + "\n")
    txt = os.path.join(d, "reads.txt")
    out.write(txt)
    bam = os.path.join(d, "reads.bam")
    pairs = text_to_bam(ref, chrom, txt, bam, extra, bulk)
    fa = write_ref(d, chrom, ref)
    cfg = write_cfg(d, bam, g["insert_size"])
    return Sample(dict(fa=fa, cfg=cfg, bd=bd, bam=bam), pairs,
                  ["-f", fa, "-i", cfg, "-b", bd])
