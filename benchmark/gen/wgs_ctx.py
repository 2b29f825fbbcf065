"""The ``wgs_ctx`` layout: one sample's whole-genome BAM over several
contigs with BreakDancer calls that include translocations (CTX), in the
shape of ``build_scene4`` (``pindel_tpu_torch/testing/scenes.py``), with
proper pairs at ``proper_pair_depth`` and a workload that does not change
with the seed.

``chroms`` are (name, length) contigs of random sequence; the first
``read_chroms`` get reads, the others none.  Each contig with reads gets
scene 3's local events, one every ``event_spacing`` bases from 50 kb, kinds
DEL, SI, DI, INV, TD in turn, ``reads_per_event`` split reads each as
anchored pairs (mapped anchor, unmapped split mate), ``rp_pairs``
discordant pairs around each DEL of ``rp_min_size`` bases or more,
``noise_per_kb`` reference-matching anchored pairs per kb, and a
BreakDancer line an event; the two events nearest each ``window``
boundary are a DEL and an INV of ``boundary_size`` bases that start 2 kb
before it.  ``translocations`` join each pair of ``translocation_pairs``
(a -> b), each between two local events on either contig:
``translocation_reads`` split reads anchored upstream of the breakpoint on
a whose other part lies on b, and a CTX line.  On top of them proper pairs
cover the contigs with reads at ``proper_pair_depth`` (both mates mapped,
100M, NM 0, fragments about ``insert_size``: ``bam_bd.proper_pairs``).

What the seed moves: the bases, the order of the events along a contig,
their positions (by up to ``JITTER`` bases), the breakpoints that follow
from them, and the reads' own draws.  What it does not: the multiset of
event kinds and sizes, drawn once from ``size_seed``; the boundary events;
every read and pair count; and the reads anchored within ``ctx_reach``
bases of a CTX breakpoint, which are the translocation reads alone, since
noise and proper pairs are kept out of those reaches and every local
event lies farther away.  So the far-end rounds, the discordant pairs and
the reads that take the cross-chromosome route are the same work for
every seed.
"""
from __future__ import annotations

import json
import os
import struct
from typing import Dict, List, Tuple

import numpy as np

from gen.bam_bd import (READ_LEN, flanking_pairs, proper_pairs,
                        record_dtype)
from gen.bamwriter import (FLAG_UNMAP, BamRecord, bgzf_compress, make_fai,
                           pair)
from gen.samples import Sample, text_records, write_cfg
from gen.simulate import (Event, SimReads, Simulator, random_seq, rc,
                          write_fasta)

PARAMS = ("chroms", "read_chroms", "window", "event_spacing",
          "boundary_size", "reads_per_event", "rp_min_size", "rp_pairs",
          "noise_per_kb", "translocation_pairs", "translocations",
          "translocation_reads", "ctx_reach", "insert_size",
          "proper_pair_depth", "size_seed")

KINDS = ("DEL", "SI", "DI", "INV", "TD")
# how far the seed moves an event from its slot, in bases
JITTER = 2_000
# first letters of the proper pairs' names, one pair of them a stretch
LETTERS = "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"


def slots(g: dict, length: int) -> Tuple[List[int], List[int], List[int]]:
    """A contig's event slots: their positions, the windows' boundaries,
    and the two slots nearest each boundary (in slot order), which hold the
    boundary events."""
    n_events = length // g["event_spacing"]
    n = len(KINDS) * (n_events // len(KINDS))
    step = (length - 100_000) / n
    pos = [50_000 + int(i * step) for i in range(n)]
    bounds = list(range(g["window"], length, g["window"]))
    near = []
    for b in bounds:
        near += sorted(sorted(range(n), key=lambda i: abs(pos[i] - b))[:2])
    return pos, bounds, near


def size_plan(g: dict) -> Dict[str, List[Tuple[str, int]]]:
    """contig -> (kind, size) of its free slots, in slot order, from
    ``size_seed`` alone (scene 3's draws: 60-2,499 bases, SI 3-19)."""
    rng = np.random.default_rng(g["size_seed"])
    out = {}
    for name, length in g["chroms"][:g["read_chroms"]]:
        pos, _bounds, near = slots(g, length)
        plan = []
        for i in range(len(pos)):
            kind = KINDS[i % len(KINDS)]
            size = int(rng.integers(60, 2500)) if kind != "SI" else \
                int(rng.integers(3, 20))
            if i not in near:
                plan.append((kind, size))
        out[name] = plan
    return out


def event_plan(g: dict, length: int, sizes: List[Tuple[str, int]],
               rng: np.random.Generator) -> List[Tuple[str, int, int, bool]]:
    """A contig's events as (kind, pos, size, at a boundary), in position
    order: ``sizes`` shuffled over the free slots, each moved by up to
    ``JITTER`` bases, and a DEL and an INV of ``boundary_size`` starting
    2 kb before each boundary."""
    pos, bounds, near = slots(g, length)
    order = rng.permutation(len(sizes))
    free = [i for i in range(len(pos)) if i not in near]
    plan = []
    for slot, k in zip(free, order.tolist()):
        kind, size = sizes[k]
        plan.append((kind, pos[slot] + int(rng.integers(-JITTER,
                                                        JITTER + 1)),
                     size, False))
    for b in bounds:
        for kind in ("DEL", "INV"):
            plan.append((kind, b - 2_000, g["boundary_size"], True))
    plan.sort(key=lambda e: e[1])
    return plan


def breakpoints(plan, n: int, phase: int) -> List[int]:
    """``n`` positions midway between consecutive events of ``plan`` (the
    end of one, the start of the next), spread over the contig and never
    beside a boundary event; ``phase`` 1 and 3 give two sets that do not
    meet (``_gap_middles`` of scene 4)."""
    gaps = [i for i in range(len(plan) - 1)
            if not plan[i][3] and not plan[i + 1][3]]
    out = []
    for k in range(n):
        i = gaps[(4 * k + phase) * (len(gaps) - 1) // (4 * n)]
        _kind, pos, size, _b = plan[i]
        out.append((pos + size + plan[i + 1][1]) // 2)
    return out


def outside(lo: int, hi: int, keep_out: List[Tuple[int, int]]) -> bool:
    """Whether [lo, hi) meets none of the ``keep_out`` stretches."""
    return all(hi <= a or lo >= b for a, b in keep_out)


def noise_reads(sim: Simulator, ref: str, chrom: str, n: int,
                keep_out: List[Tuple[int, int]], out: SimReads) -> None:
    """``Simulator.ref_noise_reads``'s ``n`` reference reads, a draw that
    would put a read or its anchor in ``keep_out`` drawn again."""
    L = READ_LEN
    while n:
        r0 = int(sim.rng.integers(200, len(ref) - L - 600))
        plus = sim.rng.random() < 0.5
        gap = int(sim.rng.integers(60, sim.insert_size - L - 10))
        anchor = max(r0 - gap, 1) if plus else r0 + L + gap
        if not outside(min(r0, anchor) - L, max(r0, anchor) + 2 * L,
                       keep_out):
            continue
        sim._counter += 1
        out.names.append(f"sim_ref_{r0}_{sim._counter}/1")
        out.seqs.append(rc(ref[r0:r0 + L]) if plus else ref[r0:r0 + L])
        out.metas.append(("+" if plus else "-", chrom, anchor + 1,
                          sim.mq, sim.insert_size, sim.tag))
        n -= 1


def stretches(length: int, keep_out: List[Tuple[int, int]],
              n_pairs: int) -> List[Tuple[int, int, int]]:
    """The contig less ``keep_out`` as (start, end, pairs): ``n_pairs``
    shared by length, largest remainders first, so the total never moves."""
    cuts, lo = [], 0
    for a, b in sorted(keep_out):
        if a > lo:
            cuts.append((lo, a))
        lo = max(lo, b)
    if lo < length:
        cuts.append((lo, length))
    total = sum(b - a for a, b in cuts)
    share = [n_pairs * (b - a) / total for a, b in cuts]
    n = [int(s) for s in share]
    for i in sorted(range(len(cuts)), key=lambda i: n[i] - share[i])[
            :n_pairs - sum(n)]:
        n[i] += 1
    return [(a, b, k) for (a, b), k in zip(cuts, n)]


def stretch_pairs(ref: str, tid: int, lo: int, hi: int, n: int, code: int,
                  insert_size: int, rng: np.random.Generator):
    """``proper_pairs``'s ``n`` pairs over ``ref[lo:hi]`` moved to
    reference ``tid`` at ``lo``, their names starting with two letters of
    their own (``code``), so no two stretches share a name: (positions,
    packed rows)."""
    pos, rows = proper_pairs(ref[lo:hi], n, insert_size, rng)
    width = len(str(max(n - 1, 0)))
    rec = rows.reshape(-1).view(record_dtype(2 + width))
    rec["refid"] = tid
    rec["next_refid"] = tid
    rec["pos"] += lo
    rec["next_pos"] += lo
    rec["name"][:, 0] = ord(LETTERS[code // len(LETTERS)])
    rec["name"][:, 1] = ord(LETTERS[code % len(LETTERS)])
    return pos + lo, rows


def on_reference(tid: int, recs) -> List[BamRecord]:
    """``recs`` (built on reference 0) moved to reference ``tid``, mates
    included."""
    for r in recs:
        r.tid = r.mate_tid = tid
    return list(recs)


def write_bam(path: str, refs, per_tid) -> None:
    """A coordinate-sorted BAM: ``per_tid`` holds, for each reference, its
    records sorted by position and its packed proper pairs as (positions,
    rows) stretches in position order, merged in by position before the
    records of the same position (``bamwriter.write_bam`` over several
    references)."""
    text = b"@HD\tVN:1.6\tSO:coordinate\n" + b"".join(
        f"@SQ\tSN:{n}\tLN:{ln}\n".encode() for n, ln in refs)
    head = bytearray(b"BAM\x01" + struct.pack("<i", len(text)) + text)
    head += struct.pack("<i", len(refs))
    for name, length in refs:
        nm = name.encode() + b"\0"
        head += struct.pack("<i", len(nm)) + nm + struct.pack("<i", length)
    parts = [bytes(head)]
    for records, bulk in per_tid:
        pos = np.concatenate([p for p, _ in bulk] or [np.zeros(0, int)])
        ends = np.concatenate([[0]] + [np.full(rows.shape[0], rows.shape[1])
                                       for _, rows in bulk]).cumsum()
        flat = memoryview(b"".join(np.ascontiguousarray(rows).tobytes()
                                   for _, rows in bulk))
        cut = np.searchsorted(pos, [r.pos for r in records], side="right")
        done = 0
        for rec, at in zip(records, cut.tolist()):
            parts.append(flat[ends[done]:ends[at]])
            parts.append(rec.pack())
            done = at
        parts.append(flat[ends[done]:])
    with open(path, "wb") as fh:
        fh.write(bgzf_compress(b"".join(parts)))


def build(g: dict, seed: int, d: str) -> Sample:
    rng = np.random.default_rng(seed)
    chroms = [(name, int(length)) for name, length in g["chroms"]]
    tids = {name: tid for tid, (name, _) in enumerate(chroms)}
    refs = {name: random_seq(rng, length) for name, length in chroms}
    sizes = size_plan(g)
    plans = {name: event_plan(g, length, sizes[name], rng)
             for name, length in chroms[:g["read_chroms"]]}
    reach = g["ctx_reach"]
    # the CTX calls' two breakpoints each
    calls = []
    for a, b in g["translocation_pairs"]:
        calls += zip([a] * g["translocations"], breakpoints(
            plans[a], g["translocations"], 1), [b] * g["translocations"],
            breakpoints(plans[b], g["translocations"], 3))
    keep_out = {name: [] for name, _ in chroms}
    for a, bp_a, b, bp_b in calls:
        keep_out[a].append((bp_a - reach, bp_a + reach + 1))
        keep_out[b].append((bp_b - reach, bp_b + reach + 1))
    sim = Simulator(rng, insert_size=g["insert_size"])
    bd_lines = ["#chr1\tpos1\tori1\tchr2\tpos2\tori2\ttype\tsize\tscore"]
    records: Dict[str, List[BamRecord]] = {name: [] for name, _ in chroms}
    for name, length in chroms[:g["read_chroms"]]:
        ref = refs[name]
        out = SimReads([], [], [])
        for i, (kind, pos, size, _b) in enumerate(plans[name]):
            if not outside(pos - 1_000, pos + size + 1_000, keep_out[name]):
                raise ValueError(f"{name}: the event at {pos} lies within "
                                 f"reach of a CTX breakpoint")
            sim.reads_for_event(ref, name, Event(kind, name, pos, size=size),
                                g["reads_per_event"], out)
            bd_lines.append(f"{name}\t{pos}\t20+20-\t{name}\t{pos + size}"
                            f"\t18+19-\t{kind}\t{size}\t99")
            if kind == "DEL" and size >= g["rp_min_size"]:
                records[name] += on_reference(tids[name], flanking_pairs(
                    f"rp_{name}_{i}", ref, pos, size, g["rp_pairs"], rng))
        noise_reads(sim, ref, name, length * g["noise_per_kb"] // 1000,
                    keep_out[name], out)
        txt = os.path.join(d, f"reads_{name}.txt")
        out.write(txt)
        records[name] += on_reference(tids[name], text_records(ref, txt))
        os.remove(txt)
    n_trans = g["translocation_reads"]
    for k, (a, bp_a, b, bp_b) in enumerate(calls):
        for j in range(n_trans):
            # a's left flank, then b from its breakpoint on
            flank = int(rng.integers(40, 60))
            frag = refs[a][bp_a - flank:bp_a] + \
                refs[b][bp_b:bp_b + READ_LEN - flank]
            gap = int(rng.integers(60, 300))
            records[a] += on_reference(tids[a], pair(
                f"t_{a}_{b}_{k}_{j}", bp_a - flank - gap - READ_LEN,
                rc(frag), refs[a]))
        bd_lines.append(f"{a}\t{bp_a}\t{n_trans}+0-\t{b}\t{bp_b}"
                        f"\t0+{n_trans}-\tCTX\t-1\t99")
    per_tid, n_proper, code = [], 0, 0
    for name, length in chroms:
        recs = sorted(records[name], key=lambda r: r.pos)
        bulk = []
        if tids[name] < g["read_chroms"]:
            n = length * g["proper_pair_depth"] // (2 * READ_LEN)
            for lo, hi, k in stretches(length, keep_out[name], n):
                if k:
                    bulk.append(stretch_pairs(refs[name], tids[name], lo, hi,
                                              k, code, g["insert_size"], rng))
                    code += 1
                    n_proper += k
        per_tid.append((recs, bulk))
    ends = [(tids[a], bp_a) for a, bp_a, _b, _p in calls] + \
        [(tids[b], bp_b) for _a, _p, b, bp_b in calls]
    ctx_reads = sum(not r.flag & FLAG_UNMAP and any(
        r.tid == tid and abs(r.pos - bp) <= reach for tid, bp in ends)
        for recs, _bulk in per_tid for r in recs)
    pairs = sum(len(recs) for recs, _bulk in per_tid) // 2 + n_proper
    fa = os.path.join(d, "ref.fa")
    write_fasta(fa, [(name, refs[name]) for name, _ in chroms])
    make_fai(fa)
    bam = os.path.join(d, "reads.bam")
    write_bam(bam, chroms, per_tid)
    bd = os.path.join(d, "calls.bd")
    with open(bd, "w") as fh:
        fh.write("\n".join(bd_lines) + "\n")
    layout = os.path.join(d, "layout.json")
    with open(layout, "w") as fh:
        json.dump(dict(pairs=pairs, proper_pairs=n_proper,
                       ctx_calls=len(calls), ctx_reads=ctx_reads,
                       events=sum(len(p) for p in plans.values())), fh)
    cfg = write_cfg(d, bam, g["insert_size"])
    return Sample(dict(fa=fa, cfg=cfg, bd=bd, bam=bam, layout=layout),
                  pairs, ["-f", fa, "-i", cfg, "-b", bd])
