"""Synthetic SV + split-read simulator (pindel-format output).

Generates a random reference, plants structural variants, and samples
split reads crossing each breakpoint the way a real aligner's unmapped
mates present to Pindel: one mate anchors near the event
(``MatchedD``/``MatchedRelPos``), the other is the breakpoint-crossing
sequence (RC-stored for '+' anchors, as in the reference's read intake,
reader.cpp:860-868).

A copy of ``pindel_tpu/testing/simulate.py``, so that the port builds its
scenes without importing the JAX package (the GPU machine has no jax).
tests/test_torch_pipeline.py holds the two to byte-identical output.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
COMP = {"A": "T", "C": "G", "G": "C", "T": "A", "N": "N"}


def rc(s: str) -> str:
    return "".join(COMP[c] for c in reversed(s))


def random_seq(rng: np.random.Generator, n: int) -> str:
    return bytes(BASES[rng.integers(0, 4, size=n)]).decode()


@dataclasses.dataclass
class Event:
    """Planted ground-truth SV.

    ``pos``: 0-based reference position of the left breakpoint (last
    reference base before the event is ``pos - 1``).
    """

    kind: str                # DEL | SI | DI | INV | TD | LI
    chrom: str
    pos: int
    size: int = 0            # deleted/inverted/duplicated reference span
    nt: str = ""             # inserted (non-template) sequence


@dataclasses.dataclass
class SimReads:
    names: List[str]
    seqs: List[str]
    metas: List[Tuple[str, str, int, int, int, str]]  # d, chr, pos, mq, ins, tag

    def write(self, path: str) -> None:
        with open(path, "w") as fh:
            for name, seq, meta in zip(self.names, self.seqs, self.metas):
                d, ch, pos, mq, ins, tag = meta
                fh.write(f"@{name}\n{seq}\n{d}\t{ch}\t{pos}\t{mq}\t{ins}\t{tag}\n")


class Simulator:
    def __init__(self, rng: np.random.Generator, read_len: int = 100,
                 insert_size: int = 500, tag: str = "S1", mq: int = 60):
        self.rng = rng
        self.read_len = read_len
        self.insert_size = insert_size
        self.tag = tag
        self.mq = mq
        self._counter = 0

    # ----------------------------------------------------------- genome
    def make_alt(self, ref: str, ev: Event) -> Tuple[str, int]:
        """(ALT sequence, ALT coordinate of the left breakpoint)."""
        p, sz = ev.pos, ev.size
        if ev.kind == "DEL":
            return ref[:p] + ref[p + sz:], p
        if ev.kind in ("SI", "LI"):
            return ref[:p] + ev.nt + ref[p:], p
        if ev.kind == "DI":
            return ref[:p] + ev.nt + ref[p + sz:], p
        if ev.kind == "INV":
            mid = rc(ref[p:p + sz])
            return ref[:p] + ev.nt + mid + ref[p + sz:], p
        if ev.kind == "TD":
            dup = ref[p:p + sz]
            return ref[:p + sz] + ev.nt + dup + ref[p + sz:], p + sz
        raise ValueError(ev.kind)

    # ------------------------------------------------------------ reads
    def reads_for_event(self, ref: str, chrom: str, ev: Event,
                        n_reads: int, out: SimReads,
                        min_flank: int = 35) -> None:
        """Sample breakpoint-crossing reads from the ALT haplotype."""
        alt, bp_alt = self.make_alt(ref, ev)
        L = self.read_len
        if ev.kind == "LI":
            # the insertion is longer than a read: '+'-anchored mates cross
            # the LEFT breakpoint, '-'-anchored mates the RIGHT breakpoint,
            # and neither can find a far end — the LI pileup signature
            for k in range(n_reads):
                flank = int(self.rng.integers(min_flank, L - min_flank))
                gap = int(self.rng.integers(60, self.insert_size - L - 10))
                self._counter += 1
                name = f"sim_LI_{ev.pos}_{self._counter}/1"
                if k % 2 == 0:
                    start_alt = bp_alt - flank
                    if start_alt < 0 or start_alt + L > len(alt):
                        continue
                    frag = alt[start_alt:start_alt + L]
                    pos = max(ev.pos - flank - gap, 1) + 1
                    out.names.append(name)
                    out.seqs.append(rc(frag))
                    out.metas.append(("+", chrom, pos, self.mq,
                                      self.insert_size, self.tag))
                else:
                    rb = bp_alt + len(ev.nt)
                    start_alt = rb - (L - flank)
                    if start_alt < 0 or start_alt + L > len(alt):
                        continue
                    frag = alt[start_alt:start_alt + L]
                    pos = ev.pos + flank + gap + 1
                    out.names.append(name)
                    out.seqs.append(frag)
                    out.metas.append(("-", chrom, pos, self.mq,
                                      self.insert_size, self.tag))
            return
        for _ in range(n_reads):
            flank_left = int(self.rng.integers(min_flank, L - min_flank))
            start_alt = bp_alt - flank_left
            if start_alt < 0 or start_alt + L > len(alt):
                continue
            frag = alt[start_alt:start_alt + L]
            # reference coordinate where the read's LEFT part starts
            r0 = ev.pos - flank_left          # 0-based ref coord
            # reference coordinate where the read's RIGHT part ends
            if ev.kind == "DEL" or ev.kind == "DI":
                r1 = ev.pos + ev.size + (L - flank_left - len(ev.nt))
            elif ev.kind in ("SI", "LI"):
                r1 = ev.pos + (L - flank_left - len(ev.nt))
            elif ev.kind == "INV":
                r1 = ev.pos + ev.size  # right part is inverted span
            elif ev.kind == "TD":
                r0 = ev.pos + ev.size - flank_left
                r1 = ev.pos + (L - flank_left - len(ev.nt))
            else:
                raise ValueError(ev.kind)
            self._counter += 1
            name = f"sim_{ev.kind}_{ev.pos}_{self._counter}/1"
            if self.rng.random() < 0.5:
                # '+' anchor upstream of the read; stored seq is RC
                gap = int(self.rng.integers(60, self.insert_size - L - 10))
                pos = max(r0 - gap, 1) + 1     # 1-based
                out.names.append(name)
                out.seqs.append(rc(frag))
                out.metas.append(("+", chrom, pos, self.mq,
                                  self.insert_size, self.tag))
            else:
                # '-' anchor downstream; stored seq as-is
                gap = int(self.rng.integers(60, self.insert_size - L - 10))
                pos = r1 + gap + 1
                out.names.append(name)
                out.seqs.append(frag)
                out.metas.append(("-", chrom, pos, self.mq,
                                  self.insert_size, self.tag))

    def ref_noise_reads(self, ref: str, chrom: str, n: int,
                        out: SimReads) -> None:
        """Fully-reference reads (should map close end, find trivial far)."""
        L = self.read_len
        for _ in range(n):
            r0 = int(self.rng.integers(200, len(ref) - L - 600))
            frag = ref[r0:r0 + L]
            self._counter += 1
            name = f"sim_ref_{r0}_{self._counter}/1"
            if self.rng.random() < 0.5:
                gap = int(self.rng.integers(60, self.insert_size - L - 10))
                out.names.append(name)
                out.seqs.append(rc(frag))
                out.metas.append(("+", chrom, max(r0 - gap, 1) + 1,
                                  self.mq, self.insert_size, self.tag))
            else:
                gap = int(self.rng.integers(60, self.insert_size - L - 10))
                out.names.append(name)
                out.seqs.append(frag)
                out.metas.append(("-", chrom, r0 + L + gap + 1,
                                  self.mq, self.insert_size, self.tag))


def standard_scene(seed: int = 0, chrom_len: int = 60_000,
                   reads_per_event: int = 8,
                   kinds: Optional[List[str]] = None,
                   chrom: str = "chrT",
                   n_noise: int = 10,
                   insert_size: int = 500,
                   ) -> Tuple[str, List[Event], SimReads]:
    """A reference + planted events + reads; deterministic per seed."""
    rng = np.random.default_rng(seed)
    ref = random_seq(rng, chrom_len)
    sim = Simulator(rng, insert_size=insert_size)
    kinds = kinds or ["DEL", "SI", "DEL", "DI", "INV", "TD", "DEL", "SI"]
    events: List[Event] = []
    out = SimReads([], [], [])
    slot = chrom_len // (len(kinds) + 2)
    for i, kind in enumerate(kinds):
        pos = slot * (i + 1) + int(rng.integers(0, slot // 4))
        if kind == "DEL":
            ev = Event("DEL", chrom, pos, size=int(rng.integers(10, 2000)))
        elif kind == "SI":
            ev = Event("SI", chrom, pos, nt=random_seq(rng, int(rng.integers(1, 16))))
        elif kind == "DI":
            ev = Event("DI", chrom, pos, size=int(rng.integers(20, 500)),
                       nt=random_seq(rng, int(rng.integers(3, 20))))
        elif kind == "INV":
            ev = Event("INV", chrom, pos, size=int(rng.integers(60, 1500)))
        elif kind == "TD":
            ev = Event("TD", chrom, pos, size=int(rng.integers(60, 1500)))
        elif kind == "LI":
            ev = Event("LI", chrom, pos, nt=random_seq(rng, 400))
        else:
            raise ValueError(kind)
        events.append(ev)
        sim.reads_for_event(ref, chrom, ev, reads_per_event, out)
    if n_noise:
        sim.ref_noise_reads(ref, chrom, n_noise, out)
    return ref, events, out


def write_fasta(path: str, chroms: List[Tuple[str, str]],
                width: int = 70) -> None:
    with open(path, "w") as fh:
        for name, seq in chroms:
            fh.write(f">{name}\n")
            for i in range(0, len(seq), width):
                fh.write(seq[i:i + width] + "\n")
