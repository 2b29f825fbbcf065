"""The ``text`` layout: ``standard_scene`` (scene 1's generator) written as
a FASTA and a pindel-format read file: ``events_per_kind`` events of each
of ``kinds`` spread over ``chrom_len`` bases, ``reads_per_event`` split
reads each, and ``n_noise`` reads of the reference."""
from __future__ import annotations

import os

from gen.samples import Sample
from gen.simulate import standard_scene, write_fasta

PARAMS = ("chrom", "chrom_len", "kinds", "events_per_kind",
          "reads_per_event", "n_noise", "insert_size")


def build(g: dict, seed: int, d: str) -> Sample:
    chrom = g["chrom"]
    ref, _events, reads = standard_scene(
        seed=seed, chrom_len=g["chrom_len"],
        kinds=list(g["kinds"]) * g["events_per_kind"],
        reads_per_event=g["reads_per_event"], n_noise=g["n_noise"],
        chrom=chrom, insert_size=g["insert_size"])
    fa = os.path.join(d, "ref.fa")
    write_fasta(fa, [(chrom, ref)])
    txt = os.path.join(d, "reads.txt")
    reads.write(txt)
    return Sample(dict(fa=fa, reads=txt), len(reads.names),
                  ["-f", fa, "-p", txt])
