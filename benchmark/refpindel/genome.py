"""Reference genome model.

Each chromosome is held as an int8 code array padded with SPACER ``N`` codes on
both sides, mirroring the reference's coordinate convention
(``g_SpacerBeforeAfter`` = 100000, pindel.h:122; ``Genome::loadChromosome``
pindel.cpp:272-312: uppercase, non-ACGT -> N, spacer concatenated).  All
"absolute" positions used by the kernels include the spacer offset.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from refpindel import dna

SPACER = 100_000


@dataclasses.dataclass
class Chromosome:
    name: str
    seq: np.ndarray          # int8 codes, spacer-padded
    index: int = 0

    @property
    def comp_size(self) -> int:
        """Padded size (reference Chromosome::getCompSize)."""
        return int(self.seq.shape[0])

    @property
    def biol_size(self) -> int:
        """Biological size (reference Chromosome::getBiolSize)."""
        return self.comp_size - 2 * SPACER

    def seq_str(self, start: int, length: int) -> str:
        """ASCII slice in padded (computational) coordinates."""
        return dna.decode(self.seq[start:start + length])


class Genome:
    """Whole-genome container, loads a FASTA fully into RAM.

    Reference: Genome::loadAll, pindel.cpp:237-245.
    """

    def __init__(self) -> None:
        self.chromosomes: List[Chromosome] = []
        self._by_name: Dict[str, Chromosome] = {}

    @classmethod
    def from_fasta(cls, path: str) -> "Genome":
        g = cls()
        name: Optional[str] = None
        chunks: List[str] = []

        def flush() -> None:
            if name is not None:
                g.add(name, "".join(chunks))
            chunks.clear()

        opener = open
        if path.endswith(".gz"):
            import gzip
            opener = gzip.open  # type: ignore[assignment]
        with opener(path, "rt") as fh:
            data = fh.read()
        if data.startswith(">"):
            # batch path: records split at line-initial '>' only, so a
            # '>' inside a header description cannot split a record
            for block in data[1:].split("\n>"):
                nl = block.find("\n")
                if nl < 0:
                    continue
                name = block[:nl].split()[0]
                g.add(name, block[nl:].replace("\n", "").replace("\r", ""))
            return g
        for line in data.split("\n"):
            line = line.strip()
            if not line:
                continue
            if line.startswith(">"):
                flush()
                name = line[1:].split()[0]
            else:
                chunks.append(line)
        flush()
        return g

    def add(self, name: str, sequence: str) -> Chromosome:
        codes = dna.encode(sequence)
        padded = np.full(codes.shape[0] + 2 * SPACER, dna.N, dtype=np.int8)
        padded[SPACER:SPACER + codes.shape[0]] = codes
        chrom = Chromosome(name=name, seq=padded, index=len(self.chromosomes))
        self.chromosomes.append(chrom)
        self._by_name[name] = chrom
        return chrom

    def get(self, name: str) -> Optional[Chromosome]:
        return self._by_name.get(name)

    def chr_id(self, name: str) -> int:
        chrom = self._by_name.get(name)
        return chrom.index if chrom is not None else -1

    def __iter__(self):
        return iter(self.chromosomes)

    def __len__(self) -> int:
        return len(self.chromosomes)
