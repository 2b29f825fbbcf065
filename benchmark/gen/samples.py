"""The benchmark's sample generators: a configuration's ``generator``
parameters and a seed -> the files a pass reads.

Each layout is a module of its own, ``gen/<kind>.py``, found by the
``kind`` that the configuration's ``generator`` names: a new layout is a new
file.  Such a module has

* ``PARAMS``: the generator keys it reads besides ``kind``; a
  configuration that gives another key, or leaves one out, is refused;
* ``build(generator, seed, d) -> Sample``: writes the sample under ``d``.

The same seed gives the same bytes.  ``Sample`` holds the paths, the input
pairs of a pass (a pindel-text record counts as one pair: a read and its
mapped mate's position) and the CLI arguments that name the inputs.  The
helpers below are frozen copies of the port's scene builders
(``pindel_tpu_torch/testing/scenes.py``) with the seed as a parameter.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import os
from typing import Dict, List

from gen.bamwriter import BamRecord, make_fai, pair, write_bam
from gen.simulate import write_fasta

HERE = os.path.dirname(os.path.abspath(__file__))


@dataclasses.dataclass
class Sample:
    files: Dict[str, str]
    pairs: int
    argv: List[str]


def load(generator: dict, gen_dir: str = HERE):
    """The module ``gen_dir/<kind>.py`` of ``generator["kind"]``, once the
    generator's keys are checked against its ``PARAMS``."""
    kind = generator["kind"]
    path = os.path.join(gen_dir, kind + ".py")
    if not os.path.isfile(path):
        raise ValueError(f"no generator {kind!r}: {path} does not exist")
    spec = importlib.util.spec_from_file_location("generator_" + kind, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    given = set(generator) - {"kind"}
    if given != set(mod.PARAMS):
        raise ValueError(
            f"generator {kind!r} reads {sorted(mod.PARAMS)}; the "
            f"configuration gives {sorted(given)} (unknown "
            f"{sorted(given - set(mod.PARAMS))}, missing "
            f"{sorted(set(mod.PARAMS) - given)})")
    return mod


def build(generator: dict, seed: int, d: str, gen_dir: str = HERE) -> Sample:
    """The sample of ``generator`` (a configuration's ``generator``) for
    ``seed``, written under ``d``."""
    return load(generator, gen_dir).build(generator, seed, d)


# ------------------------------------------------------- shared by layouts
def write_ref(d: str, chrom: str, ref: str) -> str:
    fa = os.path.join(d, "ref.fa")
    write_fasta(fa, [(chrom, ref)])
    make_fai(fa)
    return fa


def write_cfg(d: str, bam: str, insert_size: int) -> str:
    cfg = os.path.join(d, "bam.cfg")
    with open(cfg, "w") as fh:
        fh.write(f"{bam}\t{insert_size}\tS1\n")
    return cfg


def text_records(ref: str, txt: str) -> List[BamRecord]:
    """The anchored pairs (mapped anchor, unmapped split mate) of the
    pindel-text reads in ``txt``, in file order; reads whose anchor would
    leave the chromosome are dropped."""
    with open(txt) as fh:
        lines = fh.read().splitlines()
    recs = []
    for i in range(0, len(lines), 3):
        name, seq, meta = lines[i], lines[i + 1], lines[i + 2].split()
        dstr, pos, mq = meta[0], int(meta[2]), int(meta[3])
        anchor_pos = pos if dstr == "+" else pos - 100
        if anchor_pos < 0 or anchor_pos + 100 > len(ref):
            continue
        recs.extend(pair(name[1:-2], anchor_pos, seq, ref,
                         anchor_reverse=(dstr == "-"), mapq=mq))
    return recs


def text_to_bam(ref: str, chrom: str, txt: str, bam: str,
                extra=(), bulk=None) -> int:
    """Pindel-text reads -> a coordinate-sorted BAM of anchored pairs plus
    the ``extra`` records and the packed ``bulk`` ones (``write_bam``);
    returns the number of pairs."""
    recs = list(extra) + text_records(ref, txt)
    recs.sort(key=lambda r: r.pos)
    write_bam(bam, [(chrom, len(ref))], recs, bulk)
    n_bulk = 0 if bulk is None else len(bulk[0])
    return (len(recs) + n_bulk) // 2
