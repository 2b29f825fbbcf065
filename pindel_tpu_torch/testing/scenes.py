"""The scenes the port is checked on, shared by tests/test_torch_pipeline.py
and chip_smoke.py.

``SMALL_SCENES`` are simulated scenes small enough for the NumPy reference.
``golden_reports.json`` holds, for each of them, the report files that
``pindel_tpu``'s NumPy backend writes with ``-s`` and the scene's flags:
the GPU machine has no jax, so the port's reports are compared there with
these bytes.  tests/test_torch_pipeline.py keeps them equal to the JAX
package's output and rewrites them with
``PYTHONPATH=. python tests/test_torch_pipeline.py --write-golden``.
``SCENE1`` is scene 1 of bench.py.
"""
from __future__ import annotations

import json
import os
from typing import Dict

from pindel_tpu_torch.testing.simulate import standard_scene, write_fasta

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "golden_reports.json")

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
    "seed20_li": (dict(seed=20, chrom_len=60_000, reads_per_event=10,
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
