"""Somatic indel filter: tumor/normal post-filter over pindel reports.

Re-implements ``somatic_filter/somatic_indelfilter.pl`` (GenomeVIP):

1. read a ``key = value`` config (keys matched by their last dot-separated
   component, values space-stripped);
2. filter the concatenated ``ChrID`` summary lines from ``_D``/``_SI``
   (normal sample first, tumor second): per-sample coverage columns
   >= cov on both strands, zero variant support in the normal, and
   tumor VAF >= vaf against both strand coverages;
3. convert survivors with the pindel2vcf equivalent;
4. keep VCF records with HOMLEN <= hom.

Usage: ``python -m pindel_tpu.somatic <config>`` (same config format as
the reference; the ``indel.filter.pindel2vcf`` key is accepted but
ignored — the in-process converter is used).
"""
from __future__ import annotations

import sys
import tempfile
from typing import Dict, List


def read_config(path: str) -> Dict[str, str]:
    """Config parse quirks preserved (somatic_indelfilter.pl:22): split
    on '=', take only the second field, strip spaces from key and value,
    key reduced to its last '.' component."""
    out: Dict[str, str] = {}
    with open(path) as fh:
        for line in fh:
            line = line.rstrip("\n")
            fields = line.split("=")
            if len(fields) < 2:
                continue
            key = fields[0].replace(" ", "").split(".")[-1]
            out[key] = fields[1].replace(" ", "")
    return out


def filter_summary_lines(lines, cov: float, vaf: float) -> List[str]:
    """The per-line column filter (somatic_indelfilter.pl:36-46).

    Columns (0-based split on whitespace) for a two-sample report:
    32/33 normal +/− strand coverage, 34/36 normal support up/down,
    39/40 tumor strand coverage, 41/43 tumor support.  The trailing
    event-type condition is kept literally (I, or D with any NT size).
    """
    kept: List[str] = []
    for line in lines:
        t = line.split()
        if len(t) < 44:
            continue
        n_cov_p = float(t[32]) + float(t[34]) + float(t[36])
        n_cov_m = float(t[33]) + float(t[34]) + float(t[36])
        t_cov_p = float(t[39]) + float(t[41]) + float(t[43])
        t_cov_m = float(t[40]) + float(t[41]) + float(t[43])
        if not (n_cov_p >= cov and n_cov_m >= cov
                and t_cov_p >= cov and t_cov_m >= cov):
            continue
        n_support = float(t[34]) + float(t[36])
        t_support = float(t[41]) + float(t[43])
        if not (n_support == 0 and t_cov_p and t_cov_m
                and t_support / t_cov_p >= vaf
                and t_support / t_cov_m >= vaf):
            continue
        if (t[1] == "I" or (t[1] == "D" and float(t[4]) == 0)
                or (t[1] == "D" and float(t[4]) > 0)):
            kept.append(line.rstrip("\n"))
    return kept


def run(config_path: str) -> int:
    paras = read_config(config_path)
    with open(paras["input"]) as fh:
        kept = filter_summary_lines(fh, float(paras["cov"]),
                                    float(paras["vaf"]))
    with tempfile.NamedTemporaryFile("w", suffix=".pindel",
                                     delete=False) as tf:
        tf.write("\n".join(kept) + ("\n" if kept else ""))
        nocomplex = tf.name
    with tempfile.NamedTemporaryFile("w", suffix=".vcf",
                                     delete=False) as tf:
        vcf_tmp = tf.name
    from pindel_tpu_torch.pindel2vcf import main as p2v_main
    rc = p2v_main(["-R", paras["referencename"], "-r", paras["reference"],
                   "-p", nocomplex, "-d", paras["referencedate"],
                   "-v", vcf_tmp])
    if rc != 0:
        return rc
    hom = float(paras["hom"])
    with open(paras["output"], "w") as out, open(vcf_tmp) as vcf:
        for line in vcf:
            sys.stdout.write(line)          # the Perl prints every line
            if line.startswith("#"):
                out.write(line)
                continue
            info = line.split("\t")[7]
            for field in info.split(";"):
                if field.startswith("HOMLEN"):
                    if float(field.split("=")[1]) <= hom:
                        out.write(line)
                    break
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print("usage: python -m pindel_tpu.somatic <config>",
              file=sys.stderr)
        return 2
    return run(argv[0])


if __name__ == "__main__":
    sys.exit(main())
