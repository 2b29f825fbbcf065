"""pindel2vcf4tcga-equivalent converter (TCGA-flavored VCF 4.1).

The reference binary (``pindel2vcf4tcga.cpp``, 2547 LoC) is a fork of
``pindel2vcf.cpp`` whose full delta is: a VCF 4.1 / TCGA 1.2 header with
``-C/--center`` metadata and a vcfProcessLog line (:735-787), the
``TYPEOFSV`` INFO key (:1608), the ``GT:DP:BQ:SS:AD`` sample format via
``getSampleDataOfEvent`` (:1021-1030, :1620-1625), and the re-enabled
``-so/--somatic_p`` Fisher filter flag (:2077-2078).  Everything else is
byte-for-byte the same converter, so this module drives
``pindel_tpu.pindel2vcf`` with its ``tcga`` mode.
"""
from __future__ import annotations

import sys

from pindel_tpu_torch.pindel2vcf import main as _p2v_main


def main(argv=None) -> int:
    return _p2v_main(argv, tcga=True)


if __name__ == "__main__":
    sys.exit(main())
