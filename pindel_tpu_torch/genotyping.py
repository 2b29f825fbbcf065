"""RP- and RD-based genotyping of externally supplied SVs (-g, with -Y).

Re-implements the semantics of the reference's genotyping module
(genotyping.cpp:39-380), whose call-site the reference ships disabled
(`main` exits immediately when -g is set, pindel.cpp:1733-1736).  Here
the path is live: ``do_genotyping`` consumes the -g SV list and writes
per-SV genotype lines.

Reference semantics reproduced:

* SV list format (genotyping.cpp:95-113): whitespace-separated records
  ``Type ChrA PosA CI_A ChrB PosB CI_B``; PosA/PosB swapped when on the
  same chromosome and out of order.
* DEL (genotyping.cpp:148-170, 294-380): read-depth signal = ploidy-
  normalized coverage of [PosA, PosB) vs flanks (bam2depth.cpp:112-137)
  plus an RP signal — pairs collected over [PosA-CI_A-1000,
  PosB+CI_B+1000) with the build_record_RP discordance rule
  (reader.cpp:941-943), both-end MQ >= 20 (== record MQ,
  reader.cpp:968-969), same-chromosome, PosA != PosB; per-sample insert
  distance median/MAD; cutoff = median + 5*MAD; REF pairs = distance <=
  cutoff spanning a breakpoint's CI, ALT pairs = distance > cutoff
  spanning the whole event; genotype = 2*(REF_A+REF_B) /
  (REF_A+REF_B+2*ALT), or -1 when no informative pairs
  (CountRPSupport4DEL, genotyping.cpp:270-292).
* DUP/TD/GT (genotyping.cpp:172-184): read-depth signal only.
* Events smaller than SV_Genotype_Cutoff=1000 on one chromosome get a
  "Skip" log line — but are still genotyped (the reference prints the
  message without a continue, genotyping.cpp:126-131).
* The -Y ploidy file (``ChrName Ploidy`` per line, pindel.cpp:1749-1758)
  is parsed into a map; the reference never consumes it downstream (the
  RD normalization hardcodes PLOIDY=2, bam2depth.cpp:115) — we keep the
  same behavior and surface the map for callers.

Output: the reference creates ``_GT`` but writes genotypes only to
stdout (GT_Output is never written, genotyping.cpp:122).  We write the
same per-SV lines into ``_GT`` as well — an intentional, documented
improvement over the empty file.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, TextIO

import numpy as np

SV_GENOTYPE_CUTOFF = 1000   # genotyping.cpp:41
MIN_MQ = 20                 # genotyping.cpp:302
OVERHEAD = 1000             # genotyping.cpp:318


@dataclasses.dataclass
class GenotypingSV:
    """One -g input record (genotyping.h / genotyping.cpp:95-113)."""

    type: str
    chr_a: str
    pos_a: int
    ci_a: int
    chr_b: str
    pos_b: int
    ci_b: int
    index: int = 0


def read_sv_file(path: str) -> List[GenotypingSV]:
    """Whitespace-stream parse + same-chromosome position normalization
    (genotyping.cpp:95-113)."""
    toks: List[str] = []
    with open(path) as fh:
        for line in fh:
            toks.extend(line.split())
    svs: List[GenotypingSV] = []
    for i in range(0, len(toks) - 6, 7):
        sv = GenotypingSV(toks[i], toks[i + 1], int(toks[i + 2]),
                          int(toks[i + 3]), toks[i + 4], int(toks[i + 5]),
                          int(toks[i + 6]), index=len(svs))
        if sv.chr_a == sv.chr_b and sv.pos_a > sv.pos_b:
            sv.pos_a, sv.pos_b = sv.pos_b, sv.pos_a
        svs.append(sv)
    return svs


def load_ploidy(path: str) -> Dict[str, int]:
    """-Y ploidy file: ``ChrName Ploidy`` per line (pindel.cpp:1749-1758).

    The reference loads this into g_ChrName2Ploidy and never reads it
    again (RD normalization hardcodes PLOIDY=2); kept for parity and for
    callers that want it."""
    out: Dict[str, int] = {}
    with open(path) as fh:
        for line in fh:
            parts = line.split()
            if len(parts) >= 2:
                out[parts[0]] = int(parts[1])
    return out


def median_and_mad(distances: np.ndarray):
    """sorted[mid] median and MAD (getMAD, genotyping.cpp:205-221)."""
    if distances.size == 0:
        return 0, 0
    s = np.sort(distances)
    median = int(s[s.size // 2])
    diff = np.sort(np.abs(distances.astype(np.int64) - median))
    return median, int(diff[diff.size // 2])


def _count_spanning(pos_a, pos_b, dist, sel, lower: int, upper: int) -> int:
    """Pairs in sel whose (min,max) positions bracket [lower, upper]
    (CountREF_RP_DEL / CountALT_RP_DEL, genotyping.cpp:223-268)."""
    lo = np.minimum(pos_a, pos_b)
    hi = np.maximum(pos_a, pos_b)
    return int(np.sum(sel & (lo <= lower) & (hi >= upper)))


def genotype_del_rp(reader, insert_size: int, sv: GenotypingSV
                    ) -> Optional[float]:
    """RP genotype for one sample (GetRP4OnDEL + CountRPSupport4DEL,
    genotyping.cpp:270-380).  Returns None for "-1" (no informative
    pairs)."""
    lower_bin = 1
    if sv.pos_a > sv.ci_a + OVERHEAD:
        lower_bin = sv.pos_a - sv.ci_a - OVERHEAD
    upper_bin = sv.pos_b + sv.ci_b + OVERHEAD
    pos, mpos, mtid, mq = reader.collect_rp_gt(sv.chr_a, lower_bin,
                                               upper_bin, insert_size)
    tid = (reader.ref_names.index(sv.chr_a)
           if sv.chr_a in reader.ref_names else -1)
    keep = (mtid == tid) & (pos != mpos) & (mq >= MIN_MQ)
    pos, mpos = pos[keep], mpos[keep]
    dist = np.abs(pos - mpos)
    median, mad = median_and_mad(dist)
    cutoff = median + 5 * mad
    if cutoff == 0:
        return None               # Cutoff==0 -> all counts skipped
    # Intentional divergence from the reference for malformed records
    # with CI > Pos: its unsigned arithmetic underflows to ~4e9 so the
    # spanning test trivially passes; we clamp the lower bound to 0 so
    # such records count only genuinely spanning pairs (ADVICE r2).
    ref_a = _count_spanning(pos, mpos, dist, dist <= cutoff,
                            max(sv.pos_a - sv.ci_a, 0), sv.pos_a + sv.ci_a)
    ref_b = _count_spanning(pos, mpos, dist, dist <= cutoff,
                            max(sv.pos_b - sv.ci_b, 0), sv.pos_b + sv.ci_b)
    alt = _count_spanning(pos, mpos, dist, dist > cutoff,
                          max(sv.pos_a - sv.ci_a, 0), sv.pos_b + sv.ci_b)
    total = ref_a + ref_b + alt
    if total == 0:
        return None
    return float(np.float32(ref_a + ref_b) * 2
                 / (ref_a + ref_b + alt * 2))


def genotype_rd(readers: Sequence[object], genome, sv: GenotypingSV
                ) -> List[float]:
    """Read-depth genotype signals (getRelativeCoverage,
    bam2depth.cpp:139-164)."""
    from pindel_tpu_torch.depth import get_relative_coverage_internal
    chrom = genome.get(sv.chr_a)
    if chrom is None:
        return [-1.0 for _ in readers]
    return get_relative_coverage_internal(
        sv.chr_a, chrom.biol_size, sv.pos_a, sv.pos_b, readers)


def do_genotyping(genome, bam_entries, readers_by_path: Dict[str, object],
                  sv_path: str, gt_out: TextIO,
                  log=None) -> List[dict]:
    """Genotype every SV in the -g list (doGenotyping,
    genotyping.cpp:39-146).  Returns the per-SV result dicts and writes
    one line per SV to ``gt_out``."""
    from pindel_tpu_torch.profiling import g_log
    log = log or g_log

    # duplicate sample names are an error (genotyping.cpp:68-76)
    seen = set()
    for e in bam_entries:
        if e.tag in seen:
            raise ValueError("Two BAM files with the same sample name.")
        seen.add(e.tag)
    samples = [e.tag for e in bam_entries]
    readers = [readers_by_path[e.path] for e in bam_entries]

    svs = read_sv_file(sv_path)
    results: List[dict] = []
    for sv in svs:
        if (sv.chr_a == sv.chr_b
                and abs(sv.pos_a - sv.pos_b) < SV_GENOTYPE_CUTOFF):
            # printed but NOT skipped (no continue in the reference loop,
            # genotyping.cpp:126-131)
            log.info(f"Skip One SV {sv.type} {sv.chr_a} {sv.pos_a} "
                     f"{sv.ci_a} {sv.chr_b} {sv.pos_b} {sv.ci_b}")
        res = {"sv": sv, "rd": None, "rp": None}
        if sv.type == "DEL":
            res["rd"] = genotype_rd(readers, genome, sv)
            res["rp"] = [genotype_del_rp(r, e.insert_size, sv)
                         for r, e in zip(readers, bam_entries)]
        elif sv.type in ("DUP", "TD", "GT"):
            res["rd"] = genotype_rd(readers, genome, sv)
        results.append(res)

        parts = [sv.type, sv.chr_a, str(sv.pos_a), str(sv.ci_a),
                 sv.chr_b, str(sv.pos_b), str(sv.ci_b)]
        if res["rd"] is not None:
            rd = " ".join(f"{v:.2f}" for v in res["rd"])
            log.info("Genotype_Based_On_RD: " + rd)
            parts.append("RD " + rd)
        if res["rp"] is not None:
            rp = " ".join("-1" if v is None else f"{v:g}"
                          for v in res["rp"])
            log.info("Genotype_Based_On_RP: " + rp)
            parts.append("RP " + rp)
        gt_out.write("\t".join(parts) + "\t" +
                     " ".join(samples) + "\n")
    return results


def run_genotyping_files(reference_fa: str, bam_config: str, sv_path: str,
                         output_prefix: str,
                         ploidy_path: str = "") -> int:
    """-g/-Y entry point: genome + bam config -> ``<prefix>_GT``."""
    from pindel_tpu_torch.bam import BamReader, read_bam_config
    from pindel_tpu_torch.genome import Genome

    genome = Genome.from_fasta(reference_fa)
    entries = read_bam_config(bam_config)
    readers = {e.path: BamReader(e.path) for e in entries}
    if ploidy_path:
        load_ploidy(ploidy_path)
    with open(output_prefix + "_GT", "w") as out:
        do_genotyping(genome, entries, readers, sv_path, out)
    return 0
