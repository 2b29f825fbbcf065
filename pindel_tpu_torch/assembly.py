"""Assembly mode (-z): assemble breakpoint evidence for an external SV list.

Re-implements the reference's assembly module (assembly.cpp:33-745), whose
call site is disabled in the reference binary (pindel.cpp:1738-1742 parses
-z then exits) — here the mode is live, like the genotyping module.  For
each SV record ``Type ChrA PosA CI_A ChrB PosB CI_B``:

* collect split reads around each breakpoint (BAM channel), close-end
  mapped on the breakpoint chromosome (get_SR_Reads path,
  assembly.cpp:149-152);
* bin reads by their last close-end anchor position per strand and build
  a per-position base-majority consensus from every bin with >= 3 reads
  (CombineAndSort / CombineReads, assembly.cpp:245-507), preserving the
  reference's consensus quirks: the 0.66 ratio vote, the fallback
  majority pick whose ``Max_Base_Count`` comparison never updates (so it
  degenerates to "last base with count >= 3") and CARRIES the previous
  position's pick when nothing qualifies, and the >= 1.3x-read-length
  span requirement;
* close-end map the assembled contig, keep contigs anchored within
  Pos +/- CI (CleanUpCloseEnd, assembly.cpp:694-708), far-end search them
  in the partner breakpoint's window (SearchFarEndAtPos semantics), keep
  far anchors within the partner's Pos +/- CI, and emit one ``_ASM`` line
  per fully anchored contig (OutputCurrentRead, assembly.cpp:509-540);
* when no contig finds a far end and both breakpoints share a
  chromosome, try plus/minus contig overlap merging (TryLI,
  assembly.cpp:542-610) — like the reference, whose ReportLI is
  commented out, merged strings are logged but produce no ``_ASM``
  output.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from pindel_tpu_torch import dna
from pindel_tpu_torch.config import Settings
from pindel_tpu_torch.genome import SPACER, Chromosome, Genome
from pindel_tpu_torch.profiling import g_log
from pindel_tpu_torch.reads import MINUS, PLUS, SplitRead
from pindel_tpu_torch.search import Searcher

ASSEMBLY_CUTOFF = 3          # assembly.cpp:249
RATIO_CUTOFF = 0.66          # assembly.cpp:432
SPAN_FACTOR = 1.3            # assembly.cpp:321
MAX_N_FRACTION = 0.05        # assembly.cpp:476


@dataclasses.dataclass
class AssemblySV:
    """One -z input record (assembly.h Assembly struct)."""

    type: str
    chr_a: str
    pos_a: int
    ci_a: int
    chr_b: str
    pos_b: int
    ci_b: int
    index: int = 0


def read_assembly_file(path: str) -> List[AssemblySV]:
    """Whitespace token stream of 7-field records (doAssembly,
    assembly.cpp:77-93), swapping PosA/PosB when same-chromosome and
    out of order."""
    with open(path) as fh:
        toks = fh.read().split()
    out: List[AssemblySV] = []
    for k in range(0, len(toks) - 6, 7):
        sv = AssemblySV(toks[k], toks[k + 1], int(toks[k + 2]),
                        int(toks[k + 3]), toks[k + 4], int(toks[k + 5]),
                        int(toks[k + 6]), index=len(out))
        if sv.chr_a == sv.chr_b and sv.pos_a > sv.pos_b:
            sv.pos_a, sv.pos_b = sv.pos_b, sv.pos_a
        out.append(sv)
    return out


def combine_reads(strand: str, reads: List[SplitRead],
                  idxs: List[int]) -> Optional[SplitRead]:
    """Consensus of one pileup bin (CombineReads, assembly.cpp:293-507).

    Returns the assembled read (template fields + consensus sequence,
    up_close cleared) or None; the caller runs close-end mapping."""
    min_left = min(reads[i].left_most_pos for i in idxs)
    max_rdlen = max(len(reads[i].seq) for i in idxs)
    max_len = max(reads[i].left_most_pos + len(reads[i].seq)
                  for i in idxs) - min_left
    if float(max_len) < max_rdlen * SPAN_FACTOR:
        return None

    counts = np.zeros((5, max_len), dtype=np.int64)
    code_of = {"A": 0, "C": 1, "G": 2, "T": 3}
    for i in idxs:
        r = reads[i]
        if strand == PLUS:
            base0 = max_len + min_left - r.left_most_pos - len(r.seq)
        else:
            base0 = r.left_most_pos - min_left
        for k, ch in enumerate(r.seq):
            counts[code_of.get(ch, 4), base0 + k] += 1

    total = counts.sum(axis=0)
    ratio = counts / np.maximum(total, 1)
    out_chars: List[str] = []
    bases = "ACGT"
    max_base_count_index = -1     # reference quirk: never reset, and the
    # Max_Base_Count threshold variable is never updated, so the fallback
    # is "last base with count >= 3, else previous position's pick"
    for pos in range(max_len):
        voted = False
        for b in range(4):
            if ratio[b, pos] > RATIO_CUTOFF:
                out_chars.append(bases[b])
                voted = True
                break
        if voted:
            continue
        for b in range(4):
            if counts[b, pos] > 0 and counts[b, pos] >= ASSEMBLY_CUTOFF:
                max_base_count_index = b
        out_chars.append("N" if max_base_count_index == -1
                         else bases[max_base_count_index])
    consensus = "".join(out_chars)
    if consensus.count("N") >= len(consensus) * MAX_N_FRACTION:
        return None

    # template: min up_close size among reads contained in the consensus
    # (assembly.cpp:478-489), else the first read
    pick = 0
    min_close = 10_000
    for k, i in enumerate(idxs):
        r = reads[i]
        if len(r.up_close) < min_close and r.seq in consensus:
            min_close = len(r.up_close)
            pick = k
    out = reads[idxs[pick]].clone()
    out.set_seq(consensus)
    per_sample: Dict[str, int] = {}
    for i in idxs:
        per_sample[reads[i].tag] = per_sample.get(reads[i].tag, 0) + 1
    out.read_count_per_sample = per_sample
    out.thickness = len(idxs)
    from pindel_tpu_torch.reads import AnchorSet
    out.up_close = AnchorSet.empty()
    out.up_far = AnchorSet.empty()
    return out


def combine_and_sort(sv: AssemblySV, reads: List[SplitRead],
                     lower: int, upper: int,
                     first_bp: bool) -> List[SplitRead]:
    """Pileup binning + per-bin assembly (CombineAndSort,
    assembly.cpp:245-291); close-end mapping of the contigs is done by
    the caller in one batch (reference does it per contig inside
    CombineReads — independent per read, so equivalent)."""
    window_size = (upper - lower) * 3
    offset = lower * 2 - upper if lower * 2 > upper else 0
    pos = sv.pos_a if first_bp else sv.pos_b
    ci = sv.ci_a if first_bp else sv.ci_b
    bins_plus: Dict[int, List[int]] = {}
    bins_minus: Dict[int, List[int]] = {}
    for i, r in enumerate(reads):
        last_loc = int(r.up_close.loc[len(r.up_close) - 1])
        if not (last_loc + ci + len(r.seq) > SPACER + pos
                and last_loc < SPACER + pos + ci + len(r.seq)):
            continue
        slot = last_loc - offset - SPACER
        if slot < 0 or slot >= window_size:
            continue       # reference indexes out of bounds here (UB)
        if r.matched_d == PLUS:
            bins_plus.setdefault(slot, []).append(i)
        elif r.matched_d == MINUS:
            bins_minus.setdefault(slot, []).append(i)
    out: List[SplitRead] = []
    for slot in range(window_size):
        p = bins_plus.get(slot, [])
        m = bins_minus.get(slot, [])
        if len(p) < ASSEMBLY_CUTOFF and len(m) < ASSEMBLY_CUTOFF:
            continue
        g_log.info(f"Candidate: {slot} {slot + offset}\t+ {len(p)}"
                   f"\t-{len(m)}")
        if len(p) >= ASSEMBLY_CUTOFF:
            r = combine_reads(PLUS, reads, p)
            if r is not None:
                out.append(r)
        if len(m) >= ASSEMBLY_CUTOFF:
            r = combine_reads(MINUS, reads, m)
            if r is not None:
                out.append(r)
    return out


def clean_up_close_end(reads: List[SplitRead], left: int,
                       right: int) -> List[SplitRead]:
    """assembly.cpp:694-708."""
    out = []
    for r in reads:
        if not r.up_close:
            continue
        lo = int(r.up_close.loc[0])
        hi = int(r.up_close.loc[len(r.up_close) - 1])
        if left <= hi <= right or left <= lo <= right:
            out.append(r)
    return out


def clean_up_far_end(reads: List[SplitRead], left: int,
                     right: int) -> List[SplitRead]:
    """assembly.cpp:710-721."""
    out = []
    for r in reads:
        if not r.up_far:
            continue
        lo = int(r.up_far.loc[0])
        hi = int(r.up_far.loc[len(r.up_far) - 1])
        if left <= hi <= right or left <= lo <= right:
            out.append(r)
    return out


def try_li_merges(first: List[SplitRead],
                  second: List[SplitRead]) -> List[Tuple[int, str]]:
    """Plus/minus contig overlap merging (TryLI, assembly.cpp:542-610):
    every overlap >= 10 bp with <= 3 mismatches yields a merged string.
    The reference's ReportLI is commented out, so merges are informative
    only — no _ASM output."""
    out: List[Tuple[int, str]] = []
    for rp in first:
        if rp.matched_d == MINUS:
            continue
        for rm in second:
            if rm.matched_d == PLUS:
                continue
            a = dna.decode(dna.revcomp(rp.seq_codes()))
            b = rm.seq
            max_overlap = min(len(rp.seq), len(rm.seq))
            for ov in range(10, max_overlap):
                mism = 0
                for k in range(ov):
                    if a[len(a) - ov + k] != b[k]:
                        mism += 1
                        if mism > 3:
                            break
                if mism <= 3:
                    out.append((ov, a[: len(a) - ov] + b))
    return out


def _anchor_cols(aset, i: int) -> str:
    strand = MINUS if aset.strand_minus[i] else PLUS
    direction = MINUS if aset.dir_minus[i] else PLUS
    return (f"{strand} {direction} {int(aset.length[i])} "
            f"{int(aset.loc[i]) - SPACER + 1}")


def output_current_read(sv: AssemblySV, read: SplitRead, out) -> None:
    """One _ASM line (OutputCurrentRead, assembly.cpp:509-540)."""
    if not read.up_far:
        return
    nc = len(read.up_close) - 1
    nf = len(read.up_far) - 1
    line = (f"{sv.index + 1} {sv.type} {sv.chr_a} {sv.pos_a} {sv.ci_a}"
            f"\t{sv.chr_b} {sv.pos_b} {sv.ci_b}"
            f"\tA {read.matched_d} {read.matched_rel_pos} "
            f"{read.thickness}\t{read.frag_name} "
            f"{_anchor_cols(read.up_close, nc)}"
            f" | {read.far_frag_name} "
            f"{_anchor_cols(read.up_far, nf)}")
    per = read.read_count_per_sample or {}
    line += f"\t#samples {len(per)} "
    for name in sorted(per):           # std::map iterates key-sorted
        line += f"\t{name} {per[name]}"
    line += "\t NT_Size: 0\tNT_Str: \"\""
    out.write(line + "\n")


class Assembler:
    def __init__(self, settings: Settings, genome: Genome,
                 bam_entries, bam_readers, backend_factory=None):
        self.settings = settings
        self.genome = genome
        self.bam_entries = bam_entries
        self.bam_readers = bam_readers
        self.backend_factory = backend_factory
        self._searchers: Dict[str, Searcher] = {}

    def _searcher(self, chrom: Chromosome) -> Searcher:
        sr = self._searchers.get(chrom.name)
        if sr is None:
            sr = Searcher(self.settings)
            if self.backend_factory is not None:
                backend = self.backend_factory(chrom)
                if backend is not None:
                    sr.backend = backend
            self._searchers[chrom.name] = sr
        return sr

    def _collect_close_mapped(self, chrom: Chromosome, lower: int,
                              upper: int) -> List[SplitRead]:
        """get_SR_Reads over a breakpoint window + close-end mapping
        (assembly.cpp:149-152)."""
        s = self.settings
        reads: List[SplitRead] = []
        for entry in self.bam_entries:
            reader = self.bam_readers[entry.path]
            rs, _ = reader.collect_sr(
                chrom.name, lower, upper, entry.insert_size, entry.tag,
                chrom.biol_size, min_anchor_quality=s.min_anchor_quality,
                nm=s.nm, max_mismatch_rate=s.max_allowed_mismatch_rate)
            reads.extend(rs)
        searcher = self._searcher(chrom)
        searcher.map_close_ends(chrom, reads)
        return searcher.finalize_close_ends(reads)

    def _assemble_bp(self, sv: AssemblySV, first_bp: bool, out) -> int:
        """One breakpoint side of AssembleOneSV (assembly.cpp:119-245);
        returns the total number of far anchors found."""
        here_chr = self.genome.get(sv.chr_a if first_bp else sv.chr_b)
        there_chr = self.genome.get(sv.chr_b if first_bp else sv.chr_a)
        if here_chr is None or there_chr is None:
            missing = sv.chr_a if here_chr is None else sv.chr_b
            raise ValueError(f"assembly: no chromosome {missing}")
        pos = sv.pos_a if first_bp else sv.pos_b
        ci = sv.ci_a if first_bp else sv.ci_b
        other_pos = sv.pos_b if first_bp else sv.pos_a
        other_ci = sv.ci_b if first_bp else sv.ci_a

        lower = pos - ci - 1000 if pos > ci + 1000 else 1
        upper = pos + ci + 1000
        g_log.info(f"{'First' if first_bp else 'Second'} BP\tChrName "
                   f"{here_chr.name}\tRange {lower} {upper}")
        raw = self._collect_close_mapped(here_chr, lower, upper)
        contigs = combine_and_sort(sv, raw, lower, upper, first_bp)
        searcher = self._searcher(here_chr)
        searcher.map_close_ends(here_chr, contigs)
        contigs = clean_up_close_end(contigs, pos + SPACER - ci,
                                     pos + SPACER + ci)
        g_log.info(f"{'First' if first_bp else 'Second'} size "
                   f"{len(contigs)}")

        search_range = other_ci + 1000
        center = other_pos + SPACER
        searchable = []
        for r in contigs:
            r.far_frag_name = there_chr.name
            # SearchFarEndAtPos gates (farend_searcher.cpp:53-56)
            if r.seq and r.seq_codes()[0] != dna.N and r.up_close:
                searchable.append(r)
        if searchable:
            searcher._far_round(
                searchable,
                [[(there_chr, center - search_range,
                   center + search_range)]] * len(searchable))
        contigs = clean_up_far_end(contigs, other_pos + SPACER - other_ci,
                                   other_pos + SPACER + other_ci)
        n_far = 0
        for r in contigs:
            if r.up_close and r.up_far:
                output_current_read(sv, r, out)
            n_far += len(r.up_far)
        self._sides.append(contigs)
        return n_far

    def assemble_one_sv(self, sv: AssemblySV, out) -> None:
        """AssembleOneSV (assembly.cpp:110-245)."""
        g_log.info(f"Current SV: {sv.index} {sv.type} {sv.chr_a} "
                   f"{sv.pos_a} {sv.ci_a}\t{sv.chr_b} {sv.pos_b} "
                   f"{sv.ci_b}")
        self._sides: List[List[SplitRead]] = []
        n_far = self._assemble_bp(sv, True, out)
        n_far += self._assemble_bp(sv, False, out)
        if n_far == 0 and sv.chr_a == sv.chr_b:
            for ov, merged in try_li_merges(self._sides[0],
                                            self._sides[1]):
                g_log.info(f"MergedString: {ov} {merged}")

    def run(self, sv_path: str, out_path: str) -> None:
        svs = read_assembly_file(sv_path)
        g_log.info(f"Get all SVs to assemble... ({len(svs)})")
        with open(out_path, "w") as out:
            for sv in svs:
                self.assemble_one_sv(sv, out)
