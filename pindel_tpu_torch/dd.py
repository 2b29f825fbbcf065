"""Dispersed-duplication / mobile-element-insertion detection (-q mode).

Re-implements the reference's DD channel (search_MEI.{h,cpp},
search_MEI_util.{h,cpp}) on our native BAM reader + batched close-end
search engine:

* per 5 Mb window, discordant read pairs (both mates mapped, not
  concordant, mapping distance > MIN_DD_MAP_DISTANCE or cross-chromosome)
  are collected natively (``ptbam_collect_dd``) and clustered by strand
  and position (cluster_reads, search_MEI.cpp:70-112);
* clusters of >= MIN_DD_CLUSTER_SIZE reads get a breakpoint: either an
  exact one from split reads close-end-mapped near the cluster edge
  (get_breakpoints, search_MEI.cpp:225-327 — the close-end mapping runs
  on the batched device engine), or an estimate from the cluster's
  mapping positions (get_breakpoint_estimation, :335-362);
* split-read consensus sequences that align locally (native banded-SW
  scorer ptseq_contains_subseq, see native/seqmatch.cpp) are discarded as
  local-variant evidence;
* breakpoints from opposite strands within MAX_DD_BREAKPOINT_DISTANCE
  pair into DD events (searchMEI, :891-940) and are reported to ``_DD``
  in the reference's exact text format (reportMEIevent, :620-673).
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, List, Optional, TextIO

import numpy as np

from pindel_tpu_torch.config import Settings
from pindel_tpu_torch.cxxsort import cxx_sort, cxx_sort_reversed
from pindel_tpu_torch.genome import SPACER, Chromosome, Genome
from pindel_tpu_torch.reads import SplitRead

MIN_CONSENSUS_LENGTH = 15        # search_MEI.cpp:38
MIN_FRACTION_CONSENSUS = 0.8     # search_MEI.cpp:34
COMMENT_PREFIX = "# "


@dataclasses.dataclass
class SimpleRead:
    """simple_read (search_MEI.h:21-67)."""

    name: str
    tid: int
    pos: int
    strand: str
    sample_name: str
    sequence: str
    mate_tid: int = -1
    mate_pos: int = -1
    mate_strand: str = "?"
    is_split: bool = False
    mapped_sequence: str = ""
    unmapped_sequence: str = ""
    evidence_strand: str = "?"


@dataclasses.dataclass
class MEIBreakpoint:
    """MEI_breakpoint (search_MEI.h:71-84)."""

    tid: int
    pos: int
    cluster_strand: str
    associated_reads: List[SimpleRead] = dataclasses.field(
        default_factory=list)
    associated_split_reads: List[SimpleRead] = dataclasses.field(
        default_factory=list)


@dataclasses.dataclass
class MEIEvent:
    """MEI_event (search_MEI.cpp:428-445)."""

    fwd_bp: MEIBreakpoint
    rev_bp: MEIBreakpoint
    fwd_mapping_reads: List[SimpleRead] = dataclasses.field(
        default_factory=list)
    rev_mapping_reads: List[SimpleRead] = dataclasses.field(
        default_factory=list)


# --------------------------------------------------------------- helpers

_RC = str.maketrans("ACGTN", "TGCAN")


def _revcomp(s: str) -> str:
    return s.translate(_RC)[::-1]


def base_read_name(name: str) -> str:
    """base_read_name (search_MEI_util.cpp:99-106)."""
    found = name.find("/")
    if found > 0:
        return name[1:found]
    return name


def sample_dictionary(header_text: str) -> Dict[str, str]:
    """@RG ID -> SM map (get_sample_dictionary,
    search_MEI_util.cpp:356-378)."""
    out: Dict[str, str] = {}
    for line in header_text.splitlines():
        if line.startswith("@RG"):
            line += "\t"
            idpos = line.find("\tID:")
            smpos = line.find("\tSM:")
            if idpos >= 0 and smpos >= 0:
                rg_id = line[idpos + 4:line.index("\t", idpos + 4)]
                sm = line[smpos + 4:line.index("\t", smpos + 4)]
                out[rg_id] = sm
    return out


def get_sample_name(read_group: str, sample_dict: Dict[str, str],
                    all_samples) -> str:
    """get_sample_name fallback semantics
    (search_MEI_util.cpp:382-395)."""
    if read_group in sample_dict:
        return sample_dict[read_group]
    if len(all_samples) == 1:
        return next(iter(all_samples))
    return ""


def _seqmatch_lib():
    from pindel_tpu_torch import native
    lib = native.load("ptseq", ["seqmatch.cpp"], link=())
    lib.ptseq_contains_subseq.restype = ctypes.c_int32
    lib.ptseq_contains_subseq.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64,
        ctypes.c_int32, ctypes.POINTER(ctypes.c_int32), ctypes.c_int64]
    return lib


def contains_subseq(query: str, db: str, min_length: int,
                    maxmm: np.ndarray) -> bool:
    lib = _seqmatch_lib()
    t = np.ascontiguousarray(maxmm, dtype=np.int32)
    return bool(lib.ptseq_contains_subseq(
        query.encode(), len(query), db.encode(), len(db), min_length,
        t.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), t.shape[0]))


def contains_subseq_any_strand(query: str, db: str, min_length: int,
                               maxmm: np.ndarray) -> bool:
    """search_MEI_util.cpp:348-351."""
    return (contains_subseq(query, db, min_length, maxmm)
            or contains_subseq(_revcomp(query), db, min_length, maxmm))


# ------------------------------------------------------------ clustering

def cluster_reads(reads: List[SimpleRead], insert_size: int,
                  settings: Settings) -> List[List[SimpleRead]]:
    """cluster_reads (search_MEI.cpp:70-112)."""
    if not reads:
        return []
    reads = list(reads)
    # comp_simple_read (search_MEI_util.cpp:29-38) under std::sort
    cxx_sort(reads, lambda r1, r2:
             (r1.strand == "+" and r2.strand != "+")
             or (not (r1.strand != "+" and r2.strand == "+")
                 and r1.pos < r2.pos))
    clusters: List[List[SimpleRead]] = []
    current = [reads[0]]
    first = reads[0]
    last = reads[0]
    for read in reads[1:]:
        if ((read.pos - last.pos) <= settings.max_distance_cluster_reads
                and (read.pos - first.pos)
                <= insert_size - len(first.sequence)
                and last.strand == read.strand):
            current.append(read)
        else:
            clusters.append(current)
            current = [read]
            first = read
        last = read
    if current:
        clusters.append(current)
    return clusters


def get_consensus_unmapped(reads: List[SimpleRead], strand: str) -> str:
    """Consensus of split-read unmapped tails
    (get_consensus_unmapped, search_MEI.cpp:156-218).

    Sorts ``reads`` in place by unmapped length (descending), like the
    reference does before reporting.
    """
    if not reads:
        return ""
    cxx_sort(reads, lambda r1, r2: (len(r1.unmapped_sequence)
                                    > len(r2.unmapped_sequence)))
    max_len = len(reads[0].unmapped_sequence)
    consensus: List[str] = []
    for i in range(max_len):
        counts: Dict[str, int] = {}
        read_count = 0
        for read in reads:
            idx = (i if strand == "-"
                   else len(read.unmapped_sequence) - 1 - i)
            if idx < 0 or idx >= len(read.unmapped_sequence):
                continue
            read_count += 1
            ch = read.unmapped_sequence[idx]
            counts[ch] = counts.get(ch, 0) + 1
        best_char, best = "?", 0
        for ch, cnt in counts.items():
            if cnt > best:
                best, best_char = cnt, ch
        if best >= MIN_FRACTION_CONSENSUS * read_count:
            consensus.append(best_char)
        else:
            break
    out = "".join(consensus)
    if len(out) < MIN_CONSENSUS_LENGTH:
        return ""
    if strand == "+":
        out = out[::-1]
    return out


# ----------------------------------------------------------- breakpoints

class DDContext:
    """Carries the per-run state (readers, searcher, sample dicts)."""

    def __init__(self, settings: Settings, genome: Genome, bam_entries,
                 readers: Dict[str, object], searcher) -> None:
        self.settings = settings
        self.genome = genome
        self.bam_entries = bam_entries
        self.readers = readers
        self.searcher = searcher
        self.maxmm = settings.max_mismatch()
        self.all_samples = {e.tag for e in bam_entries}
        self.sample_dict: Dict[str, str] = {}
        self.current_insert_size = 0
        # seq-name dict from the first BAM (get_sequence_name_dictionary,
        # search_MEI.cpp:946-959)
        first = readers[bam_entries[0].path]
        self.seq_names: Dict[int, str] = dict(enumerate(first.ref_names))


def load_discordant_reads(ctx: DDContext, chrom_name: str, start: int,
                          end: int) -> List[SimpleRead]:
    """load_discordant_reads (search_MEI.cpp:716-767)."""
    s = ctx.settings
    out: List[SimpleRead] = []
    for entry in ctx.bam_entries:
        reader = ctx.readers[entry.path]
        if chrom_name not in reader.ref_names:
            continue
        tid = reader.ref_names.index(chrom_name)
        ctx.sample_dict = sample_dictionary(reader.header_text())
        ctx.current_insert_size = entry.insert_size
        names, seqs, rgs, pos, mpos, mtid, lens, bits = reader.collect_dd(
            tid, start, end, entry.insert_size, s.min_dd_map_distance)
        for i in range(len(pos)):
            strand = "-" if bits[i] & 1 else "+"
            mate_strand = "-" if bits[i] & 2 else "+"
            name = "@" + names[i] + ("/1" if bits[i] & 4 else "/2")
            sample = get_sample_name(rgs[i], ctx.sample_dict,
                                     ctx.all_samples)
            out.append(SimpleRead(name, tid, int(pos[i]), strand, sample,
                                  seqs[i], int(mtid[i]), int(mpos[i]),
                                  mate_strand))
    return out


def get_split_reads_for_cluster(ctx: DDContext, cluster_strand: str,
                                outer_pos: int, chrom: Chromosome
                                ) -> List[SplitRead]:
    """get_split_reads_for_cluster (search_MEI.cpp:120-150): SR channel
    over the mate window + close-end mapping on the device engine."""
    s = ctx.settings
    split_reads: List[SplitRead] = []
    for entry in ctx.bam_entries:
        ins = entry.insert_size
        if cluster_strand == "+":
            lower, upper = outer_pos - ins, outer_pos + 2 * ins
        else:
            lower, upper = outer_pos - 2 * ins, outer_pos + ins
        reads, _ = ctx.readers[entry.path].collect_sr(
            chrom.name, lower, upper, ins, entry.tag, chrom.biol_size,
            min_anchor_quality=s.min_anchor_quality, nm=s.nm,
            max_mismatch_rate=s.max_allowed_mismatch_rate)
        ctx.searcher.map_close_ends(chrom, reads)
        split_reads.extend(ctx.searcher.finalize_close_ends(reads))
    return split_reads


def get_breakpoints(ctx: DDContext, cluster: List[SimpleRead],
                    cluster_tid: int, cluster_strand: str,
                    chrom: Chromosome) -> List[MEIBreakpoint]:
    """get_breakpoints (search_MEI.cpp:225-327)."""
    s = ctx.settings
    outer = cluster[-1].pos if cluster_strand == "-" else cluster[0].pos
    split_reads = get_split_reads_for_cluster(ctx, cluster_strand, outer,
                                              chrom)
    cands: Dict[int, List[SimpleRead]] = {}
    for i, read in enumerate(split_reads):
        if read.matched_d != cluster_strand:
            continue
        comp_bp = read.last_abs_loc_close_end()
        bio_bp = comp_bp - SPACER
        if bio_bp not in cands:
            support = 1
            for j in range(i + 1, len(split_reads)):
                other = split_reads[j]
                if (other.last_abs_loc_close_end() == comp_bp
                        and other.matched_d == cluster_strand):
                    support += 1
            if support < s.min_dd_breakpoint_support:
                continue
            cands[bio_bp] = []
        cel = read.max_len_close()
        if cluster_strand == "+":
            whole = _revcomp(read.seq)
            mapped, unmapped = whole[:cel], whole[cel:]
        else:
            whole = read.seq
            mapped = whole[len(whole) - cel:]
            unmapped = whole[:len(whole) - cel]
        sample = get_sample_name(read.read_group, ctx.sample_dict,
                                 ctx.all_samples)
        cands[bio_bp].append(SimpleRead(
            read.name, -1, -1, "?", sample, whole, is_split=True,
            mapped_sequence=mapped, unmapped_sequence=unmapped))

    sr_strand = "-" if cluster_strand == "+" else "+"
    breakpoints: List[MEIBreakpoint] = []
    for bio_bp in sorted(cands):
        sreads = cands[bio_bp]
        consensus = get_consensus_unmapped(sreads, sr_strand)
        if not consensus:
            continue
        fe_start = max(0, bio_bp + SPACER - s.min_dd_map_distance)
        fe_size = min(chrom.comp_size - fe_start,
                      2 * s.min_dd_map_distance)
        db = chrom.seq_str(fe_start, fe_size)
        if not contains_subseq_any_strand(consensus, db,
                                          MIN_CONSENSUS_LENGTH, ctx.maxmm):
            bp = MEIBreakpoint(cluster_tid, bio_bp, cluster_strand)
            bp.associated_split_reads = sreads
            bp.associated_reads = [dataclasses.replace(r)
                                   for r in cluster]
            breakpoints.append(bp)
    return breakpoints


def get_breakpoint_estimation(cluster: List[SimpleRead],
                              cluster_tid: int, cluster_strand: str
                              ) -> MEIBreakpoint:
    """get_breakpoint_estimation (search_MEI.cpp:335-362).

    The running mean is computed in single precision like the reference's
    ``float dist_mean`` so the truncated estimate matches bit-for-bit.
    """
    dist_mean = np.float32(0.0)
    for i in range(len(cluster) - 1):
        diff = np.float32(cluster[i + 1].pos - cluster[i].pos) - dist_mean
        dist_mean = np.float32(np.float64(dist_mean)
                               + np.float64(1.0 / (i + 1))
                               * np.float64(diff))
    outer_high = cluster[-1].pos + len(cluster[-1].sequence)
    outer_low = cluster[0].pos
    if cluster_strand == "+":
        est = int(np.float64(outer_high) + np.float64(dist_mean))
    else:
        est = int(np.float64(outer_low) - np.float64(dist_mean))
    bp = MEIBreakpoint(cluster_tid, est, cluster_strand)
    bp.associated_reads = [dataclasses.replace(r) for r in cluster]
    return bp


def search_mei_breakpoints(ctx: DDContext,
                           discordant_reads: List[SimpleRead],
                           chrom: Chromosome,
                           mei_breakpoints: List[MEIBreakpoint]) -> None:
    """searchMEIBreakpoints (search_MEI.cpp:367-424)."""
    s = ctx.settings
    clusters = cluster_reads(discordant_reads, ctx.current_insert_size, s)
    for cluster in clusters:
        if len(cluster) < s.min_dd_cluster_size:
            continue
        cluster_strand = cluster[0].strand
        cluster_tid = cluster[0].tid
        bps = get_breakpoints(ctx, cluster, cluster_tid, cluster_strand,
                              chrom)
        if len(bps) > 1:
            best = bps[0]
            best_support = 0
            for bp in bps:
                if len(bp.associated_split_reads) > best_support:
                    best = bp
                    best_support = len(bp.associated_split_reads)
            bps = [best]
        elif not bps:
            bps = [get_breakpoint_estimation(cluster, cluster_tid,
                                             cluster_strand)]
        mei_breakpoints.extend(bps)


# -------------------------------------------------------------- events

def pair_events(mei_breakpoints: List[MEIBreakpoint],
                settings: Settings) -> List[MEIEvent]:
    """Consecutive opposite-strand breakpoint pairing
    (searchMEI, search_MEI.cpp:901-921)."""
    bps = list(mei_breakpoints)
    # comp_breakpoint_pos (search_MEI.cpp:676-680) under std::sort
    cxx_sort(bps, lambda a, b: a.tid < b.tid
             or (a.tid == b.tid and a.pos < b.pos))
    events: List[MEIEvent] = []
    for i in range(len(bps) - 1):
        a, b = bps[i], bps[i + 1]
        if (a.cluster_strand == b.cluster_strand
                or (b.pos - a.pos) > settings.max_dd_breakpoint_distance
                or a.tid != b.tid):
            continue
        if a.cluster_strand == "+":
            events.append(MEIEvent(a, b))
        else:
            events.append(MEIEvent(b, a))
    return events


def append_cluster_connections(ctx: DDContext, events: List[MEIEvent],
                               window_size: int) -> None:
    """append_cluster_connections (search_MEI.cpp:773-888): whole-genome
    second pass collecting mates that map inside the inserted elements
    (only when --DD_REPORT_DUPLICATION_READS)."""
    fwd_links: Dict[str, int] = {}
    rev_links: Dict[str, int] = {}
    exclude: Dict[str, int] = {}
    for i, ev in enumerate(events):
        for r in ev.fwd_bp.associated_reads:
            fwd_links.setdefault(base_read_name(r.name), i)
            exclude.setdefault(r.name, i)
        for r in ev.rev_bp.associated_reads:
            rev_links.setdefault(base_read_name(r.name), i)
            exclude.setdefault(r.name, i)
    for chrom in ctx.genome.chromosomes:
        start = 0
        while start <= chrom.biol_size:
            end = min(start + window_size, chrom.biol_size)
            reads = load_discordant_reads(ctx, chrom.name, start, end)
            for read in reads:
                base = base_read_name(read.name)
                idx = fwd_links.get(base)
                strand = "+"
                if idx is None:
                    idx = rev_links.get(base)
                    strand = "-"
                if idx is None:
                    continue
                if read.name in exclude:
                    continue
                if strand == "+":
                    events[idx].fwd_mapping_reads.append(read)
                else:
                    events[idx].rev_mapping_reads.append(read)
            start += window_size


# ------------------------------------------------------------ reporting

def set_evidence_strands(event: MEIEvent) -> None:
    """search_MEI.cpp:490-510."""
    for r in (event.fwd_bp.associated_reads
              + event.fwd_bp.associated_split_reads
              + event.fwd_mapping_reads):
        r.evidence_strand = "+"
    for r in (event.rev_bp.associated_reads
              + event.rev_bp.associated_split_reads
              + event.rev_mapping_reads):
        r.evidence_strand = "-"


def get_event_supporting_reads(event: MEIEvent) -> List[SimpleRead]:
    """search_MEI.cpp:515-558."""
    supporting = (list(event.fwd_mapping_reads)
                  + list(event.fwd_bp.associated_split_reads)
                  + list(event.rev_mapping_reads)
                  + list(event.rev_bp.associated_split_reads))
    for read in (event.fwd_bp.associated_reads
                 + event.rev_bp.associated_reads):
        base = base_read_name(read.name)
        if any(base == base_read_name(s.name) for s in supporting):
            continue
        pseudo = dataclasses.replace(
            read, pos=read.mate_pos, mate_pos=read.pos,
            tid=read.mate_tid, mate_tid=read.tid,
            strand=read.mate_strand, mate_strand=read.strand,
            sequence="?")
        supporting.append(pseudo)
    return supporting


def _set_reference_highlight(reference: str, breakpoint: int,
                             until_bp: bool) -> str:
    """search_MEI.cpp:474-486."""
    out = []
    for i, ch in enumerate(reference):
        if (until_bp and i < breakpoint) or (not until_bp
                                             and i >= breakpoint):
            out.append(ch.upper())
        else:
            out.append(ch.lower())
    return "".join(out)


def report_split_read_support(genome: Genome, bp: MEIBreakpoint,
                              fiveprime: bool, seq_names: Dict[int, str],
                              out: TextIO) -> None:
    """search_MEI.cpp:562-616."""
    if not bp.associated_split_reads:
        return
    if fiveprime:
        cxx_sort(bp.associated_split_reads,
                 lambda r1, r2: (len(r1.mapped_sequence)
                                 > len(r2.mapped_sequence)))
    else:
        # std::sort(rbegin, rend, by unmapped length desc)
        cxx_sort_reversed(bp.associated_split_reads,
                          lambda r1, r2: (len(r1.unmapped_sequence)
                                          > len(r2.unmapped_sequence)))
    first = bp.associated_split_reads[0]
    last = bp.associated_split_reads[-1]
    if fiveprime:
        base = len(first.mapped_sequence)
        end = len(last.unmapped_sequence)
    else:
        base = len(last.unmapped_sequence)
        end = len(first.mapped_sequence)
    offset = 1 if fiveprime else 0
    chrom = genome.get(seq_names[bp.tid])
    reference = chrom.seq_str(bp.pos - base + offset + SPACER, base + end)
    reference = _set_reference_highlight(reference, base, fiveprime)
    prefix = "Reference: "
    out.write(f"{COMMENT_PREFIX}{prefix}{reference}\n")
    for read in bp.associated_split_reads:
        indent = len(prefix)
        indent += (base - len(read.mapped_sequence) if fiveprime
                   else base - len(read.unmapped_sequence))
        out.write(COMMENT_PREFIX + " " * indent)
        if fiveprime:
            out.write(read.mapped_sequence + read.unmapped_sequence)
        else:
            out.write(read.unmapped_sequence + read.mapped_sequence)
        out.write(f" (name: {read.name} sample: {read.sample_name}) \n")


def report_supporting_reads(reads: List[SimpleRead],
                            seq_names: Dict[int, str], out: TextIO
                            ) -> None:
    """search_MEI.cpp:449-467."""
    out.write(f"{COMMENT_PREFIX}All supporting sequences for this "
              "insertion (i.e. sequences that map inside the inserted "
              "element):\n")
    reads = list(reads)
    # comp_simple_read_pos (search_MEI_util.cpp:42-54) under std::sort
    cxx_sort(reads, lambda r1, r2:
             r1.tid < r2.tid
             or (r1.tid == r2.tid
                 and (r1.pos < r2.pos
                      or (r1.pos == r2.pos and r1.strand < r2.strand))))
    for read in reads:
        if read.is_split:
            out.write(f"?\t?\t?\t{read.name}\t{read.sample_name}\t"
                      f"{read.evidence_strand}\t"
                      f"{read.unmapped_sequence}\n")
        else:
            out.write(f"{seq_names[read.tid]}\t{read.pos}\t{read.strand}"
                      f"\t{read.name}\t{read.sample_name}\t"
                      f"{read.evidence_strand}\t{read.sequence}\n")


def report_mei_event(event: MEIEvent, count: int, genome: Genome,
                     seq_names: Dict[int, str], out: TextIO) -> None:
    """reportMEIevent (search_MEI.cpp:620-673)."""
    set_evidence_strands(event)
    all_reads = get_event_supporting_reads(event)
    all_read_count = (len(event.fwd_bp.associated_reads)
                      + len(event.fwd_bp.associated_split_reads)
                      + len(event.rev_bp.associated_reads)
                      + len(event.rev_bp.associated_split_reads))
    out.write("#" * 100 + "\n")
    out.write(f"{count}\tDD\t{seq_names[event.fwd_bp.tid]}\t"
              f"{event.fwd_bp.pos}\t{event.rev_bp.pos}\t{all_read_count}"
              f"\t{len(event.fwd_bp.associated_reads)}\t"
              f"{len(event.fwd_bp.associated_split_reads)}\t"
              f"{len(event.rev_bp.associated_reads)}\t"
              f"{len(event.rev_bp.associated_split_reads)}\n")
    out.write(f"{COMMENT_PREFIX}Dispersed Duplication insertion (DD) "
              f"found on chromosome '{seq_names[event.fwd_bp.tid]}', "
              f"breakpoint at {event.fwd_bp.pos} (estimated from + "
              f"strand), {event.rev_bp.pos} (estimated from - strand)\n")
    out.write(f"{COMMENT_PREFIX}Found {all_read_count} supporting reads, "
              f"of which {len(event.fwd_bp.associated_reads)} discordant "
              f"reads and {len(event.fwd_bp.associated_split_reads)} "
              f"split reads at 5' end, "
              f"{len(event.rev_bp.associated_reads)} discordant reads "
              f"and {len(event.rev_bp.associated_split_reads)} split "
              f"reads at 3' end.\n")
    out.write(f"{COMMENT_PREFIX}Supporting reads for insertion location "
              "(5' end):\n")
    report_split_read_support(genome, event.fwd_bp, True, seq_names, out)
    out.write(f"{COMMENT_PREFIX}Supporting reads for insertion location "
              "(3' end):\n")
    report_split_read_support(genome, event.rev_bp, False, seq_names, out)
    report_supporting_reads(all_reads, seq_names, out)


# ---------------------------------------------------------------- main

def search_dd_main(settings: Settings, genome: Genome, bam_entries,
                   readers: Dict[str, object], searcher,
                   regions=None, backend_factory=None) -> int:
    """searchMEImain (search_MEI.cpp:963-1024): window scan collecting
    breakpoints, then event pairing + reporting to ``_DD``."""
    from pindel_tpu_torch.pipeline import LoopingSearchWindow, build_regions

    ctx = DDContext(settings, genome, bam_entries, readers, searcher)
    mei_breakpoints: List[MEIBreakpoint] = []
    if regions is None:
        regions = build_regions(settings, genome)
    with open(settings.out("DD"), "w") as out:
        for bed in regions:
            chrom = genome.get(bed.chr_name)
            if chrom is None:
                return 1
            if backend_factory is not None:
                searcher.backend = backend_factory(chrom)
            window = LoopingSearchWindow(chrom, settings.window_size,
                                         bed.start, bed.end)
            while True:
                reads = load_discordant_reads(
                    ctx, chrom.name, window.current_start,
                    window.current_end)
                search_mei_breakpoints(ctx, reads, chrom,
                                       mei_breakpoints)
                window.next()
                if window.finished(False, 0):
                    break
        events = pair_events(mei_breakpoints, settings)
        if settings.dd_report_duplication_reads:
            append_cluster_connections(ctx, events, settings.window_size)
        for i, event in enumerate(events):
            report_mei_event(event, i + 1, genome, ctx.seq_names, out)
    return 0
