"""End-to-end discovery pipeline: windows → search → detect → report.

Mirrors the reference driver (pindel.cpp:1581-1990): per-chromosome BED
regions, 5 Mb ``LoopingSearchWindow`` scan, per-window read intake
(ReadInRead, reader.cpp:196-361), close/far anchor search (device
backends), detector cascade (SearchSVs, pindel.cpp:1141-1176) and report
emission.  Reference quirks preserved:

* reads whose BPRight transgresses the window edge are deferred to
  ``FutureReads_SR`` which the driver then clears — i.e. dropped
  (pindel.cpp:1919-1921 insert is a no-op because FutureReads is always
  empty at that point; the clear happens at :1961-1976);
* ``g_maxPos`` early-exit for pindel-format input (pindel.cpp:469-471);
* ``MatchedRelPos`` clamped to [0, biolSize] after window filtering.

The port's entry points follow ``Pipeline``: ``make_backend_factory``
builds the torch device backends (``fused`` on one device, ``mesh``
data-parallel over several), and ``run_files`` (pindel-text and BAM
discovery), ``run_dd_files`` (``-q``) and ``run_assembly_files`` (``-z``)
take the place of the reference's entries, which build their backend
through a closed switch over its own backend names.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, TextIO

import torch

from pindel_tpu_torch import dna
from pindel_tpu_torch.config import Settings
from pindel_tpu_torch.events.detect import (CandidateReads, SearchDeletions,
                                            SearchShortInsertions,
                                            WindowContext, search_indels_nt,
                                            search_inversions,
                                            search_inversions_nt,
                                            search_tandem_duplications,
                                            search_tandem_duplications_nt)
from pindel_tpu_torch.genome import SPACER, Chromosome, Genome
from pindel_tpu_torch.reads import SplitRead, read_pindel_file
from pindel_tpu_torch.report.reporter import (
    ReporterState, do_sort_and_output_inversions, merge_inter_chr,
    sort_and_output_tandem_duplications,
    sort_and_report_interchromosomal_events, sort_output_d, sort_output_di,
    sort_output_li, sort_output_rest, sort_output_si)
from pindel_tpu_torch.profiling import (ROOT, g_fallback, g_log,
                                        g_read_stats, g_timer)
from pindel_tpu_torch.search import Searcher

AROUND_REGION_BUFFER = 10_000   # pindel.cpp:127


class BoxMap:
    """Sparse stand-in for the reference's per-box index arrays: most of
    the NumBoxes (~2·chrom/BoxSize) boxes are empty, so materialize only
    the touched ones; iteration is in box-index order like the reference's
    0..NumBoxes-1 scan."""

    def __init__(self) -> None:
        self._m: Dict[int, List[int]] = {}

    def __getitem__(self, i: int) -> List[int]:
        box = self._m.get(i)
        if box is None:
            box = self._m[i] = []
        return box

    def __iter__(self):
        return iter([self._m[k] for k in sorted(self._m)])


@dataclasses.dataclass
class BedRegion:
    chr_name: str
    start: int
    end: int


@dataclasses.dataclass
class _WindowSnap:
    """Frozen bounds of one window for the pipelined process stage (the
    live LoopingSearchWindow advances while earlier windows are still
    being processed)."""

    current_start: int
    current_end: int
    displayed_start: int
    displayed_end: int
    index: int = 0          # global window counter (multi-host sharding)


_DELEGATED = "delegated"    # close/far results come from a peer process
_SKIP = "skip"              # worker replays RP->BD state only (peer's window)


def build_regions(settings: Settings, genome: Genome) -> List[BedRegion]:
    """-c / -j / -J region selection (pindel.cpp:1601-1716)."""
    import os

    from pindel_tpu_torch.regions import Fai, SearchRegion, build_include_bed
    fai_path = settings.reference_filename + ".fai"
    fai = (Fai.read(fai_path) if os.path.exists(fai_path)
           else Fai.from_genome(genome))
    region = SearchRegion.parse(settings.region or "ALL", fai)
    beds = build_include_bed(region, fai, settings.include_bed,
                             settings.exclude_bed)
    return [BedRegion(name, start, end) for name, start, end in beds]


class LoopingSearchWindow:
    """Reference pindel.h:718-737, pindel.cpp:344-473."""

    def __init__(self, chrom: Chromosome, bin_size: int,
                 bed_start: int, bed_end: int):
        self.chrom = chrom
        self.bin_size = bin_size
        self.official_start = bed_start
        self.global_start = max(bed_start - AROUND_REGION_BUFFER, 0) \
            if bed_start >= AROUND_REGION_BUFFER else 0
        self.official_end = bed_end
        self.global_end = min(chrom.biol_size, bed_end + AROUND_REGION_BUFFER)
        self.current_start = self.global_start
        self.displayed_start = self.official_start
        self._update_ends()

    def _update_ends(self):
        self.current_end = min(self.current_start + self.bin_size,
                               self.global_end)
        self.displayed_end = min(self.displayed_start + self.bin_size,
                                 self.official_end)

    def next(self):
        self.current_start += self.bin_size
        self.displayed_start += self.bin_size
        self._update_ends()

    def finished(self, pindel_input: bool, g_max_pos: int) -> bool:
        if pindel_input and self.current_start >= g_max_pos:
            return True
        return self.current_start > self.global_end


class Pipeline:
    def __init__(self, settings: Settings, genome: Genome,
                 backend_factory=None):
        from pindel_tpu_torch.bddata import BDData
        self.settings = settings
        self.genome = genome
        self.state = ReporterState(settings)
        self.searcher = Searcher(settings)
        self.backend_factory = backend_factory  # chrom -> backend
        self.g_max_pos = 0
        self.input_reads: List[SplitRead] = []
        self._consumed_chroms: set = set()
        self._input_loader = None
        self._stream = None      # streaming text intake (textindex.py)
        self.spool = None        # multi-host window spool (parallel/multihost)
        self.bam_entries: List = []              # BAM mode (-i)
        self._bam_readers: Dict[str, object] = {}
        self._outputs: Dict[str, TextIO] = {}
        self.bd = BDData(genome)                 # g_bdData
        self.state.bd = self.bd
        if settings.breakdancer_filename:        # -b (pindel.cpp:872-875)
            self.bd.load_bd_file(settings.breakdancer_filename)
        # -T: host worker threads (reference omp_set_num_threads,
        # pindel.cpp:917) — drives the native detector loop and
        # multi-BAM window intake
        from pindel_tpu_torch.events.detect import set_num_threads
        set_num_threads(settings.num_threads)

    @property
    def bam_input(self) -> bool:
        return bool(self.bam_entries)

    # ------------------------------------------------------------------ io
    def _try_stream(self, files: List[str]) -> bool:
        """Streaming byte-offset intake for pindel-text inputs: memory
        is O(16 B/read index + one window's reads) instead of the whole
        materialized read set (textindex.py).  gz inputs are spilled
        decompressed to scratch disk once and indexed there; irregular
        files fall back to the in-RAM loader."""
        if not self.settings.stream_text_input:
            return False
        from pindel_tpu_torch.textindex import PindelTextIndex
        try:
            with g_timer.phase("intake: index pindel text"):
                self._stream = PindelTextIndex(files)
        except ValueError:
            self._stream = None
            return False
        self.input_reads = []
        self._read_index = {}
        self._input_max_pos = self._stream.max_pos
        return True

    def load_pindel_input(self, path: str) -> None:
        self._input_loader = lambda: self.load_pindel_input(path)
        if self._try_stream([path]):
            return
        with g_timer.phase("intake: parse pindel text"):
            self.input_reads = list(read_pindel_file(path))
        with g_timer.phase("intake: index reads"):
            self._index_reads()

    def load_pindel_config(self, path: str) -> None:
        """-P: config file naming one pindel file per line (first token;
        rest of the line ignored).  Reference readPindelConfigFile
        (pindel.cpp:705-738); per window the files are consumed in config
        order (reader.cpp:1469-1479), which list concatenation preserves.
        """
        import os
        files: List[str] = []
        with open(path) as fh:
            for line in fh:
                toks = line.split()
                if not toks:
                    continue
                if not os.path.exists(toks[0]):
                    raise FileNotFoundError(
                        f"I cannot find the file '{toks[0]}' referred to in "
                        f"configuration file '{path}'")
                files.append(toks[0])
        if not files:
            raise ValueError(f"no samples in pindel config file '{path}'")
        self._input_loader = lambda: self.load_pindel_config(path)
        if self._try_stream(files):
            return
        self.input_reads = []
        for f in files:
            self.input_reads.extend(read_pindel_file(f))
        self._index_reads()

    def load_bam_config(self, path: str) -> None:
        """-i: bam config; sample tags enter g_sampleNames at init
        (reference readBamConfigFile, pindel.cpp:659-692)."""
        from pindel_tpu_torch.bam import BamReader, read_bam_config
        self.bam_entries = read_bam_config(path)
        for entry in self.bam_entries:
            self.state.sample_names.add(entry.tag)
            if entry.path not in self._bam_readers:
                self._bam_readers[entry.path] = BamReader(entry.path)
        # -N germline RD filter context
        self.state.bam_entries = self.bam_entries
        self.state.bam_readers = self._bam_readers
        self.state.genome = self.genome

    def create_output_files(self) -> None:
        """TestFileForOutput truncation at init (pindel.cpp:932-938) plus
        the unconditionally-created _RP / _INT_final (pindel.cpp:1767,1538)."""
        for suffix in ("SI", "D", "TD", "INV", "LI", "BP", "CloseEndMapped",
                       "RP", "INT_final"):
            open(self.settings.out(suffix), "w").close()

    def _out(self, suffix: str) -> TextIO:
        if suffix not in self._outputs:
            self._outputs[suffix] = open(self.settings.out(suffix), "a")
        return self._outputs[suffix]

    def close(self) -> None:
        for fh in self._outputs.values():
            fh.close()
        self._outputs.clear()
        if self._stream is not None:
            self._stream.close()

    # -------------------------------------------------------------- intake
    def _reload_input_if_consumed(self, chr_name: str) -> None:
        """Reads are handed to windows without copying and mutated in
        place; window intake ranges tile disjointly inside one BED region,
        but a second region on the same chromosome (overlapping buffered
        ranges, or a repeated run()) could hand a read out twice.  In that
        rare case reload pristine reads from disk — the reference gets the
        same effect by re-reading the file every window."""
        if self._stream is not None:
            return           # streaming re-parses pristine reads anyway
        if chr_name not in self._consumed_chroms:
            return
        if self._input_loader is not None:
            self._input_loader()
        self._consumed_chroms.clear()

    def _index_reads(self) -> None:
        """One-time (chrom -> position-sorted index) over the in-RAM read
        list so per-window intake is O(hits log hits) instead of a full
        rescan (the reference rescans the whole file every window,
        reader.cpp:196-361 — its g_maxPos early-exit only helps the tail).
        """
        import numpy as np
        by_chrom: Dict[str, List[int]] = {}
        for i, read in enumerate(self.input_reads):
            by_chrom.setdefault(read.frag_name, []).append(i)
        self._read_index = {}
        for name, idxs in by_chrom.items():
            idx = np.asarray(idxs, dtype=np.int64)
            pos = np.asarray([self.input_reads[i].matched_rel_pos
                              for i in idxs], dtype=np.int64)
            order = np.argsort(pos, kind="stable")
            self._read_index[name] = (pos[order], idx[order])
        self._input_max_pos = max(
            (r.matched_rel_pos for r in self.input_reads), default=0)

    def _window_reads(self, chrom: Chromosome,
                      window: LoopingSearchWindow) -> List[SplitRead]:
        """ReadInRead filter/clamp semantics (reader.cpp:227-246)."""
        import numpy as np
        # the reference's per-window full scan leaves g_maxPos at the
        # global maximum after the first window; the precomputed max is
        # observationally identical at every finished() check
        self.g_max_pos = self._input_max_pos
        taken: List[SplitRead] = []
        if self._stream is not None:
            batch = self._stream.window_reads(
                chrom.name, window.current_start, window.current_end)
            # MatchedRelPos clamp (reader.cpp:242-245) on the field
            # arrays — objects materialize later from the clamped values
            np.clip(batch.pos, 0, chrom.biol_size, out=batch.pos)
            return batch
        entry = getattr(self, "_read_index", {}).get(chrom.name)
        if entry is None:
            return taken
        pos, idx = entry
        lo = np.searchsorted(pos, window.current_start, side="left")
        hi = np.searchsorted(pos, window.current_end, side="left")
        hits = np.sort(idx[lo:hi])          # restore file order
        if hits.size:
            self._consumed_chroms.add(chrom.name)
        reads = self.input_reads
        for i in hits:
            # windows partition the read list, so each read is handed out
            # exactly once per run and is mutated in place; a re-run
            # reloads pristine reads from disk (see run())
            r = reads[i]
            if r.matched_rel_pos > chrom.biol_size:
                r.matched_rel_pos = chrom.biol_size
            if r.matched_rel_pos < 0:
                r.matched_rel_pos = 0
            taken.append(r)
        return taken

    def _window_reads_bam(self, chrom: Chromosome,
                          window: LoopingSearchWindow):
        """get_SR_Reads BAM branch (reader.cpp:1428-1467): per config
        entry, collect split reads + reference-supporting reads over the
        window, in file order."""
        s = self.settings

        def collect(entry):
            reader = self._bam_readers[entry.path]
            return reader.collect_sr(
                chrom.name, window.current_start, window.current_end,
                entry.insert_size, entry.tag, chrom.biol_size,
                min_anchor_quality=s.min_anchor_quality, nm=s.nm,
                max_mismatch_rate=s.max_allowed_mismatch_rate)

        paths = [e.path for e in self.bam_entries]
        if (s.num_threads > 1 and len(self.bam_entries) > 1
                and len(set(paths)) == len(paths)):
            # -T: per-sample intake in parallel (the native BAM decoder
            # releases the GIL); results consumed in config order, so
            # output is identical to the serial path
            from concurrent.futures import ThreadPoolExecutor
            with ThreadPoolExecutor(max_workers=s.num_threads) as pool:
                outs = list(pool.map(g_timer.bind(collect),
                                     self.bam_entries))
        else:
            outs = [collect(entry) for entry in self.bam_entries]
        reads: List[SplitRead] = []
        ref_reads: List = []
        for rs, rr in outs:
            reads.extend(rs)
            ref_reads.extend(rr)
        return reads, ref_reads

    def _window_rp_discovery(self, chrom: Chromosome,
                             window: LoopingSearchWindow):
        """get_RP_Reads_Discovery (reader.cpp:1348-1410): discordant
        pairs per bam config entry over the window."""
        s = self.settings
        same: List = []
        inter: List = []
        for entry in self.bam_entries:
            reader = self._bam_readers[entry.path]
            rs, ri = reader.collect_rp(
                chrom.name, window.current_start, window.current_end,
                entry.insert_size, entry.tag,
                min_anchor_quality=s.min_anchor_quality)
            same.extend(rs)
            inter.extend(ri)
        return same, inter

    def _update_ref_coverage(self, ref_reads: List,
                             window: LoopingSearchWindow) -> None:
        """UpdateRefReadCoverage (pindel.cpp:1272-1330): per-sample
        per-position counts over the current window; read interior
        positions 1..len-2 only."""
        import numpy as np
        samples = self.state.sorted_samples()
        idx = {name: i for i, name in enumerate(samples)}
        start = window.current_start
        end = window.current_end
        cov = np.zeros((end - start + 1, len(samples)), dtype=np.int32)
        for rr in ref_reads:
            if rr.pos < start or rr.pos + rr.read_length > end:
                continue
            sid = idx[rr.tag]
            base = rr.pos - start
            cov[base + 1: base + rr.read_length - 1, sid] += 1
        self.state.ref_coverage = cov

    # ----------------------------------------------------------------- run
    def build_regions(self) -> List[BedRegion]:
        return build_regions(self.settings, self.genome)

    def run(self, regions: Optional[List[BedRegion]] = None) -> None:
        s = self.settings
        self._window_counter = 0
        if regions is None:
            regions = self.build_regions()
        for bed in regions:
            chrom = self.genome.get(bed.chr_name)
            if chrom is None:
                raise ValueError(f"no chromosome {bed.chr_name}")
            with g_timer.phase("entry: region"):
                if not self.bam_input:
                    self._reload_input_if_consumed(bed.chr_name)
                chr_seq = chrom.seq_str(0, chrom.comp_size)
                self.state.mask = bytearray(b"N" * chrom.comp_size)
            self.g_max_pos = 0          # reset per bed region (:1799)
            box_size = max(chrom.comp_size // 30000, 1)
            num_boxes = chrom.comp_size * 2 // box_size + 1
            with g_timer.phase("entry: chromosome"):
                backend = (self.backend_factory(chrom)
                           if self.backend_factory else None)
            if backend is not None:
                self.searcher.backend = backend

            # Software-pipelined window loop: window N+1's reads are read
            # in and its close-end kernels DISPATCHED before window N's
            # host stages (far decode, detectors, reporting) run, so the
            # device works ahead of the host.  All outputs are still
            # produced strictly in window order by _process_window.
            window = LoopingSearchWindow(chrom, s.window_size,
                                         bed.start, bed.end)
            pending = None          # 1-deep: close dispatched
            pending_far = None      # 2-deep: far dispatched
            sp = self.spool
            # With no BD evidence, no BAM RP state and no spool, windows
            # share no search-time state, so the pipeline can run TWO
            # windows deep: window N's far kernels execute while window
            # N+1's close kernels are dispatched and window N-1 is
            # detected/reported on host.  Otherwise stay 1-deep (close
            # prefetch only) to preserve the sequential BD/RP semantics.
            # Deep pipelining now covers the BD/RP evidence configs too:
            # the stage step runs window N+1's RP->BD update + mask
            # rasterization before its far dispatch (the sequential
            # order the reference uses within a window), and the process
            # step re-installs window N's evidence state for reporting
            # (BD state is per-window — see bddata.update_bd).  Only the
            # multihost spool stays 1-deep (worker dumps are ordered).
            deep = sp is None
            while True:
                wsnap = _WindowSnap(window.current_start,
                                    window.current_end,
                                    window.displayed_start,
                                    window.displayed_end,
                                    self._window_counter)
                self._window_counter += 1
                with g_timer.phase("Reading in reads"):
                    if self.bam_input:
                        reads, ref_reads = self._window_reads_bam(
                            chrom, window)
                    else:
                        reads = self._window_reads(chrom, window)
                        ref_reads = []
                mine = sp is None or sp.mine(wsnap.index)
                staged = None
                if deep and pending is not None:
                    staged = self._search_stage(pending, chrom)
                    pending = None
                if mine:
                    with g_timer.phase("Matching close ends"):
                        token = self.searcher.map_close_ends_async(chrom,
                                                                   reads)
                elif sp is not None and sp.worker:
                    # a peer searches this window; the worker still
                    # replays its RP->BD evidence in window order
                    # (_process_window handles _SKIP)
                    token = _SKIP
                else:
                    token = _DELEGATED
                if deep:
                    if pending_far is not None:
                        self._process_window(pending_far, chrom, chr_seq,
                                             box_size, num_boxes, bed)
                    pending_far = staged
                elif pending is not None:
                    self._process_window(pending, chrom, chr_seq, box_size,
                                         num_boxes, bed)
                if not deep or pending is None:
                    pending = (wsnap, reads, ref_reads, token)
                window.next()
                if window.finished(not self.bam_input, self.g_max_pos):
                    break
            if deep and pending is not None:
                staged = self._search_stage(pending, chrom)
                pending = None
                if pending_far is not None:
                    self._process_window(pending_far, chrom, chr_seq,
                                         box_size, num_boxes, bed)
                pending_far = staged
            for tail in (pending_far, pending):
                if tail is not None:
                    self._process_window(tail, chrom, chr_seq, box_size,
                                         num_boxes, bed)
            pending = pending_far = None
        # final interchromosomal merge, unconditional (pindel.cpp:1999)
        with g_timer.phase("entry: finish"):
            if "INT" in self._outputs:
                self._outputs["INT"].flush()
            merge_inter_chr(self.settings.out("INT"))

    def _bd_regions_cb(self, chrom: Chromosome):
        """Far-end evidence-window callback over the CURRENT bd mask, or
        None when no BD/RP events exist."""
        if not (self.bd.events or self.bd.events_external):
            return None

        def bd_regions(read):
            regs = []
            for chr_name, w_start, w_end in \
                    self.bd.cluster_for(read.last_abs_loc_close_end()):
                c = self.genome.get(chr_name)
                if c is None:
                    raise ValueError(f"BD window chromosome {chr_name} "
                                     "not in reference")
                regs.append((c, w_start, w_end))
            return regs

        return bd_regions

    def _search_stage(self, pending, chrom: Chromosome):
        """Deep-pipelining half-step: run the window's RP->BD evidence
        update (the within-window order the reference uses:
        pindel.cpp:1838-1852 UpdateBD -> loadRegion -> search), then
        stream its close-end results chunk by chunk, dispatching each
        chunk's far-end kernels (BD windows first) as soon as it is
        finalized — far execution overlaps the remaining close chunks on
        device.  Reporting happens one iteration later; the stage runs
        strictly in window order, so _RP writes here stay ordered."""
        window, reads, ref_reads, token = pending
        s = self.settings
        bd_delta = None
        if self.bam_input and s.search_discordant_read_pair:
            with g_timer.phase("bd: rp discovery"):
                rp, rp_inter = self._window_rp_discovery(chrom, window)
            with g_timer.phase("bd: update"), \
                    g_timer.phase("bd: update_bd"):
                bd_delta = self.bd.update_bd(
                    rp, rp_inter, self._out("RP"),
                    s.report_interchromosomal_events)
        with g_timer.phase("bd: load region"):
            self.bd.load_region(chrom.name,
                                window.current_start + SPACER,
                                window.current_end + SPACER)
        with g_timer.phase("Matching close ends"):
            kept, far_tokens = self.searcher.close_far_stream(
                chrom, token, bd_regions=self._bd_regions_cb(chrom))
        return (window, reads, ref_reads, kept, far_tokens, bd_delta)

    def _process_window(self, pending, chrom: Chromosome, chr_seq: str,
                        box_size: int, num_boxes: int,
                        bed: BedRegion) -> None:
        """Host stages of one window, in window order (the close-end
        device work was dispatched when the window was read in)."""
        s = self.settings
        staged_delta = None
        staged = len(pending) == 6  # deep pipeline: search already staged
        if staged:
            window, reads, ref_reads, kept, far_tokens, staged_delta = \
                pending
            token = None
        else:
            window, reads, ref_reads, token = pending
            kept = far_tokens = None
        if token is _SKIP:
            # worker role, peer-owned window: nothing to do — BD
            # evidence state is per-window (update_bd resets to the
            # external events, mirroring bddata.cpp:649), and the
            # owning rank ships its window's delta + _RP text to the
            # coordinator with the searched reads
            g_read_stats.reset()
            return
        self.state.region_start = window.current_start
        self.state.region_end = window.current_end
        # g_maxInsertSize update in GetCloseEndInner (pindel.cpp:2257)
        # and g_sampleNames.insert for every in-window read
        # (reader.cpp:290,335) — both strictly in window order
        from pindel_tpu_torch.textindex import ReadBatch
        with g_timer.phase("window: bookkeeping"):
            if isinstance(reads, ReadBatch):
                if reads.n:
                    self.state.max_insert_size = max(
                        self.state.max_insert_size, int(reads.isz.max()))
                self.state.sample_names.update(reads.tags)
            else:
                for r in reads:
                    if r.insert_size > self.state.max_insert_size:
                        self.state.max_insert_size = r.insert_size
                    if not self.bam_input:
                        self.state.sample_names.add(r.tag)
        # RP discovery + BD-like event conversion (pindel.cpp:1837-1847),
        # then window rasterization.  Neither affects close-end mapping,
        # so they run after the close dispatch.  Sharding: only the
        # window's OWNER runs the RP channel; a delegated window's
        # delta + _RP text arrive with its payload (VERDICT r4 item 6).
        bd_delta = None
        rp_text = ""
        with_rp = self.bam_input and s.search_discordant_read_pair
        if staged:
            # the stage step already ran this window's RP->BD update
            # (and wrote its _RP lines, in window order); re-install its
            # evidence state for the reporters (-Q confirmation, RD
            # filters) — the stage of window N+1 has since overwritten
            # the shared mask
            bd_delta = staged_delta
            if with_rp:
                with g_timer.phase("bd: update"), \
                        g_timer.phase("bd: apply delta"):
                    self.bd.apply_bd_delta(bd_delta or [])
        elif token is _DELEGATED:
            with g_timer.phase("Matching close ends"):
                # close+far anchors computed by a peer process
                kept, bd_delta, rp_text = self.spool.load(window.index)
            if with_rp:
                self._out("RP").write(rp_text)
                with g_timer.phase("bd: update"), \
                        g_timer.phase("bd: apply delta"):
                    self.bd.apply_bd_delta(bd_delta)
        elif with_rp:
            import io
            with g_timer.phase("bd: rp discovery"):
                rp, rp_inter = self._window_rp_discovery(chrom, window)
            worker = self.spool is not None and self.spool.worker
            sink = io.StringIO() if worker else self._out("RP")
            with g_timer.phase("bd: update"), \
                    g_timer.phase("bd: update_bd"):
                bd_delta = self.bd.update_bd(
                    rp, rp_inter, sink, s.report_interchromosomal_events)
            if worker:
                rp_text = sink.getvalue()
        with g_timer.phase("bd: load region"):
            self.bd.load_region(chrom.name,
                                window.current_start + SPACER,
                                window.current_end + SPACER)
        with g_timer.phase("coverage: reference reads"):
            self._update_ref_coverage(ref_reads, window)
        g_read_stats.in_window += len(reads)
        if kept is None:
            # stream: finalize each close chunk as it lands and dispatch
            # its far kernels (BD windows first) while later close
            # chunks still execute
            with g_timer.phase("Matching close ends"):
                kept, far_tokens = self.searcher.close_far_stream(
                    chrom, token, bd_regions=self._bd_regions_cb(chrom))
        from pindel_tpu_torch.reads import PLUS
        if self.spool is not None and self.spool.worker and not kept:
            # coordinator still waits (and needs the evidence delta)
            self.spool.dump(window.index, [], bd_delta, rp_text)
            g_read_stats.reset()
            return
        with g_timer.phase("window: bookkeeping"):
            for r in kept:
                if r.matched_d == PLUS:
                    g_read_stats.close_mapped_plus += 1
                else:
                    g_read_stats.close_mapped_minus += 1
            for r in kept:
                if self.state.report_length < r.read_length:
                    self.state.report_length = r.read_length
                self.state.sample_names.add(r.tag)
        if kept:
            if s.report_close_mapped_reads or \
                    s.report_only_close_mapped_reads:
                with g_timer.phase("window: close-end report"):
                    out = self._out("CloseEndMapped")
                    for r in kept:
                        out.write(f"{r.name}\n{r.seq}\n{r.matched_d}"
                                  f"\t{r.frag_name}\t{r.matched_rel_pos}"
                                  f"\t{r.ms}\t{r.insert_size}"
                                  f"\t{r.tag}\n")
            if not s.report_only_close_mapped_reads:
                if far_tokens is not None:
                    # far kernels already dispatched per close chunk
                    with g_timer.phase("Searching far ends"):
                        for ft in far_tokens:
                            self.searcher.search_far_ends_finish(ft)
                from pindel_tpu_torch.reads import MINUS as _M, PLUS as _P
                with g_timer.phase("window: bookkeeping"):
                    for r in kept:
                        fa = r.up_far
                        if fa:
                            g_read_stats.far_mapped += 1
                            r.far_frag_name = fa.chr_names[fa.chr_id[0]]
                            r.matched_far_d = (_M if fa.strand_minus[0]
                                               else _P)
                if self.spool is not None and self.spool.worker:
                    # worker role: ship this window's searched reads to
                    # the coordinator and stop before any reporting
                    self.spool.dump(window.index, kept, bd_delta, rp_text)
                    g_read_stats.reset()
                    return
                # per-window interchromosomal pool (pindel.cpp:1905-1917)
                inter_sr: List[SplitRead] = []
                if s.report_interchromosomal_events:
                    import copy
                    with g_timer.phase("window: interchromosomal"):
                        inter_sr = [copy.copy(r) for r in kept
                                    if r.up_far
                                    and r.frag_name != r.far_frag_name]
                with g_timer.phase("Searching and reporting variations"):
                    self._search_svs(kept, chr_seq, window,
                                     box_size, num_boxes, bed)
                if s.report_interchromosomal_events and inter_sr:
                    with g_timer.phase("window: interchromosomal"):
                        sort_and_report_interchromosomal_events(
                            inter_sr, self._out("INT"))
        # showReadStats per window (reference reader.cpp:183-193)
        g_read_stats.show(
            f"{chrom.name}:{window.displayed_start}-"
            f"{window.displayed_end}")
        g_read_stats.reset()

    def _search_svs(self, reads: List[SplitRead], chr_seq: str,
                    window: LoopingSearchWindow, box_size: int,
                    num_boxes: int, bed: BedRegion) -> None:
        """SearchSVs detector cascade (pindel.cpp:1141-1176)."""
        s = self.settings

        def ctx() -> WindowContext:
            return WindowContext(chr_seq=chr_seq,
                                 window_end=window.current_end,
                                 region_start=bed.start,
                                 region_end=bed.end,
                                 box_size=box_size, num_boxes=num_boxes,
                                 future=[])

        def boxes() -> "BoxMap":
            return BoxMap()

        cand = CandidateReads(reads)
        d_boxes = boxes()
        with g_timer.phase("svs: detect D"):
            SearchDeletions().search(cand, ctx(), d_boxes)
        with g_timer.phase("svs: report D"):
            sort_output_d(reads, d_boxes, chr_seq, self._out("D"),
                          self.state)

        di_boxes = boxes()
        with g_timer.phase("svs: detect DI"):
            search_indels_nt(cand, ctx(), di_boxes, s)
        with g_timer.phase("svs: report DI"):
            sort_output_di(reads, di_boxes, chr_seq, self._out("D"),
                           self._out("INV"), self.state)

        if s.analyze_td:
            td_boxes = boxes()
            with g_timer.phase("svs: detect TD"):
                search_tandem_duplications(cand, ctx(), td_boxes)
            with g_timer.phase("svs: report TD"):
                sort_and_output_tandem_duplications(
                    reads, td_boxes, chr_seq, self._out("TD"), self.state,
                    False)
            td_nt_boxes = boxes()
            with g_timer.phase("svs: detect TD_NT"):
                search_tandem_duplications_nt(cand, ctx(), td_nt_boxes, s)
            with g_timer.phase("svs: report TD"):
                sort_and_output_tandem_duplications(
                    reads, td_nt_boxes, chr_seq, self._out("TD"),
                    self.state, True)

        if s.analyze_inv:
            inv_boxes = boxes()
            with g_timer.phase("svs: detect INV"):
                search_inversions(cand, ctx(), inv_boxes, s)
            with g_timer.phase("svs: report INV"):
                do_sort_and_output_inversions(
                    reads, inv_boxes, chr_seq, self._out("INV"), self.state,
                    False)
            inv_nt_boxes = boxes()
            with g_timer.phase("svs: detect INV_NT"):
                search_inversions_nt(cand, ctx(), inv_nt_boxes, s)
            with g_timer.phase("svs: report INV"):
                do_sort_and_output_inversions(
                    reads, inv_nt_boxes, chr_seq, self._out("INV"),
                    self.state, True)

        si_boxes = boxes()
        with g_timer.phase("svs: detect SI"):
            SearchShortInsertions().search(cand, ctx(), si_boxes)
        with g_timer.phase("svs: report SI"):
            sort_output_si(reads, si_boxes, chr_seq, self._out("SI"),
                           self.state)

        if s.analyze_li:
            with g_timer.phase("svs: LI"):
                sort_output_li(reads, chr_seq, window.current_start,
                               window.current_end, self._out("LI"),
                               self.state)
        # the reference never calls its BP detector (pindel.cpp:1171-1173
        # commented out): -k leaves _BP empty; force_bp_output resurrects it
        if s.force_bp_output:
            sort_output_rest(reads, chr_seq, window.current_start,
                             window.current_end, self._out("BP"), self.state)
        else:
            self._out("BP")
        self._out("LI")



BACKENDS = ("numpy", "jax", "fused", "mesh")


def resolve_device(device) -> torch.device:
    """The torch device to search on; asking for CUDA without a card
    raises (the port never runs on the CPU in its place)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but "
                           "torch.cuda.is_available() is false")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def make_backend_factory(settings: Settings, device, backend: str = "fused",
                         devices: Optional[Sequence] = None):
    """chrom -> device backend for a ``--backend`` name: ``numpy`` is no
    factory (the Searcher runs the NumPy oracle, ops/search_np.py, on the
    host, whatever ``device`` says); ``jax`` is the per-lane search
    TorchLaneBackend (K8) for every search on ``device`` (the reference's
    name; nothing imports jax); ``fused`` is TorchFusedBackend on
    ``device``; ``mesh`` is TorchMeshBackend over ``devices``, by default
    every visible card (or ``device`` itself when it is the CPU)."""
    if backend == "numpy":
        return None
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; the port has "
                         f"{', '.join(BACKENDS)}")
    dev = resolve_device(device)
    if backend == "jax":
        from pindel_tpu_torch.ops.engine_fused import device_state_from_numpy
        from pindel_tpu_torch.ops.engine_jax import TorchLaneBackend

        def factory(chrom):
            state = device_state_from_numpy(chrom.seq,
                                            settings.max_mismatch(), dev)
            return TorchLaneBackend(settings, state, chrom_name=chrom.name)
    elif backend == "fused":
        from pindel_tpu_torch.ops.engine_fused import TorchFusedBackend

        def factory(chrom):
            return TorchFusedBackend(settings, settings.max_mismatch(),
                                     chrom.seq, chrom_name=chrom.name,
                                     device=dev)
    else:
        from pindel_tpu_torch.parallel.mesh_fused import (TorchMeshBackend,
                                                          make_device_list)
        if devices is None:
            devices = make_device_list() if dev.type == "cuda" else [dev]
        devs = [resolve_device(d) for d in devices]

        def factory(chrom):
            return TorchMeshBackend(settings, settings.max_mismatch(),
                                    chrom.seq, devs, chrom_name=chrom.name)
    return factory


def check_supported(settings: Settings, backend: str = "fused") -> None:
    """Refuse settings whose search path does not run on a device backend.

    At -x 5 and above the last geometric far-end round spans 131,072 bp:
    its window bucket outgrows the spacer the tile gather relies on, and
    the reference's device backends fail an assert there
    (engine_jax.py:273-275); only its NumPy backend runs it, and so does
    the port's ``numpy``."""
    if settings.max_range_index > 4 and backend != "numpy":
        raise NotImplementedError(
            "-x > 4: the far-end window outgrows the chromosome spacer, "
            "which the reference's device backends do not run either "
            "(ROADMAP Queue 3); --backend numpy runs it")


def run_files(reference_fa: str, pindel_file: Optional[str],
              output_prefix: str, settings: Optional[Settings] = None,
              device="cuda", bam_config: Optional[str] = None,
              pindel_config: Optional[str] = None, backend: str = "fused",
              devices: Optional[Sequence] = None, spool=None) -> Settings:
    """Convenience entry: -f/-p|-i|-P/-o equivalent on torch devices;
    ``spool`` shards the windows over processes (parallel/multihost.py)."""
    s = settings or Settings()
    check_supported(s, backend)
    s.reference_filename = reference_fa
    s.pindel_filename = pindel_file or ""
    s.bam_config_filename = bam_config or ""
    s.pindel_config_filename = pindel_config or ""
    s.output_prefix = output_prefix
    factory = make_backend_factory(s, device, backend, devices)
    # per-run reset so repeated runs in one process report per-run costs
    # and per-run fallback counts; spans are recorded under --profile or
    # a torch profiler
    g_timer.reset(record=s.profile)
    g_fallback.reset()
    try:
        with g_timer.phase(ROOT):
            _run_pass(s, reference_fa, pindel_file, bam_config,
                      pindel_config, factory, spool)
    finally:
        # exit-time phase report (reference dumps timers at pindel.cpp:2010)
        g_timer.report(stream=g_log, coarse_only=not s.profile)
        g_log.close()
    return s


def _run_pass(s: Settings, reference_fa: str, pindel_file: Optional[str],
              bam_config: Optional[str], pindel_config: Optional[str],
              factory, spool) -> None:
    """One pass of run_files after its resets, under the root span."""
    if s.log_filename:                    # -L (pindel.cpp:839-842)
        g_log.redirect(s.log_filename)
    with g_timer.phase("entry: reference"):
        genome = Genome.from_fasta(reference_fa)
    with g_timer.phase("entry: inputs"):
        pipe = Pipeline(s, genome, backend_factory=factory)
        pipe.spool = spool                # multi-process window sharding
        pipe.create_output_files()
        # the detectors run a Python re-statement when their native
        # library fails to load; load it here so a failed build raises
        from pindel_tpu_torch.events.detect import _native_detect
        if _native_detect() is None:
            raise RuntimeError("native/detect.cpp failed to build or load")
        if bam_config:
            if s.search_discordant_read_pair:
                # bddata.modify_rp runs a Python re-statement when its
                # native library fails to load; load it here so a failed
                # build raises
                from pindel_tpu_torch.bddata import _native_rp
                _native_rp()
            # the streamed reader's block index is built on open
            with g_timer.phase("intake: bam index"):
                pipe.load_bam_config(bam_config)
        elif pindel_config:
            pipe.load_pindel_config(pindel_config)
        elif pindel_file:
            pipe.load_pindel_input(pindel_file)
        else:
            raise ValueError("need a pindel file (-p), bam config (-i) or "
                             "pindel config (-P)")
    try:
        pipe.run()
    finally:
        with g_timer.phase("entry: finish"):
            pipe.close()


def _bam_readers(entries) -> Dict[str, object]:
    from pindel_tpu_torch.bam import BamReader
    readers: Dict[str, object] = {}
    for e in entries:
        if e.path not in readers:
            readers[e.path] = BamReader(e.path)
    return readers


def run_dd_files(reference_fa: str, bam_config: str, output_prefix: str,
                 settings: Optional[Settings] = None, device="cuda",
                 backend: str = "fused",
                 devices: Optional[Sequence] = None) -> int:
    """-q entry (-f/-i/-o equivalent): dispersed duplications into
    ``<prefix>_DD``, close ends searched on torch devices."""
    from pindel_tpu_torch.bam import read_bam_config
    from pindel_tpu_torch.dd import search_dd_main
    s = settings or Settings()
    check_supported(s, backend)
    s.reference_filename = reference_fa
    s.bam_config_filename = bam_config
    s.output_prefix = output_prefix
    factory = make_backend_factory(s, device, backend, devices)
    g_fallback.reset()
    genome = Genome.from_fasta(reference_fa)
    entries = read_bam_config(bam_config)
    return search_dd_main(s, genome, entries, _bam_readers(entries),
                          Searcher(s), backend_factory=factory)


def run_assembly_files(reference_fa: str, bam_config: str, sv_path: str,
                       output_prefix: str,
                       settings: Optional[Settings] = None,
                       device="cuda", backend: str = "fused",
                       devices: Optional[Sequence] = None) -> int:
    """-z entry: assemble the SV list into ``<prefix>_ASM``, with the
    close- and far-end searches on torch devices."""
    from pindel_tpu_torch.assembly import Assembler
    from pindel_tpu_torch.bam import read_bam_config
    s = settings or Settings()
    check_supported(s, backend)
    s.reference_filename = reference_fa
    s.output_prefix = output_prefix
    factory = make_backend_factory(s, device, backend, devices)
    g_fallback.reset()
    genome = Genome.from_fasta(reference_fa)
    entries = read_bam_config(bam_config)
    asm = Assembler(s, genome, entries, _bam_readers(entries),
                    backend_factory=factory)
    asm.run(sv_path, s.out("ASM"))
    return 0
