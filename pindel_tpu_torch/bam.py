"""BAM split-read channel: native reader bindings + bam-config support.

The heavy lifting (BGZF decode, record parse, mate pairing, weird/anchor/
ref-read classification, SPLIT_READ building) runs in C++
(native/bamio.cpp), mirroring the reference's reader.cpp semantics; this
module wraps the C ABI and converts the packed outputs into SplitRead
objects plus the window's reference-supporting reads as arrays.

Reference: bam config file format — one line per BAM: path, insert size,
sample tag (readBamConfigFile, pindel.cpp:659-692).
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from pindel_tpu_torch.profiling import g_bam, g_timer
from pindel_tpu_torch.reads import SplitRead


@dataclasses.dataclass
class BamConfigEntry:
    path: str
    insert_size: int
    tag: str


@dataclasses.dataclass
class RefRead:
    """REF_READ (reference pindel.h:250-258)."""

    pos: int
    mq: int
    read_length: int
    tag: str


@dataclasses.dataclass
class RefReads:
    """One BAM entry's reference reads over a window, as arrays in file
    order: the REF_READ fields ``pos`` (int64), ``mq`` and ``length``
    (int32), one element a read, all under the entry's sample ``tag``.
    Iterating yields them as ``RefRead`` objects."""

    tag: str
    pos: np.ndarray
    mq: np.ndarray
    length: np.ndarray

    @classmethod
    def empty(cls, tag: str) -> "RefReads":
        return cls(tag, np.zeros(0, np.int64), np.zeros(0, np.int32),
                   np.zeros(0, np.int32))

    def __len__(self) -> int:
        return len(self.pos)

    def __iter__(self):
        for p, q, n in zip(self.pos.tolist(), self.mq.tolist(),
                           self.length.tolist()):
            yield RefRead(p, q, n, self.tag)


@dataclasses.dataclass
class DiscordantPairs:
    """One BAM entry's discordant read pairs over a window, as the native
    RP walk (``ptbam_collect_rp``) finds them, in file order: the read's
    ``pos`` (int64), its mate's ``mpos`` (int64) and reference id ``mtid``
    (int32), the read's ``length`` (int32) and ``strands`` (int8; bit 0
    the read reversed, bit 1 its mate), one element a pair."""

    pos: np.ndarray
    mpos: np.ndarray
    mtid: np.ndarray
    length: np.ndarray
    strands: np.ndarray

    @classmethod
    def empty(cls) -> "DiscordantPairs":
        return cls(np.zeros(0, np.int64), np.zeros(0, np.int64),
                   np.zeros(0, np.int32), np.zeros(0, np.int32),
                   np.zeros(0, np.int8))

    def __len__(self) -> int:
        return len(self.pos)


def read_bam_config(path: str) -> List[BamConfigEntry]:
    """readBamConfigFile (pindel.cpp:659-692)."""
    entries: List[BamConfigEntry] = []
    with open(path) as fh:
        for line in fh:
            parts = line.split()
            if len(parts) < 3:
                continue
            entries.append(BamConfigEntry(parts[0], int(parts[1]),
                                          parts[2]))
    if not entries:
        raise ValueError(f"no entries in bam config {path}")
    return entries


def _lib():
    from pindel_tpu_torch import native
    lib = native.load("ptbam", ["bamio.cpp"])
    lib.ptbam_open.restype = ctypes.c_void_p
    lib.ptbam_open.argtypes = [ctypes.c_char_p]
    lib.ptbam_open_stream.restype = ctypes.c_void_p
    lib.ptbam_open_stream.argtypes = [ctypes.c_char_p]
    lib.ptbam_resident_records.restype = ctypes.c_int64
    lib.ptbam_resident_records.argtypes = [ctypes.c_void_p]
    lib.ptbam_error.restype = ctypes.c_char_p
    lib.ptbam_error.argtypes = [ctypes.c_void_p]
    lib.ptbam_close.argtypes = [ctypes.c_void_p]
    lib.ptbam_n_refs.restype = ctypes.c_int32
    lib.ptbam_n_refs.argtypes = [ctypes.c_void_p]
    lib.ptbam_ref_name.restype = ctypes.c_char_p
    lib.ptbam_ref_name.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.ptbam_ref_len.restype = ctypes.c_int64
    lib.ptbam_ref_len.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.ptbam_n_records.restype = ctypes.c_int64
    lib.ptbam_n_records.argtypes = [ctypes.c_void_p]
    lib.ptbam_collect_sr.restype = ctypes.c_int64
    lib.ptbam_collect_sr.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_double, ctypes.c_int64]
    for fn, restype in [
            ("ptbam_sr_names", ctypes.POINTER(ctypes.c_char)),
            ("ptbam_sr_seqs", ctypes.POINTER(ctypes.c_char)),
            ("ptbam_sr_pos", ctypes.POINTER(ctypes.c_int64)),
            ("ptbam_sr_ms", ctypes.POINTER(ctypes.c_int32)),
            ("ptbam_sr_dir", ctypes.POINTER(ctypes.c_int8)),
            ("ptbam_ref_read_pos", ctypes.POINTER(ctypes.c_int64)),
            ("ptbam_ref_read_mq", ctypes.POINTER(ctypes.c_int32)),
            ("ptbam_ref_read_len", ctypes.POINTER(ctypes.c_int32))]:
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    for fn in ("ptbam_sr_names_size", "ptbam_sr_seqs_size",
               "ptbam_n_ref_reads"):
        getattr(lib, fn).restype = ctypes.c_int64
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    lib.ptbam_collect_rp.restype = ctypes.c_int64
    lib.ptbam_collect_rp.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int64]
    lib.ptbam_collect_rp_gt.restype = ctypes.c_int64
    lib.ptbam_collect_rp_gt.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64]
    lib.ptbam_collect_dd.restype = ctypes.c_int64
    lib.ptbam_collect_dd.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64]
    lib.ptbam_header_text.restype = ctypes.c_char_p
    lib.ptbam_header_text.argtypes = [ctypes.c_void_p]
    lib.ptbam_depth_sum.restype = ctypes.c_int64
    lib.ptbam_depth_sum.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int32]
    lib.ptbam_dd_rg.restype = ctypes.POINTER(ctypes.c_char)
    lib.ptbam_dd_rg.argtypes = [ctypes.c_void_p]
    lib.ptbam_dd_rg_size.restype = ctypes.c_int64
    lib.ptbam_dd_rg_size.argtypes = [ctypes.c_void_p]
    return lib


class BamReader:
    """One parsed BAM file, window-queryable."""

    def __init__(self, path: str, streamed: bool = True):
        """``streamed`` (default): only the current window's records are
        resident — the first pass builds a block index and per-window
        queries re-decode just the needed BGZF members (the reference
        shape: per-window htslib range queries, reader.cpp:483-559).
        ``streamed=False`` decodes the whole file up front (fastest for
        repeated whole-file scans; also the PINDEL_TPU_BAM_WHOLEFILE=1
        escape hatch)."""
        import os
        if os.environ.get("PINDEL_TPU_BAM_WHOLEFILE"):
            streamed = False
        self.path = path
        self.streamed = streamed
        self._lib = _lib()
        opener = (self._lib.ptbam_open_stream if streamed
                  else self._lib.ptbam_open)
        self._h = opener(path.encode())
        err = self._lib.ptbam_error(self._h).decode()
        if err:
            self._lib.ptbam_close(self._h)
            self._h = None
            raise IOError(f"{path}: {err}")
        self.ref_names = [
            self._lib.ptbam_ref_name(self._h, i).decode()
            for i in range(self._lib.ptbam_n_refs(self._h))]
        self.ref_lens = [self._lib.ptbam_ref_len(self._h, i)
                         for i in range(len(self.ref_names))]
        self.n_records = self._lib.ptbam_n_records(self._h)
        # the range the native window cache decoded last (g_bam's loads)
        self._cached = None
        g_bam.opened(self.n_records)
        if not streamed:
            g_bam.loaded(self.n_records)

    def close(self):
        if self._h is not None:
            self._lib.ptbam_close(self._h)
            self._h = None

    def __del__(self):
        self.close()

    def collect_sr(self, chrom_name: str, start: int, end: int,
                   insert_size: int, tag: str, biol_size: int,
                   min_anchor_quality: int = 0, nm: int = 2,
                   max_mismatch_rate: float = 0.02
                   ) -> Tuple[List[SplitRead], RefReads]:
        """Split-read + ref-read collection over [start, end).

        Mirrors ReadInBamReads_SR (reader.cpp:483-559) for one window of
        one BAM; the insert-size sanity abort (reader.cpp:868-877) is
        raised as ValueError.
        """
        if chrom_name not in self.ref_names:
            return [], RefReads.empty(tag)
        tid = self.ref_names.index(chrom_name)
        with g_timer.phase("intake: bam decode"):
            n = self._query(self._lib.ptbam_collect_sr, tid, start, end,
                            min_anchor_quality, nm, max_mismatch_rate,
                            biol_size)
        with g_timer.phase("intake: bam objects"):
            return self._sr_objects(n, chrom_name, insert_size, tag)

    def _query(self, fn, tid: int, start: int, end: int, *args):
        """``fn(handle, tid, start, end, *args)``, a native query over
        [start, end) of ``tid``, which first makes the range resident
        (``ensure_window``).  Where the streamed reader inflates and
        decodes it for that, ``g_bam`` counts a load and the records then
        resident.  The native cache holds the range it decoded last,
        reaching back by the contig's longest record: it serves a query on
        that contig that starts no earlier and ends no later.  The
        whole-file reader counted its one decode on open."""
        load = False
        if self.streamed and 0 <= tid < len(self.ref_names):
            c = self._cached
            load = not (c and c[0] == tid and c[1] <= start and end <= c[2])
            if load:
                self._cached = (tid, start, end)
        out = fn(self._h, tid, start, end, *args)
        if load:
            g_bam.loaded(self._lib.ptbam_resident_records(self._h))
        return out

    def _pool(self, fn, n: int) -> np.ndarray:
        """A copy of the first ``n`` elements of a decoder pool, which the
        decoder's next call overwrites."""
        return np.ctypeslib.as_array(fn(self._h), (n,)).copy()

    def _sr_objects(self, n: int, chrom_name: str, insert_size: int,
                    tag: str) -> Tuple[List[SplitRead], RefReads]:
        """The split reads and reference reads of the last collect_sr; the
        reference reads are copied out of the decoder's pools, which its
        next call overwrites."""
        reads: List[SplitRead] = []
        if n:
            names = ctypes.string_at(
                self._lib.ptbam_sr_names(self._h),
                self._lib.ptbam_sr_names_size(self._h)
            ).decode().split("\0")[:-1]
            seqs = ctypes.string_at(
                self._lib.ptbam_sr_seqs(self._h),
                self._lib.ptbam_sr_seqs_size(self._h)
            ).decode().split("\0")[:-1]
            pos = self._lib.ptbam_sr_pos(self._h)
            ms = self._lib.ptbam_sr_ms(self._h)
            dr = self._lib.ptbam_sr_dir(self._h)
            for i in range(n):
                seq = seqs[i]
                if insert_size <= len(seq):
                    raise ValueError(
                        f"insert size {insert_size} <= read length "
                        f"{len(seq)} in {self.path}; fix the bam config")
                r = SplitRead(name=names[i], frag_name=chrom_name,
                              matched_d=chr(dr[i]),
                              matched_rel_pos=int(pos[i]), ms=int(ms[i]),
                              insert_size=insert_size, tag=tag)
                r.set_seq(seq)
                reads.append(r)
        nref = self._lib.ptbam_n_ref_reads(self._h)
        if not nref:
            return reads, RefReads.empty(tag)
        lib = self._lib
        return reads, RefReads(tag, self._pool(lib.ptbam_ref_read_pos, nref),
                               self._pool(lib.ptbam_ref_read_mq, nref),
                               self._pool(lib.ptbam_ref_read_len, nref))

    def header_text(self) -> str:
        """SAM header text (for @RG sample dictionaries)."""
        return self._lib.ptbam_header_text(self._h).decode(
            errors="replace")

    def collect_dd(self, tid: int, start: int, end: int,
                   insert_size: int, min_dd_map_distance: int):
        """Discordant reads for DD/-q mode (fetch_disc_read_callback,
        search_MEI.cpp:689-713).  Returns parallel lists/arrays:
        (names, seqs, read_groups, pos, mpos, mtid, l_qseq, strand_bits)
        where strand_bits packs read-reverse / mate-reverse / READ1."""
        n = self._query(self._lib.ptbam_collect_dd, tid, start, end,
                        insert_size, min_dd_map_distance)
        if not n:
            return [], [], [], [], [], [], [], []
        names = ctypes.string_at(
            self._lib.ptbam_sr_names(self._h),
            self._lib.ptbam_sr_names_size(self._h)
        ).decode().split("\0")[:-1]
        seqs = ctypes.string_at(
            self._lib.ptbam_sr_seqs(self._h),
            self._lib.ptbam_sr_seqs_size(self._h)
        ).decode().split("\0")[:-1]
        rgs = ctypes.string_at(
            self._lib.ptbam_dd_rg(self._h),
            self._lib.ptbam_dd_rg_size(self._h)
        ).decode().split("\0")[:-1]
        pos = self._lib.ptbam_ref_read_pos(self._h)
        mpos = self._lib.ptbam_sr_pos(self._h)
        mtid = self._lib.ptbam_sr_ms(self._h)
        lens = self._lib.ptbam_ref_read_len(self._h)
        bits = self._lib.ptbam_sr_dir(self._h)
        rng = range(n)
        return (names, seqs, rgs,
                [pos[i] for i in rng], [mpos[i] for i in rng],
                [mtid[i] for i in rng], [lens[i] for i in rng],
                [bits[i] for i in rng])

    def depth_sum(self, chrom_name: str, beg: int, end: int,
                  min_mapq: int = 20) -> int:
        """Summed per-base depth over [beg, end) (reference bam2depth
        pileup loop, bam2depth.cpp:72-95)."""
        if chrom_name not in self.ref_names:
            return 0
        tid = self.ref_names.index(chrom_name)
        return int(self._query(self._lib.ptbam_depth_sum, tid, beg, end,
                               min_mapq))

    def collect_rp(self, chrom_name: str, start: int, end: int,
                   insert_size: int, tag: str,
                   min_anchor_quality: int = 0):
        """Discordant read-pair discovery over [start, end).

        Mirrors build_record_RP_Discovery (reader.cpp:982-1097) including
        the same-chromosome PosA<PosB swap normalization; returns
        (same-chromosome RPReads, interchromosomal RPReads): the native
        walk (``rp_pairs``) and the objects built from it (``rp_reads``).
        """
        return self.rp_reads(
            chrom_name, insert_size, tag,
            self.rp_pairs(chrom_name, start, end, insert_size,
                          min_anchor_quality))

    def rp_pairs(self, chrom_name: str, start: int, end: int,
                 insert_size: int,
                 min_anchor_quality: int = 0) -> DiscordantPairs:
        """The discordant pairs of [start, end): ``ptbam_collect_rp`` over
        the window it makes resident, copied out of the decoder's pools.
        Run while the split-read channel's window is still resident, it
        decodes nothing again."""
        if chrom_name not in self.ref_names:
            return DiscordantPairs.empty()
        tid = self.ref_names.index(chrom_name)
        with g_timer.phase("intake: bam rp"):
            n = self._query(self._lib.ptbam_collect_rp, tid, start, end,
                            min_anchor_quality, insert_size)
            if not n:
                return DiscordantPairs.empty()
            lib = self._lib
            return DiscordantPairs(self._pool(lib.ptbam_ref_read_pos, n),
                                   self._pool(lib.ptbam_sr_pos, n),
                                   self._pool(lib.ptbam_sr_ms, n),
                                   self._pool(lib.ptbam_ref_read_len, n),
                                   self._pool(lib.ptbam_sr_dir, n))

    def rp_reads(self, chrom_name: str, insert_size: int, tag: str,
                 pairs: DiscordantPairs):
        """(same-chromosome RPReads, interchromosomal RPReads) of the
        discordant pairs ``rp_pairs`` found on ``chrom_name``, with the
        PosA<PosB normalization of same-chromosome pairs."""
        from pindel_tpu_torch.bddata import RPRead
        same: list = []
        inter: list = []
        # bulk-copy to python lists once (per-element array indexing and
        # dataclasses.replace dominated this loop)
        pos = pairs.pos.tolist()
        mpos = pairs.mpos.tolist()
        mtid = pairs.mtid.tolist()
        lens = pairs.length.tolist()
        strands = pairs.strands.tolist()
        nref = len(self.ref_names)
        for i in range(len(pos)):
            da = "-" if strands[i] & 1 else "+"
            db = "-" if strands[i] & 2 else "+"
            pa, pb = pos[i], mpos[i]
            chr_b = self.ref_names[mtid[i]] if 0 <= mtid[i] < nref else ""
            if chr_b == chrom_name and pa >= pb:
                # PosA < PosB normalization (reader.cpp:1061-1090)
                same.append(RPRead(
                    chr_name_a=chr_b, chr_name_b=chrom_name,
                    da=db, db=da, pos_a=pb, pos_b=pa,
                    original_pos_a=pb, original_pos_b=pa,
                    insert_size=insert_size, read_length=lens[i],
                    tag=tag, tags=[tag]))
                continue
            r = RPRead(chr_name_a=chrom_name, chr_name_b=chr_b,
                       da=da, db=db, pos_a=pa, pos_b=pb,
                       original_pos_a=pa, original_pos_b=pb,
                       insert_size=insert_size, read_length=lens[i],
                       tag=tag, tags=[tag])
            (same if chr_b == chrom_name else inter).append(r)
        return same, inter

    def collect_rp_gt(self, chrom_name: str, start: int, end: int,
                      insert_size: int):
        """Read pairs for genotyping over [start, end).

        Mirrors build_record_RP (reader.cpp:925-980): pairs with
        tid != mtid or |isize| > l_qseq + 2*insert; returns numpy arrays
        (pos_a, pos_b, mate_chrom_id, mapq) — MQA == MQB == mapq in the
        reference (reader.cpp:968-969).
        """
        import numpy as np
        if chrom_name not in self.ref_names:
            z = np.zeros(0, np.int64)
            return z, z, np.zeros(0, np.int32), np.zeros(0, np.int32)
        tid = self.ref_names.index(chrom_name)
        n = self._query(self._lib.ptbam_collect_rp_gt, tid, start, end,
                        insert_size)
        if not n:
            z = np.zeros(0, np.int64)
            return z, z, np.zeros(0, np.int32), np.zeros(0, np.int32)
        pos = np.ctypeslib.as_array(
            self._lib.ptbam_ref_read_pos(self._h), (n,)).copy()
        mpos = np.ctypeslib.as_array(
            self._lib.ptbam_sr_pos(self._h), (n,)).copy()
        mtid = np.ctypeslib.as_array(
            self._lib.ptbam_sr_ms(self._h), (n,)).copy()
        mq = np.ctypeslib.as_array(
            self._lib.ptbam_ref_read_mq(self._h), (n,)).copy()
        return pos, mpos, mtid, mq
