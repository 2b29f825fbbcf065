"""BAM split-read channel: native reader bindings + bam-config support.

The heavy lifting (BGZF decode, record parse, mate pairing, weird/anchor/
ref-read classification, SPLIT_READ building) runs in C++
(native/bamio.cpp), mirroring the reference's reader.cpp semantics; this
module wraps the C ABI and converts the packed outputs into SplitRead
objects plus reference-supporting read tuples.

Reference: bam config file format — one line per BAM: path, insert size,
sample tag (readBamConfigFile, pindel.cpp:659-692).
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import List, Optional, Tuple

from pindel_tpu_torch.profiling import g_timer
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
                   ) -> Tuple[List[SplitRead], List[RefRead]]:
        """Split-read + ref-read collection over [start, end).

        Mirrors ReadInBamReads_SR (reader.cpp:483-559) for one window of
        one BAM; the insert-size sanity abort (reader.cpp:868-877) is
        raised as ValueError.
        """
        if chrom_name not in self.ref_names:
            return [], []
        tid = self.ref_names.index(chrom_name)
        with g_timer.phase("intake: bam decode"):
            n = self._lib.ptbam_collect_sr(
                self._h, tid, start, end, min_anchor_quality, nm,
                max_mismatch_rate, biol_size)
        with g_timer.phase("intake: bam objects"):
            return self._sr_objects(n, chrom_name, insert_size, tag)

    def _sr_objects(self, n: int, chrom_name: str, insert_size: int,
                    tag: str) -> Tuple[List[SplitRead], List[RefRead]]:
        """The split reads and reference reads of the last collect_sr."""
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
        ref_reads: List[RefRead] = []
        if nref:
            rp = self._lib.ptbam_ref_read_pos(self._h)
            rq = self._lib.ptbam_ref_read_mq(self._h)
            rl = self._lib.ptbam_ref_read_len(self._h)
            ref_reads = [RefRead(int(rp[i]), int(rq[i]), int(rl[i]), tag)
                         for i in range(nref)]
        return reads, ref_reads

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
        n = self._lib.ptbam_collect_dd(self._h, tid, start, end,
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
        return int(self._lib.ptbam_depth_sum(self._h, tid, beg, end,
                                             min_mapq))

    def collect_rp(self, chrom_name: str, start: int, end: int,
                   insert_size: int, tag: str,
                   min_anchor_quality: int = 0):
        """Discordant read-pair discovery over [start, end).

        Mirrors build_record_RP_Discovery (reader.cpp:982-1097) including
        the same-chromosome PosA<PosB swap normalization; returns
        (same-chromosome RPReads, interchromosomal RPReads).
        """
        from pindel_tpu_torch.bddata import RPRead
        if chrom_name not in self.ref_names:
            return [], []
        tid = self.ref_names.index(chrom_name)
        n = self._lib.ptbam_collect_rp(self._h, tid, start, end,
                                       min_anchor_quality, insert_size)
        same: list = []
        inter: list = []
        if not n:
            return same, inter
        # pools reused by the native side: pos / mpos / mtid / mapq / len;
        # bulk-copy to python lists once (per-element ctypes pointer
        # indexing and dataclasses.replace dominated this loop)
        import numpy as np
        pos = np.ctypeslib.as_array(
            self._lib.ptbam_ref_read_pos(self._h), (n,)).tolist()
        mpos = np.ctypeslib.as_array(
            self._lib.ptbam_sr_pos(self._h), (n,)).tolist()
        mtid = np.ctypeslib.as_array(
            self._lib.ptbam_sr_ms(self._h), (n,)).tolist()
        lens = np.ctypeslib.as_array(
            self._lib.ptbam_ref_read_len(self._h), (n,)).tolist()
        strands = np.ctypeslib.as_array(
            self._lib.ptbam_sr_dir(self._h), (n,)).tolist()
        nref = len(self.ref_names)
        for i in range(n):
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
        n = self._lib.ptbam_collect_rp_gt(self._h, tid, start, end,
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
