"""Streaming pindel-text intake: byte-offset index + per-window parse.

The in-RAM loader materializes every SplitRead up front — fine at demo
scale, the wrong shape for 30x WGS where the pindel-format read set is
tens of gigabytes.  This index keeps O(16 bytes/read): one chunked scan
records, per record, its anchor chromosome, position and byte offset;
per-window intake then seeks and parses ONLY the window's records.

The reference's memory strategy is to re-read the whole file every
window and drop out-of-window records (ReadInRead, reader.cpp:196-361,
with the g_maxPos early-exit) — same O(window) working set, O(file)
re-scan per window; the index replaces the re-scan with binary search.

Record scanning and field parsing run in native code
(native/textscan.cpp, ctypes): the pure-Python record loop was ~20% of
warm pipeline wall at 50k reads.

gz inputs can't seek cheaply and fall back to the in-RAM loader.
"""
from __future__ import annotations

import ctypes
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from pindel_tpu_torch.reads import SplitRead

_CHUNK = 16 << 20
_NATIVE = None


def _lib():
    global _NATIVE
    if _NATIVE is None:
        from pindel_tpu_torch import native
        lib = native.load("pttext", ["textscan.cpp"], link=())
        lib.pt_scan.restype = ctypes.c_long
        lib.pt_scan.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.c_long, ctypes.c_int,
            ctypes.POINTER(ctypes.c_long)] + [ctypes.c_void_p] * 11 + [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_long),
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_long)]
        _NATIVE = lib
    return _NATIVE


_STR_CAP = 1 << 20


def _pt_scan(data: bytes, final: bool):
    """Scan 3-line records in ``data``; returns (count, consumed bytes,
    field arrays, chrom names, tag names)."""
    cap = data.count(b"\n") // 3 + 2
    arrs = [np.empty(cap, np.int64) for _ in range(5)]        # rec,no,nl,so,sl
    dm = np.empty(cap, np.int8)
    ints = [np.empty(cap, np.int64) for _ in range(3)]        # pos,ms,isz
    ids = [np.empty(cap, np.int32) for _ in range(2)]         # chrom,tag
    nbuf = ctypes.create_string_buffer(_STR_CAP)
    ncap = ctypes.c_long(_STR_CAP)
    tbuf = ctypes.create_string_buffer(_STR_CAP)
    tcap = ctypes.c_long(_STR_CAP)
    consumed = ctypes.c_long(0)

    def ptr(a):
        return ctypes.c_void_p(a.ctypes.data)

    cnt = _lib().pt_scan(
        data, len(data), cap, 1 if final else 0, ctypes.byref(consumed),
        *[ptr(a) for a in arrs], ptr(dm), *[ptr(a) for a in ints],
        *[ptr(a) for a in ids],
        ctypes.cast(nbuf, ctypes.c_char_p), ctypes.byref(ncap),
        ctypes.cast(tbuf, ctypes.c_char_p), ctypes.byref(tcap))
    if cnt < 0:
        raise ValueError(f"pindel text scan failed (code {cnt})")
    names = nbuf.raw[:ncap.value].decode().split("\n")[:-1] \
        if ncap.value else []
    tags = tbuf.raw[:tcap.value].decode().split("\n")[:-1] \
        if tcap.value else []
    fields = tuple(a[:cnt] for a in (*arrs, dm, *ints, *ids))
    return int(cnt), int(consumed.value), fields, names, tags


class ReadBatch:
    """Lazy window read set over the raw record blob: parsed field
    arrays up front, SplitRead objects materialized on demand — most
    reads never map a close end and never need an object.  Iterating or
    indexing materializes (compatibility with object-path consumers);
    the fused search path consumes the arrays directly."""

    __slots__ = ("blob", "no", "nl", "so", "sl", "dm", "pos", "ms",
                 "isz", "cid", "tid", "names", "tags", "n", "_text",
                 "_reads")

    def __init__(self, blob: bytes, fields, names, tags):
        self.blob = blob
        (_rec, self.no, self.nl, self.so, self.sl, self.dm, self.pos,
         self.ms, self.isz, self.cid, self.tid) = fields
        self.names = names
        self.tags = tags
        self.n = int(self.no.shape[0])
        self._text = None
        self._reads: List[Optional[SplitRead]] = [None] * self.n

    def __len__(self) -> int:
        return self.n

    def text(self) -> str:
        if self._text is None:
            self._text = self.blob.decode("ascii")
        return self._text

    def materialize(self, i: int) -> SplitRead:
        r = self._reads[i]
        if r is None:
            text = self.text()
            o = int(self.no[i])
            s = int(self.so[i])
            r = SplitRead.__new__(SplitRead)
            r.__dict__ = {
                "name": text[o:o + int(self.nl[i])],
                "seq": text[s:s + int(self.sl[i])],
                "matched_d": "-" if self.dm[i] else "+",
                "frag_name": self.names[int(self.cid[i])],
                "matched_rel_pos": int(self.pos[i]),
                "ms": int(self.ms[i]),
                "insert_size": int(self.isz[i]),
                "tag": self.tags[int(self.tid[i])]}
            self._reads[i] = r
        return r

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self.materialize(k)
                    for k in range(*i.indices(self.n))]
        return self.materialize(i)

    def __iter__(self):
        for i in range(self.n):
            yield self.materialize(i)

    @staticmethod
    def concat(batches: List["ReadBatch"]) -> "ReadBatch":
        """Merge per-file batches (a -P config names several files) into
        one window batch, remapping offsets and intern tables."""
        if len(batches) == 1:
            return batches[0]
        blob = b"".join(b.blob for b in batches)
        names: List[str] = []
        tags: List[str] = []
        nmap: Dict[str, int] = {}
        tmap: Dict[str, int] = {}
        cols = {k: [] for k in ("no", "nl", "so", "sl", "dm", "pos",
                                "ms", "isz", "cid", "tid")}
        base = 0
        for b in batches:
            cols["no"].append(b.no + base)
            cols["so"].append(b.so + base)
            for k in ("nl", "sl", "dm", "pos", "ms", "isz"):
                cols[k].append(getattr(b, k))
            cremap = np.array(
                [nmap.setdefault(nm, len(nmap)) for nm in b.names],
                np.int32) if b.names else np.zeros(0, np.int32)
            tremap = np.array(
                [tmap.setdefault(t, len(tmap)) for t in b.tags],
                np.int32) if b.tags else np.zeros(0, np.int32)
            cols["cid"].append(cremap[b.cid] if b.names else b.cid)
            cols["tid"].append(tremap[b.tid] if b.tags else b.tid)
            base += len(b.blob)
        names = [None] * len(nmap)
        for nm, i in nmap.items():
            names[i] = nm
        tags = [None] * len(tmap)
        for t, i in tmap.items():
            tags[i] = t
        fields = (None,) + tuple(
            np.concatenate(cols[k]) for k in ("no", "nl", "so", "sl",
                                              "dm", "pos", "ms", "isz",
                                              "cid", "tid"))
        return ReadBatch(blob, fields, names, tags)


def batch_from_buffer(blob: bytes) -> ReadBatch:
    """Parse a buffer of whole records into a lazy ReadBatch."""
    cnt, consumed, fields, names, tags = _pt_scan(blob, True)
    if consumed != len(blob) and blob[consumed:].strip():
        raise ValueError("record framing error in streaming intake")
    return ReadBatch(blob, fields, names, tags)


def records_from_buffer(blob: bytes) -> List[SplitRead]:
    """Parse a buffer of whole records into SplitReads (native scan +
    minimal per-record Python).  Only the parsed fields enter the
    instance dict; everything else resolves through SplitRead's
    class-level defaults."""
    cnt, consumed, fields, names, tags = _pt_scan(blob, True)
    if consumed != len(blob) and blob[consumed:].strip():
        raise ValueError("record framing error in streaming intake")
    _rec, no, nl, so, sl, dm, pos, ms, isz, cid, tid = fields
    text = blob.decode("ascii")
    nol, nll = no.tolist(), nl.tolist()
    sol, sll = so.tolist(), sl.tolist()
    dml, posl = dm.tolist(), pos.tolist()
    msl, iszl = ms.tolist(), isz.tolist()
    cidl, tidl = cid.tolist(), tid.tolist()
    out: List[SplitRead] = []
    ap = out.append
    new = SplitRead.__new__
    for i in range(cnt):
        r = new(SplitRead)
        ci = cidl[i]
        o = nol[i]
        s = sol[i]
        if ci >= 0:
            r.__dict__ = {
                "name": text[o:o + nll[i]], "seq": text[s:s + sll[i]],
                "matched_d": "-" if dml[i] else "+",
                "frag_name": names[ci],
                "matched_rel_pos": posl[i], "ms": msl[i],
                "insert_size": iszl[i], "tag": tags[tidl[i]]}
        else:
            r.__dict__ = {"name": text[o:o + nll[i]],
                          "seq": text[s:s + sll[i]]}
        ap(r)
    return out


_EMPTY_FIELDS = (np.zeros(0, np.int64),) * 5 + (
    np.zeros(0, np.int8),) + (np.zeros(0, np.int64),) * 3 + (
    np.zeros(0, np.int32),) * 2


class PindelTextIndex:
    """(chrom -> position-sorted (pos, file_id, offset)) over one or
    more pindel text files (a -P config is a file list).

    gz inputs are decompressed ONCE into a spill file and indexed there
    (gz offers no random access), so per-window memory stays O(window)
    at the cost of scratch disk — the reference's gz_line_reader instead
    rewinds and re-decompresses the whole file every window
    (gz_line_reader.cpp)."""

    def __init__(self, paths: List[str]):
        self.paths = []
        self._spills: List[str] = []
        for path in paths:
            if path.endswith(".gz"):
                self.paths.append(self._spill_gz(path))
            else:
                self.paths.append(path)
        self._handles: List = [None] * len(self.paths)
        chrom_ids: Dict[str, int] = {}
        chrom_l: List[np.ndarray] = []
        pos_l: List[np.ndarray] = []
        off_l: List[np.ndarray] = []
        fid_l: List[np.ndarray] = []
        self.sizes = []
        for fid, path in enumerate(self.paths):
            c, p, o = self._scan(path, chrom_ids)
            chrom_l.append(c)
            pos_l.append(p)
            off_l.append(o)
            fid_l.append(np.full(c.shape, fid, np.int32))
            self.sizes.append(os.path.getsize(path))
        chrom = np.concatenate(chrom_l) if chrom_l else np.zeros(0, np.int32)
        pos = np.concatenate(pos_l) if pos_l else np.zeros(0, np.int64)
        off = np.concatenate(off_l) if off_l else np.zeros(0, np.int64)
        fid = np.concatenate(fid_l) if fid_l else np.zeros(0, np.int32)
        self.max_pos = int(pos.max()) if pos.size else 0
        self.n_records = int(pos.size)
        self._by_chrom: Dict[str, Tuple[np.ndarray, ...]] = {}
        names = {v: k for k, v in chrom_ids.items()}
        for cid, name in names.items():
            sel = np.flatnonzero(chrom == cid)
            order = np.argsort(pos[sel], kind="stable")
            sel = sel[order]
            self._by_chrom[name] = (pos[sel], fid[sel], off[sel])
        # per-file record-start offsets in file order, for record ends
        self._file_offsets = [np.sort(o) for o in off_l]

    @staticmethod
    def _scan(path: str, chrom_ids: Dict[str, int]):
        """One sequential chunked pass (native scanner): per record, the
        meta line's (chrom, pos) plus the record's byte offset."""
        chrom_out: List[np.ndarray] = []
        pos_out: List[np.ndarray] = []
        off_out: List[np.ndarray] = []
        carry = b""
        base = 0            # file offset of carry[0]
        size = os.path.getsize(path)
        with open(path, "rb") as fh:
            while True:
                chunk = fh.read(_CHUNK)
                final = not chunk
                data = carry + chunk
                if not data:
                    break
                cnt, consumed, fields, names, _tags = _pt_scan(data, final)
                rec_off = fields[0]     # record byte offsets in `data`
                pos = fields[6]
                cid = fields[9]
                if cnt:
                    if int(cid.min()) < 0:
                        raise ValueError(
                            f"{path}: irregular pindel text (blank lines "
                            "or short records); streaming unsupported")
                    # map chunk-local chrom ids into the global table
                    remap = np.empty(len(names), np.int32)
                    for j, nm in enumerate(names):
                        gi = chrom_ids.get(nm)
                        if gi is None:
                            gi = chrom_ids[nm] = len(chrom_ids)
                        remap[j] = gi
                    chrom_out.append(remap[cid])
                    pos_out.append(pos.copy())
                    off_out.append(rec_off + base)
                carry = data[consumed:]
                base += consumed
                if final:
                    if carry.strip():
                        raise ValueError(
                            f"{path}: trailing partial record")
                    break
        if not chrom_out:
            return (np.zeros(0, np.int32), np.zeros(0, np.int64),
                    np.zeros(0, np.int64))
        return (np.concatenate(chrom_out),
                np.concatenate(pos_out).astype(np.int64),
                np.concatenate(off_out).astype(np.int64))

    def _spill_gz(self, path: str) -> str:
        """Stream-decompress a gz input into a scratch file (one pass,
        bounded memory) and index that instead."""
        import gzip
        import tempfile
        fd, spill = tempfile.mkstemp(prefix="pindel_tpu_gz_",
                                     suffix=".txt")
        with gzip.open(path, "rb") as src, os.fdopen(fd, "wb") as dst:
            while True:
                chunk = src.read(_CHUNK)
                if not chunk:
                    break
                dst.write(chunk)
        self._spills.append(spill)
        return spill

    def _handle(self, fid: int):
        if self._handles[fid] is None:
            self._handles[fid] = open(self.paths[fid], "rb")
        return self._handles[fid]

    def close(self) -> None:
        for h in self._handles:
            if h is not None:
                h.close()
        self._handles = [None] * len(self.paths)
        for spill in self._spills:
            try:
                os.unlink(spill)
            except OSError:
                pass
        self._spills = []

    def window_reads(self, chrom_name: str, start: int, end: int
                     ) -> "ReadBatch":
        """The records with start <= pos < end as a lazy ReadBatch, in
        config-file order then file order (matching the in-RAM loader's
        restored global read order)."""
        entry = self._by_chrom.get(chrom_name)
        if entry is None:
            return ReadBatch(b"", _EMPTY_FIELDS, [], [])
        pos, fid, off = entry
        lo = np.searchsorted(pos, start, side="left")
        hi = np.searchsorted(pos, end, side="left")
        if lo == hi:
            return ReadBatch(b"", _EMPTY_FIELDS, [], [])
        sel_f = fid[lo:hi]
        sel_o = off[lo:hi]
        batches: List[ReadBatch] = []
        for f in np.unique(sel_f).tolist():
            offs = np.sort(sel_o[sel_f == f])
            batches.append(batch_from_buffer(self._read_blob(int(f),
                                                             offs)))
        return ReadBatch.concat(batches)

    def _read_blob(self, fid: int, offs: np.ndarray) -> bytes:
        """Read the records at the given start offsets (sorted),
        coalescing adjacent records into single seeks."""
        fo = self._file_offsets[fid]
        idx = np.searchsorted(fo, offs)
        nxt = np.where(idx + 1 < fo.size, fo[np.minimum(idx + 1,
                                                        fo.size - 1)],
                       self.sizes[fid])
        fh = self._handle(fid)
        parts: List[bytes] = []
        k = 0
        n = offs.size
        while k < n:
            j = k
            while j + 1 < n and offs[j + 1] == nxt[j]:
                j += 1
            fh.seek(int(offs[k]))
            parts.append(fh.read(int(nxt[j] - offs[k])))
            k = j + 1
        return b"".join(parts)
