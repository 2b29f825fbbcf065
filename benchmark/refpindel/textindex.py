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

Record scanning and field parsing: ``_pt_scan``, a Python restatement of
the port's native scanner (native/textscan.cpp).

gz inputs can't seek cheaply and fall back to the in-RAM loader.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from refpindel.reads import SplitRead

_CHUNK = 16 << 20
_WS = b" \t\r"
_ALNUM = [chr(c).isascii() and chr(c).isalnum() for c in range(256)]


def _token(line: bytes, i: int):
    """The next token of ``line`` from ``i`` (skipping spaces, tabs and
    CRs): (start, end)."""
    n = len(line)
    while i < n and line[i] in _WS:
        i += 1
    j = i
    while j < n and line[j] not in _WS:
        j += 1
    return i, j


def _long(line: bytes, i: int):
    """A signed decimal at ``i`` (after spaces, tabs, CRs): (value, end), or
    None where none starts there."""
    n = len(line)
    while i < n and line[i] in _WS:
        i += 1
    neg = False
    if i < n and line[i] in b"+-":
        neg = line[i] == 45
        i += 1
    j = i
    while j < n and 48 <= line[j] <= 57:
        j += 1
    if j == i:
        return None
    v = int(line[i:j])
    return (-v if neg else v), j


def _pt_scan(data: bytes, final: bool):
    """Scan 3-line records in ``data``; returns (count, consumed bytes,
    field arrays, chrom names, tag names).  The port's ``textscan.cpp``,
    restated: per record the offsets of the record, its name and its
    sequence (trailing non-alphanumerics trimmed), the meta line's strand,
    position, mapping quality and insert size, and first-seen ids of its
    chromosome and tag (-1, and zeros, where the meta line is short); with
    ``final`` a last record without its newlines counts."""
    n = len(data)
    cols = [[] for _ in range(11)]
    chroms: Dict[bytes, int] = {}
    tags: Dict[bytes, int] = {}
    p = consumed = 0

    def line_end(i):
        j = data.find(b"\n", i) if i < n else -1
        return n if j < 0 else j

    while p < n:
        nl1 = line_end(p)
        if nl1 == n and not final:
            break
        l2 = min(nl1 + 1, n)
        nl2 = line_end(l2)
        if nl2 == n and not final:
            break
        l3 = min(nl2 + 1, n)
        nl3 = line_end(l3)
        if nl3 == n and not final:
            break
        sl = nl2 - l2
        while sl > 0 and not _ALNUM[data[l2 + sl - 1]]:
            sl -= 1
        meta = data[l3:nl3]
        d0, d1 = _token(meta, 0)
        c0, c1 = _token(meta, d1)
        vals = []
        i = c1
        if d1 - d0 == 1 and meta[d0] in b"+-" and c1 > c0:
            for _ in range(3):
                got = _long(meta, i)
                if got is None:
                    break
                vals.append(got[0])
                i = got[1]
        t0, t1 = _token(meta, i) if len(vals) == 3 else (0, 0)
        row = [p, p, nl1 - p, l2, sl]
        if t1 > t0:
            row += [int(meta[d0] == 45), *vals,
                    chroms.setdefault(meta[c0:c1], len(chroms)),
                    tags.setdefault(meta[t0:t1], len(tags))]
        else:
            row += [0, 0, 0, 0, -1, -1]
        for col, v in zip(cols, row):
            col.append(v)
        p = min(nl3 + 1, n)
        consumed = p
    types = [np.int64] * 5 + [np.int8] + [np.int64] * 3 + [np.int32] * 2
    fields = tuple(np.array(c, t) for c, t in zip(cols, types))
    return (len(cols[0]), consumed, fields,
            [k.decode() for k in chroms], [k.decode() for k in tags])


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
    """Parse a buffer of whole records into SplitReads (``_pt_scan`` +
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
        """One sequential chunked pass (``_pt_scan``): per record, the
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
