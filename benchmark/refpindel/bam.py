"""BAM split-read channel: a plain reader in Python and NumPy, and
bam-config support.

The whole file is read at once: BGZF members inflated with ``zlib``,
records walked by their block sizes, fixed fields and CIGAR-derived values
(``bam_cigar2len``, ``bam_cigar2mismatch``, ``HasIndel``, ``isWeirdRead``)
worked out over all records with NumPy.  Window queries then follow the
reference's reader.cpp semantics: mate pairing and the split-read and
reference-read records of ``fetch_func_SR`` (reader.cpp:1099-1151,
``build_record_SR`` :799-898, ``isGoodAnchor`` :561-613, ``isRefRead``
:620-656), and the discordant pairs of ``build_record_RP_Discovery``
(reader.cpp:982-1097).  Written from the SAM specification and those
semantics; no native code.

Reference: bam config file format — one line per BAM: path, insert size,
sample tag (readBamConfigFile, pindel.cpp:659-692).
"""
from __future__ import annotations

import dataclasses
import struct
import zlib
from typing import List, Tuple

import numpy as np

from refpindel.reads import SplitRead

FLAG_PAIRED = 0x1
FLAG_UNMAP = 0x4
FLAG_MUNMAP = 0x8
FLAG_REVERSE = 0x10
FLAG_MREVERSE = 0x20
FLAG_READ1 = 0x40
FLAG_READ2 = 0x80
FLAG_SECONDARY = 0x100
FLAG_QCFAIL = 0x200
FLAG_DUP = 0x400
SEQ_NT16 = "=ACMGRSVTWYHKDBN"
# a packed byte -> its two bases
_PAIRS = [SEQ_NT16[b >> 4] + SEQ_NT16[b & 15] for b in range(256)]
_COMP = str.maketrans("ACGT", "TGCA")
_FIXED = np.dtype([
    ("block_size", "<i4"), ("refid", "<i4"), ("pos", "<i4"),
    ("l_read_name", "u1"), ("mapq", "u1"), ("bin", "<u2"),
    ("n_cigar", "<u2"), ("flag", "<u2"), ("l_seq", "<i4"),
    ("next_refid", "<i4"), ("next_pos", "<i4"), ("tlen", "<i4")])
_INT_TAG = {ord("c"): ("<i1", 1), ord("C"): ("<u1", 1),
            ord("s"): ("<i2", 2), ord("S"): ("<u2", 2),
            ord("i"): ("<i4", 4), ord("I"): ("<u4", 4)}


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


def inflate(raw: bytes) -> bytes:
    """The concatenated payload of a BGZF file's gzip members.  Each member
    is inflated to its end and the next starts where it stopped, so the
    ``BC`` field's block size is not relied on."""
    out = []
    view = memoryview(raw)
    off, n = 0, len(raw)
    while off < n:
        d = zlib.decompressobj(31)
        while not d.eof:
            if off >= n:
                raise IOError("a BGZF member is cut short")
            piece = view[off:off + (1 << 17)]
            out.append(d.decompress(piece))
            off += len(piece) - len(d.unused_data)
    return b"".join(out)


def _nm(aux: bytes) -> int:
    """NM from a record's aux bytes (the last NM seen, 0 where its type is
    not an integer's; -1 when absent), scanning tags in order and stopping
    at an unknown type."""
    nm, p, end = -1, 0, len(aux)
    while p + 3 <= end:
        t, typ = aux[p:p + 2], aux[p + 2]
        p += 3
        value = 0
        if typ in _INT_TAG:
            fmt, skip = _INT_TAG[typ]
            if p + skip <= end:
                value = int(np.frombuffer(aux, fmt, 1, p)[0])
        elif typ == ord("A"):
            skip = 1
        elif typ == ord("f"):
            skip = 4
        elif typ in (ord("Z"), ord("H")):
            q = aux.find(b"\0", p)
            skip = (q if q >= 0 else end) - p + 1
        elif typ == ord("B"):
            if p + 5 > end:
                return nm
            sub = aux[p]
            count = struct.unpack_from("<I", aux, p + 1)[0]
            skip = 5 + (1 if sub in b"cC" else 2 if sub in b"sS" else 4) \
                * count
        else:
            return nm
        if t == b"NM":
            nm = value
        p += skip
    return nm


class BamReader:
    """One BAM file, read whole and queried by window."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as fh:
            data = inflate(fh.read())
        if data[:4] != b"BAM\1":
            raise IOError(f"{path}: not a BAM file")
        l_text = struct.unpack_from("<i", data, 4)[0]
        off = 8 + l_text
        n_ref = struct.unpack_from("<i", data, off)[0]
        off += 4
        self.ref_names, self.ref_lens = [], []
        for _ in range(n_ref):
            l_name = struct.unpack_from("<i", data, off)[0]
            self.ref_names.append(
                data[off + 4:off + 4 + l_name].split(b"\0")[0].decode())
            self.ref_lens.append(
                struct.unpack_from("<i", data, off + 4 + l_name)[0])
            off += 8 + l_name
        starts = []
        size = struct.Struct("<i")
        n = len(data)
        while off + 4 <= n:
            bs = size.unpack_from(data, off)[0]
            if bs < 32 or off + 4 + bs > n:
                break
            starts.append(off)
            off += 4 + bs
        self.data = data
        self._decode(np.asarray(starts, np.int64))

    def _decode(self, offs: np.ndarray) -> None:
        buf = np.frombuffer(self.data, np.uint8)
        n = offs.size
        self.offs = offs
        fixed = np.lib.stride_tricks.sliding_window_view(
            buf, _FIXED.itemsize)[offs].copy().view(_FIXED).reshape(n)
        self.tid = fixed["refid"].astype(np.int64)
        self.pos = fixed["pos"].astype(np.int64)
        self.mapq = fixed["mapq"].astype(np.int64)
        self.flag = fixed["flag"].astype(np.int64)
        self.l_qseq = fixed["l_seq"].astype(np.int64)
        self.mtid = fixed["next_refid"].astype(np.int64)
        self.mpos = fixed["next_pos"].astype(np.int64)
        self.isize = fixed["tlen"].astype(np.int64)
        self.name_len = np.maximum(
            fixed["l_read_name"].astype(np.int64) - 1, 0)
        n_cigar = fixed["n_cigar"].astype(np.int64)
        self.cigar_at = offs + 36 + fixed["l_read_name"]
        # every CIGAR op, with the record it belongs to
        rec = np.repeat(np.arange(n), n_cigar)
        first = np.cumsum(n_cigar) - n_cigar
        k = np.arange(rec.size) - first[rec]
        words = np.lib.stride_tricks.sliding_window_view(buf, 4)[
            self.cigar_at[rec] + 4 * k].copy().view("<u4").reshape(-1)
        op = (words & 0xF).astype(np.int64)
        ln = (words >> 4).astype(np.int64)

        def per_record(mask, weights=None):
            w = np.where(mask, ln if weights is None else weights, 0)
            return np.bincount(rec, w, minlength=n).astype(np.int64)

        ref_span = per_record(np.isin(op, (0, 2, 3, 7, 8)))
        # bam_cigar2len: M, I, S add, D subtracts (reader.cpp:1318-1333)
        self.cigar2len = (per_record(np.isin(op, (0, 1, 4)))
                          - per_record(op == 2))
        # bam_cigar2mismatch: every length that is not M (:1335-1346)
        self.cigar_mm = per_record(op != 0)
        idnshp = per_record(np.isin(op, (1, 2, 3, 4, 5, 6)), 1) > 0
        indel = per_record(np.isin(op, (1, 2)), 1) > 0
        self.has_indel = (n_cigar > 2) & indel          # HasIndel
        mapped = (self.flag & FLAG_UNMAP) == 0
        self.endpos = np.where(mapped & (ref_span > 0), self.pos + ref_span,
                               self.pos + 1)
        self.seq_at = self.cigar_at + 4 * n_cigar
        aux_at = self.seq_at + (self.l_qseq + 1) // 2 + self.l_qseq
        aux_end = offs + 4 + fixed["block_size"]
        self.nm = self._nm_all(buf, aux_at, aux_end)
        edits = np.maximum(self.nm, 0)
        # isWeirdRead (reader.cpp:661-690)
        self.weird = (~mapped | idnshp | (self.nm > 0)
                      | (edits + self.cigar_mm > 0))
        # per reference: [first, last + 1) of its records and its widest
        # span (at least 1)
        self.tid_begin, self.tid_end, self.tid_max_span = {}, {}, {}
        for t in range(len(self.ref_names)):
            at = np.flatnonzero(self.tid == t)
            if at.size:
                self.tid_begin[t] = int(at[0])
                self.tid_end[t] = int(at[-1]) + 1
                self.tid_max_span[t] = max(1, int(
                    (self.endpos[at] - self.pos[at]).max()))

    def _nm_all(self, buf, aux_at, aux_end) -> np.ndarray:
        """NM of every record: where the aux data is one integer NM tag it
        is read at once, elsewhere by ``_nm``."""
        n = aux_at.size
        nm = np.full(n, -1, np.int64)
        size = aux_end - aux_at
        todo = np.flatnonzero(size > 0)
        lone = np.zeros(n, bool)
        for typ, (fmt, width) in _INT_TAG.items():
            cand = todo[size[todo] == 3 + width]
            if not cand.size:
                continue
            head = np.lib.stride_tricks.sliding_window_view(buf, 3)[
                aux_at[cand]]
            hit = cand[(head[:, 0] == ord("N")) & (head[:, 1] == ord("M"))
                       & (head[:, 2] == typ)]
            if hit.size:
                vals = np.lib.stride_tricks.sliding_window_view(
                    buf, width)[aux_at[hit] + 3].copy().view(fmt)
                nm[hit] = vals.reshape(-1).astype(np.int64)
                lone[hit] = True
        for i in todo[~lone[todo]].tolist():
            nm[i] = _nm(self.data[aux_at[i]:aux_end[i]])
        return nm

    def name(self, i: int) -> bytes:
        at = int(self.offs[i]) + 36
        return self.data[at:at + int(self.name_len[i])]

    def seq(self, i: int) -> str:
        at, n = int(self.seq_at[i]), int(self.l_qseq[i])
        return "".join(_PAIRS[b] for b in
                       self.data[at:at + (n + 1) // 2])[:n]

    def _range(self, chrom_name: str, start: int, end: int):
        """[lo, hi) of the records a window query looks at: from the first
        at or after ``start`` less the widest span, to the first at or
        after ``end``."""
        tid = self.ref_names.index(chrom_name)
        if tid not in self.tid_begin:
            return 0, 0
        b, e = self.tid_begin[tid], self.tid_end[tid]
        lo = b + int(np.searchsorted(self.pos[b:e],
                                     start - self.tid_max_span[tid]))
        past = np.flatnonzero(self.pos[lo:e] >= end)
        return lo, (lo + int(past[0]) if past.size else e)

    def collect_sr(self, chrom_name: str, start: int, end: int,
                   insert_size: int, tag: str, biol_size: int,
                   min_anchor_quality: int = 0, nm: int = 2,
                   max_mismatch_rate: float = 0.02
                   ) -> Tuple[List[SplitRead], List[RefRead]]:
        """Split-read + ref-read collection over [start, end) (the
        reference's ReadInBamReads_SR and fetch_func_SR, reader.cpp:483-559
        and :1099-1151): the first sight of a name is kept, and built as a
        split read of its own if weird; the second pairs them (the kept
        one built of its own again, a quirk of the reference), each mate a
        good anchor giving the other's split read, if weird, and the other
        as a reference read, if it is one.  The insert-size sanity abort
        (reader.cpp:868-877) is raised as ValueError."""
        if chrom_name not in self.ref_names:
            return [], []
        lo, hi = self._range(chrom_name, start, end)
        q = min_anchor_quality
        flag = self.flag[lo:hi]
        mapq = self.mapq[lo:hi]
        mapped = (flag & FLAG_UNMAP) == 0
        skip = (flag & (FLAG_SECONDARY | FLAG_QCFAIL | FLAG_DUP)) != 0
        good = mapped & (mapq >= q) & ((q == 0) | ~skip)
        nm_ = self.nm[lo:hi]
        lq = self.l_qseq[lo:hi]
        max_edits = (lq * max_mismatch_rate).astype(np.int64) + 1
        edits_ok = (nm_ < 0) | ((nm_ <= nm) & (nm_ <= max_edits))
        ref_ok = (~skip & edits_ok & ~self.has_indel[lo:hi] & mapped
                  & (np.maximum(nm_, 0) <= 2) & (self.cigar_mm[lo:hi] <= 2)
                  & (mapq >= q))
        overlap = (self.endpos[lo:hi] > start).tolist()
        weird = self.weird[lo:hi].tolist()
        good = good.tolist()
        ref_ok = ref_ok.tolist()
        reads: List[SplitRead] = []
        ref_reads: List[RefRead] = []

        def build(m: int, u: int) -> None:
            self._build_sr(lo + m, lo + u, q, biol_size, chrom_name,
                           insert_size, tag, reads)

        def ref_read(k: int) -> None:
            i = lo + k
            ref_reads.append(RefRead(int(self.pos[i]), int(self.mapq[i]),
                                     int(self.l_qseq[i]), tag))

        pending = {}
        for k in range(hi - lo):
            if not overlap[k]:
                continue
            qname = self.name(lo + k)
            other = pending.pop(qname, None)
            if other is None:
                pending[qname] = k
                if weird[k]:
                    build(k, k)
                continue
            if weird[other]:
                build(other, other)
            if good[k]:
                if weird[other]:
                    build(k, other)
                if ref_ok[other]:
                    ref_read(other)
            if good[other]:
                if weird[k]:
                    build(other, k)
                if ref_ok[k]:
                    ref_read(k)
        return reads, ref_reads

    def _build_sr(self, m: int, u: int, min_qual: int, biol_size: int,
                  chrom_name: str, insert_size: int, tag: str,
                  reads: List[SplitRead]) -> None:
        """build_record_SR (reader.cpp:799-898): the split read of the
        unmapped-side record ``u`` anchored by ``m``."""
        if int(self.mapq[m]) < min_qual:
            return
        seq = self.seq(u).strip("N")
        length = len(seq)
        if seq.count("N") > int(length * .10) or length < 22:
            return
        uflag = int(self.flag[u])
        if uflag & FLAG_REVERSE:
            seq = "".join(c if c in "ACGT" else "N"
                          for c in seq)[::-1].translate(_COMP)
        rel_pos = int(self.pos[m])
        direction = "+"
        if int(self.flag[m]) & FLAG_REVERSE:
            direction = "-"
            rel_pos += int(self.cigar2len[m])
        if rel_pos > biol_size:
            rel_pos = biol_size
        if rel_pos < 1:
            rel_pos = 0
        name = "@" + self.name(u).decode()
        if uflag & FLAG_READ1:
            name += "/1"
        elif uflag & FLAG_READ2:
            name += "/2"
        if insert_size <= len(seq):
            raise ValueError(
                f"insert size {insert_size} <= read length {len(seq)} in "
                f"{self.path}; fix the bam config")
        r = SplitRead(name=name, frag_name=chrom_name, matched_d=direction,
                      matched_rel_pos=rel_pos, ms=int(self.mapq[m]),
                      insert_size=insert_size, tag=tag)
        r.set_seq(seq)
        reads.append(r)

    def collect_rp(self, chrom_name: str, start: int, end: int,
                   insert_size: int, tag: str,
                   min_anchor_quality: int = 0):
        """Discordant read-pair discovery over [start, end)
        (build_record_RP_Discovery, reader.cpp:982-1097): paired, mapq at
        least the gate, both mates mapped, and another chromosome, |isize|
        over 3 inserts + 1000 or mates on one strand; with the
        same-chromosome PosA < PosB swap.  Returns (same-chromosome
        RPReads, interchromosomal RPReads)."""
        from refpindel.bddata import RPRead
        if chrom_name not in self.ref_names:
            return [], []
        lo, hi = self._range(chrom_name, start, end)
        flag = self.flag[lo:hi]
        rev = (flag & FLAG_REVERSE) != 0
        mrev = (flag & FLAG_MREVERSE) != 0
        keep = ((self.endpos[lo:hi] > start) & ((flag & FLAG_PAIRED) != 0)
                & (self.mapq[lo:hi] >= min_anchor_quality)
                & ((flag & (FLAG_UNMAP | FLAG_MUNMAP)) == 0)
                & ((self.tid[lo:hi] != self.mtid[lo:hi])
                   | (np.abs(self.isize[lo:hi]) > 3 * insert_size + 1000)
                   | (rev == mrev)))
        at = lo + np.flatnonzero(keep)
        same: list = []
        inter: list = []
        nref = len(self.ref_names)
        for pa, pb, mt, ln, ra, rb in zip(
                self.pos[at].tolist(), self.mpos[at].tolist(),
                self.mtid[at].tolist(), self.l_qseq[at].tolist(),
                rev[at - lo].tolist(), mrev[at - lo].tolist()):
            da = "-" if ra else "+"
            db = "-" if rb else "+"
            chr_b = self.ref_names[mt] if 0 <= mt < nref else ""
            if chr_b == chrom_name and pa >= pb:
                # PosA < PosB normalization (reader.cpp:1061-1090)
                same.append(RPRead(
                    chr_name_a=chr_b, chr_name_b=chrom_name,
                    da=db, db=da, pos_a=pb, pos_b=pa,
                    original_pos_a=pb, original_pos_b=pa,
                    insert_size=insert_size, read_length=ln,
                    tag=tag, tags=[tag]))
                continue
            r = RPRead(chr_name_a=chrom_name, chr_name_b=chr_b,
                       da=da, db=db, pos_a=pa, pos_b=pb,
                       original_pos_a=pa, original_pos_b=pb,
                       insert_size=insert_size, read_length=ln,
                       tag=tag, tags=[tag])
            (same if chr_b == chrom_name else inter).append(r)
        return same, inter
