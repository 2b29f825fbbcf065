"""Minimal BAM writer for the benchmark's samples.

The benchmark's frozen copy of ``pindel_tpu_torch/testing/bamwriter.py``
(BGZF-compressed BAM from explicit alignment records, ``make_fai`` and the
``pair`` helper).

BAM/BGZF layout per the SAM spec (htslib not used; everything from the
published format): BGZF = gzip members with a BC extra field carrying the
block size; records are little-endian packed.
"""
from __future__ import annotations

import dataclasses
import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

SEQ_NT16 = "=ACMGRSVTWYHKDBN"
CIGAR_OPS = "MIDNSHP=X"

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

_BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")


def _bgzf_block(data: bytes) -> bytes:
    co = zlib.compressobj(6, zlib.DEFLATED, -15)
    comp = co.compress(data) + co.flush()
    bsize = len(comp) + 25              # total block size - 1
    header = struct.pack("<BBBBIBBHBBHH",
                         0x1F, 0x8B, 8, 4, 0, 0, 0xFF, 6,
                         ord("B"), ord("C"), 2, bsize)
    return header + comp + struct.pack("<II", zlib.crc32(data) & 0xFFFFFFFF,
                                       len(data) & 0xFFFFFFFF)


def bgzf_compress(data: bytes, block: int = 60000) -> bytes:
    """``data`` cut into ``block``-byte members, compressed on a few threads
    (zlib releases the GIL); the bytes do not depend on the threads."""
    view = memoryview(data)
    blocks = [view[i:i + block] for i in range(0, len(data), block)]
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as ex:
        members = list(ex.map(_bgzf_block, blocks))
    return b"".join(members) + _BGZF_EOF


# base -> its 4-bit BAM code; a base outside SEQ_NT16 is 15 (N)
_NT16 = bytes(SEQ_NT16.index(chr(c)) if chr(c) in SEQ_NT16 else 15
              for c in range(256))


def _pack_seq(seq: str) -> bytes:
    """Two bases a byte, the first in the high nibble."""
    codes = seq.encode().translate(_NT16)
    if len(codes) % 2:
        codes += b"\0"
    return bytes((codes[i] << 4) | codes[i + 1]
                 for i in range(0, len(codes), 2))


@dataclasses.dataclass
class BamRecord:
    qname: str
    flag: int
    tid: int
    pos: int                       # 0-based
    mapq: int = 0
    cigar: Sequence[Tuple[int, str]] = ()   # [(length, op), ...]
    mate_tid: int = -1
    mate_pos: int = -1
    tlen: int = 0
    seq: str = ""
    qual: Optional[bytes] = None
    tags: Dict[str, object] = dataclasses.field(default_factory=dict)

    def pack(self) -> bytes:
        name = self.qname.encode() + b"\0"
        cig = b"".join(struct.pack("<I", (ln << 4) | CIGAR_OPS.index(op))
                       for ln, op in self.cigar)
        seq4 = _pack_seq(self.seq)
        qual = self.qual if self.qual is not None else b"\xff" * len(self.seq)
        aux = b""
        for tag, value in self.tags.items():
            if isinstance(value, int):
                aux += tag.encode() + b"i" + struct.pack("<i", value)
            else:
                aux += tag.encode() + b"Z" + str(value).encode() + b"\0"
        body = struct.pack(
            "<iiBBHHHiiii", self.tid, self.pos,
            len(name), self.mapq, 0, len(self.cigar), self.flag,
            len(self.seq), self.mate_tid, self.mate_pos, self.tlen)
        body += name + cig + seq4 + qual + aux
        return struct.pack("<i", len(body)) + body


def write_bam(path: str, refs: List[Tuple[str, int]],
              records: List[BamRecord], bulk=None) -> None:
    """refs: [(name, length)]; records are written in the given order.
    ``bulk`` is ``(pos, rows)``: records already packed, one a row of
    ``rows`` (uint8), sorted by ``pos``; they are merged in by position,
    before the ``records`` of the same position (``records`` must be sorted
    by position then)."""
    payload = bytearray()
    text = b"@HD\tVN:1.6\tSO:coordinate\n" + b"".join(
        f"@SQ\tSN:{n}\tLN:{ln}\n".encode() for n, ln in refs)
    payload += b"BAM\x01" + struct.pack("<i", len(text)) + text
    payload += struct.pack("<i", len(refs))
    for name, length in refs:
        nm = name.encode() + b"\0"
        payload += struct.pack("<i", len(nm)) + nm + struct.pack("<i",
                                                                 length)
    if bulk is None:
        for rec in records:
            payload += rec.pack()
    else:
        pos, rows = bulk
        width = rows.shape[1]
        flat = memoryview(np.ascontiguousarray(rows).reshape(-1))
        cut = np.searchsorted(pos, [r.pos for r in records], side="right")
        parts, done = [bytes(payload)], 0
        for rec, at in zip(records, cut.tolist()):
            parts.append(flat[done * width:at * width])
            parts.append(rec.pack())
            done = at
        parts.append(flat[done * width:])
        payload = b"".join(parts)
    with open(path, "wb") as fh:
        fh.write(bgzf_compress(bytes(payload)))


def pair(qname, anchor_pos, mate_seq, ref, anchor_reverse=False,
         read_len=100, mate_first=False, mapq=60):
    """An anchored pair: clean mapped anchor + unmapped weird mate."""
    flag_a = FLAG_PAIRED | (FLAG_REVERSE if anchor_reverse else 0)
    anchor = BamRecord(qname, flag_a, 0, anchor_pos, mapq,
                       [(read_len, "M")], 0, anchor_pos, 0,
                       ref[anchor_pos:anchor_pos + read_len],
                       tags={"NM": 0})
    mate = BamRecord(qname, FLAG_PAIRED | FLAG_UNMAP | FLAG_READ1,
                     0, anchor_pos, 0, [], 0, anchor_pos, 0, mate_seq)
    return [mate, anchor] if mate_first else [anchor, mate]


def make_fai(fa_path: str, out_path: str = None) -> str:
    """Write a samtools-compatible .fai index for a FASTA file: per
    sequence its name, length, offset of the first base, bases per line and
    bytes per line (newline included)."""
    out_path = out_path or fa_path + ".fai"
    rows = []
    with open(fa_path, "rb") as fh:
        name = None
        length = 0
        offset = 0
        linebases = 0
        linewidth = 0
        pos = 0
        for raw in fh:
            line = raw.rstrip(b"\r\n")
            if raw.startswith(b">"):
                if name is not None:
                    rows.append((name, length, offset, linebases, linewidth))
                name = line[1:].split()[0].decode()
                length = 0
                offset = pos + len(raw)
                linebases = 0
                linewidth = 0
            elif line:
                if linebases == 0:
                    linebases = len(line)
                    linewidth = len(raw)
                length += len(line)
            pos += len(raw)
        if name is not None:
            rows.append((name, length, offset, linebases, linewidth))
    with open(out_path, "w") as out:
        for r in rows:
            out.write("\t".join(str(x) for x in r) + "\n")
    return out_path
