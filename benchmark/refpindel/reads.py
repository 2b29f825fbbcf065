"""Split-read records and Pindel-format text input.

Reference structures: ``SPLIT_READ`` (pindel.h:265-383), ``UniquePoint``
(pindel.h:137-158); text format reader ``PindelReadReader``
(pindel_read_reader.cpp:50-66): records of three lines ::

    @name
    SEQUENCE
    ±  chr  pos  MQ  insert_size  sample_tag
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, List, NamedTuple, Optional

import numpy as np

from refpindel import dna

PLUS = "+"
MINUS = "-"
FORWARD = "+"
BACKWARD = "-"
SENSE = "+"
ANTISENSE = "-"


class UniquePoint(NamedTuple):
    """A unique partial alignment anchor (reference pindel.h:137-158).

    Materialized on demand from AnchorSet — per-anchor Python objects are
    off the hot path.
    """

    chr_name: str
    length_str: int          # matched prefix/suffix length
    abs_loc: int             # padded-coordinate position of the anchor end
    direction: str           # FORWARD '+' / BACKWARD '-'
    strand: str              # SENSE '+' / ANTISENSE '-'
    mismatches: int


class AnchorSet:
    """Struct-of-arrays anchor list (the UP_Close / UP_Far of one read).

    Hundreds of thousands of anchors are produced per device batch; they
    are kept as numpy arrays end-to-end (detectors consume the arrays
    directly) and only converted to UniquePoint views on indexed access.
    """

    __slots__ = ("length", "loc", "mm", "dir_minus", "strand_minus",
                 "chr_names", "chr_id", "uniform")

    def __init__(self, length, loc, mm, dir_minus, strand_minus,
                 chr_names, chr_id):
        self.length = length              # int64 [n]
        self.loc = loc                    # int64 [n]
        self.mm = mm                      # int64 [n]
        self.dir_minus = dir_minus        # bool  [n]
        self.strand_minus = strand_minus  # bool  [n]
        self.chr_names = chr_names        # small list[str], indexed by
        self.chr_id = chr_id              # int8  [n] into chr_names
        self.uniform = False              # single-representative chain:
        # constant dir/strand/chr and loc -/+ length, which makes
        # clean_unique_points a provable no-op (set by the fused decode)

    @classmethod
    def empty(cls) -> "AnchorSet":
        # shared immutable singleton: anchor sets are always *replaced*,
        # never mutated in place, and this is constructed per read
        return _EMPTY_ANCHORS

    @classmethod
    def from_points(cls, ups: List[UniquePoint]) -> "AnchorSet":
        n = len(ups)
        length = np.empty(n, dtype=np.int64)
        loc = np.empty(n, dtype=np.int64)
        mm = np.empty(n, dtype=np.int64)
        dm = np.empty(n, dtype=bool)
        sm = np.empty(n, dtype=bool)
        chr_names: List[str] = []
        cid = np.empty(n, dtype=np.int8)
        for i, u in enumerate(ups):
            length[i] = u.length_str
            loc[i] = u.abs_loc
            mm[i] = u.mismatches
            dm[i] = u.direction == MINUS
            sm[i] = u.strand == MINUS
            if u.chr_name not in chr_names:
                chr_names.append(u.chr_name)
            cid[i] = chr_names.index(u.chr_name)
        return cls(length, loc, mm, dm, sm, chr_names, cid)

    def __len__(self) -> int:
        return int(self.length.shape[0])

    def __bool__(self) -> bool:
        return self.length.shape[0] > 0

    def __getitem__(self, i: int) -> UniquePoint:
        if i < 0:
            i += len(self)
        return UniquePoint(
            chr_name=self.chr_names[self.chr_id[i]] if self.chr_names else "",
            length_str=int(self.length[i]), abs_loc=int(self.loc[i]),
            direction=MINUS if self.dir_minus[i] else "+",
            strand=MINUS if self.strand_minus[i] else "+",
            mismatches=int(self.mm[i]))

    def __iter__(self):
        return (self[i] for i in range(len(self)))

    def select(self, mask: np.ndarray) -> "AnchorSet":
        return AnchorSet(self.length[mask], self.loc[mask], self.mm[mask],
                         self.dir_minus[mask], self.strand_minus[mask],
                         self.chr_names, self.chr_id[mask])


def _make_empty_anchors() -> AnchorSet:
    z = np.zeros(0, dtype=np.int64)
    b = np.zeros(0, dtype=bool)
    a = AnchorSet(z, z, z, b, b, [], np.zeros(0, dtype=np.int8))
    for arr in (a.length, a.loc, a.mm, a.dir_minus, a.strand_minus, a.chr_id):
        arr.flags.writeable = False
    return a


_EMPTY_ANCHORS = _make_empty_anchors()


@dataclasses.dataclass
class SplitRead:
    """One unmapped-mate read plus its anchor metadata."""

    name: str = ""
    frag_name: str = ""           # anchor chromosome
    far_frag_name: str = ""
    matched_d: str = ""           # anchor strand '+'/'-'
    matched_rel_pos: int = 0      # anchor position (biological coords)
    ms: int = 0                   # anchor mapping quality
    insert_size: int = 0
    tag: str = ""                 # sample name
    seq: str = ""                 # UnmatchedSeq (may be RC-flipped in search)
    mapper_split: bool = False

    # close/far anchors, filled by the search
    up_close: "AnchorSet" = dataclasses.field(default_factory=AnchorSet.empty)
    up_far: "AnchorSet" = dataclasses.field(default_factory=AnchorSet.empty)

    # event fields, filled by detectors (reference SPLIT_READ members)
    used: bool = False
    unique_read: bool = False
    bp: int = 0
    left: int = 0
    right: int = 0
    bp_left: int = 0
    bp_right: int = 0
    indel_size: int = 0
    nt_str: str = ""
    nt_size: int = 0              # NOT derived from nt_str (reference quirk:
                                  # SI sets NT_str but leaves NT_size 0)
    matched_far_d: str = ""
    max_snp_error: int = 0        # g_maxMismatch[len], set by the searcher
    close_end_mismatch: int = 0
    far_end_mismatch: int = 0
    left_most_pos: int = 0
    read_group: str = ""
    sample_name_to_number: Optional[dict] = None
    thickness: int = 0            # assembled-contig support (assembly mode)
    read_count_per_sample: Optional[dict] = None

    def clone(self) -> "SplitRead":
        """Fast shallow copy (copy.copy dispatch is hot at WGS scale)."""
        r = SplitRead.__new__(SplitRead)
        r.__dict__.update(self.__dict__)
        return r

    def set_seq(self, seq: str) -> None:
        """setUnmatchedSeq: trim trailing non-alnum (pindel.cpp:142-159)."""
        if seq and not seq[-1].isalnum():
            while seq and not seq[-1].isalnum():
                seq = seq[:-1]
        self.seq = seq

    @property
    def read_length(self) -> int:
        return len(self.seq)

    def seq_codes(self) -> np.ndarray:
        """Encoded bases, cached per seq *object* (the search flips seq by
        assigning a new string, which invalidates by identity)."""
        d = self.__dict__
        if d.get("_codes_for") is not self.seq:
            d["_codes"] = dna.encode(self.seq)
            d["_codes"].flags.writeable = False
            d["_codes_for"] = self.seq
        return d["_codes"]

    # --- anchor helpers (reference pindel.cpp:475-518) ---
    def max_len_close(self) -> int:
        n = len(self.up_close)
        return int(self.up_close.length[n - 1]) if n else 0

    def max_len_far(self) -> int:
        n = len(self.up_far)
        return int(self.up_far.length[n - 1]) if n else 0

    def has_close_end(self) -> bool:
        return bool(self.up_close)

    def last_abs_loc_close_end(self) -> int:
        return int(self.up_close.loc[len(self.up_close) - 1])

    def good_far_end_found(self) -> bool:
        return self.max_len_far() + self.max_len_close() >= len(self.seq)


def clean_unique_points(ups: AnchorSet) -> AnchorSet:
    """Keep only the anchor chain consistent with the longest match.

    Reference: CleanUniquePoints, pindel.cpp:2904-2941.  Vectorized over
    the AnchorSet arrays.
    """
    if not ups or ups.uniform:
        return ups
    n = len(ups)
    last_dir_minus = bool(ups.dir_minus[n - 1])
    if not last_dir_minus:
        terminal = ups.loc[n - 1] - ups.length[n - 1]
        mask = ups.loc - ups.length == terminal
    else:
        terminal = ups.loc[n - 1] + ups.length[n - 1]
        mask = ups.loc + ups.length == terminal
    mask &= (ups.dir_minus == last_dir_minus)
    mask &= (ups.strand_minus == ups.strand_minus[n - 1])
    mask &= (ups.chr_id == ups.chr_id[n - 1])
    if mask.all():
        return ups
    return ups.select(mask)


_PROTO_READ = SplitRead()

# Class-level fallbacks for the default_factory fields so batch-parsed
# instances need only their parsed fields in __dict__ (simple-field
# defaults are already dataclass class attributes).  The shared empty
# AnchorSet is immutable by convention — search code always REBINDS
# up_close/up_far, never mutates in place.
SplitRead.up_close = _PROTO_READ.up_close
SplitRead.up_far = _PROTO_READ.up_far


def _make_read(name: str, seq: str, meta: List[str]) -> SplitRead:
    """One record -> SplitRead via prototype clone (dataclass __init__
    with ~25 defaulted fields is measurably slow at WGS read counts)."""
    read = SplitRead.__new__(SplitRead)
    read.__dict__.update(_PROTO_READ.__dict__)
    read.name = name
    read.set_seq(seq)
    if len(meta) >= 6:
        read.matched_d = meta[0]
        read.frag_name = meta[1]
        read.matched_rel_pos = int(meta[2])
        read.ms = int(meta[3])
        read.insert_size = int(meta[4])
        read.tag = meta[5]
    return read


def read_pindel_file(path: str) -> Iterator[SplitRead]:
    """Iterate SplitReads from a Pindel text file (optionally .gz).

    Clean files (every record exactly three non-blank lines starting with
    '@') take a whole-file batch path; anything irregular falls back to
    the line-by-line reader with identical semantics."""
    opener = open
    if path.endswith(".gz"):
        import gzip
        opener = gzip.open  # type: ignore[assignment]
    with opener(path, "rt") as fh:
        data = fh.read()
    lines = data.split("\n")
    if lines and lines[-1] == "":
        lines.pop()
    if len(lines) % 3 == 0 and "" not in lines:
        # with no blank lines the line reader consumes exactly 3 lines
        # per record, so the batch path is equivalent
        yield from _read_pindel_batch(lines)
        return
    yield from _read_pindel_lines(lines)


def _read_pindel_batch(lines: List[str]) -> List[SplitRead]:
    """Tight-loop record parser (one inlined _make_read per 3 lines).

    Only the parsed fields enter the instance dict; every other field
    resolves through the class-level defaults (incl. the shared empty
    AnchorSets) — parsing is a per-run cost at WGS read counts and the
    30-field dict copy dominated it."""
    out: List[SplitRead] = []
    ap = out.append
    new = SplitRead.__new__
    for k in range(0, len(lines), 3):
        seq = lines[k + 1]
        if seq and not seq[-1].isalnum():     # setUnmatchedSeq trim
            while seq and not seq[-1].isalnum():
                seq = seq[:-1]
        meta = lines[k + 2].split()
        r = new(SplitRead)
        if len(meta) >= 6:
            r.__dict__ = {
                "name": lines[k], "seq": seq,
                "matched_d": meta[0], "frag_name": meta[1],
                "matched_rel_pos": int(meta[2]), "ms": int(meta[3]),
                "insert_size": int(meta[4]), "tag": meta[5]}
        else:
            r.__dict__ = {"name": lines[k], "seq": seq}
        ap(r)
    return out


def _read_pindel_lines(lines: List[str]) -> Iterator[SplitRead]:
    i = 0
    n = len(lines)
    while i < n:
        name = lines[i]
        i += 1
        if not name:
            continue
        seq = lines[i] if i < n else ""
        i += 1
        meta = lines[i].split() if i < n else []
        i += 1
        yield _make_read(name, seq, meta)
