"""Base encoding and sequence utilities.

Encoding: A=0, C=1, G=2, T=3, N=4.  The reference keeps chromosomes as ASCII
``std::string`` (pindel.h:595-626); we encode to small ints once at load so
device kernels compare int8 lanes.

Match semantics (reference ``searcher.cpp:36-44`` ``Matches`` and
``CheckMismatches`` ``searcher.cpp:368-380``):
  * read base in ACGT: matches iff ref base equal (ref N never matches);
  * read base N: matches iff ref base in ACGT (N matches any real base,
    but N-vs-N is a mismatch).
Strict equality (used for the perfect-match window around the breakpoint,
``searcher.cpp:349-363``) is plain byte equality, where N==N *does* match.
"""
from __future__ import annotations

import numpy as np

A, C, G, T, N = 0, 1, 2, 3, 4
NBASES = 5

_ENCODE = np.full(256, N, dtype=np.int8)
for _i, _b in enumerate("ACGT"):
    _ENCODE[ord(_b)] = _i
    _ENCODE[ord(_b.lower())] = _i
_ENCODE.flags.writeable = False

_DECODE = np.frombuffer(b"ACGTN", dtype=np.uint8)

# Reverse complement, N -> N (reference Convert2RC4N, pindel.cpp:966-970).
RC = np.array([T, G, C, A, N], dtype=np.int8)
RC.flags.writeable = False


def encode(seq: str) -> np.ndarray:
    """ASCII sequence -> int8 codes (non-ACGT -> N)."""
    return _ENCODE[np.frombuffer(seq.encode("ascii"), dtype=np.uint8)]


def decode(codes: np.ndarray) -> str:
    # int8 codes index _DECODE directly (values 0..4); avoiding the int64
    # upcast matters when decoding whole chromosomes
    return _DECODE[np.asarray(codes)].tobytes().decode("ascii")


def revcomp(codes: np.ndarray) -> np.ndarray:
    """Reverse complement of encoded sequence."""
    return RC[codes[::-1]]


_RC_STR = str.maketrans(
    {c: "N" for c in map(chr, range(128))} | {
        "A": "T", "C": "G", "G": "C", "T": "A", "N": "N"})


def revcomp_str(seq: str) -> str:
    return seq[::-1].translate(_RC_STR)


# exact string-level equivalent of decode(revcomp(encode(s))): lowercase
# acgt complement to uppercase, everything else to N — a single
# translate instead of the numpy round-trip (hot in the close-end flip)
_RC_EXACT = str.maketrans(
    {chr(c): chr(int(_DECODE[RC[_ENCODE[c]]])) for c in range(256)})


def flip_rc(seq: str) -> str:
    """Persistent setUnmatchedSeq RC flip (pindel.cpp:2545)."""
    return seq[::-1].translate(_RC_EXACT)


def matches(read_base: np.ndarray, ref_base: np.ndarray) -> np.ndarray:
    """Vectorized Matches(): see module docstring."""
    read_base = np.asarray(read_base)
    ref_base = np.asarray(ref_base)
    return np.where(read_base == N, ref_base != N, ref_base == read_base)


def cap2low(seq: str) -> str:
    """Lowercase ACGTN (reference Cap2LowArray, pindel.cpp:971-976)."""
    return seq.lower()
