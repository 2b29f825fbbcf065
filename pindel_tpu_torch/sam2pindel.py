"""sam2pindel-equivalent converter: SAM text → Pindel input format.

Behavior-identical reimplementation of the reference converter
(``SAM_2_PINDEL_cin_2011Sept26.cpp``): token-stream SAM parsing (:154-176),
header-line skip (:155-162), the mate-strand/position arithmetic for the
Illumina-PairEnd and Illumina-MatePair platforms (:185-255), the
report-classification rules (``WhetherReport`` :337-359: one-end-mapped vs
mapped-with-difficulties vs skipped), and the RC table that maps bases
outside ACGTN to NUL bytes (:127-133, :361-370).
"""
from __future__ import annotations

import sys
from typing import TextIO

_RC = {"A": "T", "C": "G", "G": "C", "T": "A", "N": "N"}


def _revcomp(seq: str) -> str:
    return "".join(_RC.get(c, "\0") for c in reversed(seq))


class _TokenStream:
    """C++ istream semantics: ``>>`` skips whitespace and reads a token;
    ``getline`` reads to end of the current line."""

    def __init__(self, text: str):
        self.text = text
        self.i = 0

    def token(self) -> str:
        n = len(self.text)
        while self.i < n and self.text[self.i] in " \t\n\r":
            self.i += 1
        start = self.i
        while self.i < n and self.text[self.i] not in " \t\n\r":
            self.i += 1
        return self.text[start:self.i]

    def getline(self) -> str:
        n = len(self.text)
        start = self.i
        while self.i < n and self.text[self.i] != "\n":
            self.i += 1
        line = self.text[start:self.i]
        if self.i < n:
            self.i += 1
        return line

    def eof(self) -> bool:
        return self.i >= len(self.text)


def _whether_report(seq: str, cigar: str, query_unmapped: bool,
                    mate_unmapped: bool) -> int:
    """WhetherReport (SAM_2_PINDEL...cpp:337-359)."""
    num_n = seq.count("N")
    if num_n * 10 > len(seq):
        return 0
    if query_unmapped and not mate_unmapped:
        return 1
    for ch in cigar:
        if "A" <= ch <= "Z" and ch != "M":
            if not mate_unmapped:
                return 2
    return 0


def convert(sam_text: str, out: TextIO, insert_size: int, tag: str,
            num_skip_lines: int = 0,
            platform: str = "Illumina-PairEnd") -> tuple:
    """Returns (records seen, one-end-mapped written, difficult written)."""
    if platform not in ("Illumina-PairEnd", "Illumina-MatePair"):
        raise ValueError("platform must be Illumina-PairEnd or "
                         "Illumina-MatePair")
    ts = _TokenStream(sam_text)
    for _ in range(num_skip_lines):
        ts.getline()
    count = one_end = difficult = 0
    while True:
        qname = ts.token()
        if not qname and ts.eof():
            break
        if qname.startswith("@"):
            ts.getline()
            continue
        flag = int(ts.token() or 0)
        rname = ts.token()
        ts.token()                       # POS (unused by the converter)
        mapq = int(ts.token() or 0)
        cigar = ts.token()
        mrnm = ts.token()
        mpos = int(ts.token() or 0)
        ts.token()                       # ISIZE
        seq = ts.token()
        ts.token()                       # QUAL
        ts.getline()                     # OPT
        if mrnm == "=":
            mrnm = rname
        query_unmapped = bool(flag & 0x4)
        mate_unmapped = bool(flag & 0x8)
        mate_reverse = bool(flag & 0x20)
        count += 1

        report = _whether_report(seq, cigar, query_unmapped, mate_unmapped)
        if mate_unmapped or mrnm == "*" or seq == "*":
            continue
        if report == 0:
            continue
        if platform == "Illumina-PairEnd":
            if report == 1:
                if not mate_reverse:
                    out.write(f"@{qname}\n{seq}\n+\t{mrnm}\t{mpos}"
                              f"\t{mapq}\t{insert_size}\t{tag}\n")
                else:
                    out.write(f"@{qname}\n{seq}\n-\t{mrnm}"
                              f"\t{mpos + len(seq)}\t{mapq}"
                              f"\t{insert_size}\t{tag}\n")
                one_end += 1
            else:
                if not mate_reverse:
                    out.write(f"@{qname}\n{_revcomp(seq)}\n+\t{mrnm}"
                              f"\t{mpos}\t{mapq}\t{insert_size}\t{tag}\n")
                else:
                    out.write(f"@{qname}\n{seq}\n-\t{mrnm}"
                              f"\t{mpos + len(seq)}\t{mapq}"
                              f"\t{insert_size}\t{tag}\n")
                difficult += 1
        else:  # Illumina-MatePair: orientation conventions flipped
            if report == 1:
                if not mate_reverse:
                    out.write(f"@{qname}\n{_revcomp(seq)}\n-\t{mrnm}"
                              f"\t{mpos}\t{mapq}\t{insert_size}\t{tag}\n")
                else:
                    out.write(f"@{qname}\n{_revcomp(seq)}\n+\t{mrnm}"
                              f"\t{mpos + len(seq)}\t{mapq}"
                              f"\t{insert_size}\t{tag}\n")
                one_end += 1
            else:
                if not mate_reverse:
                    out.write(f"@{qname}\n{seq}\n-\t{mrnm}\t{mpos}"
                              f"\t{mapq}\t{insert_size}\t{tag}\n")
                else:
                    out.write(f"@{qname}\n{_revcomp(seq)}\n+\t{mrnm}"
                              f"\t{mpos + len(seq)}\t{mapq}"
                              f"\t{insert_size}\t{tag}\n")
                difficult += 1
    return count, one_end, difficult


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) != 6:
        print("usage: sam2pindel <input.sam|-> <output.pindel> "
              "<insert size> <tag> <skip lines> "
              "<Illumina-PairEnd|Illumina-MatePair>")
        return 1
    src, dst, insert_size, tag, skip, platform = argv
    text = sys.stdin.read() if src == "-" else open(src).read()
    with open(dst, "w") as out:
        count, one_end, difficult = convert(
            text, out, int(insert_size), tag, int(skip), platform)
    print(f"{count}\t{one_end}\t{difficult}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
