"""pindel2vcf-equivalent converter: Pindel report files → VCF 4.0.

Implements the full behavior of the reference converter
(``pindel2vcf.cpp``, version 0.6.3) with identical output bytes:

* summarizing-line detection and field layout (``isSVSummarizingLine``
  :1640-1661, ``convertIndelToSVdata`` :1755-1948);
* the sticky new-format detection ``pindel024uOrLater``
  (:1718-1726: more line elements than FIRST_SAMPLE_INDEX + 5*samples);
* REF/ALT synthesis per SVTYPE (:1168-1226), GATK position/equilength
  workarounds (:1010-1016, :1131-1136);
* genotype derivation (``deriveGenotype`` :908-938, ``balanced`` :880-906,
  ``Genotype::getGTRDAD/getGTAD`` :957-970);
* filters (``throughFilter`` :2181-2224) including the microsatellite
  repeat logic (``countRepeats``/``testHypothesis`` :1356-1394,
  ``withinAllowedRepeats*`` :1417-1453);
* windowed emission with the last-record backup quirk
  (``reportSVsInChromosome`` :2247-2312: the final SV of each window is
  held back and re-inserted into the next window's list);
* the FILTER column always printing ``PASS`` (operator<< :1547-1556:
  ``somatic_p_value`` stays 0.0 because the ``-so`` flag is disabled, and
  ``0.0 < 0.05`` selects the PASS branch unconditionally).

This is a from-scratch Python implementation of those semantics — no code
is copied from the reference.
"""
from __future__ import annotations

import dataclasses
import sys
from typing import Dict, List, Optional, Set, Tuple

COMPLEMENT = {"A": "T", "C": "G", "G": "C", "T": "A"}
FIRST_SAMPLE_INDEX = 32          # pindel2vcf.cpp:96
SIZE_TO_WARN_FOR = 1_000_000     # g_sizeToWarnFor


def complement_base(ch: str) -> str:
    return COMPLEMENT.get(ch, "N")


def revcomp(dna: str) -> str:
    """createComplement (pindel2vcf.cpp:275-283): reverse complement."""
    return "".join(complement_base(c) for c in reversed(dna))


def atoi(s: str) -> int:
    """C atoi: leading integer or 0."""
    s = s.strip()
    i = 0
    if i < len(s) and s[i] in "+-":
        i += 1
    j = i
    while j < len(s) and s[j].isdigit():
        j += 1
    if j == i:
        return 0
    return int(s[:j] if s[0] not in "+-" else s[:j])


class TokenStream:
    """istringstream ``>>`` semantics over one line."""

    def __init__(self, line: str):
        self.toks = line.split()
        self.i = 0
        self.failed = False

    def fetch(self, index: int) -> str:
        """fetchElement (pindel2vcf.cpp:1599-1606): the index-th next
        element; "" and fail past the end."""
        el = ""
        for _ in range(index):
            if self.i < len(self.toks):
                el = self.toks[self.i]
                self.i += 1
            else:
                self.failed = True
                el = ""
        return el

    def n_elements(self) -> int:
        return len(self.toks)


class InputReader:
    """Multiple files presented as one stream of lines
    (pindel2vcf.cpp:286-365).

    iostream timing is preserved: each openable file contributes its lines
    plus one trailing "" (the getline that trips the eofbit); eof() only
    becomes true after that final empty line has been consumed — so a
    record whose summary line is the last line of the last file is still
    accepted by the caller's ``!eof()`` check.  Unopenable files contribute
    nothing (the failed stream is skipped by canReadMore).
    """

    def __init__(self, filenames: List[str]):
        self.filenames = filenames
        self.lines: List[str] = []
        self.rewind()

    def rewind(self) -> None:
        self.lines = []
        for fn in self.filenames:
            try:
                with open(fn) as fh:
                    self.lines.extend(line.rstrip("\n") for line in fh)
                self.lines.append("")    # the eof-setting empty getline
            except OSError:
                pass
        self.pos = 0

    def get_line(self) -> str:
        if self.pos < len(self.lines):
            line = self.lines[self.pos]
            self.pos += 1
            return line
        return ""

    def eof(self) -> bool:
        return self.pos >= len(self.lines)


def is_pindel_sv_identifier(ident: str) -> bool:
    return ident in ("D", "I", "LI", "TD", "INV")


def is_sv_summarizing_line(line: str) -> bool:
    toks = line.split()
    if len(toks) < 2:
        return False
    return is_pindel_sv_identifier(toks[1])


@dataclasses.dataclass
class Params:
    """g_par (pindel2vcf.cpp:222-254) with createParameters defaults."""

    reference: str = ""
    reference_name: str = ""           # -R
    reference_date: str = ""           # -d
    pindelfile: str = ""               # -p
    pindelroot: str = ""               # -P
    vcffile: str = ""                  # -v
    chromosome: str = ""               # -c
    window_size: int = 300             # -w (millions of bases)
    min_coverage: int = 10             # -mc
    het_cutoff: float = 0.2            # -he
    hom_cutoff: float = 0.8            # -ho
    minsize: int = 1                   # -is
    maxsize: int = -1                  # -as
    bothstrands: bool = False          # -b
    minsupp_samples: int = 1           # -m
    minsupp_reads: int = 1             # -e
    max_supp_reads: int = -1           # -f
    region_start: int = 0              # -sr
    region_end: int = -1               # -er
    max_inter_repeat_no: int = -1      # -ir
    max_inter_repeat_length: int = -1  # -il
    max_post_repeat_no: int = -1       # -pr
    max_post_repeat_length: int = -1   # -pl
    only_balanced_samples: bool = False    # -sb
    minimum_strand_support: int = 1    # -ss
    compact_output: int = SIZE_TO_WARN_FOR  # -co
    somatic: bool = False              # -so (CLI-settable only in the
    # tcga converter; pindel2vcf.cpp:2038 comments the flag out but the
    # fisher/FILTER logic is live in both, pindel2vcf.cpp:1541-1549)
    gatk_compatible: bool = False      # -G
    tcga: bool = False                 # pindel2vcf4tcga output flavor
    center: str = ""                   # -C (tcga only)


def _fact32(n: int) -> int:
    """FACT with C int (32-bit wrapping) semantics
    (pindel2vcf.cpp:1503-1517 — overflows for n >= 13 exactly as the
    reference does)."""
    fact = 1
    for i in range(1, max(n, 1) + 1):
        fact = (fact * i) & 0xFFFFFFFF
    return fact - 0x100000000 if fact >= 0x80000000 else fact


def fisher_test(a: int, c: int, b: int, d: int) -> float:
    """Naive factorial Fisher p (pindel2vcf.cpp:1519-1526) including its
    int-overflow behavior; the klib kt_fisher_exact in the same file is
    dead code at this call site."""
    n = a + b + c + d

    def mul32(*xs):
        acc = 1
        for x in xs:
            acc = (acc * x) & 0xFFFFFFFF
        return acc - 0x100000000 if acc >= 0x80000000 else acc

    num = mul32(_fact32(a + b), _fact32(c + d), _fact32(a + c),
                _fact32(d + b))
    den = float(mul32(_fact32(a), _fact32(b), _fact32(c), _fact32(d),
                      _fact32(n)))
    try:
        return num / den
    except ZeroDivisionError:
        if num == 0:
            return float("nan")
        return float("inf") if num > 0 else float("-inf")


def _cxx_double(v: float) -> str:
    """std::ostream default double formatting (printf %g, precision 6)."""
    import math
    if math.isinf(v):
        return "inf" if v > 0 else "-inf"
    if math.isnan(v):
        # the only NaN source here is 0.0/0.0, whose x86 SSE QNaN has the
        # sign bit set — iostream prints it as "-nan"
        return "-nan"
    return "%g" % v


@dataclasses.dataclass
class Genotype:
    """Per-sample depth triple (pindel2vcf.cpp:823-867)."""

    plus: int = 0
    minus: int = 0
    ref_support: int = 0

    def total(self) -> int:
        return self.plus + self.minus

    def fuse(self, other: "Genotype") -> None:
        self.plus += other.plus
        self.minus += other.minus
        self.ref_support = max(self.ref_support, other.ref_support)


def derive_genotype(gt: Genotype, par: Params) -> str:
    """deriveGenotype (pindel2vcf.cpp:908-938)."""
    ev = gt.total()
    ref = gt.ref_support
    if ev + ref < par.min_coverage:
        return "0/0"
    af = float(ev) / (ev + ref)
    if af < par.het_cutoff:
        return "0/0"
    if af < par.hom_cutoff:
        return "0/1"
    return "1/1"


def test_hypothesis(hypothesis: str, sequence: str) -> int:
    """testHypothesis (pindel2vcf.cpp:1357-1369)."""
    hl = len(hypothesis)
    for i, ch in enumerate(sequence):
        if hypothesis[i % hl] != ch:
            return 0
    return len(sequence) // hl


def count_repeats(sequence: str, max_repeat_length: int) -> Tuple[int, int]:
    """countRepeats (pindel2vcf.cpp:1373-1394) → (repeats, best_size)."""
    maximum_len = min(max_repeat_length, len(sequence) // 2)
    if max_repeat_length < 0:
        maximum_len = len(sequence) // 2
    best_len = 0
    best_num = 0
    hypothesis = ""
    for rl in range(1, maximum_len + 1):
        hypothesis += sequence[rl - 1]
        repeats = test_hypothesis(hypothesis, sequence)
        if repeats > 0 and repeats * len(hypothesis) > best_len * best_num:
            best_len = len(hypothesis)
            best_num = repeats
    return best_num, best_len


class SVRecord:
    """SVData (pindel2vcf.cpp:1000-1226)."""

    def __init__(self, n_samples: int, genome: "VcfGenome", par: Params):
        self.genome = genome
        self.par = par
        self.chromosome = ""
        self.position = 0
        self.end = 0
        self.homlen = 0
        self.homseq = ""
        self.bpr_start = 0
        self.bpr_end = 0
        self.svlen = 0
        self.replace_len = 0
        self.replace_len_two = 0
        self.nt = ""
        self.nt2 = ""
        self.svtype = ""
        self.id = "."
        self.quality = "."
        self.filter = "."
        self.format = [Genotype() for _ in range(max(n_samples, 1))]

    # --- position / equilength helpers -------------------------------
    def alt_same_length_as_ref(self) -> bool:
        return ((self.svtype == "RPL" and self.svlen == self.replace_len)
                or (self.svtype == "INV" and self.replace_len == 0
                    and self.replace_len_two == 0))

    def get_position(self) -> int:
        if self.par.gatk_compatible and self.alt_same_length_as_ref():
            return self.position + 1
        return self.position

    # --- REF / ALT ----------------------------------------------------
    def get_reference(self) -> str:
        seq = self.genome.get(self.chromosome)
        if self.svtype == "INS" and self.svlen == 0:     # long insertion
            return seq[self.position]
        start = self.position
        if self.par.gatk_compatible and self.alt_same_length_as_ref():
            start = self.position + 1
        return seq[start:self.end]

    def get_alternative(self) -> str:
        if self.svtype == "INS" and self.svlen == 0:
            return "<INS>"
        seq = self.genome.get(self.chromosome)
        alt = ""
        if self.svtype in ("INS", "DEL", "RPL"):
            if not (self.par.gatk_compatible
                    and self.alt_same_length_as_ref()):
                alt += seq[self.position]
            alt += self.nt
        elif self.svtype == "DUP:TANDEM":
            ref = self.get_reference()
            alt = ref + self.nt + ref[1:]
        elif self.svtype == "INV":
            ref = self.get_reference()
            if self.par.gatk_compatible and self.alt_same_length_as_ref():
                alt = revcomp(ref)
            else:
                alt = (seq[self.position] + self.nt
                       + revcomp(ref[1:]) + self.nt2)
        return alt

    def output_ref_alt(self) -> Tuple[str, str]:
        """getOutputFormattedReference/Alternative with -co compaction
        (pindel2vcf.cpp:1240-1272)."""
        ref = self.get_reference()
        alt = self.get_alternative()
        if alt == "<INS>":
            return ref, alt
        if self.par.compact_output > 1:
            if (len(ref) > self.par.compact_output
                    or len(alt) > self.par.compact_output):
                return ref[:1], f"<{self.svtype}>"
        return ref, alt

    # --- support ------------------------------------------------------
    def both_strands(self) -> bool:
        return (any(g.plus > 0 for g in self.format)
                and any(g.minus > 0 for g in self.format))

    def num_support_samples(self, only_balanced: bool,
                            min_strand: int) -> int:
        n = 0
        for g in self.format:
            if only_balanced:
                if g.plus >= min_strand and g.minus >= min_strand:
                    n += 1
            elif g.plus >= min_strand or g.minus >= min_strand:
                n += 1
        return n

    def num_support_reads(self) -> int:
        return sum(g.total() for g in self.format)

    # --- repeats ------------------------------------------------------
    def get_sv_sequence(self) -> str:
        """getSVSequence (pindel2vcf.cpp:1397-1413)."""
        ref = self.get_reference()
        alt = self.get_alternative()
        pos = 0
        max_pos = min(len(ref), len(alt))
        while pos < max_pos and ref[pos] == alt[pos]:
            pos += 1
        if pos == max_pos:
            return alt[pos:] if max_pos == len(ref) else ref[pos:]
        return alt[pos:]

    def within_allowed_repeats_post_indel(self, max_repeat_len: int,
                                          max_no_repeats: int) -> bool:
        seq = self.get_sv_sequence()
        repeat_count, actual_len = count_repeats(seq, max_repeat_len)
        if actual_len > 0:
            hypothesis = seq[:actual_len]
            extended = test_hypothesis(hypothesis, seq + self.homseq)
            return extended - repeat_count <= max_no_repeats
        extended, best_size = count_repeats(seq + self.homseq,
                                            max_repeat_len)
        repetitive_len = best_size * extended
        post = repetitive_len - len(seq)
        if best_size == 0:
            return True
        return int(post / best_size) <= max_no_repeats

    def within_allowed_repeats_internal(self, max_repeat_len: int,
                                        max_no_repeats: int) -> bool:
        seq = self.get_sv_sequence()
        repeat_count, _ = count_repeats(seq, max_repeat_len)
        return repeat_count <= max_no_repeats

    # --- ordering / dedup ----------------------------------------------
    def sort_key(self):
        return (self.chromosome, self.get_position(), self.svlen)

    def same_event(self, other: "SVRecord") -> bool:
        """operator== (pindel2vcf.cpp:1455-1493) — defined but the fuse
        call site is commented out in the reference main loop."""
        if (self.svtype == "DEL" and other.svtype == "DEL"
                and self.bpr_start == other.bpr_start
                and self.bpr_end == other.bpr_end
                and self.svlen == other.svlen
                and self.chromosome == other.chromosome):
            return True
        if (self.svtype == "RPL" and other.svtype == "RPL"
                and self.svlen - self.replace_len
                == other.svlen - other.replace_len
                and self.bpr_start == other.bpr_start
                and self.chromosome == other.chromosome):
            return True
        if (self.svtype == "INS" and other.svtype == "INS"
                and self.bpr_start == other.bpr_start
                and self.bpr_end == other.bpr_end
                and self.svlen == other.svlen
                and self.chromosome == other.chromosome):
            return True
        return False

    # --- printing -------------------------------------------------------
    def vcf_line(self, pindel024u_or_later: bool) -> str:
        ref, alt = self.output_ref_alt()
        cols = [self.chromosome, str(self.get_position()), self.id,
                ref, alt, self.quality]
        # FILTER (pindel2vcf.cpp:1541-1550): with -so unset the p stays
        # 0.0 < 0.05, so plain runs always print PASS; d_filter is "."
        somatic_p = 0.0
        somatic_on = len(self.format) == 2 and self.par.somatic
        if somatic_on:
            somatic_p = fisher_test(
                self.format[0].total(), self.format[0].ref_support,
                self.format[1].total(), self.format[1].ref_support)
        cols.append("PASS" if somatic_p < 0.05 else ".")
        info = (f"END={self.position + len(self.get_reference()) - 1};"
                f"HOMLEN={self.homlen};")
        if self.homlen != 0:
            info += f"HOMSEQ={self.homseq};"
        info += "SVLEN="
        if self.svtype in ("RPL", "DEL") and self.svlen > 0:
            info += "-"
        svtype_key = "TYPEOFSV" if self.par.tcga else "SVTYPE"
        info += f"{self.svlen};{svtype_key}={self.svtype}"
        if self.svtype in ("RPL", "DUP:TANDEM", "INV"):
            info += f";NTLEN={self.replace_len}"
        if self.svtype == "INV":
            info += f",{self.replace_len_two}"
        if somatic_on:
            info += f";{_cxx_double(somatic_p)}"
        cols.append(info)
        cols.append("GT:DP:BQ:SS:AD" if self.par.tcga else "GT:AD")
        for g in self.format:
            if pindel024u_or_later and self.get_alternative() != "<INS>":
                if self.par.tcga:
                    # getSampleDataOfEvent (pindel2vcf4tcga.cpp:1021-1030)
                    cols.append(f"{derive_genotype(g, self.par)}:"
                                f"{g.ref_support + g.total()}:.:2:"
                                f"{g.ref_support},{g.total()}")
                else:
                    cols.append(f"{derive_genotype(g, self.par)}:"
                                f"{g.ref_support},{g.total()}")
            else:
                # getGTAD with getGTold (pindel2vcf.cpp:941-955)
                if self.par.gatk_compatible:
                    gt = "0/0" if g.plus == 0 and g.minus == 0 else "0/1"
                else:
                    gt = "." if g.plus == 0 and g.minus == 0 else "1/."
                cols.append(f"{gt}:{g.total()}")
        return "\t".join(cols)


class VcfGenome:
    """1-shifted chromosome access (pindel2vcf.cpp:616-736): sequence is
    prefixed with one 'N', uppercased, non-ACGTN → N."""

    def __init__(self, fasta: str):
        self.names: List[str] = []
        self._seqs: Dict[str, str] = {}
        name = None
        parts: List[str] = []
        with open(fasta) as fh:
            for line in fh:
                if line.startswith(">"):
                    if name is not None:
                        self._seqs[name] = self._finish(parts)
                    name = line[1:].split()[0] if len(line) > 1 else ""
                    self.names.append(name)
                    parts = []
                else:
                    parts.append(line.strip())
        if name is not None:
            self._seqs[name] = self._finish(parts)

    # one-pass sanitize: letters upper-cased with non-ACGTN -> N,
    # non-letters dropped (the per-char generator this replaces was 90%
    # of converter wall at 6 Mb)
    _SANITIZE = str.maketrans({
        c: ((chr(c).upper() if chr(c).upper() in "ACGTN" else "N")
            if chr(c).isalpha() else None)
        for c in range(256)})

    @classmethod
    def _finish(cls, parts: List[str]) -> str:
        return "N" + "".join(parts).translate(cls._SANITIZE)

    def get(self, name: str) -> str:
        return self._seqs.get(name, "")

    def size(self, name: str) -> int:
        return len(self._seqs.get(name, ""))


class Converter:
    def __init__(self, par: Params):
        self.par = par
        self.pindel024u_or_later = False     # sticky, pindel2vcf.cpp:256

    # --- pass 1: names ----------------------------------------------------
    def scan_names(self, reader: InputReader
                   ) -> Tuple[Set[str], Set[str]]:
        """getSampleNamesAndChromosomeNames (pindel2vcf.cpp:1666-1754)."""
        samples: Set[str] = set()
        chromosomes: Set[str] = set()
        while not reader.eof():
            line = reader.get_line()
            while not reader.eof() and not is_sv_summarizing_line(line):
                line = reader.get_line()
            if not is_sv_summarizing_line(line):
                return samples, chromosomes
            ts = TokenStream(line)
            n_el = ts.n_elements()
            sv_type = ts.fetch(2)
            if sv_type == "LI":
                chromosomes.add(ts.fetch(2))
                first = ts.fetch(7)
                samples.add(first)
                name = ts.fetch(5)
                while not ts.failed:
                    samples.add(name)
                    name = ts.fetch(5)
                continue
            chromosomes.add(ts.fetch(6))
            n_samples = atoi(ts.fetch(FIRST_SAMPLE_INDEX - 12))
            first = ts.fetch(4)
            if first:
                samples.add(first)
            if n_el > FIRST_SAMPLE_INDEX + 5 * n_samples:
                self.pindel024u_or_later = True
            stride = 7 if self.pindel024u_or_later else 5
            name = ts.fetch(stride)
            while not ts.failed:
                if name:
                    samples.add(name)
                name = ts.fetch(stride)
        return samples, chromosomes

    # --- pass 2: one record -------------------------------------------------
    def parse_record(self, reader: InputReader, sample_map: Dict[str, int],
                     genome: VcfGenome, svd: SVRecord,
                     target_chromosome: str) -> None:
        """convertIndelToSVdata (pindel2vcf.cpp:1755-1948)."""
        line = reader.get_line()
        while not reader.eof() and not is_sv_summarizing_line(line):
            line = reader.get_line()
        if not is_sv_summarizing_line(line):
            return
        ts = TokenStream(line)
        sv_type = ts.fetch(2)
        if sv_type == "LI":
            svd.svtype = "INS"
            svd.svlen = 0
            chrom = ts.fetch(2)
            svd.chromosome = chrom
            if chrom != target_chromosome:
                return
            before_start = atoi(ts.fetch(1))
            svd.position = before_start
            atoi(ts.fetch(2))                       # total plus support
            rightmost = atoi(ts.fetch(1))
            svd.end = rightmost
            svd.bpr_start, svd.bpr_end = before_start, rightmost
            atoi(ts.fetch(2))                       # total minus support
            sample_name = ts.fetch(1)
            plus = atoi(ts.fetch(2))
            minus = atoi(ts.fetch(2))
            while not ts.failed:
                if sample_name in sample_map:
                    svd.format[sample_map[sample_name]] = Genotype(
                        plus, minus, 0)
                sample_name = ts.fetch(1)
                plus = atoi(ts.fetch(2))
                minus = atoi(ts.fetch(2))
            return

        svd.svlen = atoi(ts.fetch(1))
        num_nt_str = ts.fetch(2)
        num_nt = atoi(num_nt_str)
        simple_inversion = False
        num_nt_inv = -1
        if sv_type == "INV":
            if ":" not in num_nt_str:
                simple_inversion = True
            else:
                num_nt_inv = atoi(num_nt_str.split(":", 1)[1])
        nt_added = ts.fetch(1)
        if sv_type == "INV":
            if ":" not in nt_added:
                simple_inversion = True
            else:
                sep = nt_added.find(":")
                svd.nt2 = nt_added[sep + 2: sep + 2 + num_nt_inv]
                nt_added = nt_added[:sep]
        nt_added = nt_added[1:]                 # opening quote
        nt_added = nt_added[:num_nt]            # closing quote and beyond
        if not simple_inversion:
            svd.nt = nt_added

        chrom = ts.fetch(2)
        if chrom != target_chromosome:
            return
        seq = genome.get(chrom)
        svd.chromosome = chrom
        before_start = atoi(ts.fetch(2))
        svd.position = before_start
        leftmost_end = atoi(ts.fetch(1))
        leftmost_start = atoi(ts.fetch(2))
        rightmost_end = atoi(ts.fetch(1))
        svd.bpr_start, svd.bpr_end = leftmost_start, rightmost_end
        svd.end = leftmost_end
        svd.homlen = rightmost_end - leftmost_end
        svd.homseq = seq[leftmost_end:rightmost_end]
        if sv_type == "D":
            if num_nt == 0:
                svd.svtype = "DEL"
                svd.replace_len = 0
            else:
                svd.svtype = "RPL"
                svd.replace_len = num_nt
        elif sv_type == "I":
            svd.svtype = "INS"
            svd.replace_len = 0
        elif sv_type == "TD":
            svd.svtype = "DUP:TANDEM"
            svd.replace_len = num_nt
        elif sv_type == "INV":
            svd.svtype = "INV"
            if simple_inversion:
                svd.replace_len, svd.replace_len_two = 0, 0
            else:
                svd.replace_len, svd.replace_len_two = num_nt, num_nt_inv

        sample_name = ts.fetch(18)
        ref_start = ref_end = 0
        if self.pindel024u_or_later:
            ref_start = atoi(ts.fetch(1))
            ref_end = atoi(ts.fetch(1))
        total_ref = max(ref_start, ref_end)
        plus = atoi(ts.fetch(1))
        minus = atoi(ts.fetch(2))
        while not ts.failed:
            if sample_name in sample_map:
                svd.format[sample_map[sample_name]] = Genotype(
                    plus, minus, total_ref)
            sample_name = ts.fetch(2)
            if self.pindel024u_or_later:
                ref_start = atoi(ts.fetch(1))
                ref_end = atoi(ts.fetch(1))
            total_ref = max(ref_start, ref_end)
            plus = atoi(ts.fetch(1))
            minus = atoi(ts.fetch(2))

    # --- filter ------------------------------------------------------------
    def through_filter(self, sv: SVRecord) -> bool:
        """throughFilter (pindel2vcf.cpp:2181-2224)."""
        par = self.par
        if par.minsize > 1 and abs(sv.svlen) < par.minsize:
            return False
        if par.maxsize > 0 and abs(sv.svlen) > par.maxsize:
            return False
        if par.bothstrands and not sv.both_strands():
            return False
        if (par.minsupp_samples >= 1
                and sv.num_support_samples(par.only_balanced_samples,
                                           par.minimum_strand_support)
                < par.minsupp_samples):
            return False
        if par.minsupp_reads >= 1 \
                and sv.num_support_reads() < par.minsupp_reads:
            return False
        if par.max_supp_reads >= 1 \
                and sv.num_support_reads() > par.max_supp_reads:
            return False
        if par.region_start > 0 and sv.get_position() < par.region_start:
            return False
        if par.region_end > 0 and sv.get_position() > par.region_end:
            return False
        if par.max_inter_repeat_no >= 0 and \
                not sv.within_allowed_repeats_internal(
                    par.max_inter_repeat_length, par.max_inter_repeat_no):
            return False
        if par.max_post_repeat_no >= 0 and \
                not sv.within_allowed_repeats_post_indel(
                    par.max_post_repeat_length, par.max_post_repeat_no):
            return False
        return True

    # --- driver --------------------------------------------------------------
    def header(self, samples: List[str]) -> str:
        if self.par.tcga:
            return self._header_tcga(samples)
        lines = [
            "##fileformat=VCFv4.0",
            f"##fileDate={self.par.reference_date}",
            "##source=pindel",
            f"##reference={self.par.reference_name}",
            '##INFO=<ID=END,Number=1,Type=Integer,Description="End position'
            ' of the variant described in this record">',
            '##INFO=<ID=HOMLEN,Number=1,Type=Integer,Description="Length of'
            ' base pair identical micro-homology at event breakpoints">',
            '##INFO=<ID=PF,Number=1,Type=Integer,Description="The number of'
            ' samples carry the variant">',
            '##INFO=<ID=HOMSEQ,Number=.,Type=String,Description="Sequence of'
            ' base pair identical micro-homology at event breakpoints">',
            '##INFO=<ID=SVLEN,Number=1,Type=Integer,Description="Difference'
            ' in length between REF and ALT alleles">',
            '##INFO=<ID=SVTYPE,Number=1,Type=String,Description="Type of'
            ' structural variant">',
            '##INFO=<ID=NTLEN,Number=.,Type=Integer,Description="Number of'
            ' bases inserted in place of deleted code">',
            '##FORMAT=<ID=PL,Number=3,Type=Integer,Description="Normalized,'
            ' Phred-scaled likelihoods for genotypes as defined in the VCF'
            ' specification">',
            '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">',
        ]
        if self.pindel024u_or_later:
            lines.append(
                '##FORMAT=<ID=RD,Number=1,Type=Integer,Description='
                '"Reference depth, how many reads support the reference">')
        lines.append(
            '##FORMAT=<ID=AD,Number=2,Type=Integer,Description="Allele'
            ' depth, how many reads support this allele">')
        cols = "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO"
        if samples:
            cols += "\tFORMAT"
            for s in samples:
                cols += "\t" + s
        lines.append(cols)
        return "\n".join(lines) + "\n"

    def _header_tcga(self, samples: List[str]) -> str:
        """TCGA-flavored header (pindel2vcf4tcga.cpp:735-787)."""
        p = self.par
        lines = [
            "##fileformat=VCFv4.1",
            f"##fileDate={p.reference_date}",
            "##tcgaversion=1.2",
            f"##reference={p.reference_name}",
            f'##center="{p.center}"',
            "##phasing=none",
            (f'##vcfProcessLog=<InputVCF="{p.vcffile}";'
             'InputVCFSource="pindel2vcf";'
             'InputVCFVer="0.6.3";'
             f'InputVCFParam="d={p.reference_date}">'),
            '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">',
            '##FORMAT=<ID=DP,Number=1,Type=Integer,Description="Read depth'
            ' at this position in the sample">',
            '##FORMAT=<ID=BQ,Number=.,Type=Integer,Description="Average'
            ' base quality for reads supporting alleles">',
            '##FORMAT=<ID=SS,Number=1,Type=Integer,Description="Variant'
            ' status relative to non-adjacent Normal,0=wildtype,'
            '1=germline,2=somatic,3=LOH,4=post-transcriptional'
            ' modification,5=unknown">',
            '##FORMAT=<ID=AD,Number=.,Type=Integer,Description="Depth of'
            ' reads supporting alleles 0/1/2/3...">',
            '##INFO=<ID=END,Number=1,Type=Integer,Description="End position'
            ' of the variant described in this record">',
            '##INFO=<ID=HOMLEN,Number=.,Type=Integer,Description="Length of'
            ' base pair identical micro-homology at event breakpoints">',
            '##INFO=<ID=PF,Number=1,Type=Integer,Description="The number of'
            ' samples carry the variant">',
            '##INFO=<ID=HOMSEQ,Number=.,Type=String,Description="Sequence of'
            ' base pair identical micro-homology at event breakpoints">',
            '##INFO=<ID=SVLEN,Number=.,Type=Integer,Description="Difference'
            ' in length between REF and ALT alleles">',
            '##INFO=<ID=TYPEOFSV,Number=1,Type=String,Description="Type of'
            ' structural variant">',
            '##INFO=<ID=NTLEN,Number=.,Type=Integer,Description="Number of'
            ' bases inserted in place of deleted code">',
            '##FORMAT=<ID=PL,Number=3,Type=Integer,Description="Normalized,'
            ' Phred-scaled likelihoods for AA,AB,BB genotypes where A=ref'
            ' and B=alt; not applicable if site is not biallelic">',
        ]
        cols = "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO"
        if samples:
            cols += "\tFORMAT"
            for s in samples:
                cols += "\t" + s
        lines.append(cols)
        return "\n".join(lines) + "\n"

    def report_chromosome(self, chrom_id: str, chromosome_names: Set[str],
                          samples: List[str], reader: InputReader,
                          sample_map: Dict[str, int], genome: VcfGenome,
                          out) -> None:
        """reportSVsInChromosome (pindel2vcf.cpp:2247-2312) with the
        backup-SV quirk: the last record of each window is withheld and
        re-inserted into the next window; after all windows it is printed
        if it passes the filter."""
        if chrom_id not in chromosome_names:
            return
        region_start = 0
        backup: Optional[SVRecord] = None
        window = self.par.window_size * 1_000_000
        while True:
            region_end = region_start + window
            reader.rewind()
            svs: List[SVRecord] = []
            if backup is not None:
                svs.append(backup)
            while not reader.eof():
                svd = SVRecord(len(samples), genome, self.par)
                self.parse_record(reader, sample_map, genome, svd, chrom_id)
                if (not reader.eof()
                        and svd.chromosome == chrom_id
                        and region_start <= svd.get_position() < region_end):
                    svs.append(svd)
            # the reference sorts with UNSTABLE std::sort
            # (pindel2vcf.cpp:2287) under operator< on (chrom, position,
            # svlen) only — records tying on all three (e.g. a tandem
            # duplication and an insertion of the same length at one
            # position) land in introsort's permutation order, which
            # cxx_sort replicates exactly
            from pindel_tpu_torch.cxxsort import cxx_sort
            for sv in svs:
                sv._k = sv.sort_key()
            cxx_sort(svs, lambda a, b: a._k < b._k)
            for i, sv in enumerate(svs):
                if i != len(svs) - 1 and self.through_filter(sv):
                    out.write(sv.vcf_line(self.pindel024u_or_later) + "\n")
            if svs:
                backup = svs[-1]
            region_start += window
            if region_end >= genome.size(chrom_id):
                break
        if backup is not None and self.through_filter(backup):
            out.write(backup.vcf_line(self.pindel024u_or_later) + "\n")


def convert(par: Params) -> str:
    """Run the conversion; returns the output VCF path."""
    if par.pindelfile and par.pindelroot:
        raise ValueError("use either -p or -P, not both")
    if par.pindelfile:
        files = [par.pindelfile]
        default_vcf = par.pindelfile + ".vcf"
    elif par.pindelroot:
        files = [par.pindelroot + suffix
                 for suffix in ("_D", "_SI", "_LI", "_INV", "_TD")]
        default_vcf = par.pindelroot + ".vcf"
    else:
        raise ValueError("need -p or -P")
    vcffile = par.vcffile or default_vcf
    par.vcffile = vcffile     # resolved name; the tcga header prints it
    # (reference resolves g_par.vcffile before createHeader, :2206-2211)

    conv = Converter(par)
    reader = InputReader(files)
    sample_set, chromosome_names = conv.scan_names(reader)
    samples = sorted(sample_set)
    sample_map = {name: i for i, name in enumerate(samples)}
    genome = VcfGenome(par.reference)
    with open(vcffile, "w") as out:
        out.write(conv.header(samples))
        if par.chromosome:
            conv.report_chromosome(par.chromosome, chromosome_names,
                                   samples, reader, sample_map, genome, out)
        else:
            for name in genome.names:
                conv.report_chromosome(name, chromosome_names, samples,
                                       reader, sample_map, genome, out)
    return vcffile


def main(argv=None, tcga: bool = False) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="pindel2vcf4tcga" if tcga else "pindel2vcf",
        description=("Convert pindel_tpu/pindel reports to TCGA-flavored"
                     " VCF 4.1" if tcga else
                     "Convert pindel_tpu/pindel reports to VCF 4.0"))
    if tcga:
        # pindel2vcf4tcga.cpp:2024-2025 and :2077-2078
        ap.add_argument("-C", "--center", default="")
        ap.add_argument("-so", "--somatic_p", action="store_true")
    ap.add_argument("-r", "--reference", required=True)
    ap.add_argument("-R", "--reference_name", required=True)
    ap.add_argument("-d", "--reference_date", required=True)
    ap.add_argument("-p", "--pindel_output", default="")
    ap.add_argument("-P", "--pindel_output_root", default="")
    ap.add_argument("-v", "--vcf", default="")
    ap.add_argument("-c", "--chromosome", default="")
    ap.add_argument("-w", "--window_size", type=int, default=300)
    ap.add_argument("-mc", "--min_coverage", type=int, default=10)
    ap.add_argument("-he", "--het_cutoff", type=float, default=0.2)
    ap.add_argument("-ho", "--hom_cutoff", type=float, default=0.8)
    ap.add_argument("-is", "--min_size", type=int, default=1)
    ap.add_argument("-as", "--max_size", type=int, default=-1)
    ap.add_argument("-b", "--both_strands_supported", action="store_true")
    ap.add_argument("-m", "--min_supporting_samples", type=int, default=1)
    ap.add_argument("-e", "--min_supporting_reads", type=int, default=1)
    ap.add_argument("-f", "--max_supporting_reads", type=int, default=-1)
    ap.add_argument("-sr", "--region_start", type=int, default=0)
    ap.add_argument("-er", "--region_end", type=int, default=-1)
    ap.add_argument("-ir", "--max_internal_repeats", type=int, default=-1)
    ap.add_argument("-il", "--max_internal_repeatlength", type=int,
                    default=-1)
    ap.add_argument("-pr", "--max_postindel_repeats", type=int, default=-1)
    ap.add_argument("-pl", "--max_postindel_repeatlength", type=int,
                    default=-1)
    ap.add_argument("-sb", "--only_balanced_samples", action="store_true")
    ap.add_argument("-ss", "--minimum_strand_support", type=int, default=1)
    ap.add_argument("-co", "--compact_output_limit", type=int,
                    default=SIZE_TO_WARN_FOR)
    ap.add_argument("-G", "--gatk_compatible", action="store_true")
    args = ap.parse_args(argv)

    par = Params(
        reference=args.reference, reference_name=args.reference_name,
        reference_date=args.reference_date, pindelfile=args.pindel_output,
        pindelroot=args.pindel_output_root, vcffile=args.vcf,
        chromosome=args.chromosome, window_size=args.window_size,
        min_coverage=args.min_coverage, het_cutoff=args.het_cutoff,
        hom_cutoff=args.hom_cutoff, minsize=args.min_size,
        maxsize=args.max_size, bothstrands=args.both_strands_supported,
        minsupp_samples=args.min_supporting_samples,
        minsupp_reads=args.min_supporting_reads,
        max_supp_reads=args.max_supporting_reads,
        region_start=args.region_start, region_end=args.region_end,
        max_inter_repeat_no=args.max_internal_repeats,
        max_inter_repeat_length=args.max_internal_repeatlength,
        max_post_repeat_no=args.max_postindel_repeats,
        max_post_repeat_length=args.max_postindel_repeatlength,
        only_balanced_samples=args.only_balanced_samples,
        minimum_strand_support=args.minimum_strand_support,
        compact_output=args.compact_output_limit,
        gatk_compatible=args.gatk_compatible,
        tcga=tcga,
        center=getattr(args, "center", ""),
        somatic=getattr(args, "somatic_p", False))
    convert(par)
    return 0


if __name__ == "__main__":
    sys.exit(main())
