"""Search-region selection: -c region strings and -j/-J BED files.

Faithful port of the reference semantics: ``SearchRegion`` parsing
(user_defined_settings.cpp:104-162, including the comma-stripping and the
"chromosome name only" form), the include-BED construction in ``main``
(pindel.cpp:1606-1716: WGS vs single-region, per-record start/end swap and
chromosome-size clamp, intersection with the -c region), and
``CleanUpBedRecord`` (pindel.cpp:1380-1512) with its quirks: it is a no-op
when no exclude regions exist, and the final chromosome-size clamp is
applied to every sorted record except the last.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple


@dataclasses.dataclass
class Fai:
    """.fai index: names, sizes and chromosome order
    (init_g_ChrNameAndSizeAndIndex, pindel.cpp:1332-1348)."""

    names: List[str]
    sizes: List[int]

    @classmethod
    def read(cls, path: str) -> "Fai":
        names: List[str] = []
        sizes: List[int] = []
        with open(path) as fh:
            for line in fh:
                parts = line.split()
                if len(parts) >= 2:
                    names.append(parts[0])
                    sizes.append(int(parts[1]))
        return cls(names, sizes)

    @classmethod
    def from_genome(cls, genome) -> "Fai":
        return cls([c.name for c in genome], [c.biol_size for c in genome])

    def index(self, name: str) -> int:
        try:
            return self.names.index(name)
        except ValueError:
            return len(self.names)

    def size(self, name: str) -> int:
        try:
            return self.sizes[self.names.index(name)]
        except ValueError:
            return 0


@dataclasses.dataclass
class SearchRegion:
    """-c parse (user_defined_settings.cpp:104-162)."""

    chr_name: str
    start: int = -1
    end: int = -1
    start_defined: bool = False
    end_defined: bool = False

    @property
    def all_chromosomes(self) -> bool:
        return self.chr_name.upper() == "ALL"

    @classmethod
    def parse(cls, region_string: str, fai: Fai) -> "SearchRegion":
        if ":" in region_string:
            chr_name, coords = region_string.split(":", 1)
            coords = coords.replace(",", "")
            r = cls(chr_name)
            if "-" in coords:
                start_str, end_str = coords.split("-", 1)
                r.end = _atoi(end_str)
                r.end_defined = True
            else:
                start_str = coords
            r.start = _atoi(start_str)
            r.start_defined = True
            if r.start < 0 or (r.end_defined and r.end < r.start):
                raise ValueError(f"cannot parse region '{region_string}'")
            return r
        r = cls(region_string, 1, 1, True, True)
        for name, size in zip(fai.names, fai.sizes):
            if name == r.chr_name:
                r.end = size
        return r

    def get_start(self) -> int:
        if not self.start_defined:
            raise ValueError("region start requested but not defined")
        return self.start

    def get_end(self) -> int:
        if not self.end_defined:
            raise ValueError("region end requested but not defined")
        return self.end


def _atoi(s: str) -> int:
    s = s.strip()
    j = 0
    if j < len(s) and s[j] in "+-":
        j += 1
    while j < len(s) and s[j].isdigit():
        j += 1
    head = s[:j]
    return int(head) if head and head not in "+-" else 0


Bed = Tuple[str, int, int]          # (chr, start, end)


def _read_bed(path: str) -> List[Bed]:
    out: List[Bed] = []
    with open(path) as fh:
        for line in fh:
            parts = line.split()
            if len(parts) < 3:
                continue
            name, start, end = parts[0], _atoi(parts[1]), _atoi(parts[2])
            if start > end:
                start, end = end, start
            out.append((name, start, end))
    return out


def build_include_bed(region: SearchRegion, fai: Fai,
                      include_bed_path: str = "",
                      exclude_bed_path: str = "") -> List[Bed]:
    """pindel.cpp:1606-1716 + CleanUpBedRecord."""
    include: List[Bed] = []
    if region.all_chromosomes:
        if include_bed_path:
            for name, start, end in _read_bed(include_bed_path):
                end = min(end, fai.size(name))
                include.append((name, start, end))
        else:
            include = [(n, 1, s) for n, s in zip(fai.names, fai.sizes)]
    else:
        chr_name = region.chr_name
        start = region.get_start()
        end = min(region.get_end(), fai.size(chr_name))
        if include_bed_path:
            for name, bstart, bend in _read_bed(include_bed_path):
                if name != chr_name:
                    continue
                if bstart > end or start > bend:
                    continue
                include.append((name, max(bstart, start), min(bend, end)))
        else:
            include = [(chr_name, start, end)]
    exclude = _read_bed(exclude_bed_path) if exclude_bed_path else []
    return clean_up_bed(include, exclude, fai)


def clean_up_bed(include: List[Bed], exclude: List[Bed],
                 fai: Fai) -> List[Bed]:
    """CleanUpBedRecord (pindel.cpp:1380-1512); a no-op without
    exclude regions."""
    if not exclude:
        return include
    inc = [list(b) for b in include]
    i = 0
    while i < len(inc):                 # list may grow while iterating
        rec = inc[i]
        for ex_name, ex_start, ex_end in exclude:
            if rec[1] == rec[2]:
                break
            if rec[0] != ex_name:
                continue
            if rec[1] > ex_end or ex_start > rec[2]:
                continue
            if ex_start <= rec[1] and rec[2] <= ex_end:
                rec[2] = rec[1]                       # fully excluded
            elif rec[1] < ex_start and ex_end < rec[2]:
                inc.append([rec[0], ex_end, rec[2]])  # split in two
                rec[2] = ex_start
            elif ex_start <= rec[1] < ex_end < rec[2]:
                rec[1] = ex_end
            elif rec[1] < ex_start < rec[2] < ex_end:
                rec[2] = ex_start
        i += 1

    result = [rec for rec in inc if rec[1] != rec[2]]
    # merge overlaps (pindel.cpp:1440-1476)
    for first in range(len(result) - 1):
        for second in range(first + 1, len(result)):
            a, b = result[first], result[second]
            if a[0] != b[0]:
                continue
            if a[1] > b[2] or b[1] > a[2]:
                continue
            if b[1] <= a[1] and a[2] <= b[2]:
                a[2] = a[1]
                break
            elif a[1] <= b[1] and b[2] <= a[2]:
                b[1] = b[2]
                break
            elif b[1] <= a[1] <= b[2] <= a[2]:
                a[1] = b[1]
                b[1] = b[2]
            elif a[1] <= b[1] <= a[2] <= b[2]:
                a[2] = b[2]
                b[1] = b[2]

    final = [rec for rec in result if rec[1] != rec[2]]
    # selection sort by (.fai chromosome index, start); the size clamp is
    # applied inside the loop, so the LAST record is never clamped
    # (pindel.cpp:1478-1503)
    for first in range(len(final) - 1):
        for second in range(first + 1, len(final)):
            fa, fb = final[first], final[second]
            ia, ib = fai.index(fa[0]), fai.index(fb[0])
            if ia > ib or (ia == ib and fa[1] > fb[1]):
                final[first], final[second] = fb, fa
        size = fai.size(final[first][0])
        if size < final[first][2]:
            final[first][2] = size
    return [tuple(rec) for rec in final]
