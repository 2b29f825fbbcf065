"""What decides ``correct``: every report file a pass wrote against the
plain reference's reports of the same sample.

Two numbers are compared, each with the limit 0, since the reports are
exact integer output that the configurations promise byte for byte:

* ``report_files_differing``: over every judged pass, the report files
  (by suffix, either side's) whose bytes differ from the reference's; a
  pass that writes the right lines in another order counts here;
* ``report_lines_differing``: over every judged pass and suffix, the lines
  in one side and not in the other, counted with their multiplicity: how
  far a pass is off, where it is.
"""
from __future__ import annotations

import collections
import os
from typing import Dict, List

LIMIT = 0


def reports(prefix: str) -> Dict[str, bytes]:
    """The report files a run wrote under ``prefix``, by suffix."""
    d, base = os.path.split(prefix)
    out = {}
    for name in sorted(os.listdir(d)):
        if name.startswith(base + "_"):
            with open(os.path.join(d, name), "rb") as fh:
                out[name[len(base) + 1:]] = fh.read()
    return out


def lines_differing(got: Dict[str, bytes], want: Dict[str, bytes]) -> int:
    """Lines of ``got`` not in ``want`` and of ``want`` not in ``got``, over
    every suffix of either, with multiplicity."""
    n = 0
    for suffix in set(got) | set(want):
        a = collections.Counter(got.get(suffix, b"").splitlines())
        b = collections.Counter(want.get(suffix, b"").splitlines())
        n += sum(((a - b) + (b - a)).values())
    return n


def files_differing(got: Dict[str, bytes], want: Dict[str, bytes]) -> list:
    """The suffixes, of either side, whose files differ in any byte or
    exist on one side only."""
    return sorted(s for s in set(got) | set(want)
                  if got.get(s) != want.get(s))


def judge(pass_prefixes: List[str], ref_prefix: str) -> dict:
    """The comparison of every pass with the reference: the differing files
    and lines in all, per pass, the suffixes that differ and the
    reference's size."""
    want = reports(ref_prefix)
    per_pass, files, suffixes = [], 0, set()
    for prefix in pass_prefixes:
        got = reports(prefix)
        per_pass.append(lines_differing(got, want))
        differ = files_differing(got, want)
        files += len(differ)
        suffixes |= set(differ)
    return dict(report_lines_differing=sum(per_pass),
                report_files_differing=files, per_pass=per_pass,
                suffixes_differing=sorted(suffixes),
                reference_lines=sum(len(v.splitlines())
                                    for v in want.values()),
                reference_bytes=sum(len(v) for v in want.values()),
                reference_files=sorted(want))


def correct(verdict: dict) -> bool:
    return (verdict["report_files_differing"] <= LIMIT
            and verdict["report_lines_differing"] <= LIMIT)
