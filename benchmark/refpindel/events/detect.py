"""Event detectors: pair close/far anchors into SV evidence per read.

Ports the reference's detector semantics exactly (iteration order, `Used`
flags, mismatch-budget escalation) so clustered output is bit-identical:

* template method: SearchVariant::Search (search_variant.cpp:48-266) with
  subclasses SearchDeletions (searchdeletions.cpp) and SearchShortInsertions
  (searchshortinsertions.cpp);
* deletions with non-template insertions: searchIndels
  (search_deletions_nt.cpp:27-166).

The host-side cost of this layer is trivial next to the search kernels; it
stays in Python deliberately (per-read logic over a handful of anchors).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple, Union

import numpy as np

from refpindel.config import Settings
from refpindel.events.canonical import (get_real_start_4_deletion,
                                               get_real_start_4_insertion,
                                               revcomp_str)
from refpindel.genome import SPACER
from refpindel.reads import MINUS, PLUS, SplitRead


@dataclasses.dataclass
class WindowContext:
    """Per-window state shared by all detectors.

    ``boxes`` bins read indices by BPLeft/box_size (reference BoxSize
    binning, pindel.cpp:1806-1810); ``future`` holds reads deferred to the
    next window (FutureReads_SR).
    """

    chr_seq: str              # padded chromosome string
    window_end: int           # currentWindow.getEnd(), biological coords
    region_start: int         # userSettings region (bed record), 1-based
    region_end: int
    box_size: int
    num_boxes: int
    future: List[SplitRead]


def read_transgresses_bin_boundaries(read: SplitRead, upper: int) -> bool:
    """Reference: pindel.cpp:560-563."""
    return read.bp_right > upper - 2 * read.insert_size


def read_in_specified_region(read: SplitRead, ctx: WindowContext) -> bool:
    """Reference: readInSpecifiedRegion, pindel.cpp:566-584."""
    if read.bp_left + 1 < ctx.region_start:
        return False
    if read.bp_left + 1 > ctx.region_end:
        return False
    return True



# branch codes understood by native/detect.cpp's ptdetect_first_pairs
BR_D_PLUS, BR_D_MINUS = 0, 1
BR_SI_PLUS, BR_SI_MINUS = 2, 3
BR_TD_PLUS, BR_TD_MINUS = 4, 5
BR_INV_P1, BR_INV_P2, BR_INV_M1, BR_INV_M2 = 6, 7, 8, 9
BR_SKIP = 255


def _native_detect():
    """The port loads native/detect.cpp here; the plain reference runs the
    Python re-statements of its loops (None: no native library)."""
    return None


_NUM_THREADS = 1


def set_num_threads(n: int) -> None:
    """-T: host worker threads for the native detector loop (reference
    omp_set_num_threads, pindel.cpp:917)."""
    global _NUM_THREADS
    _NUM_THREADS = max(int(n), 1)


def get_num_threads() -> int:
    return _NUM_THREADS


class RaggedAnchors:
    """Concatenated (ragged) anchor arrays over one window's candidates.

    Anchor chains average dozens of points, so pair selection runs in
    native code over these flat arrays (native/detect.cpp) instead of a
    padded cube or per-read numpy calls.  First/last-anchor gathers feed
    the vectorized detector preconditions.
    """

    __slots__ = ("n", "minus", "rdlen", "max_snp",
                 "cl_off", "cl_len", "cl_loc", "cl_mm",
                 "fa_off", "fa_len", "fa_loc", "fa_mm", "fa_dm",
                 "cl_loc0", "cl_locL", "fa_loc0", "fa_locL",
                 "cl_sm0", "fa_sm0", "cl_dm0", "fa_dm0",
                 "cl_lenL", "cl_mmL", "fa_lenL", "fa_mmL", "fa_dmL")

    def __init__(self, pairs):
        n = self.n = len(pairs)
        self.minus = np.fromiter((r.matched_d == MINUS for _, r in pairs),
                                 bool, n)
        self.rdlen = np.fromiter((len(r.seq) for _, r in pairs),
                                 np.int64, n)
        self.max_snp = np.fromiter((r.max_snp_error for _, r in pairs),
                                   np.int64, n)
        nc = np.fromiter((len(r.up_close) for _, r in pairs), np.int64, n)
        nf = np.fromiter((len(r.up_far) for _, r in pairs), np.int64, n)
        self.cl_off = np.zeros(n + 1, np.int64)
        self.fa_off = np.zeros(n + 1, np.int64)
        np.cumsum(nc, out=self.cl_off[1:])
        np.cumsum(nf, out=self.fa_off[1:])
        tc, tf = int(self.cl_off[n]), int(self.fa_off[n])
        # bulk concatenates (one C pass per column) instead of a
        # per-read slice-assignment loop; the native selector consumes
        # int64/uint8, so cast once per column
        cl_sets = [r.up_close for _, r in pairs]
        fa_sets = [r.up_far for _, r in pairs]

        def cat(arrs, total, dtype):
            if not arrs:
                return np.empty(total, dtype)
            return np.concatenate(arrs).astype(dtype, copy=False)

        self.cl_len = cat([c.length for c in cl_sets], tc, np.int64)
        self.cl_loc = cat([c.loc for c in cl_sets], tc, np.int64)
        self.cl_mm = cat([c.mm for c in cl_sets], tc, np.int64)
        self.fa_len = cat([f.length for f in fa_sets], tf, np.int64)
        self.fa_loc = cat([f.loc for f in fa_sets], tf, np.int64)
        self.fa_mm = cat([f.mm for f in fa_sets], tf, np.int64)
        self.fa_dm = cat([f.dir_minus for f in fa_sets], tf, np.uint8)
        first_c = self.cl_off[:-1]
        last_c = np.maximum(self.cl_off[1:] - 1, 0)
        first_f = self.fa_off[:-1]
        last_f = np.maximum(self.fa_off[1:] - 1, 0)
        self.cl_loc0 = self.cl_loc[first_c]
        self.cl_locL = self.cl_loc[last_c]
        self.fa_loc0 = self.fa_loc[first_f]
        self.fa_locL = self.fa_loc[last_f]
        self.cl_lenL = self.cl_len[last_c]
        self.cl_mmL = self.cl_mm[last_c]
        self.fa_lenL = self.fa_len[last_f]
        self.fa_mmL = self.fa_mm[last_f]
        self.fa_dmL = self.fa_dm[last_f].astype(bool)
        self.fa_dm0 = self.fa_dm[first_f].astype(bool)
        cl_sm = np.empty(n, bool)
        cl_dm = np.empty(n, bool)
        fa_sm = np.empty(n, bool)
        for k, (_, r) in enumerate(pairs):
            cl_sm[k] = r.up_close.strand_minus[0]
            cl_dm[k] = r.up_close.dir_minus[0]
            fa_sm[k] = r.up_far.strand_minus[0]
        self.cl_sm0 = cl_sm
        self.cl_dm0 = cl_dm
        self.fa_sm0 = fa_sm

    def used_mask(self, pairs) -> np.ndarray:
        return np.fromiter((r.used for _, r in pairs), bool, self.n)

    def first_pairs(self, branch: np.ndarray, min_inv: int = 0):
        """Native argmin over (sum_mm, ci_order, fi_order) per read under
        the per-read ``branch`` predicate; rows with branch == BR_SKIP or
        no qualifying pair get -1."""
        import ctypes
        lib = _native_detect()
        assert lib is not None
        n = self.n
        out_ci = np.empty(n, np.int32)
        out_fi = np.empty(n, np.int32)

        def p64(a):
            return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))

        def p8(a):
            return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))

        lib.ptdetect_first_pairs(
            n, p8(branch), p64(self.max_snp), p64(self.rdlen),
            int(min_inv),
            p64(self.cl_off), p64(self.cl_len), p64(self.cl_loc),
            p64(self.cl_mm),
            p64(self.fa_off), p64(self.fa_len), p64(self.fa_loc),
            p64(self.fa_mm), p8(self.fa_dm),
            out_ci.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            out_fi.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            get_num_threads())
        return out_ci, out_fi


class CandidateReads:
    """Pre-filtered (index, read) pairs shared by all detectors.

    The invariant part of every detector's eligibility prefix — far end
    present and on the anchor chromosome — never changes during the
    detector cascade (only ``used`` flips), so the pipeline computes it
    once per window instead of 7x over the full read list."""

    __slots__ = ("pairs", "_ragged")

    def __init__(self, reads):
        self.pairs = [(i, r) for i, r in enumerate(reads)
                      if r.up_far and r.frag_name == r.far_frag_name]
        self._ragged = None

    @property
    def ragged(self) -> RaggedAnchors:
        if self._ragged is None:
            self._ragged = RaggedAnchors(self.pairs)
        return self._ragged


# detectors accept either a plain read list or the shared prefilter
ReadsArg = Union[List[SplitRead], "CandidateReads"]


def _eligible(reads: ReadsArg):
    if isinstance(reads, CandidateReads):
        return reads.pairs
    return [(i, r) for i, r in enumerate(reads)
            if r.up_far and r.frag_name == r.far_frag_name]


def _place_read(read: SplitRead, idx: int, ctx: WindowContext,
                boxes: List[List[int]]) -> bool:
    """Shared tail: defer to next window or bin into a box; returns placed."""
    if read_transgresses_bin_boundaries(read, ctx.window_end):
        ctx.future.append(read)
        read.used = True
        return False
    if read_in_specified_region(read, ctx):
        box_index = read.bp_left // ctx.box_size
        if box_index < ctx.num_boxes:
            boxes[box_index].append(idx)
            read.used = True
            return True
    return False


def _read_anchors(read: SplitRead):
    """(abs_loc, length, mismatches, is_minus_direction) array views for
    the read's close and far AnchorSets — zero copies."""
    c, f = read.up_close, read.up_far
    return ((c.loc, c.length, c.mm, c.dir_minus),
            (f.loc, f.length, f.mm, f.dir_minus))


_BIG = np.iinfo(np.int64).max


def pick_first_pair(pred: np.ndarray, cmm: np.ndarray, fmm: np.ndarray,
                    max_snp: int, ci_asc: bool, fi_asc: bool):
    """Vectorized equivalent of the reference's budget-escalation loops.

    A pair (ci, fi) first becomes eligible at budget = close.mm + far.mm;
    within a budget the loops scan ci (asc/desc per branch) then fi.  The
    winner therefore minimizes (sum_mm, ci_order, fi_order) over pairs
    passing the geometry predicate.  Returns (ci, fi) or None.
    """
    sum_mm = cmm[:, None] + fmm[None, :]
    ok = pred & (sum_mm <= max_snp)
    if not ok.any():
        return None
    nc, nf = ok.shape
    ci_key = np.arange(nc, dtype=np.int64)
    if not ci_asc:
        ci_key = ci_key[::-1]
    fi_key = np.arange(nf, dtype=np.int64)
    if not fi_asc:
        fi_key = fi_key[::-1]
    key = sum_mm * (nc * nf) + ci_key[:, None] * nf + fi_key[None, :]
    key[~ok] = _BIG
    flat = int(np.argmin(key))
    return flat // nf, flat % nf


class VariantSearcher:
    """Template method, reference SearchVariant::Search.

    The hot path is a vectorized candidate-pair selection
    (pick_first_pair); the scalar reference loop remains as the fallback
    for the rare non-terminating placements (region-filter miss,
    chromosome-bounds break)."""

    def decision1(self, read: SplitRead, ci: int, fi: int) -> bool:
        raise NotImplementedError

    def decision2(self, read: SplitRead, ci: int, fi: int) -> bool:
        raise NotImplementedError

    def indel_size(self, read: SplitRead) -> int:
        raise NotImplementedError

    def inserted_str1(self, read: SplitRead) -> str:
        raise NotImplementedError

    def inserted_str2(self, read: SplitRead) -> str:
        raise NotImplementedError

    def pred1(self, read, cl, fa) -> np.ndarray:
        raise NotImplementedError

    def pred2(self, read, cl, fa) -> np.ndarray:
        raise NotImplementedError

    # native branch codes (plus-anchor, minus-anchor); set by subclasses
    BR = (BR_SKIP, BR_SKIP)

    def search(self, reads: ReadsArg, ctx: WindowContext,
               boxes: List[List[int]]) -> None:
        if (isinstance(reads, CandidateReads) and reads.pairs
                and _native_detect() is not None):
            self._search_batched(reads, ctx, boxes)
            return
        chr_len = len(ctx.chr_seq)
        for idx, read in _eligible(reads):
            if read.used:
                continue
            self._search_one(read, idx, ctx, boxes, chr_len)

    def _search_batched(self, cand: "CandidateReads", ctx: WindowContext,
                        boxes: List[List[int]]) -> None:
        """One native ragged pair-selection over the whole window (the
        per-read pair loops dominated the detector cascade in profiles)."""
        ra = cand.ragged
        pairs = cand.pairs
        chr_len = len(ctx.chr_seq)
        used = ra.used_mask(pairs)
        branch = np.full(ra.n, BR_SKIP, np.uint8)
        branch[~used & ~ra.minus] = self.BR[0]
        branch[~used & ra.minus] = self.BR[1]
        ci, fi = ra.first_pairs(branch)
        for k in np.flatnonzero(ci >= 0):
            idx, read = pairs[k]
            if read.used:
                continue
            self._apply_hit(read, idx, int(ci[k]), int(fi[k]), ctx, boxes,
                            chr_len)

    def _apply_hit(self, read: SplitRead, idx: int, ci: int, fi: int,
                   ctx: WindowContext, boxes: List[List[int]],
                   chr_len: int) -> None:
        close_u, far_u = read.up_close[ci], read.up_far[fi]
        if read.matched_d == PLUS:
            read.left = close_u.abs_loc - close_u.length_str + 1
            read.right = far_u.abs_loc + far_u.length_str - 1
            read.bp = close_u.length_str - 1
            read.indel_size = self.indel_size(read)
            read.nt_str = self.inserted_str1(read)
            read.bp_left = close_u.abs_loc - SPACER
            read.bp_right = far_u.abs_loc - SPACER
        else:
            read.left = far_u.abs_loc - far_u.length_str + 1
            read.right = close_u.abs_loc + close_u.length_str - 1
            read.bp = far_u.length_str - 1
            read.indel_size = self.indel_size(read)
            read.nt_str = self.inserted_str2(read)
            read.bp_left = far_u.abs_loc - SPACER
            read.bp_right = close_u.abs_loc - SPACER
        self._finish(read, idx, ctx, boxes, chr_len)
        if not read.used:
            self._search_read_scalar(read, idx, ctx, boxes, chr_len)

    def _search_one(self, read: SplitRead, idx: int, ctx: WindowContext,
                    boxes: List[List[int]], chr_len: int) -> None:
        """Per-read vectorized selection (chains beyond the SoA caps)."""
        cl, fa = _read_anchors(read)
        far_minus = fa[3]
        if read.matched_d == PLUS:
            pred = self.pred1(read, cl, fa) & far_minus[None, :]
            hit = pick_first_pair(pred, cl[2], fa[2],
                                  read.max_snp_error,
                                  ci_asc=True, fi_asc=False)
        elif read.matched_d == MINUS:
            pred = self.pred2(read, cl, fa) & ~far_minus[None, :]
            hit = pick_first_pair(pred, cl[2], fa[2],
                                  read.max_snp_error,
                                  ci_asc=False, fi_asc=False)
        else:
            return
        if hit is None:
            return
        self._apply_hit(read, idx, hit[0], hit[1], ctx, boxes, chr_len)

    def _search_read_scalar(self, read: SplitRead, idx: int,
                            ctx: WindowContext, boxes: List[List[int]],
                            chr_len: int) -> None:
        """Reference loop, bit-exact fallback."""
        max_snp = read.max_snp_error
        if True:
            if read.matched_d == PLUS:
                for budget in range(max_snp + 1):
                    if read.used:
                        break
                    for ci in range(len(read.up_close)):
                        if read.used:
                            break
                        if read.up_close[ci].mismatches > budget:
                            continue
                        for fi in range(len(read.up_far) - 1, -1, -1):
                            if read.used:
                                break
                            far = read.up_far[fi]
                            close = read.up_close[ci]
                            if far.mismatches > budget:
                                continue
                            if far.mismatches + close.mismatches > budget:
                                continue
                            if far.direction != MINUS:
                                continue
                            if not self.decision1(read, ci, fi):
                                continue
                            read.left = close.abs_loc - close.length_str + 1
                            read.right = far.abs_loc + far.length_str - 1
                            read.bp = close.length_str - 1
                            read.indel_size = self.indel_size(read)
                            read.nt_str = self.inserted_str1(read)
                            read.bp_left = close.abs_loc - SPACER
                            read.bp_right = far.abs_loc - SPACER
                            if not self._finish(read, idx, ctx, boxes,
                                                chr_len):
                                break
            elif read.matched_d == MINUS:
                for budget in range(max_snp + 1):
                    if read.used:
                        break
                    for ci in range(len(read.up_close) - 1, -1, -1):
                        if read.used:
                            break
                        if read.up_close[ci].mismatches > budget:
                            continue
                        for fi in range(len(read.up_far) - 1, -1, -1):
                            if read.used:
                                break
                            far = read.up_far[fi]
                            close = read.up_close[ci]
                            if far.mismatches > budget:
                                continue
                            if far.mismatches + close.mismatches > budget:
                                continue
                            if far.direction != PLUS:
                                continue
                            if not self.decision2(read, ci, fi):
                                continue
                            read.left = far.abs_loc - far.length_str + 1
                            read.right = close.abs_loc + close.length_str - 1
                            read.bp = far.length_str - 1
                            read.indel_size = self.indel_size(read)
                            read.nt_str = self.inserted_str2(read)
                            read.bp_left = far.abs_loc - SPACER
                            read.bp_right = close.abs_loc - SPACER
                            if not self._finish(read, idx, ctx, boxes,
                                                chr_len):
                                break

    def _finish(self, read: SplitRead, idx: int, ctx: WindowContext,
                boxes: List[List[int]], chr_len: int) -> bool:
        """Canonicalize + place; returns False when the far loop must break
        (reference ``break`` after Used=true inside ChrSeq bounds check)."""
        if chr_len < read.bp_left or chr_len < read.bp_right:
            read.used = True
            return False
        real_left, real_right = read.bp_left, read.bp_right
        if read.nt_str:
            read.nt_str, real_left, real_right = _real4ins(
                ctx.chr_seq, read.nt_str, real_left, real_right)
        else:
            real_left, real_right = get_real_start_4_deletion(
                ctx.chr_seq, real_left, real_right)
        diff = read.bp_left - real_left
        diff = min(diff, read.bp - 1)
        if diff > 0:
            read.bp -= diff
            read.bp_left -= diff
            read.bp_right -= diff
        _place_read(read, idx, ctx, boxes)
        return True


def _real4ins(chr_seq, nt, left, right):
    nt2, l2, r2 = get_real_start_4_insertion(chr_seq, nt, left, right)
    return nt2, l2, r2


class SearchDeletions(VariantSearcher):
    """Pure deletions (D).  Reference: searchdeletions.cpp:38-70."""

    BR = (BR_D_PLUS, BR_D_MINUS)

    def pred1(self, read, cl, fa):
        return ((fa[1][None, :] + cl[1][:, None] == read.read_length)
                & (fa[0][None, :] > cl[0][:, None] + 1))

    def pred2(self, read, cl, fa):
        return ((cl[1][:, None] + fa[1][None, :] == read.read_length)
                & (cl[0][:, None] > fa[0][None, :] + 1))

    def decision1(self, read, ci, fi):
        return (read.up_far[fi].length_str + read.up_close[ci].length_str
                == read.read_length
                and read.up_far[fi].abs_loc > read.up_close[ci].abs_loc + 1)

    def decision2(self, read, ci, fi):
        return (read.up_close[ci].length_str + read.up_far[fi].length_str
                == read.read_length
                and read.up_close[ci].abs_loc > read.up_far[fi].abs_loc + 1)

    def indel_size(self, read):
        return (read.right - read.left) - (read.read_length - 1)

    def inserted_str1(self, read):
        return ""

    def inserted_str2(self, read):
        return ""


class SearchShortInsertions(VariantSearcher):
    """Short insertions (SI).  Reference: searchshortinsertions.cpp:38-71.

    Note: the reference leaves NT_size untouched here (0) even though
    NT_str is set — preserved for sort/filter fidelity.
    """

    BR = (BR_SI_PLUS, BR_SI_MINUS)

    def pred1(self, read, cl, fa):
        return ((fa[0][None, :] == cl[0][:, None] + 1)
                & (cl[1][:, None] + fa[1][None, :] < read.read_length))

    def pred2(self, read, cl, fa):
        return ((cl[0][:, None] == fa[0][None, :] + 1)
                & (fa[1][None, :] + cl[1][:, None] < read.read_length))

    def decision1(self, read, ci, fi):
        return (read.up_far[fi].abs_loc == read.up_close[ci].abs_loc + 1
                and read.up_close[ci].length_str + read.up_far[fi].length_str
                < read.read_length)

    def decision2(self, read, ci, fi):
        return (read.up_close[ci].abs_loc == read.up_far[fi].abs_loc + 1
                and read.up_far[fi].length_str + read.up_close[ci].length_str
                < read.read_length)

    def indel_size(self, read):
        return (read.read_length - 1) - (read.right - read.left)

    def inserted_str1(self, read):
        return revcomp_str(read.seq)[read.bp + 1: read.bp + 1 + read.indel_size]

    def inserted_str2(self, read):
        return read.seq[read.bp + 1: read.bp + 1 + read.indel_size]


def left_most_td(read: SplitRead, ctx: WindowContext) -> None:
    """Left-shift a tandem duplication (search_tandem_duplications.cpp:189)."""
    chr_seq = ctx.chr_seq
    pos = read.bp_left + SPACER
    original = pos
    end = read.bp_right + SPACER - 1
    if pos >= len(chr_seq) or end >= len(chr_seq):
        read.bp_left = 1
        read.bp_right = 1
        read.bp = 1
        read.used = True
        return
    while chr_seq[pos] == chr_seq[end]:
        pos -= 1
        end -= 1
    diff = original - pos
    if diff > 0:
        if diff >= read.bp:
            diff = read.bp - 1
        read.bp_left -= diff
        read.bp_right -= diff
        read.bp -= diff


def left_most_inv(read: SplitRead, ctx: WindowContext) -> None:
    """Right-shift an inversion breakpoint (search_inversions.cpp:283-317)."""
    from refpindel.events.canonical import _RC
    chr_seq = ctx.chr_seq
    chr_len = len(chr_seq)
    pos = read.bp_left + SPACER + 1
    original = pos
    end = read.bp_right + SPACER - 1
    if chr_len <= pos + SPACER or chr_len <= original + SPACER:
        read.bp_left = 1
        read.bp_right = 1
        read.bp = 1
        read.used = True
        return
    while chr_seq[pos] == _RC.get(chr_seq[end], "N"):
        pos += 1
        end -= 1
    diff = pos - original
    if diff > 0:
        if read.matched_d == PLUS:
            if diff >= read.bp:
                diff = read.bp - 1
            # reference quirk: the plus branch clamps DIFF but never
            # applies it (search_inversions.cpp:304-307)
        else:
            if diff + read.bp >= read.read_length:
                diff = read.read_length - read.bp - 1
            read.bp_left += diff
            read.bp_right -= diff
            read.bp += diff


def search_tandem_duplications(reads: ReadsArg, ctx: WindowContext,
                               boxes: List[List[int]]) -> None:
    """Reference: searchTandemDuplications (search_tandem_duplications.cpp).

    Native ragged pair selection when available; per-read vectorized
    selection otherwise, with the reference loop as placement fallback."""
    if (isinstance(reads, CandidateReads) and reads.pairs
            and _native_detect() is not None):
        ra = reads.ragged
        pairs = reads.pairs
        used = ra.used_mask(pairs)
        branch = np.full(ra.n, BR_SKIP, np.uint8)
        branch[~used & ~ra.minus] = BR_TD_PLUS
        branch[~used & ra.minus] = BR_TD_MINUS
        ci_a, fi_a = ra.first_pairs(branch)
        for k in np.flatnonzero(ci_a >= 0):
            idx, read = pairs[k]
            if read.used:
                continue
            _td_apply_hit(read, idx, int(ci_a[k]), int(fi_a[k]), ctx, boxes)
        return
    for idx, read in _eligible(reads):
        if read.used:
            continue
        cl, fa = _read_anchors(read)
        L = read.read_length
        if read.matched_d == PLUS:
            pred = ((fa[1][None, :] + cl[1][:, None] == L)
                    & (fa[0][None, :] + fa[1][None, :] < cl[0][:, None])
                    & (fa[0][None, :] + cl[1][:, None] < cl[0][:, None])
                    & fa[3][None, :])
            hit = pick_first_pair(pred, cl[2], fa[2], read.max_snp_error,
                                  ci_asc=True, fi_asc=False)
        elif read.matched_d == MINUS:
            pred = ((cl[1][:, None] + fa[1][None, :] == L)
                    & (cl[0][:, None] + cl[1][:, None] < fa[0][None, :])
                    & (cl[0][:, None] + fa[1][None, :] < fa[0][None, :])
                    & ~fa[3][None, :])
            hit = pick_first_pair(pred, cl[2], fa[2], read.max_snp_error,
                                  ci_asc=False, fi_asc=True)
        else:
            continue
        if hit is None:
            continue
        _td_apply_hit(read, idx, hit[0], hit[1], ctx, boxes)


def _td_apply_hit(read: SplitRead, idx: int, ci: int, fi: int,
                  ctx: WindowContext, boxes: List[List[int]]) -> None:
    close_u, far_u = read.up_close[ci], read.up_far[fi]
    if read.matched_d == PLUS:
        read.right = close_u.abs_loc - close_u.length_str + 1
        read.left = far_u.abs_loc + far_u.length_str - 1
        read.bp = close_u.length_str - 1
        read.indel_size = close_u.abs_loc - far_u.abs_loc + 1
        read.bp_right = close_u.abs_loc - SPACER
        read.bp_left = far_u.abs_loc - SPACER
    else:
        read.right = far_u.abs_loc - far_u.length_str + 1
        read.left = close_u.abs_loc + close_u.length_str - 1
        read.bp = far_u.length_str - 1
        read.indel_size = far_u.abs_loc - close_u.abs_loc + 1
        read.bp_right = far_u.abs_loc - SPACER
        read.bp_left = close_u.abs_loc - SPACER
    if read.bp_left != 0:
        left_most_td(read, ctx)
        if not read.used:
            _place_read(read, idx, ctx, boxes)
    if not read.used:
        _td_scalar_read(read, idx, ctx, boxes)


def _td_scalar_read(read: SplitRead, idx: int, ctx: WindowContext,
                    boxes: List[List[int]]) -> None:
    """Bit-exact reference fallback for one read."""
    if True:
        if read.matched_d == PLUS:
            for budget in range(read.max_snp_error + 1):
                for ci in range(len(read.up_close)):
                    if read.used:
                        break
                    close = read.up_close[ci]
                    if close.mismatches > budget:
                        continue
                    for fi in range(len(read.up_far) - 1, -1, -1):
                        if read.used:
                            break
                        far = read.up_far[fi]
                        if far.mismatches > budget:
                            continue
                        if far.mismatches + close.mismatches > budget:
                            continue
                        if far.direction != MINUS:
                            continue
                        if not (far.length_str + close.length_str
                                == read.read_length
                                and far.abs_loc + far.length_str
                                < close.abs_loc
                                and far.abs_loc + close.length_str
                                < close.abs_loc):
                            continue
                        read.right = close.abs_loc - close.length_str + 1
                        read.left = far.abs_loc + far.length_str - 1
                        read.bp = close.length_str - 1
                        read.indel_size = close.abs_loc - far.abs_loc + 1
                        read.bp_right = close.abs_loc - SPACER
                        read.bp_left = far.abs_loc - SPACER
                        if read.bp_left == 0:
                            continue
                        left_most_td(read, ctx)
                        _place_read(read, idx, ctx, boxes)
        elif read.matched_d == MINUS:
            for budget in range(read.max_snp_error + 1):
                for ci in range(len(read.up_close) - 1, -1, -1):
                    if read.used:
                        break
                    close = read.up_close[ci]
                    if close.mismatches > budget:
                        continue
                    for fi in range(len(read.up_far)):
                        if read.used:
                            break
                        far = read.up_far[fi]
                        if far.mismatches > budget:
                            continue
                        if far.mismatches + close.mismatches > budget:
                            continue
                        if far.direction != PLUS:
                            continue
                        if not (close.length_str + far.length_str
                                == read.read_length
                                and close.abs_loc + close.length_str
                                < far.abs_loc
                                and close.abs_loc + far.length_str
                                < far.abs_loc):
                            continue
                        read.right = far.abs_loc - far.length_str + 1
                        read.left = close.abs_loc + close.length_str - 1
                        read.bp = far.length_str - 1
                        read.indel_size = far.abs_loc - close.abs_loc + 1
                        read.bp_right = far.abs_loc - SPACER
                        read.bp_left = close.abs_loc - SPACER
                        if read.bp_left == 0:
                            continue
                        left_most_td(read, ctx)
                        _place_read(read, idx, ctx, boxes)


def _nt_prefilter(reads: ReadsArg, settings: Settings, extra=None):
    """Last-anchor numpy prefilter shared by the NT detectors: the
    detectors below only consult up_close[-1]/up_far[-1], so the mismatch
    ceiling (and any ``extra(ra)`` mask) eliminates most reads in one
    vectorized pass; survivors re-run the exact per-read logic."""
    if not isinstance(reads, CandidateReads) or not reads.pairs:
        return _eligible(reads)
    ra = reads.ragged
    pairs = reads.pairs
    lens = ra.fa_lenL + ra.cl_lenL
    ceil = (1 + settings.seq_error_rate * lens).astype(np.int64)
    keep = ~ra.used_mask(pairs) & (ra.fa_mmL + ra.cl_mmL <= ceil)
    if extra is not None:
        keep &= extra(ra)
    return [pairs[k] for k in np.flatnonzero(keep)]


def search_tandem_duplications_nt(reads: ReadsArg, ctx: WindowContext,
                                  boxes: List[List[int]],
                                  settings: Settings) -> None:
    """Reference: searchTandemDuplicationsNT
    (search_tandem_duplications_nt.cpp:27-131)."""
    cand = _nt_prefilter(
        reads, settings,
        extra=lambda ra: ra.fa_lenL + ra.cl_lenL < ra.rdlen)
    for idx, read in cand:
        if read.used:
            continue
        close = read.up_close[-1]
        far = read.up_far[-1]
        if far.length_str + close.length_str >= read.read_length:
            continue
        if far.mismatches + close.mismatches > int(
                1 + settings.seq_error_rate
                * (far.length_str + close.length_str)):
            continue
        if read.matched_d == PLUS:
            if far.direction != MINUS:
                continue
            if not (far.abs_loc + far.length_str < close.abs_loc
                    and far.abs_loc + close.length_str < close.abs_loc
                    and far.length_str + close.length_str
                    > settings.min_num_matched_bases):
                continue
            read.right = close.abs_loc - close.length_str + 1
            read.left = far.abs_loc + far.length_str - 1
            read.bp = close.length_str - 1
            read.indel_size = close.abs_loc - far.abs_loc + 1
            read.nt_size = (read.read_length - close.length_str
                            - far.length_str)
            read.nt_str = revcomp_str(read.seq)[
                read.bp + 1: read.bp + 1 + read.nt_size]
            read.bp_right = close.abs_loc - SPACER
            read.bp_left = far.abs_loc - SPACER
            _place_read(read, idx, ctx, boxes)
        elif read.matched_d == MINUS:
            if far.direction != PLUS:
                continue
            if not (close.abs_loc + close.length_str < far.abs_loc
                    and close.abs_loc + far.length_str < far.abs_loc
                    and far.length_str + close.length_str
                    > settings.min_num_matched_bases):
                continue
            read.right = far.abs_loc - far.length_str + 1
            read.left = close.abs_loc + close.length_str - 1
            read.bp = far.length_str - 1
            read.indel_size = far.abs_loc - close.abs_loc + 1
            read.nt_size = (read.read_length - close.length_str
                            - far.length_str)
            read.nt_str = read.seq[read.bp + 1: read.bp + 1 + read.nt_size]
            read.bp_right = far.abs_loc - SPACER
            read.bp_left = close.abs_loc - SPACER
            _place_read(read, idx, ctx, boxes)


def _place_no_transgress(read, idx, ctx, boxes):
    """INV Minus-branch placement: no bin-boundary deferral (reference
    asymmetry, search_inversions.cpp:190-200)."""
    if read_in_specified_region(read, ctx):
        box_index = read.bp_left // ctx.box_size
        if box_index < ctx.num_boxes:
            boxes[box_index].append(idx)
            read.used = True


def search_inversions(reads: ReadsArg, ctx: WindowContext,
                      boxes: List[List[int]], settings: Settings) -> None:
    """Reference: searchInversions (search_inversions.cpp:30-280).

    Native ragged pair selection when available (branch preconditions
    vectorized over the first/last-anchor gathers); per-read vectorized
    selection otherwise; reference loop as placement fallback."""
    min_inv = settings.min_inversion_size
    if (isinstance(reads, CandidateReads) and reads.pairs
            and _native_detect() is not None):
        ra = reads.ragged
        pairs = reads.pairs
        used = ra.used_mask(pairs)
        elig = (~used & (ra.cl_sm0 != ra.fa_sm0)
                & (ra.cl_dm0 == ra.fa_dm0))
        p1 = elig & ~ra.minus & (ra.fa_loc0 > ra.cl_locL + min_inv)
        p2 = (elig & ~ra.minus & ~p1
              & (ra.fa_locL + min_inv < ra.cl_loc0))
        m1 = elig & ra.minus & (ra.cl_locL > ra.fa_loc0 + min_inv)
        m2 = (elig & ra.minus & ~m1
              & (ra.cl_loc0 + min_inv < ra.fa_locL))
        branch = np.full(ra.n, BR_SKIP, np.uint8)
        branch[p1] = BR_INV_P1
        branch[p2] = BR_INV_P2
        branch[m1] = BR_INV_M1
        branch[m2] = BR_INV_M2
        ci_a, fi_a = ra.first_pairs(branch, min_inv=min_inv)
        names = {BR_INV_P1: "p1", BR_INV_P2: "p2",
                 BR_INV_M1: "m1", BR_INV_M2: "m2"}
        for k in np.flatnonzero(ci_a >= 0):
            idx, read = pairs[k]
            if read.used:
                continue
            _inv_apply_hit(read, idx, names[int(branch[k])], int(ci_a[k]),
                           int(fi_a[k]), ctx, boxes, settings)
        return
    for idx, read in _eligible(reads):
        if read.used:
            continue
        if not (read.up_close[0].strand != read.up_far[0].strand
                and read.up_close[0].direction == read.up_far[0].direction):
            continue
        cl, fa = _read_anchors(read)
        L = read.read_length
        lens_eq = cl[1][:, None] + fa[1][None, :] == L
        hit = None
        branch = None
        if read.matched_d == PLUS:
            if read.up_far[0].abs_loc > read.last_abs_loc_close_end() + min_inv:
                pred = (lens_eq & ~fa[3][None, :]
                        & (fa[0][None, :] > cl[0][:, None] + min_inv))
                hit = pick_first_pair(pred, cl[2], fa[2], read.max_snp_error,
                                      ci_asc=False, fi_asc=True)
                branch = "p1"
            elif read.up_far[-1].abs_loc + min_inv < read.up_close[0].abs_loc:
                pred = (lens_eq & ~fa[3][None, :]
                        & (fa[0][None, :] + min_inv < cl[0][:, None]))
                hit = pick_first_pair(pred, cl[2], fa[2], read.max_snp_error,
                                      ci_asc=True, fi_asc=False)
                branch = "p2"
        elif read.matched_d == MINUS:
            if read.up_close[-1].abs_loc > read.up_far[0].abs_loc + min_inv:
                pred = (lens_eq & fa[3][None, :]
                        & (cl[0][:, None] > fa[0][None, :] + min_inv))
                hit = pick_first_pair(pred, cl[2], fa[2], read.max_snp_error,
                                      ci_asc=False, fi_asc=True)
                branch = "m1"
            elif read.up_close[0].abs_loc + min_inv < read.up_far[-1].abs_loc:
                pred = (lens_eq & fa[3][None, :]
                        & (cl[0][:, None] + min_inv < fa[0][None, :]))
                hit = pick_first_pair(pred, cl[2], fa[2], read.max_snp_error,
                                      ci_asc=True, fi_asc=False)
                branch = "m2"
        if hit is None:
            continue
        _inv_apply_hit(read, idx, branch, hit[0], hit[1], ctx, boxes,
                       settings)


def _inv_apply_hit(read: SplitRead, idx: int, branch: str, ci: int, fi: int,
                   ctx: WindowContext, boxes: List[List[int]],
                   settings: Settings) -> None:
    L = read.read_length
    close_u, far_u = read.up_close[ci], read.up_far[fi]
    read.nt_str = ""
    read.nt_size = 0
    if branch == "p1":
        read.left = (close_u.abs_loc + 1) - close_u.length_str
        read.right = far_u.abs_loc - far_u.length_str + L
        read.bp = close_u.length_str - 1
        read.indel_size = far_u.abs_loc - close_u.abs_loc
        read.bp_left = close_u.abs_loc + 1 - SPACER
        read.bp_right = far_u.abs_loc - SPACER
    elif branch == "p2":
        read.right = close_u.abs_loc - close_u.length_str + L
        read.left = far_u.abs_loc - far_u.length_str + 1
        read.bp = far_u.length_str - 1
        read.indel_size = close_u.abs_loc - far_u.abs_loc
        read.bp_right = close_u.abs_loc - SPACER
        read.bp_left = (far_u.abs_loc + 1) - SPACER
    elif branch == "m1":
        read.left = far_u.abs_loc + far_u.length_str - L
        read.right = close_u.abs_loc + close_u.length_str - 1
        read.bp = far_u.length_str - 1
        read.indel_size = close_u.abs_loc - far_u.abs_loc
        read.bp_left = far_u.abs_loc - SPACER
        read.bp_right = close_u.abs_loc - 1 - SPACER
    else:
        read.right = far_u.abs_loc + far_u.length_str - 1
        read.left = close_u.abs_loc + close_u.length_str - L
        read.bp = close_u.length_str - 1
        read.indel_size = far_u.abs_loc - close_u.abs_loc
        read.bp_left = close_u.abs_loc - SPACER
        read.bp_right = far_u.abs_loc - 1 - SPACER
    left_most_inv(read, ctx)
    if not read.used:
        if branch in ("p1", "p2"):
            _place_read(read, idx, ctx, boxes)
        else:
            _place_no_transgress(read, idx, ctx, boxes)
    if not read.used:
        _inv_scalar_read(read, idx, ctx, boxes, settings)


def _inv_scalar_read(read: SplitRead, idx: int, ctx: WindowContext,
                     boxes: List[List[int]], settings: Settings) -> None:
    """Bit-exact reference fallback for one read."""
    min_inv = settings.min_inversion_size

    def place_no_transgress(read, idx):
        _place_no_transgress(read, idx, ctx, boxes)

    if True:
        if read.matched_d == PLUS:
            if read.up_far[0].abs_loc > \
                    read.last_abs_loc_close_end() + min_inv:
                for budget in range(read.max_snp_error + 1):
                    for ci in range(len(read.up_close) - 1, -1, -1):
                        if read.used:
                            break
                        close = read.up_close[ci]
                        if close.mismatches > budget:
                            continue
                        for fi in range(len(read.up_far)):
                            if read.used:
                                break
                            far = read.up_far[fi]
                            if far.mismatches > budget:
                                continue
                            if far.mismatches + close.mismatches > budget:
                                continue
                            if far.direction != PLUS:
                                continue
                            if not (far.length_str + close.length_str
                                    == read.read_length
                                    and far.abs_loc
                                    > close.abs_loc + min_inv):
                                continue
                            read.left = (close.abs_loc + 1) - close.length_str
                            read.right = (far.abs_loc - far.length_str
                                          + read.read_length)
                            read.bp = close.length_str - 1
                            read.indel_size = far.abs_loc - close.abs_loc
                            read.nt_str = ""
                            read.nt_size = 0
                            read.bp_left = close.abs_loc + 1 - SPACER
                            read.bp_right = far.abs_loc - SPACER
                            left_most_inv(read, ctx)
                            _place_read(read, idx, ctx, boxes)
            elif read.up_far[-1].abs_loc + min_inv < read.up_close[0].abs_loc:
                for budget in range(read.max_snp_error + 1):
                    for ci in range(len(read.up_close)):
                        if read.used:
                            break
                        close = read.up_close[ci]
                        if close.mismatches > budget:
                            continue
                        for fi in range(len(read.up_far) - 1, -1, -1):
                            if read.used:
                                break
                            far = read.up_far[fi]
                            if far.mismatches > budget:
                                continue
                            if far.mismatches + close.mismatches > budget:
                                continue
                            if far.direction != PLUS:
                                continue
                            if not (far.length_str + close.length_str
                                    == read.read_length
                                    and far.abs_loc + min_inv
                                    < close.abs_loc):
                                continue
                            read.right = (close.abs_loc - close.length_str
                                          + read.read_length)
                            read.left = far.abs_loc - far.length_str + 1
                            read.bp = far.length_str - 1
                            read.indel_size = close.abs_loc - far.abs_loc
                            read.nt_str = ""
                            read.nt_size = 0
                            read.bp_right = close.abs_loc - SPACER
                            read.bp_left = (far.abs_loc + 1) - SPACER
                            left_most_inv(read, ctx)
                            _place_read(read, idx, ctx, boxes)
        elif read.matched_d == MINUS:
            if read.up_close[-1].abs_loc > read.up_far[0].abs_loc + min_inv:
                for budget in range(read.max_snp_error + 1):
                    for ci in range(len(read.up_close) - 1, -1, -1):
                        if read.used:
                            break
                        close = read.up_close[ci]
                        if close.mismatches > budget:
                            continue
                        for fi in range(len(read.up_far)):
                            if read.used:
                                break
                            far = read.up_far[fi]
                            if far.mismatches > budget:
                                continue
                            if far.mismatches + close.mismatches > budget:
                                continue
                            if far.direction != MINUS:
                                continue
                            if not (close.length_str + far.length_str
                                    == read.read_length
                                    and close.abs_loc
                                    > far.abs_loc + min_inv):
                                continue
                            read.left = (far.abs_loc + far.length_str
                                         - read.read_length)
                            read.right = (close.abs_loc + close.length_str
                                          - 1)
                            read.bp = far.length_str - 1
                            read.indel_size = close.abs_loc - far.abs_loc
                            read.nt_str = ""
                            read.nt_size = 0
                            read.bp_left = far.abs_loc - SPACER
                            read.bp_right = close.abs_loc - 1 - SPACER
                            left_most_inv(read, ctx)
                            place_no_transgress(read, idx)
            elif read.up_close[0].abs_loc + min_inv < read.up_far[-1].abs_loc:
                for budget in range(read.max_snp_error + 1):
                    for ci in range(len(read.up_close)):
                        if read.used:
                            break
                        close = read.up_close[ci]
                        if close.mismatches > budget:
                            continue
                        for fi in range(len(read.up_far) - 1, -1, -1):
                            if read.used:
                                break
                            far = read.up_far[fi]
                            if far.mismatches > budget:
                                continue
                            if far.mismatches + close.mismatches > budget:
                                continue
                            if far.direction != MINUS:
                                continue
                            if not (close.length_str + far.length_str
                                    == read.read_length
                                    and close.abs_loc + min_inv
                                    < far.abs_loc):
                                continue
                            read.right = far.abs_loc + far.length_str - 1
                            read.left = (close.abs_loc + close.length_str
                                         - read.read_length)
                            read.bp = close.length_str - 1
                            read.indel_size = far.abs_loc - close.abs_loc
                            read.nt_str = ""
                            read.nt_size = 0
                            read.bp_left = close.abs_loc - SPACER
                            read.bp_right = far.abs_loc - 1 - SPACER
                            left_most_inv(read, ctx)
                            place_no_transgress(read, idx)


def search_inversions_nt(reads: ReadsArg, ctx: WindowContext,
                         boxes: List[List[int]],
                         settings: Settings) -> None:
    """Reference: searchInversionsNT (search_inversions_nt.cpp:30-200)."""
    min_inv = settings.min_inversion_size
    mnmb = settings.min_num_matched_bases
    cand = _nt_prefilter(
        reads, settings,
        extra=lambda ra: ((ra.cl_sm0 != ra.fa_sm0)
                          & (ra.cl_dm0 == ra.fa_dm0)
                          & (ra.fa_lenL + ra.cl_lenL < ra.rdlen)
                          & (ra.fa_lenL + ra.cl_lenL >= mnmb)))
    for idx, read in cand:
        if read.used:
            continue
        close = read.up_close[-1]
        far = read.up_far[-1]
        if far.mismatches + close.mismatches > int(
                1 + settings.seq_error_rate
                * (far.length_str + close.length_str)):
            continue
        if not (read.up_close[0].strand != read.up_far[0].strand
                and read.up_close[0].direction == read.up_far[0].direction):
            continue
        lens = far.length_str + close.length_str
        if read.matched_d == PLUS and far.direction == PLUS:
            if (lens < read.read_length
                    and far.abs_loc > close.abs_loc + min_inv
                    and lens >= mnmb):
                read.left = (close.abs_loc + 1) - close.length_str
                read.right = (far.abs_loc - far.length_str
                              + read.read_length)
                read.bp = close.length_str - 1
                read.indel_size = far.abs_loc - close.abs_loc
                read.nt_size = read.read_length - lens
                read.nt_str = revcomp_str(read.seq)[
                    read.bp + 1: read.bp + 1 + read.nt_size]
                read.bp_left = close.abs_loc + 1 - SPACER
                read.bp_right = far.abs_loc - SPACER
                _place_read(read, idx, ctx, boxes)
            if (lens < read.read_length
                    and far.abs_loc + min_inv < close.abs_loc
                    and lens >= mnmb and not read.used):
                read.right = (close.abs_loc - close.length_str
                              + read.read_length)
                read.left = far.abs_loc - far.length_str + 1
                read.bp = far.length_str - 1
                read.indel_size = close.abs_loc - far.abs_loc
                read.nt_size = read.read_length - lens
                read.nt_str = read.seq[read.bp + 1:
                                       read.bp + 1 + read.nt_size]
                read.bp_right = close.abs_loc - SPACER
                read.bp_left = (far.abs_loc + 1) - SPACER
                _place_read(read, idx, ctx, boxes)
        elif read.matched_d == MINUS and far.direction == MINUS:
            if (lens < read.read_length
                    and close.abs_loc > far.abs_loc + min_inv
                    and lens >= mnmb):
                read.left = (far.abs_loc + far.length_str
                             - read.read_length)
                read.right = close.abs_loc + close.length_str - 1
                read.bp = far.length_str - 1
                read.indel_size = close.abs_loc - far.abs_loc
                read.nt_size = read.read_length - lens
                read.nt_str = read.seq[read.bp + 1:
                                       read.bp + 1 + read.nt_size]
                read.bp_left = far.abs_loc - SPACER
                read.bp_right = close.abs_loc - 1 - SPACER
                _place_read(read, idx, ctx, boxes)
            if (lens < read.read_length
                    and close.abs_loc + min_inv < far.abs_loc
                    and lens >= mnmb and not read.used):
                read.right = far.abs_loc + far.length_str - 1
                read.left = (close.abs_loc + close.length_str
                             - read.read_length)
                read.bp = close.length_str - 1
                read.indel_size = far.abs_loc - close.abs_loc
                read.nt_size = read.read_length - lens
                read.nt_str = revcomp_str(read.seq)[
                    read.bp + 1: read.bp + 1 + read.nt_size]
                read.bp_left = close.abs_loc - SPACER
                read.bp_right = far.abs_loc - 1 - SPACER
                _place_read(read, idx, ctx, boxes)


def search_indels_nt(reads: ReadsArg, ctx: WindowContext,
                     boxes: List[List[int]], settings: Settings) -> None:
    """Deletions with non-template insertion (DI / RPL).

    Reference: searchIndels, search_deletions_nt.cpp:27-166 — only the
    last (longest) close and far anchors are considered, with a
    length-scaled mismatch ceiling.  The geometry predicates are
    evaluated vectorized over the ragged last-anchor gathers; survivors
    get their event fields filled per read."""
    mnmb = settings.min_num_matched_bases
    if isinstance(reads, CandidateReads) and reads.pairs:
        ra = reads.ragged
        pairs = reads.pairs
        lens = ra.fa_lenL + ra.cl_lenL
        ceil = (1 + settings.seq_error_rate * lens).astype(np.int64)
        keep = (~ra.used_mask(pairs)
                & (ra.fa_mmL + ra.cl_mmL <= ceil)
                & (lens < ra.rdlen) & (lens >= mnmb)
                & (ra.fa_dmL == ~ra.minus)
                & np.where(ra.minus,
                           ra.cl_locL > ra.fa_locL + 1,
                           ra.fa_locL > ra.cl_locL + 1))
        cll = ra.cl_lenL
        clo = ra.cl_locL
        fll = ra.fa_lenL
        flo = ra.fa_locL
        for k in np.flatnonzero(keep).tolist():
            idx, read = pairs[k]
            if read.used:
                continue
            _indels_nt_apply(read, idx, ctx, boxes, int(cll[k]),
                             int(clo[k]), int(fll[k]), int(flo[k]))
        return
    for idx, read in _eligible(reads):
        if read.used:
            continue
        close = read.up_close[-1]
        far = read.up_far[-1]
        if far.mismatches + close.mismatches > int(
                1 + settings.seq_error_rate
                * (far.length_str + close.length_str)):
            continue
        lens = far.length_str + close.length_str
        if read.matched_d == PLUS:
            if far.direction != MINUS:
                continue
            if not (lens < read.read_length and lens >= mnmb
                    and far.abs_loc > close.abs_loc + 1):
                continue
        elif read.matched_d == MINUS:
            if far.direction != PLUS:
                continue
            if not (lens < read.read_length and lens >= mnmb
                    and close.abs_loc > far.abs_loc + 1):
                continue
        else:
            continue
        _indels_nt_apply(read, idx, ctx, boxes, close.length_str,
                         close.abs_loc, far.length_str, far.abs_loc)


def _indels_nt_apply(read: SplitRead, idx: int, ctx: WindowContext,
                     boxes: List[List[int]], clen: int, cloc: int,
                     flen: int, floc: int) -> None:
    """Event fields for one DI hit (search_deletions_nt.cpp:56-160)."""
    rdlen = len(read.seq)
    if read.matched_d == PLUS:
        read.left = cloc - clen + 1
        read.right = floc + flen - 1
        read.bp = clen - 1
        read.nt_size = rdlen - flen - clen
        read.nt_str = revcomp_str(read.seq)[
            read.bp + 1: read.bp + 1 + read.nt_size]
        read.indel_size = ((read.right - read.left) + read.nt_size
                           - (rdlen - 1))
        read.bp_left = cloc - SPACER
        read.bp_right = floc - SPACER
    else:
        read.left = floc - flen + 1
        read.right = cloc + clen - 1
        read.bp = flen - 1
        read.nt_size = rdlen - clen - flen
        read.nt_str = read.seq[read.bp + 1: read.bp + 1 + read.nt_size]
        read.indel_size = ((read.right - read.left)
                           - (rdlen - 1) + read.nt_size)
        read.bp_left = floc - SPACER
        read.bp_right = cloc - SPACER
    _place_read(read, idx, ctx, boxes)
