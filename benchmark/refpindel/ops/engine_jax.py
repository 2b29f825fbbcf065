"""The legacy per-lane search backend in PyTorch (port of
pindel_tpu/ops/engine_jax.py).

``_search_kernel`` is the single-pass length scan of the JAX module over a
batch of reads with up to NL candidate lanes each (one lane per close-end
window; two per far-end region: the forward strand and the reverse-
complement backward strand).  Every lane is normalized to a forward tile
(a chromosome slice, flipped for backward lanes) and the scan carries each
candidate's cumulative mismatch count over the prefix length.  Per length
it emits the aggregates the emission rules need, and the rules are applied
on the device; the output is the JAX kernel's packed int8 buffer, bit for
bit.  It is XLA code in the JAX package, not a Pallas kernel; here it is
the plain version, a step loop of torch ops.  On a card the backend runs
``_route_kernel`` instead: the same search as one shard of the window-
parallel search (ops/sharded_search.py, the CUDA shard kernel at one shard
over the whole window), its merge, recount and emission rules, packed into
the same buffer bit for bit.

``TorchLaneBackend`` is the counterpart of ``JaxBackend``: the Searcher's
per-lane ``run`` interface, which ``TorchFusedBackend.run`` hands the lanes
its explicit-window kernel does not take (several regions, windows too wide
for the spacer, non-uniform chains).  The host half (``unpack_kernel_output``
and ``decode_emissions``) is copied from the JAX module, which imports jax
at module top.
"""
from __future__ import annotations

import time
from typing import List, Sequence, Tuple

import numpy as np
import torch

from refpindel import dna
from refpindel.config import MAX_READ_LENGTH
from refpindel.genome import SPACER
from refpindel.ops.search_np import Lane
from refpindel.profiling import g_timer
from refpindel.reads import AnchorSet

DEAD = 127      # dead-candidate mismatch level sentinel
NEVER = -(1 << 20)   # step of the last strict mismatch: none yet

LEGACY_ROWS = 0      # reads searched by TorchLaneBackend.run since import
PLAIN_ON_CARD = 0    # _search_kernel calls on a CUDA device since import

_I32 = torch.int32


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _search_kernel(chrom, slice_start, reverse, qq, valid_w, qlen,
                   max_snp, tsec_minus, maxmm, max_allowed,
                   *, w: int, lmax: int, nl: int, mpm: int, bp_start: int):
    """Device search over a batch (see the JAX ``_search_kernel``).

    Args:
      chrom: [C] int8 padded chromosome codes.
      slice_start: [B, NL] int32 start of the contiguous tile slice.
      reverse: [B, NL] bool - tile is read right-to-left (backward lane).
      qq: [B, NL, Lmax] int8 oriented per-lane query codes.
      valid_w: [B, NL] int32 number of valid candidate offsets (<= W).
      qlen: [B] int32 query lengths.
      max_snp, tsec_minus: [B] int32 per-read budgets.
      maxmm: [MAX_READ_LENGTH] int32 budget table.
      max_allowed: [B] float32 whole-read mismatch threshold.
    Returns the packed [B, 5*Lmax + 2] int8 buffer: per length the emit
    flag, the min level, the representative's lane and (int16) offset,
    then the int16 whole-read mismatch count at the last emission.
    """
    global PLAIN_ON_CARD
    dev = chrom.device
    if dev.type == "cuda":
        PLAIN_ON_CARD += 1
    b = qq.shape[0]
    assert slice_start.shape == (b, nl), (slice_start.shape, nl)
    tile_len = w + lmax
    # jax.lax.dynamic_slice first wraps a negative start by the operand's
    # length (Python-style indexing), then clamps it so the slice stays in
    # range
    c = chrom.shape[0]
    start = slice_start.to(_I32)
    start = torch.where(start < 0, start + c, start).clamp(0, c - tile_len)
    steps = torch.arange(tile_len, dtype=_I32, device=dev)
    pos = torch.where(reverse[..., None],
                      start[..., None] + (tile_len - 1) - steps,
                      start[..., None] + steps)
    tiles = chrom.index_select(0, pos.reshape(-1)).reshape(b, nl, tile_len)
    del pos

    ms = max_snp.to(_I32)[:, None, None]
    tm = tsec_minus.to(_I32)[:, None, None]
    q0 = qq[:, :, 0:1]
    widx = torch.arange(w, dtype=_I32, device=dev)
    seeded = ((tiles[:, :, :w] == q0) & (widx < valid_w[..., None])
              & (q0 != dna.N))
    last_step = (qlen.to(_I32) - 1)[:, None, None]

    cum = torch.zeros((b, nl, w), dtype=_I32, device=dev)
    cum_at_end = torch.zeros_like(cum)
    # The JAX kernel keeps the strict mismatches of the last mpm steps in a
    # ring buffer cleared at step 0; "any set" equals "the last strict
    # mismatch at a step >= 1 lies within mpm steps".
    lastmm = torch.full_like(cum, NEVER)
    outs = {k: torch.empty((b, lmax), dtype=_I32, device=dev)
            for k in ("min_mm", "cnt1", "cntp", "rep_flat")}
    rep_strict_bad = torch.empty((b, lmax), dtype=torch.bool, device=dev)
    hi_add = (tsec_minus - max_snp).to(_I32)
    for l in range(lmax):
        if l > 0:
            # step l compares tile[w + l] vs qq[l] (the seed step counts 0)
            ref = tiles[:, :, l:l + w]
            qb = qq[:, :, l:l + 1]
            strict = ref != qb
            cum += strict ^ (qb == dna.N)     # Matches() semantics for N
            lastmm.masked_fill_(strict, l)
        cum_at_end = torch.where(last_step == l, cum, cum_at_end)
        lvl = torch.where(seeded & (cum <= tm), cum, DEAD)
        min_mm = torch.where(lvl <= ms, lvl, DEAD).amin(dim=(1, 2))
        at_min = lvl == min_mm[:, None, None]
        hi = torch.minimum(min_mm + hi_add, tsec_minus.to(_I32))
        outs["min_mm"][:, l] = min_mm
        outs["cnt1"][:, l] = at_min.sum(dim=(1, 2), dtype=_I32)
        outs["cntp"][:, l] = (lvl <= hi[:, None, None]).sum(dim=(1, 2),
                                                            dtype=_I32)
        # representative: first (lane, w) in lane-major order at min level
        # (argmax returns the first maximum; bool is refused)
        rep = torch.argmax(at_min.reshape(b, -1).to(torch.uint8), dim=1)
        outs["rep_flat"][:, l] = rep
        rep_strict_bad[:, l] = torch.gather(
            lastmm.reshape(b, -1), 1, rep[:, None])[:, 0] > l - mpm
    del tiles, seeded, cum, lastmm

    min_mm = outs["min_mm"]
    rep_flat = outs["rep_flat"]
    rep_lane = rep_flat // w
    rep_w = rep_flat % w
    lens = torch.arange(1, lmax + 1, dtype=_I32, device=dev)[None, :]
    in_range = (lens >= bp_start) & (lens <= qlen.to(_I32)[:, None] - 1)
    maxmm_l = maxmm[lens.clamp(max=MAX_READ_LENGTH - 1).long()]
    stop_here = in_range & (min_mm > maxmm_l)
    alive = torch.cumsum(stop_here.to(_I32), dim=1) == 0

    # full-read mismatch count for the representative candidate
    full_mm = torch.gather(cum_at_end.reshape(b, -1), 1, rep_flat.long())
    # direction-dependent MPM length rule: forward lanes need L > mpm,
    # backward lanes L >= mpm
    rep_reverse = torch.gather(reverse, 1, rep_lane.long())
    len_ok = torch.where(rep_reverse, lens >= mpm, lens > mpm)
    # max_allowed is float32(double(n) * double(rate)), made on the host
    whole_read_fit = full_mm.to(torch.float32) >= max_allowed[:, None]

    emit = (in_range & alive
            & (min_mm <= max_snp.to(_I32)[:, None])
            & (outs["cnt1"] == 1)
            & (lens >= bp_start + min_mm)
            & (outs["cntp"] == 1)
            & (min_mm <= maxmm_l)
            & len_ok
            & ~rep_strict_bad
            & whole_read_fit)

    return _pack(emit, min_mm, rep_lane, rep_w, full_mm)


def _pack(emit, min_mm, rep_lane, rep_w, full_mm):
    """The packed [B, 5*lmax + 2] int8 buffer of ``_search_kernel``, the
    whole-read mismatch count taken from ``full_mm`` at the last
    emission."""
    lmax = emit.shape[1]
    lidx = torch.arange(lmax, dtype=_I32, device=emit.device)[None, :]
    last_emit = torch.where(emit, lidx, -1).amax(dim=1)
    full_last = torch.gather(full_mm, 1,
                             last_emit.clamp(min=0).long()[:, None])[:, 0]
    full_last = torch.where(last_emit >= 0, full_last, 0).to(torch.int16)
    # int32 -> int16 wraps as XLA's convert does: at the 65536 window
    # bucket offsets >= 32768 come back negative (ROADMAP Queue 3)
    rep_w16 = rep_w.to(torch.int16)
    return torch.cat([
        emit.to(torch.int8),
        min_mm.to(torch.int8),
        rep_lane.to(torch.int8),
        rep_w16.contiguous().view(torch.int8),
        full_last[:, None].contiguous().view(torch.int8),
    ], dim=1)


def unpack_kernel_output(packed: np.ndarray, lmax: int):
    """Host-side split of the packed kernel buffer."""
    packed = np.asarray(packed)
    emit = packed[:, :lmax].astype(bool)
    min_mm = packed[:, lmax:2 * lmax]
    rep_lane = packed[:, 2 * lmax:3 * lmax]
    rep_w = np.ascontiguousarray(
        packed[:, 3 * lmax:5 * lmax]).view(np.int16)
    full_last = np.ascontiguousarray(
        packed[:, 5 * lmax:5 * lmax + 2]).view(np.int16)[:, 0]
    return emit, min_mm, rep_lane, rep_w, full_last


def pack_lanes(batch_lanes: List[List[Lane]], rows: int, nl: int, w: int,
               lmax: int):
    """The per-lane search's host packing of ``batch_lanes`` into ``rows``
    rows (the rest padding): every lane becomes a forward tile (a backward
    lane's slice ends at its window's end and its query is reversed).
    Returns slice_start, reverse, qq, valid_w, and the lanes' forward,
    direction-minus, strand-minus flags and chromosome names."""
    slice_start = np.zeros((rows, nl), dtype=np.int32)
    rev = np.zeros((rows, nl), dtype=bool)
    qq = np.full((rows, nl, lmax), dna.N, dtype=np.int8)
    valid_w = np.zeros((rows, nl), dtype=np.int32)
    lane_dir_minus = np.zeros((rows, nl), dtype=bool)
    lane_strand_minus = np.zeros((rows, nl), dtype=bool)
    lane_fwd = np.ones((rows, nl), dtype=bool)
    lane_chr = [[""] * nl for _ in range(rows)]
    for i, lanes in enumerate(batch_lanes):
        for j, lane in enumerate(lanes):
            lw = max(lane.end - lane.start, 0)
            n = lane.query.shape[0]
            if lane.forward:
                slice_start[i, j] = lane.start
                qq[i, j, :n] = lane.query
            else:
                slice_start[i, j] = lane.end - w - lmax
                rev[i, j] = True
                qq[i, j, :n] = lane.query[::-1]
                lane_fwd[i, j] = False
            valid_w[i, j] = min(lw, w)
            lane_dir_minus[i, j] = lane.direction == "-"
            lane_strand_minus[i, j] = lane.strand == "-"
            lane_chr[i][j] = lane.chr_name
    return (slice_start, rev, qq, valid_w, lane_fwd, lane_dir_minus,
            lane_strand_minus, lane_chr)


class TorchLaneBackend:
    """Backend with the Searcher-facing ``run`` interface on a torch device
    (counterpart of ``JaxBackend``).

    It searches the chromosome and budget table of a ``DeviceState`` that
    a ``TorchFusedBackend`` already holds, as the JAX engine's legacy
    backend shares the fused backend's chromosome buffer.  Batches above
    ``MAX_CHUNK`` reads are chunked as in the JAX engine.  The device's
    type picks the search: on a card ``_route_kernel`` (the CUDA shard
    kernel) over the whole batch, on the CPU the plain
    ``_search_kernel`` in row groups of at most ``ROW_ELEMS`` candidates
    (reads x lanes x window), which bounds its [B, NL, W] int32 state.  Rows
    are independent, so neither changes a result.
    """

    MAX_CHUNK = 8192
    ROW_ELEMS = 1 << 25
    W_BUCKETS = (512, 2048, 8192, 32768)

    def __init__(self, settings, state, chrom_name: str = None):
        self.mpm = settings.min_perfect_match_around_bp
        self.rate = settings.max_allowed_mismatch_rate
        self.state = state
        self.device = state.chrom.device
        # the Searcher sends lanes on other chromosomes to NumPy
        self.chrom_name = chrom_name

    def _bucket(self, width: int) -> int:
        for b in self.W_BUCKETS:
            if width <= b:
                return b
        return _round_up(width, 32768)

    def run(self, batch_lanes: List[List[Lane]], bp_start: int,
            max_snps: Sequence[int], tsec_minus: Sequence[int]
            ) -> List[Tuple[AnchorSet, int]]:
        global LEGACY_ROWS
        if not batch_lanes:
            return []
        if len(batch_lanes) > self.MAX_CHUNK:
            out: List[Tuple[AnchorSet, int]] = []
            for lo in range(0, len(batch_lanes), self.MAX_CHUNK):
                hi = lo + self.MAX_CHUNK
                out.extend(self.run(batch_lanes[lo:hi], bp_start,
                                    max_snps[lo:hi], tsec_minus[lo:hi]))
            return out
        t_pack = time.monotonic()
        nl = max(len(lanes) for lanes in batch_lanes)
        widths = [max((l.end - l.start) for l in lanes) if lanes else 1
                  for lanes in batch_lanes]
        w = self._bucket(max(max(widths), 1))
        qlens = [int(lanes[0].query.shape[0]) for lanes in batch_lanes]
        lmax = _round_up(max(qlens), 128)
        if w + lmax > SPACER:
            # the JAX engine asserts here (engine_jax.py:273-275): a tile
            # past the spacer would read the neighbouring chromosome
            raise NotImplementedError(
                f"window bucket {w}+{lmax} exceeds the spacer; chunked "
                "far-end search for very large -x is not implemented in "
                "the reference either (ROADMAP Queue 3)")

        b = len(batch_lanes)
        (slice_start, rev, qq, valid_w, lane_fwd, lane_dir_minus,
         lane_strand_minus, lane_chr) = pack_lanes(batch_lanes, b, nl, w,
                                                   lmax)
        qlen_a = np.array(qlens, dtype=np.int32)
        ms_a = np.array(max_snps, dtype=np.int32)
        tm_a = np.array(tsec_minus, dtype=np.int32)
        max_allowed = np.float32(
            np.array(qlens, dtype=np.float64) * np.float64(self.rate))
        t_kernel = time.monotonic()
        g_timer.add("device: pack lanes", t_kernel - t_pack)
        packed = self._search(slice_start, rev, qq, valid_w, qlen_a, ms_a,
                              tm_a, max_allowed, w=w, lmax=lmax, nl=nl,
                              bp_start=bp_start)
        LEGACY_ROWS += b
        t_decode = time.monotonic()
        g_timer.add(f"device: kernel+xfer w={w} nl={nl}",
                    t_decode - t_kernel)
        emit, min_mm, rep_lane, rep_w, full_last = unpack_kernel_output(
            packed, lmax)

        out = decode_emissions(
            emit, min_mm, rep_lane, rep_w, full_last,
            slice_start, w, lmax, lane_fwd, lane_dir_minus,
            lane_strand_minus, lane_chr)
        g_timer.add("device: decode emissions", time.monotonic() - t_decode)
        return out

    def _search(self, slice_start, rev, qq, valid_w, qlen, ms, tm,
                max_allowed, *, w: int, lmax: int, nl: int,
                bp_start: int) -> np.ndarray:
        """The device's search over a packed batch; returns the packed
        [B, 5*lmax + 2] int8 output."""
        dev = self.device
        b = qq.shape[0]
        step = max(1, self.ROW_ELEMS // (nl * w))
        kernel = _search_kernel
        parts = []
        with torch.inference_mode():
            for lo in range(0, b, step):
                hi = min(lo + step, b)

                def up(a):
                    return torch.from_numpy(
                        np.ascontiguousarray(a[lo:hi])).to(dev)

                parts.append(kernel(
                    self.state.chrom, up(slice_start), up(rev), up(qq),
                    up(valid_w), up(qlen), up(ms), up(tm), self.state.maxmm,
                    up(max_allowed), w=w, lmax=lmax, nl=nl, mpm=self.mpm,
                    bp_start=bp_start).cpu())
        return torch.cat(parts).numpy()


def decode_emissions(emit, min_mm, rep_lane, rep_w, full_last,
                     slice_start, w: int, lmax: int, lane_fwd,
                     lane_dir_minus, lane_strand_minus, lane_chr
                     ) -> List[Tuple[AnchorSet, int]]:
    """Vectorized (read, length) -> AnchorSet conversion.

    One numpy pass over all emissions; no per-anchor Python objects -
    each read gets a struct-of-arrays AnchorSet slice.  ``full_last`` is
    the whole-read mismatch count at each read's last emission ([B]).
    """
    b = emit.shape[0]
    emit = np.asarray(emit)
    flat = np.flatnonzero(emit)
    if flat.size == 0:
        return [(AnchorSet.empty(), 0) for _ in range(b)]
    rows = flat // lmax
    lcols = flat % lmax
    lengths = (lcols + 1).astype(np.int64)
    lanes_sel = np.asarray(rep_lane)[rows, lcols]
    wi = np.asarray(rep_w)[rows, lcols]
    ss = slice_start[rows, lanes_sel].astype(np.int64)
    mm = np.asarray(min_mm)[rows, lcols].astype(np.int64)
    fwd = lane_fwd[rows, lanes_sel]
    dirm = lane_dir_minus[rows, lanes_sel]
    strm = lane_strand_minus[rows, lanes_sel]
    abs_loc = np.where(
        fwd, ss + wi + lengths - 1,
        (ss + w + lmax - 1 - wi) - (lengths - 1)).astype(np.int64)

    results: List[Tuple[AnchorSet, int]] = []
    bounds = np.searchsorted(rows, np.arange(b + 1))
    cid0 = np.zeros(0, dtype=np.int8)
    for i in range(b):
        lo, hi = int(bounds[i]), int(bounds[i + 1])
        if lo == hi:
            results.append((AnchorSet.empty(), 0))
            continue
        sl = slice(lo, hi)
        lanes_i = lanes_sel[sl]
        chrs = lane_chr[i]
        if len(set(chrs)) <= 1:
            chr_names = [chrs[0]] if chrs else []
            cid = np.zeros(hi - lo, dtype=np.int8) if chrs else cid0
        else:
            chr_names = []
            lane_cid = np.empty(len(chrs), dtype=np.int8)
            for j, c in enumerate(chrs):
                if c not in chr_names:
                    chr_names.append(c)
                lane_cid[j] = chr_names.index(c)
            cid = lane_cid[lanes_i]
        results.append((AnchorSet(lengths[sl], abs_loc[sl], mm[sl],
                                  dirm[sl], strm[sl], chr_names, cid),
                        int(full_last[i])))
    return results
