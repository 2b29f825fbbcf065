"""Fused search engine in PyTorch (port of pindel_tpu/ops/engine_fused.py).

Each per-window search is two launches per read chunk, exactly as in the
JAX engine:

* ``_close_kernel`` evaluates all four attempts of the reference close
  schedule (GetCloseEnd, pindel.cpp:2531-2576) as lane groups and keeps the
  first that emits, range 0 before range 1;
* ``_far_kernel`` runs every geometric far-end round (span 64*4^k) with the
  NewUPFarIsBetter replacement rule (farend_searcher.cpp:30-44) between
  rounds.

``_far_win_kernel`` runs one both-strand far-end round over an explicit
window per read: the BreakDancer/RP evidence windows of BAM input.  The
three dispatch on the payload's device: a CUDA tensor takes the hand-written
fused kernels (``fused_cuda.pt_close``/``pt_far``/``pt_far_win``,
``csrc/fused_search.cu``: one launch a call, tiles read straight from the
chromosome, the scan and the emission rules in the block), a CPU tensor the
plain versions ``_close_kernel_ref``/``_far_kernel_ref``/
``_far_win_kernel_ref``.  The plain versions go through ``_scan_lanes`` ->
``scan_rows``, which launches the hand-written CUDA scan (``csrc/scan.cu``)
on CUDA tensors and runs its plain PyTorch version on CPU tensors.  The
device half below keeps the JAX functions' names and output contracts, so
the host half (copied from the JAX module, which imports jax at module top)
decodes the same packed words.
``TorchFusedBackend`` reaches the three launches through its dispatch
points ``_close_call``/``_far_call``/``_far_win_call``, which take the host
payload of a chunk's real rows (rounded up to ``dp``, the devices the mesh
backend splits them over); the data-parallel backend
(``parallel/mesh_fused.py``) overrides them to split the payload over
several devices.  Uniform chains are rebuilt exactly on the host; the rest
go back to the Searcher, which reruns them on the NumPy oracle
(``search.py``), except in ``run``, whose non-uniform rows and
non-canonical lanes take the legacy per-lane backend (``engine_jax.py``) on
the same device.  A backend made with a ``partner_factory`` hands the
Searcher the backends of other chromosomes (``partner``): the reads whose
evidence windows lie on one of them take ``run`` there, K4 against that
chromosome's state.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from pindel_tpu_torch import dna
from pindel_tpu_torch.config import MAX_READ_LENGTH
from pindel_tpu_torch.genome import SPACER
from pindel_tpu_torch.profiling import g_fallback, g_timer
from pindel_tpu_torch.ops import fused_cuda
from pindel_tpu_torch.ops.engine_jax import TorchLaneBackend
from pindel_tpu_torch.ops.scan import dead_level, key_shift, scan_rows

_I32 = torch.int32

FAR_WIN_ROWS = 0     # reads searched by _far_win_kernel since import


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# ------------------------------------------------------------ device half
def _chrom_cat(chrom):
    """[CL] int8 chromosome -> [2*NR, 128]: 128-padded rows of the
    chromosome followed by the rows of its reverse, so a lane's tile
    (forward or flipped) is a contiguous row-take."""
    cl = chrom.shape[0]
    clpad = _round_up(cl, 128)
    fwd = torch.cat([chrom, torch.full((clpad - cl,), dna.N,
                                       dtype=torch.int8,
                                       device=chrom.device)])
    return torch.cat([fwd.reshape(-1, 128),
                      torch.flip(fwd, (0,)).reshape(-1, 128)])


def _scan_lanes(chrom, slice_start, reverse, qq, valid_w, qlen,
                max_snp, tsec_minus, thr, *, w: int, lmax: int,
                g: int, nlg: int, mpm: int, lsteps: int = 0):
    """Dense length scan over candidate lanes with per-group statistics
    (see the JAX ``_scan_lanes``).

    Shapes: slice_start/reverse/valid_w [B, NL]; qq [B, NL, lmax] with
    NL = g * nlg; qlen/max_snp/tsec_minus/thr [B] int32.  Returns
    (min_mm, lvl2, rep_key, rep_strict_bad, fit_ok), each [B, G, lmax];
    on equal levels the earlier lane of a group wins (lane-major order).
    """
    nl = g * nlg
    tile_len = w + lmax
    b = qq.shape[0]
    rows = b * nl
    nrows2 = chrom.shape[0]
    clpad = (nrows2 // 2) * 128
    nr = _round_up(tile_len, 128) // 128 + 1
    tpad = nr * 128
    start_log = torch.where(reverse, clpad - slice_start - tile_len,
                            slice_start)
    arow = start_log // 128 + reverse.to(_I32) * (nrows2 // 2)
    off = start_log % 128
    row_idx = arow[..., None] + torch.arange(nr, dtype=_I32,
                                             device=chrom.device)
    # jnp.take(mode="clip") clamps the row index into range
    row_idx = row_idx.reshape(-1).clamp(0, nrows2 - 1)
    tiles = chrom.index_select(0, row_idx).reshape(rows, tpad)

    kmin, k2 = scan_rows(
        tiles, qq.reshape(rows, lmax).contiguous(),
        valid_w.reshape(rows).contiguous(),
        torch.repeat_interleave(qlen, nl), torch.repeat_interleave(thr, nl),
        off.reshape(rows).contiguous(),
        w=w, lmax=lmax, mpm=mpm, lsteps=lsteps or lmax)
    kmin = kmin.reshape(b, g, nlg, lmax)
    k2 = k2.reshape(b, g, nlg, lmax)

    shift = key_shift(w)
    if nlg == 1:
        kmin_g = kmin[:, :, 0]
        lvl2 = k2[:, :, 0] >> shift
    else:
        # lane-major merge within each group: candidates of lane j rank
        # after equal-level candidates of lane i<j (PD exploration order)
        lvl_l = kmin >> shift
        kmin_g = kmin[:, :, 0]
        lvl2_g = k2[:, :, 0] >> shift
        lane_of = torch.zeros(kmin_g.shape, dtype=_I32, device=kmin.device)
        for j in range(1, nlg):
            lj = lvl_l[:, :, j]
            better = lj < (kmin_g >> shift)
            lvl2_g = torch.where(better,
                                 torch.minimum(k2[:, :, j] >> shift,
                                               kmin_g >> shift),
                                 torch.minimum(lvl2_g, lj))
            lane_of = torch.where(better, j, lane_of)
            kmin_g = torch.where(better, kmin[:, :, j], kmin_g)
        lvl2 = lvl2_g
    min_mm = kmin_g >> shift
    rep_w = (kmin_g >> 2) & ((1 << (shift - 2)) - 1)
    rep_key = rep_w if nlg == 1 else lane_of * w + rep_w
    rep_strict_bad = (kmin_g & 2) == 2
    fit_ok = (kmin_g & 1) == 0
    return min_mm, lvl2, rep_key, rep_strict_bad, fit_ok


def _emit_rules(min_mm, lvl2, rep_key, rep_strict_bad, fit_ok,
                reverse, qlen, max_snp, tsec_minus, maxmm,
                *, w: int, lmax: int, g: int, nlg: int, mpm: int,
                bp_start: int):
    """Per-(group, length) emission decision (CheckLeft/Right_Close +
    CheckBoth + CheckMismatches); returns emit [B,G,L] and the chain
    summary (rep at the last emission, uniformity, any emission, index of
    the last emission)."""
    dev = min_mm.device
    dead = dead_level(lmax)
    lens = torch.arange(1, lmax + 1, dtype=_I32, device=dev)[None, None, :]
    in_range = (lens >= bp_start) & (lens <= qlen[:, None, None] - 1)
    maxmm_l = maxmm[lens.clamp(max=MAX_READ_LENGTH - 1).long()]
    min_live = torch.where(min_mm >= dead, 10 ** 6, min_mm)
    stop_here = in_range & (min_live > maxmm_l)
    alive = torch.cumsum(stop_here.to(_I32), dim=2) == 0

    g_dim = min_mm.shape[1]
    if nlg == 1:
        rev_rep = reverse.reshape(reverse.shape[0], g_dim, 1)
    else:
        rep_lane_rel = rep_key // w
        rev_g = reverse.reshape(reverse.shape[0], g_dim, 1, nlg)
        onehot = rep_lane_rel[..., None] == torch.arange(
            nlg, dtype=_I32, device=dev)
        rev_rep = torch.any(onehot & rev_g, dim=-1)
    len_ok = torch.where(rev_rep, lens >= mpm, lens > mpm)

    # "exactly one candidate at the min level, none within min+additional
    # levels" (searcher.cpp:171-192) == runner-up beyond min(min+add, tsec)
    hi = torch.minimum(min_live + (tsec_minus - max_snp)[:, None, None],
                       tsec_minus[:, None, None])
    unique_ok = lvl2 > hi

    emit = (in_range & alive
            & (min_live <= max_snp[:, None, None])
            & (lens >= bp_start + min_live)
            & unique_ok
            & (min_live <= maxmm_l)
            & len_ok
            & ~rep_strict_bad
            & fit_ok)

    lidx = torch.arange(lmax, dtype=_I32, device=dev)[None, None, :]
    last = torch.where(emit, lidx, -1).amax(dim=2)                # [B,G]
    any_emit = last >= 0
    rep_last = torch.gather(rep_key, 2,
                            last.clamp(min=0)[:, :, None].long())[:, :, 0]
    uniform = torch.all(~emit | (rep_key == rep_last[:, :, None]), dim=2)
    return emit, rep_last, uniform, any_emit, last


def _pack_words(emit):
    """[..., L] bool -> [..., L/32] int32 (little-endian within a word).
    Packed in int64 and wrapped into int32 (torch has no uint32 shifts)."""
    shp = emit.shape
    e = emit.reshape(shp[:-1] + (shp[-1] // 32, 32)).to(torch.int64)
    bits = torch.arange(32, dtype=torch.int64, device=emit.device)
    words = (e << bits).sum(dim=-1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(_I32)


def _complement(codes):
    """Base complement 3-c for ACGT; N stays N."""
    c = codes.to(_I32)
    return torch.where(c == dna.N, c, 3 - c).to(torch.int8)


def _reverse_codes_np(codes: np.ndarray, qlen: np.ndarray) -> np.ndarray:
    """Reverse each row within its qlen (padding stays N at the tail)."""
    b, lmax = codes.shape
    li = np.arange(lmax)[None, :]
    valid = li < qlen[:, None]
    idx = np.where(valid, np.maximum(qlen[:, None] - 1 - li, 0), li)
    out = np.take_along_axis(codes, idx, axis=1)
    return np.where(valid, out, np.int8(dna.N)).astype(np.int8)


def _pack_payload(codes: np.ndarray, meta32: np.ndarray) -> np.ndarray:
    """[b, lmax] int8 codes + [b, K] int32 meta -> [b, lmax//2+4K] int8."""
    a = codes.astype(np.uint8)
    packed = (a[:, 0::2] | (a[:, 1::2] << 4)).view(np.int8)
    return np.concatenate([packed, meta32.astype("<i4").view(np.int8)
                           .reshape(codes.shape[0], -1)], axis=1)


def _unpack_payload(payload, lmax: int, nmeta: int):
    """Device-side inverse of the packer -> (codes [b,lmax] int8,
    meta [b,nmeta] int32).  Meta bytes are little-endian int32, as the
    native packer writes them."""
    b = payload.shape[0]
    p32 = payload[:, :lmax // 2].to(_I32)
    codes = torch.stack([p32 & 15, (p32 >> 4) & 15], dim=-1) \
        .reshape(b, lmax).to(torch.int8)
    meta = payload[:, lmax // 2:].contiguous().view(_I32)
    assert meta.shape == (b, nmeta), (meta.shape, nmeta)
    return codes, meta


# ------------------------------------------------------------ close kernel
# close meta words: [0] anchor pos; [1] insert_size | qlen<<17;
# [2] ms | tm<<8 | thr<<16 | minus<<26
CM_WORDS = 3


def _close_meta(pos, isz, qlen, ms, tm, thr, minus) -> np.ndarray:
    m = np.zeros((pos.shape[0], CM_WORDS), np.int32)
    m[:, 0] = pos
    m[:, 1] = isz | (qlen.astype(np.int64) << 17)
    m[:, 2] = (ms | (tm.astype(np.int64) << 8)
               | (thr.astype(np.int64) << 16)
               | (minus.astype(np.int64) << 26))
    return m


def _close_kernel(chrom, payload, maxmm, **static):
    """K2 on the payload's device: ``fused_cuda.pt_close`` on a card, the
    plain ``_close_kernel_ref`` on the CPU; any other device raises."""
    kind = payload.device.type
    if kind == "cpu":
        return _close_kernel_ref(chrom, payload, maxmm, **static)
    if kind == "cuda":
        from pindel_tpu_torch.ops import fused_cuda
        return fused_cuda.pt_close(chrom, payload, maxmm, **static)
    raise ValueError(f"_close_kernel: no kernel for device {payload.device}")


def _close_kernel_ref(chrom, payload, maxmm,
                      *, w0: int, w1: int, lmax: int, mpm: int,
                      bp_start: int, lsteps: int, with_r1: bool):
    """All four close-end attempts in one launch (see the JAX
    ``_close_kernel``): '+' reads query [RC(f), f, f, RC(f)], '-' reads
    [R(f), C(f), C(f), R(f)] over range 0 then range 1; the first emitting
    attempt wins.  payload [B, lmax + 4*CM_WORDS] int8 holds the 4-bit
    codes of the read and of its host-reversed copy.  Output [B, lmax//32
    + 2] int32: emission words, representative, winner | uniform << 8."""
    codes2, meta = _unpack_payload(payload, 2 * lmax, CM_WORDS)
    pos = meta[:, 0]
    isz = meta[:, 1] & 0x1ffff
    qlen = meta[:, 1] >> 17
    ms = meta[:, 2] & 0xff
    tm = (meta[:, 2] >> 8) & 0xff
    thr = (meta[:, 2] >> 16) & 0x3ff
    minus = ((meta[:, 2] >> 26) & 1).to(torch.bool)
    f = codes2[:, :lmax]
    rf = codes2[:, lmax:]          # reverse-within-qlen, host-computed
    cf = _complement(f)
    rcf = _complement(rf)          # reverse and complement commute
    mm_col = minus[:, None]
    q_orig = torch.where(mm_col, rf, rcf)   # attempt with original sequence
    q_flip = torch.where(mm_col, cf, f)     # attempt with RC'd sequence

    def one_range(k, w, qa, qb):
        # attempt windows (close_end_lane geometry, pindel.cpp:2271-2316)
        plus_start = pos + SPACER - k * isz
        minus_end = pos + SPACER + k * isz
        start = torch.where(minus, minus_end - (2 * k + 1) * isz, plus_start)
        end = torch.where(minus, minus_end, plus_start + (2 * k + 1) * isz)
        ss = torch.where(minus, end - (w + lmax), start)
        valid = (end - start).clamp(0, w)
        qq = torch.stack([qa, qb], dim=1)                         # [B,2,L]
        slice_start = torch.stack([ss, ss], dim=1)
        reverse = torch.stack([minus, minus], dim=1)
        valid_w = torch.stack([valid, valid], dim=1)
        stats = _scan_lanes(chrom, slice_start, reverse, qq, valid_w,
                            qlen, ms, tm, thr,
                            w=w, lmax=lmax, g=2, nlg=1, mpm=mpm,
                            lsteps=lsteps)
        emit, rep_last, uniform, any_emit, _last = _emit_rules(
            *stats, reverse, qlen, ms, tm, maxmm,
            w=w, lmax=lmax, g=2, nlg=1, mpm=mpm, bp_start=bp_start)
        # first hit: argmax returns the first maximum (bool is refused)
        winner = torch.argmax(any_emit.to(_I32), dim=1).to(_I32)
        has = torch.any(any_emit, dim=1)
        wl = winner.long()
        emit_w = torch.gather(
            emit, 1, wl[:, None, None].expand(-1, 1, lmax))[:, 0]
        rep_w = torch.gather(rep_last, 1, wl[:, None])[:, 0]
        uni_w = torch.gather(uniform, 1, wl[:, None])[:, 0]
        return has, winner, emit_w, rep_w, uni_w

    has0, win0, emit0, rep0, uni0 = one_range(0, w0, q_orig, q_flip)
    if with_r1:
        has1, win1, emit1, rep1, uni1 = one_range(1, w1, q_flip, q_orig)
        use1 = ~has0
        emit = torch.where(use1[:, None], emit1, emit0)
        rep = torch.where(use1, rep1, rep0)
        uni = torch.where(use1, uni1, uni0)
        winner = torch.where(has0, win0,
                             torch.where(has1, win1 + 2, 255))
    else:
        emit, rep, uni = emit0, rep0, uni0
        winner = torch.where(has0, win0, 255)
    words = _pack_words(emit)
    flags = winner | (uni.to(_I32) << 8)
    return torch.cat([words, rep[:, None].to(_I32), flags[:, None]], dim=1)


# -------------------------------------------------------------- far kernel
# far meta words: [0] close-end center; [1] qlen | close_max<<10 |
# init_max<<20; [2] ms | tm<<8 | thr<<16; [3] padded chromosome size
FM_WORDS = 4


def _far_meta(center, qlen, close_max, init_max, ms, tm, thr,
              comp_size: int) -> np.ndarray:
    m = np.zeros((center.shape[0], FM_WORDS), np.int32)
    m[:, 0] = center
    m[:, 1] = (qlen.astype(np.int64) | (close_max.astype(np.int64) << 10)
               | (init_max.astype(np.int64) << 20))
    m[:, 2] = (ms | (tm.astype(np.int64) << 8)
               | (thr.astype(np.int64) << 16))
    m[:, 3] = comp_size
    return m


def _far_kernel(chrom, payload, maxmm, **static):
    """K3 on the payload's device: ``fused_cuda.pt_far`` on a card, the
    plain ``_far_kernel_ref`` on the CPU; any other device raises."""
    kind = payload.device.type
    if kind == "cpu":
        return _far_kernel_ref(chrom, payload, maxmm, **static)
    if kind == "cuda":
        from pindel_tpu_torch.ops import fused_cuda
        return fused_cuda.pt_far(chrom, payload, maxmm, **static)
    raise ValueError(f"_far_kernel: no kernel for device {payload.device}")


def _far_kernel_ref(chrom, payload, maxmm,
                    *, spans: Tuple[int, ...], ws: Tuple[int, ...],
                    lmax: int, mpm: int, bp_start: int, lsteps: int = 0):
    """All geometric far-end rounds in one launch (see the JAX
    ``_far_kernel``): lane 0 a forward tile with the current sequence,
    lane 1 a backward tile with its complement.  A read is searched in a
    round while close_max + far_max < qlen; a round replaces the current
    result when new_max >= far_max.  Output [B, lmax//32 + 2] int32:
    emission words, rep, round | replaced << 8 | uniform << 9."""
    codes, meta = _unpack_payload(payload, lmax, FM_WORDS)
    b = codes.shape[0]
    dev = codes.device
    center = meta[:, 0]
    qlen = meta[:, 1] & 0x3ff
    close_max = (meta[:, 1] >> 10) & 0x3ff
    ms = meta[:, 2] & 0xff
    tm = (meta[:, 2] >> 8) & 0xff
    thr = (meta[:, 2] >> 16) & 0x3ff
    comp_size = meta[:, 3]
    q0 = codes                            # forward lane: current sequence
    q1 = _complement(codes)               # backward lane: R(RC(cur)) = C(cur)

    st_emit = torch.zeros((b, lmax), dtype=torch.bool, device=dev)
    st_rep = torch.zeros((b,), dtype=_I32, device=dev)
    st_uni = torch.ones((b,), dtype=torch.bool, device=dev)
    st_max = (meta[:, 1] >> 20) & 0x3ff
    st_round = torch.full((b,), 255, dtype=_I32, device=dev)
    st_replaced = torch.zeros((b,), dtype=torch.bool, device=dev)
    fwd_bwd = torch.tensor([False, True], device=dev)[None, :].expand(b, 2)

    for r, (span, wb) in enumerate(zip(spans, ws)):
        # window geometry: search.py search_far_ends
        start = torch.where(center > span + SPACER, center - span, SPACER)
        end = torch.maximum(torch.minimum(center + span,
                                          comp_size - SPACER), start)
        qq = torch.stack([q0, q1], dim=1)
        slice_start = torch.stack([start, end - (wb + lmax)], dim=1)
        valid = (end - start).clamp(0, wb)
        valid_w = torch.stack([valid, valid], dim=1)
        stats = _scan_lanes(chrom, slice_start, fwd_bwd, qq, valid_w,
                            qlen, ms, tm, thr,
                            w=wb, lmax=lmax, g=1, nlg=2, mpm=mpm,
                            lsteps=lsteps)
        emit, rep_last, uniform, any_emit, last = _emit_rules(
            *stats, fwd_bwd, qlen, ms, tm, maxmm,
            w=wb, lmax=lmax, g=1, nlg=2, mpm=mpm, bp_start=bp_start)
        emit = emit[:, 0]
        rep_last = rep_last[:, 0]
        uniform = uniform[:, 0]
        new_max = torch.where(any_emit[:, 0], last[:, 0] + 1, 0)

        active = close_max + st_max < qlen
        replace = active & (new_max >= st_max)
        st_emit = torch.where(replace[:, None], emit, st_emit)
        st_rep = torch.where(replace, rep_last, st_rep)
        st_uni = torch.where(replace, uniform, st_uni)
        st_max = torch.where(replace, new_max, st_max)
        st_round = torch.where(replace, r, st_round)
        st_replaced = st_replaced | replace

    words = _pack_words(st_emit)
    flags = (st_round | (st_replaced.to(_I32) << 8)
             | (st_uni.to(_I32) << 9))
    return torch.cat([words, st_rep[:, None], flags[:, None]], dim=1)


# ------------------------------------------------- explicit-window kernel
# meta words for _far_win_kernel: [0] window start; [1] window end;
# [2] qlen; [3] ms | tm<<8 | thr<<16
FW_WORDS = 4


def _far_win_kernel(chrom, payload, maxmm, **static):
    """K4 on the payload's device: ``fused_cuda.pt_far_win`` on a card, the
    plain ``_far_win_kernel_ref`` on the CPU; any other device raises."""
    kind = payload.device.type
    if kind == "cpu":
        return _far_win_kernel_ref(chrom, payload, maxmm, **static)
    if kind == "cuda":
        from pindel_tpu_torch.ops import fused_cuda
        return fused_cuda.pt_far_win(chrom, payload, maxmm, **static)
    raise ValueError(f"_far_win_kernel: no kernel for device "
                     f"{payload.device}")


def _far_win_kernel_ref(chrom, payload, maxmm,
                        *, w: int, lmax: int, mpm: int, bp_start: int,
                        lsteps: int = 0):
    """One both-strand far-end round over explicit per-read windows (see
    the JAX ``_far_win_kernel``): the BreakDancer/RP evidence-window path
    for the single-window case, with the lanes and emission rules of one
    ``_far_kernel`` round.  Replacement against earlier results happens on
    the host (``_far_round`` in search.py).  Output [B, lmax//32 + 2]
    int32: emission words, rep, any_emit | uniform << 1."""
    codes, meta = _unpack_payload(payload, lmax, FW_WORDS)
    b = codes.shape[0]
    start = meta[:, 0]
    end = meta[:, 1]
    qlen = meta[:, 2]
    ms = meta[:, 3] & 0xff
    tm = (meta[:, 3] >> 8) & 0xff
    thr = (meta[:, 3] >> 16) & 0x3ff
    qq = torch.stack([codes, _complement(codes)], dim=1)
    slice_start = torch.stack([start, end - (w + lmax)], dim=1)
    reverse = torch.tensor([False, True],
                           device=codes.device)[None, :].expand(b, 2)
    valid = (end - start).clamp(0, w)
    valid_w = torch.stack([valid, valid], dim=1)
    stats = _scan_lanes(chrom, slice_start, reverse, qq, valid_w,
                        qlen, ms, tm, thr,
                        w=w, lmax=lmax, g=1, nlg=2, mpm=mpm, lsteps=lsteps)
    emit, rep_last, uniform, any_emit, _last = _emit_rules(
        *stats, reverse, qlen, ms, tm, maxmm,
        w=w, lmax=lmax, g=1, nlg=2, mpm=mpm, bp_start=bp_start)
    words = _pack_words(emit[:, 0])
    flags = any_emit[:, 0].to(_I32) | (uniform[:, 0].to(_I32) << 1)
    return torch.cat([words, rep_last[:, 0:1], flags[:, None]], dim=1)


# --------------------------------------------------------------- host side
_PACKLIB = None


def _packer():
    global _PACKLIB
    if _PACKLIB is None:
        import ctypes

        from pindel_tpu_torch import native
        lib = native.load("ptpack", ["packer.cpp"], link=())
        for fn in ("pt_pack_close", "pt_pack_far"):
            getattr(lib, fn).argtypes = [
                ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_void_p]
        lib.pt_codes.argtypes = [
            ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
        lib.pt_pack_close_at.argtypes = [
            ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
        lib.pt_codes_at.argtypes = [
            ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p]
        _PACKLIB = lib
    return _PACKLIB


def _seq_blob(reads, nb: int):
    """(concatenated latin-1 sequence bytes, int64 offsets[nb+1])."""
    blob = "".join(r.seq for r in reads).encode("latin-1")
    offs = np.zeros(nb + 1, np.int64)
    np.cumsum(np.fromiter((len(r.seq) for r in reads), np.int64, nb),
              out=offs[1:])
    return blob, offs


def _ptr(a: np.ndarray):
    import ctypes
    return ctypes.c_void_p(a.ctypes.data)


def _native_pack_close(blob: bytes, offs: np.ndarray, nb: int, b: int,
                       lmax: int, meta32: np.ndarray) -> np.ndarray:
    out = np.empty((b, lmax + 4 * meta32.shape[1]), np.int8)
    m = np.ascontiguousarray(meta32.astype("<i4"))
    _packer().pt_pack_close(blob, _ptr(offs), nb, b, lmax, _ptr(m),
                            m.shape[1], _ptr(out))
    return out


def _native_pack_far(blob: bytes, offs: np.ndarray, nb: int, b: int,
                     lmax: int, meta32: np.ndarray) -> np.ndarray:
    out = np.empty((b, lmax // 2 + 4 * meta32.shape[1]), np.int8)
    m = np.ascontiguousarray(meta32.astype("<i4"))
    _packer().pt_pack_far(blob, _ptr(offs), nb, b, lmax, _ptr(m),
                          m.shape[1], _ptr(out))
    return out


def _native_codes(blob: bytes, offs: np.ndarray, nb: int, b: int,
                  lmax: int) -> np.ndarray:
    out = np.empty((b, lmax), np.int8)
    _packer().pt_codes(blob, _ptr(offs), nb, b, lmax, _ptr(out))
    return out


def _native_pack_close_at(blob: bytes, off: np.ndarray, ln: np.ndarray,
                          nb: int, b: int, lmax: int,
                          meta32: np.ndarray) -> np.ndarray:
    """pt_pack_close over per-read (offset, length) pairs (lazy
    ReadBatch path)."""
    out = np.empty((b, lmax + 4 * meta32.shape[1]), np.int8)
    m = np.ascontiguousarray(meta32.astype("<i4"))
    _packer().pt_pack_close_at(blob, _ptr(off), _ptr(ln), nb, b, lmax,
                               _ptr(m), m.shape[1], _ptr(out))
    return out


def _native_codes_at(blob: bytes, off: np.ndarray, ln: np.ndarray,
                     nb: int, b: int, lmax: int) -> np.ndarray:
    out = np.empty((b, lmax), np.int8)
    _packer().pt_codes_at(blob, _ptr(off), _ptr(ln), nb, b, lmax,
                          _ptr(out))
    return out


def unpack_words(words: np.ndarray, lmax: int) -> np.ndarray:
    """[..., L/32] int32 -> [..., L] bool (inverse of _pack_words)."""
    u = np.asarray(words).view(np.uint32)
    bits = (u[..., :, None] >> np.arange(32, dtype=np.uint32)) & 1
    return bits.reshape(*words.shape[:-1], -1)[..., :lmax].astype(bool)


@dataclasses.dataclass
class ChainDecode:
    """One read's reconstructed anchor chain (all points share one
    representative candidate; lengths come from the emission bitmask)."""

    lengths: np.ndarray        # int64 [n]
    abs_loc: np.ndarray        # int64 [n]
    mm: np.ndarray             # int64 [n]
    full_mm: int               # whole-read mismatches of the chain


def decode_chains(chrom_codes: np.ndarray, emit: np.ndarray,
                  w_off: np.ndarray, slice_start: np.ndarray,
                  tile_reverse: np.ndarray, queries: np.ndarray,
                  qlen: np.ndarray, wbuck: np.ndarray, lmax: int
                  ) -> List[Optional[ChainDecode]]:
    """Vectorized reconstruction of uniform chains (see the JAX module):
    positions from the lane geometry, mismatch counts from a recount
    against the chromosome with the device's rule (seed step counts 0;
    Matches() semantics for N)."""
    n = emit.shape[0]
    out: List[Optional[ChainDecode]] = [None] * n
    idx = np.flatnonzero(emit.any(axis=1))
    if idx.size == 0:
        return out
    woff = w_off[idx].astype(np.int64)
    ss = slice_start[idx].astype(np.int64)
    rev = tile_reverse[idx]
    wb = wbuck[idx].astype(np.int64)
    ql = qlen[idx].astype(np.int64)
    tlen = wb + lmax

    # ref row step l: tile[w_off + l]; tile = chrom[ss:ss+tlen], flipped
    # when the lane is a backward lane
    l = np.arange(lmax, dtype=np.int64)[None, :]
    pos = np.where(rev[:, None],
                   ss[:, None] + tlen[:, None] - 1 - (woff[:, None] + l),
                   ss[:, None] + woff[:, None] + l)
    ref = chrom_codes[np.clip(pos, 0, chrom_codes.shape[0] - 1)]
    q = queries[idx]
    step_mm = ~dna.matches(q, ref)
    step_mm[:, 0] = False                                   # seed step
    step_mm &= l < ql[:, None]
    cum = np.cumsum(step_mm, axis=1, dtype=np.int32)
    full = cum[np.arange(idx.size), np.maximum(ql - 1, 0)]

    # split the emitted (row, length) pairs per read in one pass
    rows, cols = np.nonzero(emit[idx])
    lens_all = cols + 1
    mm_all = cum[rows, cols]
    # forward: ss+woff + (ll-1); backward: ss+tlen - woff - ll
    loc_base = np.where(rev, ss + tlen - woff, ss + woff)   # per read
    loc_all = np.where(rev[rows],
                       loc_base[rows] - lens_all,
                       loc_base[rows] + lens_all - 1)
    bounds = np.searchsorted(rows, np.arange(idx.size + 1))
    fulli = full.tolist()
    for k, i in enumerate(idx):
        sl = slice(bounds[k], bounds[k + 1])
        out[i] = ChainDecode(
            lengths=lens_all[sl],
            abs_loc=loc_all[sl],
            mm=mm_all[sl],
            full_mm=fulli[k])
    return out


@dataclasses.dataclass
class DeviceState:
    """What the search keeps on the device: the encoded chromosome (int8,
    spacer-padded; the legacy per-lane search slices its tiles from it),
    its [2*NR, 128] forward-and-reverse layout for the fused kernels' tile
    row-takes, and the per-length mismatch budget table."""

    chrom: torch.Tensor
    chromcat: torch.Tensor
    maxmm: torch.Tensor


def device_state_from_numpy(chrom_codes: np.ndarray, maxmm: np.ndarray,
                            device) -> DeviceState:
    """Counterpart of FusedJaxBackend.__init__'s uploads: one chromosome
    copy goes up, the aligned layout is built on the device."""
    device = torch.device(device)
    # a writable contiguous int8 copy only where the input is not one
    chrom = torch.from_numpy(np.require(chrom_codes, np.int8, ["C", "W"]))
    maxmm_t = torch.from_numpy(np.require(maxmm, np.int32, ["C", "W"]))
    fused_cuda.count_upload(chrom.nbytes + maxmm_t.nbytes)
    chrom, maxmm_t = chrom.to(device), maxmm_t.to(device)
    return DeviceState(chrom, _chrom_cat(chrom), maxmm_t)


class _Download:
    """A kernel output on its way to host memory: a non-blocking copy
    into pinned memory plus an event; ``get`` waits for the event before
    NumPy reads the buffer."""

    def __init__(self, dev: torch.Tensor):
        if dev.device.type == "cuda":
            self._host = torch.empty(dev.shape, dtype=dev.dtype,
                                     pin_memory=True)
            # the copy and the event on the stream of the tensor's device,
            # which need not be the current device (the mesh backend)
            with torch.cuda.device(dev.device):
                self._host.copy_(dev, non_blocking=True)
                self._event = torch.cuda.Event()
                self._event.record()
        else:
            self._host = dev
            self._event = None

    def get(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()


def canonical_lanes(lanes, chrom_name: str) -> bool:
    """Whether one read's far-end ``lanes`` take ``_far_win_kernel`` on
    ``chrom_name``: one (forward, backward) lane pair over a single window
    of that chromosome (``far_end_lanes`` in search.py over one region),
    with a query the payload's 10-bit threshold field holds."""
    return (len(lanes) == 2 and lanes[0].forward and not lanes[1].forward
            and lanes[0].chr_name == chrom_name
            and lanes[1].chr_name == chrom_name
            and lanes[0].start == lanes[1].start
            and lanes[0].end == lanes[1].end
            and lanes[0].query.shape[0] <= 0x3ff)


class TorchFusedBackend:
    """Per-chromosome fused search backend on a torch device.

    The Searcher probes its method set by duck typing (search.py):
    ``close_ends_dispatch_lazy``/``close_ends_dispatch`` start one
    ``_close_kernel`` launch per chunk, ``close_ends_decode_stream`` yields
    decoded chunks as their results land, ``far_ends_dispatch``/
    ``far_ends_decode`` do the same for ``_far_kernel``.  Device work stays
    on the calling thread; the ``-T`` pool decodes with NumPy only.
    """

    # chunking as in the JAX engine; results do not depend on it.  The
    # launches take a chunk's real rows, rounded up to ``dp``
    CHUNK = 32768
    LEAD = 8192
    dp = 1      # devices a launch's rows are split over

    def __init__(self, settings, maxmm: np.ndarray, chrom_codes: np.ndarray,
                 chrom_name: str = None, device="cuda",
                 partner_factory=None):
        self.settings = settings
        self.mpm = settings.min_perfect_match_around_bp
        self.rate = settings.max_allowed_mismatch_rate
        self.maxmm = np.asarray(maxmm, dtype=np.int32)
        self.chrom_codes = np.asarray(chrom_codes)
        self.chrom_name = chrom_name
        self.device = torch.device(device)
        self.state = device_state_from_numpy(self.chrom_codes, self.maxmm,
                                             self.device)
        # the legacy per-lane backend searches the same device buffers
        self._legacy = TorchLaneBackend(settings, self.state, chrom_name)
        self._pool = None
        self._pool_tried = False
        # chrom -> the backend of another chromosome (``partner``)
        self.partner_factory = partner_factory
        self._partners = {}

    def partner(self, chrom, lanes) -> Optional["TorchFusedBackend"]:
        """The backend of ``chrom``, another chromosome than this one's, for
        a read whose far-end ``lanes`` lie on it in ``run``'s canonical
        shape: made by ``partner_factory`` at the first such read and kept
        until this backend is freed, so a region uploads each chromosome
        its evidence windows reach once.  None without a factory or for
        another shape (the Searcher then takes the NumPy oracle)."""
        if self.partner_factory is None or not canonical_lanes(
                lanes, chrom.name):
            return None
        backend = self._partners.get(chrom.name)
        if backend is None:
            backend = self._partners[chrom.name] = self.partner_factory(chrom)
        return backend

    def _decode_pool(self):
        """Worker pool for host-side chain decode (gated on -T>1): the
        decode of one chunk overlaps the device wait of the next."""
        if not self._pool_tried:
            self._pool_tried = True
            from pindel_tpu_torch.events.detect import get_num_threads
            if get_num_threads() > 1:
                from concurrent.futures import ThreadPoolExecutor
                self._pool = ThreadPoolExecutor(max_workers=1)
        return self._pool

    def run(self, batch_lanes, bp_start, max_snps, tsec_minus):
        """The legacy per-lane API (BreakDancer/RP evidence windows; on a
        ``partner`` backend, another region's reads whose windows lie on
        this chromosome).  The canonical evidence-window shape
        (``canonical_lanes``) takes ``_far_win_kernel``; anything else
        (multi-window clusters, windows too wide for the spacer,
        non-uniform chains) takes the legacy per-lane backend on the same
        device."""
        global FAR_WIN_ROWS
        n = len(batch_lanes)
        if n == 0:
            return []
        if not all(canonical_lanes(lanes, self.chrom_name)
                   for lanes in batch_lanes):
            return self._legacy.run(batch_lanes, bp_start, max_snps,
                                    tsec_minus)
        if n > self.CHUNK:
            out = []
            for lo in range(0, n, self.CHUNK):
                hi = lo + self.CHUNK
                out.extend(self.run(batch_lanes[lo:hi], bp_start,
                                    max_snps[lo:hi], tsec_minus[lo:hi]))
            return out
        with g_timer.phase("fused: pack bdwin"):
            b = self._rows(n)
            qlen = np.zeros(b, np.int32)
            qlen[:n] = [lanes[0].query.shape[0] for lanes in batch_lanes]
            qlen[n:] = 1
            lmax = _round_up(max(int(qlen.max()), 8), 128)
            codes = np.full((b, lmax), dna.N, np.int8)
            start = np.zeros(b, np.int64)
            end = np.zeros(b, np.int64)
            for i, lanes in enumerate(batch_lanes):
                q = lanes[0].query
                codes[i, :q.shape[0]] = q
                start[i] = lanes[0].start
                end[i] = lanes[0].end
            w = self._w_bucket(max(int((end - start).max()), 1))
            fits = w + lmax <= SPACER
            if fits:
                ms = np.zeros(b, np.int32)
                ms[:n] = max_snps
                tm = np.zeros(b, np.int32)
                tm[:n] = tsec_minus
                thr = np.zeros(b, np.int32)
                thr[:n] = np.ceil(np.float32(
                    qlen[:n].astype(np.float64) * np.float64(self.rate))
                ).astype(np.int32)
                meta = np.zeros((b, FW_WORDS), np.int32)
                meta[:, 0] = start
                meta[:, 1] = end
                meta[:, 2] = qlen
                meta[:, 3] = (ms | (tm.astype(np.int64) << 8)
                              | (thr.astype(np.int64) << 16))
                payload = _pack_payload(codes, meta)
                lsteps = _round_up(int(qlen[:n].max()), 16)
        if not fits:
            return self._legacy.run(batch_lanes, bp_start, max_snps,
                                    tsec_minus)
        with g_timer.phase("fused: bdwin wait"):
            outarr = self._far_win_call(
                payload, w=w, lmax=lmax, mpm=self.mpm, bp_start=bp_start,
                lsteps=lsteps).get()
        FAR_WIN_ROWS += n
        with g_timer.phase("fused: decode bdwin"):
            nw = lmax // 32
            emit = unpack_words(outarr[:n, :nw], lmax)
            rep = outarr[:n, nw].astype(np.int64)
            flags = outarr[:n, nw + 1]
            any_emit = (flags & 1).astype(bool)
            uni = ((flags >> 1) & 1).astype(bool)
            lane = rep // w
            w_off = rep % w
            ss = np.where(lane == 1, end[:n] - (w + lmax), start[:n])
            q_dev = np.where((lane == 1)[:, None], dna.RC[codes[:n]],
                             codes[:n]).astype(np.int8)
            chains = decode_chains(self.chrom_codes, emit, w_off, ss,
                                   lane == 1, q_dev, qlen[:n],
                                   np.full(n, w, np.int64), lmax)
            from pindel_tpu_torch.reads import AnchorSet
            from pindel_tpu_torch.search import _anchorset_from_chain
            results: List = [None] * n
            legacy_rows: List[int] = []
            for i in range(n):
                ch = chains[i]
                if not any_emit[i] or ch is None:
                    results[i] = (AnchorSet.empty(), 0)
                elif not uni[i]:
                    # non-uniform chain: exact per-length reconstruction via
                    # the legacy per-lane path
                    legacy_rows.append(i)
                else:
                    lm = bool(lane[i])
                    results[i] = (_anchorset_from_chain(
                        ch, lm, lm, self.chrom_name), ch.full_mm)
            g_fallback.add(n, len(legacy_rows))
            if legacy_rows:
                sub = self._legacy.run(
                    [batch_lanes[i] for i in legacy_rows], bp_start,
                    [max_snps[i] for i in legacy_rows],
                    [tsec_minus[i] for i in legacy_rows])
                for i, res in zip(legacy_rows, sub):
                    results[i] = res
        return results

    # kernel dispatch points (overridden by the mesh backend): each takes
    # the host payload and returns its packed output on the way to host
    # memory (``get`` waits for it)
    def _close_call(self, payload: np.ndarray, **static):
        return self._launch(_close_kernel, payload, static)

    def _far_call(self, payload: np.ndarray, **static):
        return self._launch(_far_kernel, payload, static)

    def _far_win_call(self, payload: np.ndarray, **static):
        return self._launch(_far_win_kernel, payload, static)

    def _launch(self, kernel, payload: np.ndarray, static) -> _Download:
        fused_cuda.count_upload(payload.nbytes)
        with torch.inference_mode():
            out = kernel(self.state.chromcat,
                         torch.from_numpy(payload).to(self.device),
                         self.state.maxmm, **static)
            return _Download(out)

    def _rows(self, n: int) -> int:
        """Rows of a launch of n reads: the real rows, rounded up to dp
        (rows are searched independently and only real rows are decoded,
        so the padding never changes a result)."""
        return _round_up(max(n, 1), self.dp)

    @staticmethod
    def _w_bucket(width: int) -> int:
        """Window bucket: 128*2^k with 3*2^k intermediates (192, 384,
        768, 1536, ...)."""
        b = 128
        while True:
            if width <= b:
                return b
            if width <= (b // 2) * 3:
                return (b // 2) * 3
            b *= 2

    def _budgets(self, qlen: np.ndarray, nb: int):
        ms = self.maxmm[np.minimum(qlen, MAX_READ_LENGTH - 1)].astype(
            np.int32)
        ms[nb:] = 0
        tm = ms + self.settings.additional_mismatch
        assert int(tm.max()) <= 200, "mismatch budget exceeds u8 headroom"
        # integer threshold equivalent to CheckMismatches' float compare
        # (searcher.cpp:383-387): float32(k) >= float32(n*rate), with k
        # integral and < 2^24, holds iff k >= ceil(float32(n*rate))
        ma = np.float32(qlen.astype(np.float64) * np.float64(self.rate))
        thr = np.ceil(ma).astype(np.int32)
        return ms, tm, thr

    def _chunk_plan(self, n: int) -> List[Tuple[int, int]]:
        """(lo, hi) chunks: a small leading chunk whenever the batch
        exceeds it, so the host's decode stream starts early."""
        if n == 0:
            return []
        if n <= self.LEAD or n - self.LEAD < 512:
            return [(0, n)]
        plan = [(0, self.LEAD)]
        lo = self.LEAD
        while lo < n:
            plan.append((lo, min(lo + self.CHUNK, n)))
            lo += self.CHUNK
        return plan

    # ------------------------------------------------------------- close
    def close_ends(self, reads, bp_start: int):
        """Run the 4-attempt close-end schedule for all reads; per read
        (chain | None, winner attempt 0..3 or -1, needs_fallback)."""
        return self.close_ends_decode(
            reads, self.close_ends_dispatch(reads, bp_start))

    def close_ends_dispatch_lazy(self, batch, act, bp_start: int):
        """Dispatch over a lazy ReadBatch: ``act`` holds the batch row
        indices of the active reads, in window order."""
        n = act.size
        results = [(None, -1, False)] * n
        pending = []
        for lo, hi in self._chunk_plan(n):
            pending.append(self._close_dispatch_batch(
                batch, act[lo:hi], lo, results, bp_start))
        return results, pending

    def close_ends_dispatch(self, reads, bp_start: int):
        """Async half of close_ends: one launch per chunk; returns a token
        for ``close_ends_decode``."""
        n = len(reads)
        results: List[Tuple[Optional[ChainDecode], int, bool]] = \
            [(None, -1, False)] * n
        pending = []
        for lo, hi in self._chunk_plan(n):
            pending.append(
                self._close_dispatch(reads[lo:hi], lo, results, bp_start))
        return results, pending

    def close_ends_decode(self, reads, token):
        results, pending = token
        for st in pending:
            self._close_finish(st, results)
        for st in pending:
            self._join_decode(st)
        return results

    @staticmethod
    def _join_decode(st) -> None:
        """Wait for a chunk's decode on the -T pool, where it went."""
        fut = st.pop("fut", None)
        if fut is not None:
            with g_timer.phase("fused: close decode join"):
                fut.result()

    def close_ends_decode_stream(self, reads, token):
        """Yield (lo, hi, results) per chunk as its device results land."""
        results, pending = token
        for st in pending:
            self._close_finish(st, results)
            self._join_decode(st)
            yield st["base"], st["base"] + st["nb"], results

    def _close_dispatch(self, reads, base: int, results, bp_start: int):
        nb = len(reads)
        b = self._rows(nb)
        blob, offs = _seq_blob(reads, nb)
        qlen = np.zeros(b, np.int32)
        qlen[:nb] = np.diff(offs)
        minus = np.zeros(b, bool)
        pos = np.zeros(b, np.int64)
        isz = np.zeros(b, np.int64)
        for i, r in enumerate(reads):
            minus[i] = r.matched_d == "-"
            pos[i] = r.matched_rel_pos
            isz[i] = r.insert_size
        lmax = _round_up(max(int(qlen.max()), 8), 128)
        pack_fn = lambda meta: _native_pack_close(blob, offs, nb, b,  # noqa: E731
                                                  lmax, meta)
        codes_fn = lambda: _native_codes(blob, offs, nb, b, lmax)  # noqa: E731
        return self._close_dispatch_core(
            nb, b, lmax, qlen, minus, pos, isz, base, results, bp_start,
            pack_fn, codes_fn)

    def _close_dispatch_batch(self, batch, rows, base: int, results,
                              bp_start: int):
        """Array-sourced dispatch: a lazy ReadBatch + row indices."""
        nb = rows.size
        b = self._rows(nb)
        qlen = np.zeros(b, np.int32)
        qlen[:nb] = batch.sl[rows]
        minus = np.zeros(b, bool)
        minus[:nb] = batch.dm[rows] != 0
        pos = np.zeros(b, np.int64)
        pos[:nb] = batch.pos[rows]
        isz = np.zeros(b, np.int64)
        isz[:nb] = batch.isz[rows]
        lmax = _round_up(max(int(qlen.max()), 8), 128)
        soff = np.ascontiguousarray(batch.so[rows])
        slen = np.ascontiguousarray(batch.sl[rows])
        blob = batch.blob
        pack_fn = lambda meta: _native_pack_close_at(  # noqa: E731
            blob, soff, slen, nb, b, lmax, meta)
        codes_fn = lambda: _native_codes_at(blob, soff, slen, nb, b,  # noqa: E731
                                            lmax)
        return self._close_dispatch_core(
            nb, b, lmax, qlen, minus, pos, isz, base, results, bp_start,
            pack_fn, codes_fn)

    def _close_dispatch_core(self, nb, b, lmax, qlen, minus, pos, isz,
                             base, results, bp_start, pack_fn, codes_fn):
        with g_timer.phase("fused: pack close"):
            ms, tm, thr = self._budgets(qlen, nb)
            # attempt windows (close_end_lane geometry, pindel.cpp:2271-2316)
            win = np.zeros((2, b, 2), np.int64)
            for k in (0, 1):
                plus_start = pos + SPACER - k * isz
                plus_end = plus_start + (2 * k + 1) * isz
                minus_end = pos + SPACER + k * isz
                minus_start = minus_end - (2 * k + 1) * isz
                win[k, :, 0] = np.where(minus, minus_start, plus_start)
                win[k, :, 1] = np.where(minus, minus_end, plus_end)
            w0, w1 = (self._w_bucket(max(int((win[k, :, 1]
                                              - win[k, :, 0]).max()), 1))
                      for k in (0, 1))
            qlen[nb:] = 1                      # padding rows: never active
            st = dict(dev=None, base=base, nb=nb, b=b, qlen=qlen,
                      codes_fn=codes_fn, minus=minus, win=win, w0=w0,
                      w1=w1, lmax=lmax, bp_start=bp_start,
                      lsteps=_round_up(int(qlen[:nb].max()), 16))
            if w0 + lmax > SPACER:
                # the range-0 window bucket outgrows the spacer padding the
                # tile gather relies on: the whole chunk takes the exact
                # NumPy oracle
                for i in range(nb):
                    results[base + i] = (None, -1, True)
                return st
            # range-1 windows can outgrow the spacer even when range 0 fits
            # (3x wider): skip range 1 on device, fall back per failure
            with_r1 = (w1 + lmax) <= SPACER
            st["with_r1"] = with_r1
            if int(isz.max()) > 0x1ffff or int(qlen.max()) > 0x3ff \
                    or int(thr.max()) > 0x3ff:
                # bit-packed meta cannot hold this chunk (jumbo inserts)
                for i in range(nb):
                    results[base + i] = (None, -1, True)
                return st
            meta = _close_meta(pos, isz, qlen, ms, tm, thr, minus)
            payload = pack_fn(meta)
        with g_timer.phase("fused: dispatch close"):
            st["dev"] = self._close_call(
                payload, w0=w0, w1=w1, lmax=lmax, mpm=self.mpm,
                bp_start=bp_start, lsteps=st["lsteps"], with_r1=with_r1)
        return st

    def _close_finish(self, st, results):
        """Wait for a chunk's kernel output and decode the winners of both
        ranges (on the -T pool when enabled; the caller joins st["fut"])."""
        if st["dev"] is None:
            return
        base, nb, lmax = st["base"], st["nb"], st["lmax"]
        with g_timer.phase("fused: close wait"):
            out = st["dev"].get()
        st["dev"] = None
        nw = lmax // 32
        emit = unpack_words(out[:nb, :nw], lmax)
        rep = out[:nb, nw].astype(np.int64)
        flags = out[:nb, nw + 1]
        winner = (flags & 255).astype(np.int64)
        uniform = ((flags >> 8) & 1).astype(bool)
        if not st["with_r1"]:
            # range-1 window outgrew the spacer: exact-semantics
            # fallback for range-0 failures
            for i in np.flatnonzero(winner == 255).tolist():
                results[base + i] = (None, -1, True)

        def _decode():
            with g_timer.phase("fused: decode close"):
                codes = st["codes_fn"]()
                r0 = np.flatnonzero(winner < 2)
                if r0.size:
                    self._decode_close_rows(
                        st, results, r0, emit[r0], rep[r0], winner[r0],
                        uniform[r0], st["qlen"], codes, st["minus"],
                        st["win"][0], st["w0"], flip=(winner[r0] == 1))
                r1 = np.flatnonzero((winner == 2) | (winner == 3))
                if r1.size:
                    self._decode_close_rows(
                        st, results, r1, emit[r1], rep[r1], winner[r1],
                        uniform[r1], st["qlen"], codes, st["minus"],
                        st["win"][1], st["w1"], flip=(winner[r1] == 2))

        pool = self._decode_pool()
        if pool is not None:
            st["fut"] = pool.submit(g_timer.bind(_decode))
        else:
            _decode()

    def _decode_close_rows(self, st, results, idx, emit, rep_w,
                           winner, uniform, qlen_a, codes_a, minus_a,
                           win_a, wbuck: int, *, flip):
        """Decode the winning attempts of a set of rows into results
        (``idx``: chunk-relative read indices; ``flip``: the query was the
        RC-flipped sequence, attempts 1 and 2)."""
        base, lmax = st["base"], st["lmax"]
        rows = idx
        n = idx.size
        qlen = qlen_a[rows]
        codes = codes_a[rows]
        minus = minus_a[rows]
        start = win_a[rows, 0]
        end = win_a[rows, 1]
        tlen = wbuck + lmax
        ss = np.where(minus, end - tlen, start)
        # device-oriented query of the winning attempt: '-' reads use
        # R(f) / C(f); '+' reads RC(f) / f (see _close_kernel)
        cf = dna.RC[codes]
        li = np.arange(lmax)
        ridx = np.where(li < qlen[:, None],
                        np.maximum(qlen[:, None] - 1 - li, 0), li)
        rf = np.where(li < qlen[:, None],
                      np.take_along_axis(codes, ridx, axis=1), dna.N)
        rcf = np.where(li < qlen[:, None],
                       np.take_along_axis(cf, ridx, axis=1), dna.N)
        mcol = minus[:, None]
        fcol = np.asarray(flip)[:, None]
        q_dev = np.where(mcol, np.where(fcol, cf, rf),
                         np.where(fcol, codes, rcf)).astype(np.int8)
        chains = decode_chains(self.chrom_codes, emit, rep_w, ss,
                               minus, q_dev, qlen,
                               np.full(n, wbuck, np.int64), lmax)
        winl = winner.tolist()
        unil = uniform.tolist()
        idxl = idx.tolist()
        for k in range(n):
            ch = chains[k]
            if ch is None:
                continue
            if not unil[k]:
                results[base + idxl[k]] = (None, winl[k], True)
                continue
            results[base + idxl[k]] = (ch, winl[k], False)

    # --------------------------------------------------------------- far
    def far_ends(self, reads, spans: Sequence[int], comp_size: int,
                 bp_start: int = 10):
        """Geometric far-end escalation for close-mapped reads; per read
        (chain | None, lane_minus, replaced, needs_fallback)."""
        return self.far_ends_decode(
            reads, self.far_ends_dispatch(reads, spans, comp_size,
                                          bp_start))

    def far_ends_dispatch(self, reads, spans: Sequence[int],
                          comp_size: int, bp_start: int = 10):
        """Async half of far_ends (token for ``far_ends_decode``)."""
        n = len(reads)
        results: List[Tuple[Optional[ChainDecode], bool, bool, bool]] = \
            [(None, False, False, False)] * n
        pending = []
        for lo, hi in self._chunk_plan(n):
            pending.append(self._far_dispatch(reads[lo:hi], lo, spans,
                                              comp_size, bp_start))
        return results, pending

    def far_ends_decode(self, reads, token):
        results, pending = token
        for st in pending:
            self._far_decode(st, results)
        return results

    def _far_dispatch(self, reads, base: int, spans, comp_size,
                      bp_start: int):
        with g_timer.phase("fused: pack far"):
            nb = len(reads)
            b = self._rows(nb)
            nr = len(spans)
            blob, offs = _seq_blob(reads, nb)
            qlen = np.zeros(b, np.int32)
            qlen[:nb] = np.diff(offs)
            lmax = _round_up(max(int(qlen.max()), 8), 128)
            close_max = np.zeros(b, np.int32)
            init_max = np.zeros(b, np.int32)
            center = np.zeros(b, np.int64)
            for i, r in enumerate(reads):
                close_max[i] = r.max_len_close()
                init_max[i] = r.max_len_far()
                center[i] = r.last_abs_loc_close_end()
            qlen[nb:] = 1                        # padding rows: never active
            close_max[nb:] = 1
            wins = np.zeros((b, nr, 2), np.int64)
            ws = []
            for k, span in enumerate(spans):
                # window geometry: search.py search_far_ends
                start = np.where(center > span + SPACER, center - span,
                                 SPACER)
                end = np.minimum(center + span, comp_size - SPACER)
                wins[:, k, 0] = start
                wins[:, k, 1] = np.maximum(end, start)
                ws.append(self._w_bucket(2 * span))
            assert max(ws) + lmax <= SPACER, (ws, lmax)
            ms, tm, thr = self._budgets(qlen, nb)
            assert int(qlen.max()) <= 0x3ff \
                and int(close_max.max()) <= 0x3ff \
                and int(init_max.max()) <= 0x3ff \
                and int(thr.max()) <= 0x3ff, \
                "read length exceeds far-meta bit packing"
            meta = _far_meta(center, qlen, close_max, init_max, ms, tm,
                             thr, comp_size)
            payload = _native_pack_far(blob, offs, nb, b, lmax, meta)
        with g_timer.phase("fused: dispatch far"):
            dev = self._far_call(
                payload, spans=tuple(spans), ws=tuple(ws), lmax=lmax,
                mpm=self.mpm, bp_start=bp_start,
                lsteps=_round_up(int(qlen[:nb].max()), 16))
        return dict(dev=dev, base=base, nb=nb, b=b, qlen=qlen, blob=blob,
                    offs=offs, wins=wins, ws=ws, lmax=lmax)

    def _far_decode(self, st, results):
        codes = _native_codes(st["blob"], st["offs"], st["nb"], st["b"],
                              st["lmax"])
        with g_timer.phase("fused: far wait"):
            out = st["dev"].get()
        with g_timer.phase("fused: decode far"):
            self._far_decode_rows(st, results, out, codes)

    def _far_decode_rows(self, st, results, out, codes):
        base, nb, lmax = st["base"], st["nb"], st["lmax"]
        qlen, wins, ws = st["qlen"], st["wins"], st["ws"]
        nw = lmax // 32
        emit = unpack_words(out[:nb, :nw], lmax)
        rep = out[:nb, nw].astype(np.int64)
        flags = out[:nb, nw + 1]
        win_round = (flags & 255).astype(np.int64)
        replaced = ((flags >> 8) & 1).astype(bool)
        uni = ((flags >> 9) & 1).astype(bool)

        rr = np.where(win_round == 255, 0, win_round)
        wbuck = np.asarray(ws, np.int64)[rr]
        lane = rep // wbuck
        w_off = rep % wbuck
        start = wins[np.arange(nb), rr, 0]
        end = wins[np.arange(nb), rr, 1]
        tlen = wbuck + lmax
        ss = np.where(lane == 1, end - tlen, start)
        q_dev = np.where((lane == 1)[:, None], dna.RC[codes[:nb]],
                         codes[:nb]).astype(np.int8)
        chains = decode_chains(self.chrom_codes, emit, w_off, ss,
                               lane == 1, q_dev, qlen[:nb], wbuck, lmax)
        lanel = (lane == 1).tolist()
        unil = uni.tolist()
        for i in np.flatnonzero(replaced).tolist():
            ch = chains[i]
            if ch is not None and not unil[i]:
                results[base + i] = (None, False, True, True)
                continue
            results[base + i] = (ch, lanel[i], True, False)
