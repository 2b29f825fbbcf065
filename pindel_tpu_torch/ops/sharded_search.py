"""The window-parallel search (port of pindel_tpu/parallel/mesh.py's
``_search_step_local``): the plain twin of the shard kernel, the merge of
the shards' partials and the emission rules.

The JAX function runs K8's per-lane search (ops/engine_jax.py) under
``shard_map`` with each lane's candidate columns split over ``wp`` devices,
and rebuilds the per-length aggregates with a ``pmin``/``psum`` over the
shards at every step.  Here a shard computes, for its rows and its columns
``[off, off + w_local)`` of every lane, at every step ``l < lmax``:

* ``cnt[l, v]``: how many of its candidates sit at level ``v`` for ``v`` in
  ``0..T`` (``T`` the batch's largest ``tsec_minus``), and at ``DEAD`` in the
  last slot;
* ``key[l, v]``: the smallest ``2 * key + strict_bad`` over its candidates at
  level ``v`` for ``v`` in ``0..S`` (``S`` the batch's largest ``max_snp``),
  and over its ``DEAD`` candidates (bit cleared) in the last slot, where
  ``key = lane * w_total + global column``; ``NO_KEY`` where none.

A candidate's level is at most its read's ``tsec_minus`` or ``DEAD``, and
keys are distinct, so one sum and one min over the shards rebuild the JAX
function's ``min_mm``, ``cnt1``, ``cntp``, ``key_glob`` and
``rep_strict_bad`` bit for bit (``merge_partials``).  The JAX function
gives a dead candidate the level value ``DEAD`` (127), so with budgets at or
above it a live candidate at 127 counts with the dead ones; ``levels``
sizes T and S for that, and the merge adds the two.  The strict bit of a
``DEAD`` representative is left out: emission needs ``min_mm <= max_snp``,
so it is read only where ``max_snp`` reaches DEAD, and ``dead_rep_strict``
recounts it there.  ``finish`` recounts the representative's whole-read
mismatches (the JAX function's ``full_mm``) and applies the emission
rules.  ``shard_partials`` runs the CUDA kernel (ops/sharded_search_cuda.py)
on a card and ``shard_partials_ref`` on the CPU.
"""
from __future__ import annotations

import torch

from pindel_tpu_torch import dna
from pindel_tpu_torch.config import MAX_READ_LENGTH

DEAD = 127
BIGKEY = 1 << 30            # the JAX function's key where no candidate is
NO_KEY = 2 ** 31 - 1        # partial key slot with no candidate
NEVER = -(1 << 20)          # step of the last strict mismatch: none yet
RECOUNT_ELEMS = 1 << 24     # (row, step, step) elements per recount chunk

_I32 = torch.int32


def levels(s_max: int, t_max: int, lmax: int):
    """T and S of a batch whose largest ``max_snp`` is ``s_max`` and largest
    ``tsec_minus`` is ``t_max``: no level passes lmax - 1 (a step adds at
    most one mismatch), and where a live candidate can sit at DEAD's level
    the keys are kept up to it, since the JAX function counts that
    candidate with the dead ones."""
    t = max(min(t_max, lmax - 1), 0)
    s = max(min(s_max, t), 0)
    return t, (max(s, DEAD) if t >= DEAD else s)


def tile_starts(slice_start, reverse, chrom_len: int, *, off,
                w_total: int, w_local: int, lmax: int):
    """Chromosome start of each lane's tile in the shard at column ``off``
    (an int, or a tensor of offsets beside ``slice_start``), as
    ``jax.lax.dynamic_slice`` takes it: backward tiles advance from the
    window's other end, a negative start wraps by the chromosome's length,
    then the start is clamped so the tile stays inside."""
    start = slice_start.to(_I32)
    start = torch.where(reverse, start + (w_total - w_local - off),
                        start + off)
    start = torch.where(start < 0, start + chrom_len, start)
    return start.clamp(0, chrom_len - (w_local + lmax))


def shard_partials_ref(chrom, slice_start, reverse, qq, valid_w, max_snp,
                       tsec_minus, *, off: int, w_total: int, w_local: int,
                       lmax: int, nl: int, mpm: int, t_levels: int,
                       s_levels: int):
    """One shard's partials in plain torch (the kernel's contract).

    Args: ``chrom`` [C] int8; ``slice_start`` [B, NL] int32; ``reverse``
    [B, NL] bool; ``qq`` [B, NL, lmax] int8; ``valid_w`` [B, NL] int32;
    ``max_snp``, ``tsec_minus`` [B] int32.  ``t_levels`` and ``s_levels``
    are T and S.  Returns ``cnt`` [B, lmax, T + 2] and ``key`` [B, lmax,
    S + 2], int32."""
    dev = chrom.device
    b = qq.shape[0]
    tile_len = w_local + lmax
    start = tile_starts(slice_start, reverse, chrom.shape[0], off=off,
                        w_total=w_total, w_local=w_local, lmax=lmax)
    steps = torch.arange(tile_len, dtype=_I32, device=dev)
    pos = torch.where(reverse[..., None],
                      start[..., None] + (tile_len - 1) - steps,
                      start[..., None] + steps)
    tiles = chrom.index_select(0, pos.reshape(-1)).reshape(b, nl, tile_len)
    del pos
    widx = torch.arange(w_local, dtype=_I32, device=dev) + off
    q0 = qq[:, :, 0:1]
    seeded = ((tiles[:, :, :w_local] == q0) & (widx < valid_w[..., None])
              & (q0 != dna.N))
    key2 = ((torch.arange(nl, dtype=_I32, device=dev)[:, None] * w_total
             + widx) * 2).expand(b, nl, w_local).reshape(b, -1)
    tm = tsec_minus.to(_I32)[:, None, None]
    t_dead, s_dead = t_levels + 1, s_levels + 1
    cnt = torch.zeros((b, lmax, t_levels + 2), dtype=_I32, device=dev)
    key = torch.full((b, lmax, s_levels + 3), NO_KEY, dtype=_I32, device=dev)
    cum = torch.zeros((b, nl, w_local), dtype=_I32, device=dev)
    lastmm = torch.full_like(cum, NEVER)
    ones = torch.ones((b, nl * w_local), dtype=_I32, device=dev)
    for l in range(lmax):
        if l > 0:
            ref = tiles[:, :, l:l + w_local]
            qb = qq[:, :, l:l + 1]
            strict = ref != qb
            cum += strict ^ (qb == dna.N)     # Matches() semantics for N
            lastmm.masked_fill_(strict, l)
        live = seeded & (cum <= tm)
        lvl = torch.where(live, cum, 0).reshape(b, -1)
        dead = ~live.reshape(b, -1)
        # the ring of the last mpm strict mismatches is cleared at step 0
        bad = (lastmm.reshape(b, -1) > l - mpm).to(_I32)
        cnt[:, l].scatter_add_(1, torch.where(dead, t_dead, lvl).long(),
                               ones)
        # levels above S take no key: they go to a slot cut off below
        slot = torch.where(dead, s_dead,
                           torch.where(lvl <= s_levels, lvl, s_dead + 1))
        key[:, l].scatter_reduce_(1, slot.long(),
                                  torch.where(dead, key2, key2 + bad),
                                  reduce="amin")
    return cnt, key[:, :, :s_levels + 2].contiguous()


def shard_partials(chrom, slice_start, reverse, qq, valid_w, max_snp,
                   tsec_minus, **kw):
    """The shard kernel on CUDA tensors, its plain twin on CPU tensors."""
    if chrom.device.type == "cuda":
        from pindel_tpu_torch.ops.sharded_search_cuda import \
            shard_partials_cuda
        return shard_partials_cuda(chrom, slice_start, reverse, qq, valid_w,
                                   max_snp, tsec_minus, **kw)
    if chrom.device.type != "cpu":
        raise ValueError(f"no shard kernel for device {chrom.device}")
    return shard_partials_ref(chrom, slice_start, reverse, qq, valid_w,
                              max_snp, tsec_minus, **kw)


def merge_partials(cnts, keys, max_snp, tsec_minus):
    """The JAX function's per-step ``psum``/``pmin`` from the shards'
    partials (one tensor per shard, all on one device).  Returns
    ``min_mm``, ``cnt1``, ``cntp``, ``key_glob`` (int32) and
    ``rep_strict_bad`` (bool), each [B, lmax]."""
    cnt = torch.stack(list(cnts)).sum(dim=0, dtype=_I32)
    key = torch.stack(list(keys)).amin(dim=0)
    t_levels = cnt.shape[2] - 2
    s_levels = key.shape[2] - 2
    dev = cnt.device
    ms = max_snp.to(_I32)[:, None, None]
    tm = tsec_minus.to(_I32)[:, None]
    lev = torch.arange(t_levels + 1, dtype=_I32, device=dev)
    alive = cnt[:, :, :t_levels + 1]
    dead = cnt[:, :, t_levels + 1]
    # the smallest level at or under max_snp that holds a candidate; one
    # above max_snp counts as DEAD (the JAX function's lvl_cap), and every
    # candidate sits in some slot
    low = torch.where((alive > 0) & (lev <= ms), lev, BIGKEY).amin(dim=2)
    capped = (dead > 0) | ((alive > 0) & (lev > ms)).any(dim=2)
    min_mm = torch.where(capped, low.clamp(max=DEAD), low)
    is_dead = min_mm == DEAD
    # at DEAD's level the dead candidates count with a live one there
    live_at = torch.gather(alive, 2, min_mm.clamp(max=t_levels)
                           .long()[..., None])[..., 0]
    cnt1 = (torch.where(min_mm <= t_levels, live_at, 0)
            + torch.where(is_dead, dead, 0))
    hi = torch.minimum(min_mm + (tm - max_snp.to(_I32)[:, None]), tm)
    cntp = ((alive * (lev <= hi[..., None])).sum(dim=2, dtype=_I32)
            + torch.where(hi >= DEAD, dead, 0))
    enc = torch.gather(key, 2, min_mm.clamp(max=s_levels)
                       .long()[..., None])[..., 0]
    enc = torch.where(min_mm <= s_levels, enc, NO_KEY)
    enc = torch.where(is_dead, torch.minimum(enc, key[:, :, s_levels + 1]),
                      enc)
    none = enc == NO_KEY
    key_glob = torch.where(none, BIGKEY, enc >> 1)
    rep_strict_bad = ~none & ((enc & 1) == 1)
    return min_mm, cnt1, cntp, key_glob, rep_strict_bad


def _rep_steps(chrom, slice_start, reverse, qq, key_glob, *, w_total: int,
               w_local: int, lmax: int):
    """For the candidate each ``key_glob`` [R, lmax] names (candidate 0 for
    ``BIGKEY``), read from the tile of the shard that owns its column: its
    tile's codes and its query's at steps 1..lmax-1, [R, lmax, lmax - 1]
    int8 each."""
    s = torch.arange(1, lmax, dtype=_I32, device=chrom.device)
    k = torch.where(key_glob != BIGKEY, key_glob, 0)
    lane = (k // w_total).long()
    col = k % w_total
    shard = col // w_local
    u = col - shard * w_local
    rev = torch.gather(reverse, 1, lane)
    start = tile_starts(torch.gather(slice_start, 1, lane), rev,
                        chrom.shape[0], off=shard * w_local,
                        w_total=w_total, w_local=w_local, lmax=lmax)
    t = u[..., None] + s                                   # tile index
    pos = torch.where(rev[..., None],
                      start[..., None] + (w_local + lmax - 1) - t,
                      start[..., None] + t)
    q = torch.gather(qq, 1, lane[..., None].expand(-1, -1, lmax))[..., 1:]
    return chrom[pos.long()], q


def recount(chrom, slice_start, reverse, qq, qlen, key_glob, *, w_total: int,
            w_local: int, lmax: int):
    """Whole-read mismatches (steps 1..qlen-1) of the candidate each
    ``key_glob`` names, read from the tile of the shard that owns its
    column; 0 for ``BIGKEY`` and for a row whose qlen - 1 is no step.  This
    is the JAX function's ``full_mm``, [B, lmax] int32."""
    dev = chrom.device
    b = key_glob.shape[0]
    full = torch.zeros((b, lmax), dtype=_I32, device=dev)
    rows = max(1, RECOUNT_ELEMS // (lmax * lmax))
    s = torch.arange(1, lmax, dtype=_I32, device=dev)
    for lo in range(0, b, rows):
        hi = min(lo + rows, b)
        ref, q = _rep_steps(chrom, slice_start[lo:hi], reverse[lo:hi],
                            qq[lo:hi], key_glob[lo:hi], w_total=w_total,
                            w_local=w_local, lmax=lmax)
        mm = (ref != q) ^ (q == dna.N)
        n = qlen[lo:hi].to(_I32)[:, None, None]
        counted = (s <= n - 1) & (n - 1 < lmax)
        full[lo:hi] = torch.where(key_glob[lo:hi] != BIGKEY, (mm & counted)
                                  .sum(dim=2, dtype=_I32), 0)
    return full


def dead_rep_strict(merged, chrom, slice_start, reverse, qq, *,
                    w_total: int, w_local: int, lmax: int, mpm: int):
    """``merged`` with the strict bit of each representative at DEAD's
    level recounted: a strict mismatch at one of its steps (l - mpm, l], l
    >= 1, as the JAX function's ring holds them.  The partials keep no
    strict bit for dead candidates, and it is read only where ``max_snp``
    reaches DEAD."""
    min_mm, cnt1, cntp, key_glob, strict_bad = merged
    b = key_glob.shape[0]
    out = strict_bad.clone()
    rows = max(1, RECOUNT_ELEMS // (lmax * lmax))
    lidx = torch.arange(lmax, dtype=_I32, device=chrom.device)[:, None]
    s = lidx[1:, 0]
    ring = (s <= lidx) & (s > lidx - mpm)                 # [lmax, lmax - 1]
    for lo in range(0, b, rows):
        hi = min(lo + rows, b)
        ref, q = _rep_steps(chrom, slice_start[lo:hi], reverse[lo:hi],
                            qq[lo:hi], key_glob[lo:hi], w_total=w_total,
                            w_local=w_local, lmax=lmax)
        bad = ((ref != q) & ring).any(dim=2)
        at_dead = (min_mm[lo:hi] == DEAD) & (key_glob[lo:hi] != BIGKEY)
        out[lo:hi] = torch.where(at_dead, bad, out[lo:hi])
    return min_mm, cnt1, cntp, key_glob, out


def finish(merged, full_mm, reverse, qlen, max_snp, maxmm, max_allowed, *,
           w_total: int, lmax: int, mpm: int, bp_start: int):
    """The emission rules of the JAX function (mesh.py:137-157) over the
    merged aggregates; returns ``emit`` (bool), ``min_mm``, ``rep_lane``,
    ``rep_w`` and ``full_mm`` (int32), each [B, lmax]."""
    min_mm, cnt1, cntp, key_glob, rep_strict_bad = merged
    dev = min_mm.device
    lens = torch.arange(1, lmax + 1, dtype=_I32, device=dev)[None, :]
    in_range = (lens >= bp_start) & (lens <= qlen.to(_I32)[:, None] - 1)
    maxmm_l = maxmm.to(dev)[lens.clamp(max=MAX_READ_LENGTH - 1).long()]
    stop_here = in_range & (min_mm > maxmm_l)
    alive = torch.cumsum(stop_here.to(_I32), dim=1) == 0
    rep_lane = key_glob // w_total
    rep_w = key_glob % w_total
    # BIGKEY's lane lies past the lanes; JAX fills its gather (True), and
    # emission is off there anyway (min_mm is DEAD)
    nl = reverse.shape[1]
    rep_reverse = torch.where(
        rep_lane < nl,
        torch.gather(reverse, 1, rep_lane.clamp(max=nl - 1).long()), True)
    len_ok = torch.where(rep_reverse, lens >= mpm, lens > mpm)
    # max_allowed is float32(double(qlen) * double(rate)), made on the host
    whole_read_bad_fit = full_mm.to(torch.float32) >= max_allowed[:, None]
    emit = (in_range & alive
            & (min_mm <= max_snp.to(_I32)[:, None])
            & (cnt1 == 1)
            & (lens >= bp_start + min_mm)
            & (cntp == 1)
            & (min_mm <= maxmm_l)
            & len_ok
            & ~rep_strict_bad
            & whole_read_bad_fit)
    return emit, min_mm, rep_lane, rep_w, full_mm
