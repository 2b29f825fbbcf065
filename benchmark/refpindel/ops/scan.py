"""Packed-key length scan: the plain PyTorch version and the dispatch.

``scan_rows_ref`` is the bit-exact twin of ``_xla_scan_rows``
(``pindel_tpu/ops/engine_fused.py``), which is itself the twin of the
Pallas kernel ``pindel_tpu/ops/pallas_scan.py:_kernel``.  Per row it scans
every candidate lane of a reference tile against one query:

* pass 1 counts each candidate's whole-read Matches() mismatches over steps
  ``1..qlen-1`` (a step mismatches when ``(ref != q) XOR (q == N)``) and
  sets ``fitbad = total < thr``;
* pass 2 carries a packed key ``level << shift | woff << 2 | strict_bad << 1
  | fitbad`` per candidate (seeded lanes start at level 0, the others at
  ``dead``) plus the step of its last strict mismatch, and records per step
  the min key ``kmin`` and the min over the keys ``!= kmin`` (``k2``).

``scan_rows`` runs the plain version on every device (the port's picks
its hand-written kernel for a CUDA tensor).
"""
from __future__ import annotations

import numpy as np
import torch

from refpindel import dna

U8DEAD = 255
I16DEAD = 1000   # > max possible level for lmax > 255; keeps the key in int32
NEVER = -(1 << 20)   # lastmm sentinel: no strict mismatch yet
MAXI = 2 ** 31 - 1   # runner-up placeholder when every key equals the min


def key_shift(w: int) -> int:
    """Bits below the level in the packed key: the window offset + 2 flags."""
    wbits = max(int(np.ceil(np.log2(w))), 1)
    return wbits + 2


def dead_level(lmax: int) -> int:
    return U8DEAD if lmax <= 255 else I16DEAD


# rows scanned at a time: a block's [rows, WE] int32 state stays in the
# CPU's cache (rows are independent, so blocking changes no bit)
BLOCK_ROWS = 256


def scan_rows_ref(tiles, qq, valid_w, qlen, thr, off=None,
                  *, w: int, lmax: int, mpm: int, lsteps: int = 0):
    """[R, T] int8 tiles, [R, lmax] int8 queries, [R] int32 valid_w / qlen /
    thr / off -> (kmin, k2): [R, lmax] int32, zero past ``lsteps``.

    Lane space is WE = T - lmax >= w; candidates of row r live in
    ``[off[r], off[r] + valid_w[r])``.  With ``off`` omitted, T == w + lmax.
    Each row's result depends on that row alone: on the CPU the trailing
    run of rows equal to the last one (a batch bucket's padding) is scanned
    once and copied, and the rest in blocks of ``BLOCK_ROWS``.
    """
    r, t = tiles.shape
    assert t - lmax >= w, (t, w, lmax)
    if off is None:
        assert t - lmax == w, (t, w, lmax)
        off = torch.zeros((r,), dtype=torch.int32, device=tiles.device)
    kw = dict(w=w, lmax=lmax, mpm=mpm, lsteps=lsteps)
    if tiles.device.type != "cpu" or r == 0:
        return _scan_block(tiles, qq, valid_w, qlen, thr, off, **kw)
    n = r - _trailing_copies(tiles, qq, valid_w, qlen, thr, off)
    parts = [_scan_block(*(x[i:min(i + BLOCK_ROWS, n)]
                           for x in (tiles, qq, valid_w, qlen, thr, off)),
                         **kw)
             for i in range(0, n, BLOCK_ROWS)]
    kmin = torch.cat([p[0] for p in parts])
    k2 = torch.cat([p[1] for p in parts])
    if n < r:
        kmin = torch.cat([kmin, kmin[-1:].expand(r - n, -1)])
        k2 = torch.cat([k2, k2[-1:].expand(r - n, -1)])
    return kmin, k2


def _trailing_copies(tiles, *rows) -> int:
    """How many rows before the last one equal it in every input."""
    same = (tiles == tiles[-1:]).all(dim=1)
    for x in rows:
        same &= (x == x[-1:]).all(dim=1) if x.dim() == 2 else x == x[-1]
    diff = torch.nonzero(~same)
    return tiles.shape[0] - 1 - (int(diff[-1]) + 1 if len(diff) else 0)


def _scan_block(tiles, qq, valid_w, qlen, thr, off,
                *, w: int, lmax: int, mpm: int, lsteps: int = 0):
    """``scan_rows_ref`` on rows with ``off`` given."""
    lsteps = lsteps or lmax
    dead = dead_level(lmax)
    shift = key_shift(w)
    assert ((dead + lmax) << shift) + (1 << shift) < 2 ** 31, (w, lmax)
    r, t = tiles.shape
    we = t - lmax
    i32 = torch.int32
    dev = tiles.device
    off_c = off.to(i32)[:, None]
    qlen_c = qlen.to(i32)[:, None]
    u8 = torch.uint8
    # per-step flags as 0/1 bytes: (ref - q).bool() is exact for codes 0-4
    # and, on the CPU, far cheaper than a broadcast compare
    qn = (qq == dna.N).to(u8)                               # [R, lmax]

    def strict_mismatch(l):
        return (tiles[:, l:l + we] - qq[:, l:l + 1]).bool().view(u8)

    # pass 1: whole-read mismatch totals per candidate -> fit bit (step 0
    # never counts); Matches() mismatch = strict mismatch XOR (q == N)
    totals = torch.zeros((r, we), dtype=i32, device=dev)
    for l in range(1, lsteps):
        lv = (l < qlen_c).to(u8)
        totals.add_((strict_mismatch(l) ^ qn[:, l:l + 1]) & lv)
    fitbad = (totals < thr.to(i32)[:, None]).to(i32)

    widx = torch.arange(we, dtype=i32, device=dev)[None, :]
    q0 = qq[:, 0:1]
    seeded = ((tiles[:, :we] == q0) & (widx >= off_c)
              & (widx < off_c + valid_w.to(i32)[:, None]) & (q0 != dna.N))
    woff = (widx - off_c).clamp(0, w - 1)
    keybase = ((~seeded).to(i32) * dead << shift) | (woff << 2) | fitbad

    # lastmm is held as lastmm - NEVER (0 = no strict mismatch yet): steps
    # only grow, so recording step l where d holds is a max, not a select
    lastmm_n = torch.zeros((r, we), dtype=i32, device=dev)
    kmin = torch.zeros((r, lmax), dtype=i32, device=dev)
    k2 = torch.zeros((r, lmax), dtype=i32, device=dev)
    for l in range(lsteps):
        if l >= 1:
            # at step 0 nothing counts and lastmm stays NEVER
            d = strict_mismatch(l)
            lv = (l < qlen_c).to(u8)
            keybase.add_((d ^ qn[:, l:l + 1]) & lv, alpha=1 << shift)
            torch.maximum(lastmm_n, d.to(i32) * (l - NEVER), out=lastmm_n)
        # strict_bad: lastmm > l - mpm
        key = torch.add(keybase, lastmm_n > l - mpm - NEVER, alpha=2)
        m = key.amin(dim=1)
        kmin[:, l] = m
        k2[:, l] = torch.where(key == m[:, None], MAXI, key).amin(dim=1)
    return kmin, k2


def seed_counts(tiles, qq, valid_w, off, *, lmax: int):
    """Seeded candidates per row ([R] int64): lanes c in [off, off +
    valid_w) of [0, WE) with ``tile[c] == q[0]`` and ``q[0] != N``."""
    we = tiles.shape[1] - lmax
    widx = torch.arange(we, dtype=torch.int32, device=tiles.device)[None, :]
    off_c = off.to(torch.int32)[:, None]
    q0 = qq[:, 0:1]
    seeded = ((tiles[:, :we] == q0) & (widx >= off_c)
              & (widx < off_c + valid_w.to(torch.int32)[:, None]))
    return seeded.sum(dim=1) * (q0[:, 0] != dna.N)


def sparse_rows(seeds, valid_w, qlen, *, w: int, lmax: int, lsteps: int = 0):
    """Rows whose min and second min are decided by their seeded lanes
    alone (the kernel's sparse branch): two or more seeds, distinct seeded
    keys (``valid_w <= w``) and seeded levels below ``dead``
    (``min(lsteps, qlen) <= dead``)."""
    lsteps = lsteps or lmax
    return ((seeds >= 2) & (valid_w <= w)
            & (torch.clamp(qlen, max=lsteps) <= dead_level(lmax)))


def scan_rows(tiles, qq, valid_w, qlen, thr, off=None,
              *, w: int, lmax: int, mpm: int, lsteps: int = 0):
    """The scan on any device (counterpart of ``_scan_rows``)."""
    return scan_rows_ref(tiles, qq, valid_w, qlen, thr, off,
                         w=w, lmax=lmax, mpm=mpm, lsteps=lsteps)
