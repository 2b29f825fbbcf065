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

``scan_rows`` picks the implementation from the tensors' device: a CPU
tensor takes the plain version, a CUDA tensor the hand-written kernel
(``scan_cuda.py``); any other device raises.
"""
from __future__ import annotations

import numpy as np
import torch

from pindel_tpu import dna

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


def scan_rows_ref(tiles, qq, valid_w, qlen, thr, off=None,
                  *, w: int, lmax: int, mpm: int, lsteps: int = 0):
    """[R, T] int8 tiles, [R, lmax] int8 queries, [R] int32 valid_w / qlen /
    thr / off -> (kmin, k2): [R, lmax] int32, zero past ``lsteps``.

    Lane space is WE = T - lmax >= w; candidates of row r live in
    ``[off[r], off[r] + valid_w[r])``.  With ``off`` omitted, T == w + lmax.
    """
    lsteps = lsteps or lmax
    dead = dead_level(lmax)
    shift = key_shift(w)
    assert ((dead + lmax) << shift) + (1 << shift) < 2 ** 31, (w, lmax)
    r, t = tiles.shape
    we = t - lmax
    assert we >= w, (t, w, lmax)
    i32 = torch.int32
    dev = tiles.device
    if off is None:
        assert we == w, (t, w, lmax)
        off = torch.zeros((r,), dtype=i32, device=dev)
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


def scan_rows(tiles, qq, valid_w, qlen, thr, off=None,
              *, w: int, lmax: int, mpm: int, lsteps: int = 0):
    """Device dispatch of the scan (counterpart of ``_scan_rows``)."""
    kind = tiles.device.type
    if kind == "cpu":
        return scan_rows_ref(tiles, qq, valid_w, qlen, thr, off,
                             w=w, lmax=lmax, mpm=mpm, lsteps=lsteps)
    if kind == "cuda":
        from pindel_tpu_torch.ops.scan_cuda import scan_rows_cuda
        return scan_rows_cuda(tiles, qq, valid_w, qlen, thr, off,
                              w=w, lmax=lmax, mpm=mpm, lsteps=lsteps)
    raise ValueError(f"scan_rows: no scan for device {tiles.device}")
