"""Inputs of the fused search calls (``engine_fused._close_kernel``, K2,
``_far_kernel``, K3, and ``_far_win_kernel``, K4) built for the places where
the fused kernels' exactness could break.  Each case is (label, kernel name,
chromosome codes with their spacers, maxmm, payload, static arguments), the
payload packed as the backend packs it; the tests hold the port against the
JAX package on them, and chip_smoke.py holds ``pt_close``/``pt_far``/
``pt_far_win`` against the plain versions on the card.

Close cases (reads copied from the chromosome in each attempt's
orientation, some into range 1's window only, some random, with up to two
substitutions; both strands):

* ``close``: main-path shapes, both ranges;
* ``close_r0``: ``with_r1=False``;
* ``close_full``: ``qlen == lmax`` (and so ``lsteps == lmax``);
* ``close_long``: lmax 256 with reads of 130-250 bases, ``lsteps < lmax``;
* ``close_long384``: lmax 384 with reads of 250-360 bases, ``lsteps <
  lmax``; ``close_long512``: lmax 512 with reads of 385-500 bases (the
  backend rounds lmax up to 128 from reads of up to 500 bases); their reads
  carry substitutions in their middle, so that they emit;
* ``close_edges``: anchors next to either end of the chromosome, just
  past its end (forward tiles run into the reversed half), far past it
  (past the layout's last row: the clamp) and before its start, and
  inserts beyond the spacer, so tiles start before 0 (a negative
  ``start_log``).

Far cases (reads copied from inside a round's window, forward or reverse
complemented, or random):

* ``far_x0`` .. ``far_x4``: ``-x`` 0-4 (one to five rounds);
* ``far_active``: reads inactive from round 0 (close_max + init_max >=
  qlen), reads that become inactive after a round's hit, and reads whose
  sequence lies in the window on both strands (equal levels in the two
  lanes: lane 0 wins);
* ``far_edges``: centres next to either end of a short chromosome (the
  windows clamp to the spacers) and past its end (the forward tile runs
  past the layout's last row, the backward one starts before row 0);
* ``far_long384``: lmax 384 with reads of 300-384 bases; ``far_long512``:
  lmax 512 with reads of 250-480 bases, ``lsteps < lmax``; substitutions
  in their middle, as the long close cases.

Explicit-window cases (K4: a window [start, end) a read, as
``TorchFusedBackend.run`` packs BreakDancer/RP evidence windows; split
reads, a prefix copied from inside their window, forward or reverse
complemented, some on both strands inside it, so that the lanes tie and
lane 0 must win, or random, each with a random tail):

* ``far_win``: w 2048, windows narrower than, equal to and wider than w
  (the valid lanes clipped to w); the first window starts before the
  spacer and the last ends past the chromosome;
* ``far_win_edges``: windows that start before the spacer (and before 0),
  end past the chromosome, end before they start (no valid lane), end so
  early that the backward tile starts below 0, and start past the
  chromosome (the forward tile past the layout's last row: the clamp);
* ``far_win_wide32768``, ``far_win_wide98304``: the widest buckets, the
  second at lmax 512 (``w + lmax`` 98,816, next to the spacer's 100,000);
* ``far_win_long512``: lmax 512 with reads of 250-500 bases;
* ``far_win_skewed``: many narrow windows (128-512 bases) and a few at the
  bucket's full width (w 8192, lmax 128), the spread of widths inside one
  call that sets K4's critical path; ``far_win_skewed32768``: the same
  with one read at w 32768.  ``far_win_case(name, reads=n)`` scales their
  narrow reads to ``n`` (the wide ones stay a hundredth of the call, at
  least the case's own count), the size at which the card times them.
"""
from __future__ import annotations

import numpy as np

from pindel_tpu_torch import dna
from pindel_tpu_torch.config import Settings
from pindel_tpu_torch.genome import SPACER
from pindel_tpu_torch.ops.engine_fused import (FW_WORDS, TorchFusedBackend,
                                               _close_meta, _far_meta,
                                               _pack_payload,
                                               _reverse_codes_np, _round_up)

N = dna.N
CLOSE_CASES = ("close", "close_r0", "close_full", "close_long",
               "close_long384", "close_long512", "close_edges")
FAR_CASES = ("far_x0", "far_x1", "far_x2", "far_x3", "far_x4",
             "far_active", "far_edges", "far_long384", "far_long512")
FAR_WIN_CASES = ("far_win", "far_win_edges", "far_win_wide32768",
                 "far_win_wide98304", "far_win_long512", "far_win_skewed",
                 "far_win_skewed32768")
CASES = CLOSE_CASES + FAR_CASES + FAR_WIN_CASES
MPM = 3
# (lmax, reads, least and most read length) of the long-read cases; the
# others take lmax 128 and 60 reads of 40-100 bases
LONG = {"close_long": (256, 40, 130, 250),
        "close_long384": (384, 24, 250, 360),
        "close_long512": (512, 24, 385, 500),
        "far_long384": (384, 24, 300, 384), "far_long512": (512, 24, 250, 480),
        "far_win_long512": (512, 24, 250, 500),
        "far_win_wide98304": (512, 8, 250, 500)}
# the long-read K2/K3 cases take _split's reads (the reads of the others
# have up to two substitutions, fewer than a whole read of 250 bases or more
# needs to fail CheckMismatches, so they would hardly emit)
SPLIT = ("close_long384", "close_long512", "far_long384", "far_long512")
# the skewed K4 cases: (bucket, narrow reads, reads at the bucket's width)
SKEWED = {"far_win_skewed": (8192, 60, 4),
          "far_win_skewed32768": (32768, 30, 1)}


def _chrom(rng, length: int) -> np.ndarray:
    """A random chromosome with a few Ns, padded with the spacers."""
    seq = rng.integers(0, 4, length).astype(np.int8)
    seq[rng.integers(0, length, 5)] = N
    out = np.full(length + 2 * SPACER, N, np.int8)
    out[SPACER:SPACER + length] = seq
    return out


def _mutate(rng, q: np.ndarray) -> np.ndarray:
    q = q.copy()
    k = int(rng.integers(0, 3))
    if k:
        q[rng.integers(0, q.shape[0], k)] = rng.integers(0, 4, k)
    return q


def _budgets(qlen):
    settings = Settings()
    maxmm = np.asarray(settings.max_mismatch(), np.int32)
    ms = maxmm[np.minimum(qlen, maxmm.shape[0] - 1)].astype(np.int32)
    tm = ms + settings.additional_mismatch
    thr = np.ceil(np.float32(qlen.astype(np.float64)
                             * settings.max_allowed_mismatch_rate)
                  ).astype(np.int32)
    return maxmm, ms, tm, thr


def _split(rng, q: np.ndarray) -> np.ndarray:
    """``q`` with more substitutions than CheckMismatches lets a whole read
    have (2% of its length), all in its middle tenth: read from either end,
    its anchor then emits up to about half its length, and the whole read
    does not fit."""
    q = q.copy()
    ql = q.shape[0]
    at = rng.choice(np.arange(ql // 2, ql // 2 + ql // 10), ql // 40 + 2,
                    replace=False)
    q[at] = (q[at] + rng.integers(1, 4, at.shape[0])) % 4
    return q


def _close(rng, chrom, pos, isz, minus, qlen, lmax, r1_only, split):
    """A read per row: its codes in an attempt's orientation around its
    window (range 1's only where ``r1_only``), or random; ``split``: with
    ``_split``'s substitutions."""
    codes = np.full((pos.shape[0], lmax), N, np.int8)
    for i in range(pos.shape[0]):
        ql = int(qlen[i])
        lo = int(pos[i]) + SPACER - (int(isz[i]) if r1_only[i] else 0)
        if minus[i]:
            lo -= int(isz[i])
        x = int(np.clip(lo + rng.integers(0, max(int(isz[i]), 1)), 0,
                        chrom.shape[0] - ql))
        s = chrom[x:x + ql]
        kind = i % 5
        q = (dna.revcomp(s), s, s[::-1], dna.RC[s],
             rng.integers(0, 4, ql).astype(np.int8))[kind]
        codes[i, :ql] = _split(rng, q) if split else _mutate(rng, q)
    return codes


def close_case(name: str, seed: int = 0):
    rng = np.random.default_rng(seed)
    lmax, n, lo, hi = LONG.get(name, (128, 60, 40, 100))
    chrom = _chrom(rng, 6000)
    biol = chrom.shape[0] - 2 * SPACER
    if name == "close_full":
        qlen = np.full(n, lmax, np.int32)
    else:
        qlen = rng.integers(lo, hi + 1, n).astype(np.int32)
    isz = rng.integers(150, 600, n).astype(np.int64)
    pos = rng.integers(600, biol - 800, n).astype(np.int64)
    minus = rng.random(n) < 0.5
    r1_only = rng.random(n) < 0.3
    if name == "close_edges":
        # next to either end, past the end, and (with inserts beyond the
        # spacer) windows that start before the layout's first row
        comp = chrom.shape[0]
        for k, (lo, hi) in enumerate(((0, 40), (biol - 40, biol),
                                      (biol + SPACER, biol + SPACER + 200),
                                      (2 * comp, 2 * comp + 500),
                                      (-SPACER, 50 - SPACER))):
            pos[k::5] = rng.integers(lo, hi, pos[k::5].shape[0])
        isz[0::3] = rng.integers(SPACER + 100, 0x1ffff, isz[0::3].shape[0])
    codes = _close(rng, chrom, pos, isz, minus, qlen, lmax, r1_only,
                   name in SPLIT)
    maxmm, ms, tm, thr = _budgets(qlen)
    meta = _close_meta(pos, isz, qlen, ms, tm, thr, minus)
    payload = _pack_payload(
        np.concatenate([codes, _reverse_codes_np(codes, qlen)], axis=1),
        meta)
    wb = TorchFusedBackend._w_bucket
    w0 = wb(int(isz.max()))
    w1 = wb(3 * int(isz.max()))
    if name == "close_edges":
        w0, w1 = wb(600), wb(1800)
    static = dict(w0=w0, w1=w1, lmax=lmax, mpm=MPM, bp_start=8,
                  lsteps=_round_up(int(qlen.max()), 16),
                  with_r1=name != "close_r0")
    return chrom, maxmm, payload, static


def far_case(name: str, seed: int = 0):
    rng = np.random.default_rng(seed)
    lmax, n, lo, hi = LONG.get(name, (128, 60, 40, 100))
    rounds = int(name[-1]) + 1 if name.startswith("far_x") else 3
    spans = tuple(64 * 4 ** k for k in range(rounds))
    length = 600 if name == "far_edges" else 40000
    chrom = _chrom(rng, length)
    comp_size = chrom.shape[0]
    qlen = rng.integers(lo, hi + 1, n).astype(np.int32)
    center = rng.integers(SPACER + 100, comp_size - SPACER - 100,
                          n).astype(np.int64)
    close_max = rng.integers(5, 30, n).astype(np.int32)
    init_max = np.zeros(n, np.int32)
    codes = np.full((n, lmax), N, np.int8)
    for i in range(n):
        ql = int(qlen[i])
        span = spans[int(rng.integers(0, rounds))]
        x = int(np.clip(center[i] + rng.integers(-span, span), 0,
                        comp_size - ql))
        s = chrom[x:x + ql]
        kind = i % 4
        if name == "far_active" and kind == 3:
            # the read on both strands inside the window: equal levels
            y = int(np.clip(center[i] + 20, 0, comp_size - ql))
            chrom[y:y + ql] = dna.revcomp(s)
            q = s
        else:
            q = (s, dna.revcomp(s), s,
                 rng.integers(0, 4, ql).astype(np.int8))[kind]
        codes[i, :ql] = _split(rng, q) if name in SPLIT else _mutate(rng, q)
    if name == "far_active":
        init_max[0::5] = qlen[0::5] - close_max[0::5]      # inactive at 0
        close_max[1::5] = qlen[1::5] - 25                   # after a hit
        init_max[2::5] = rng.integers(0, 40, init_max[2::5].shape[0])
    if name == "far_edges":
        center[0::3] = rng.integers(SPACER - 50, SPACER + 30,
                                    center[0::3].shape[0])
        center[1::3] = comp_size - SPACER + rng.integers(-30, 60,
                                                         center[1::3].shape[0])
        # past the chromosome: the forward tile past the layout's last row,
        # the backward one from a negative start
        center[2::3] = comp_size + rng.integers(0, 10 ** 6,
                                                center[2::3].shape[0])
    maxmm, ms, tm, thr = _budgets(qlen)
    meta = _far_meta(center, qlen, close_max, init_max, ms, tm, thr,
                     comp_size)
    payload = _pack_payload(codes, meta)
    static = dict(spans=spans,
                  ws=tuple(TorchFusedBackend._w_bucket(2 * s) for s in spans),
                  lmax=lmax, mpm=MPM, bp_start=10,
                  lsteps=_round_up(int(qlen.max()), 16))
    return chrom, maxmm, payload, static


def far_win_case(name: str, seed: int = 0, reads: int = 0):
    rng = np.random.default_rng(seed)
    lmax, n, lo, hi = LONG.get(name, (128, 48, 40, 100))
    w = {"far_win_edges": 512, "far_win_wide32768": 32768,
         "far_win_wide98304": 98304}.get(name, 2048)
    if name.startswith("far_win_wide"):
        n = 8
    wide = 0
    if name in SKEWED:
        w, narrow, wide = SKEWED[name]
        narrow = reads or narrow
        wide = max(wide, narrow // 100)
        n = narrow + wide
    chrom = _chrom(rng, 3000 if name == "far_win_edges" else
                   max(20000, 2 * w))
    comp_size = chrom.shape[0]
    biol = comp_size - 2 * SPACER
    qlen = rng.integers(lo, hi + 1, n).astype(np.int32)
    codes = np.full((n, lmax), N, np.int8)
    start = np.zeros(n, np.int64)
    end = np.zeros(n, np.int64)
    for i in range(n):
        ql = int(qlen[i])
        if name in SKEWED:
            # the wide reads spread over the call, the rest narrow
            width = w if i % (n // wide) == 0 and i // (n // wide) < wide \
                else int(rng.integers(128, 513))
        else:
            width = (w // 3, w, w + w // 2)[i % 3]
        pos = SPACER + int(rng.integers(0, biol - ql))
        start[i] = pos - int(rng.integers(0, width))
        end[i] = start[i] + width
        s = chrom[pos:pos + ql]
        kind = i % 4
        if kind == 3:
            # the read on both strands inside its window: equal levels in
            # the two lanes
            y = int(np.clip(pos + 10, 0, comp_size - ql))
            chrom[y:y + ql] = dna.revcomp(s)
            q = s
        else:
            q = (s, dna.revcomp(s), rng.integers(0, 4, ql).astype(np.int8)
                 )[kind]
        # a split read: a prefix from the window, a random tail, so that
        # the whole read does not fit (the CheckMismatches rule)
        k = int(rng.integers(ql // 3, ql - 7))
        q = np.concatenate([q[:k], rng.integers(0, 4, ql - k)]).astype(np.int8)
        codes[i, :ql] = _mutate(rng, q)
    if name not in SKEWED:
        start[0] = SPACER - 7
        end[-1] = comp_size - SPACER + 5
    if name == "far_win_edges":
        for k in range(n):
            kind = k % 6
            if kind == 0:      # before the spacer, some before 0
                start[k] = SPACER - int(rng.integers(1, SPACER + 300))
                end[k] = start[k] + int(rng.integers(100, 800))
            elif kind == 1:    # past the chromosome's end
                end[k] = comp_size - SPACER + int(rng.integers(0, 2000))
                start[k] = end[k] - int(rng.integers(100, 800))
            elif kind == 2:    # end before start
                end[k] = start[k] - int(rng.integers(1, 300))
            elif kind == 3:    # the backward tile starts below 0
                end[k] = int(rng.integers(-300, w + lmax))
                start[k] = end[k] - int(rng.integers(0, 700))
            elif kind == 4:    # the forward tile past the layout's end
                start[k] = comp_size + int(rng.integers(0, 10 ** 6))
                end[k] = start[k] + int(rng.integers(100, 800))
    maxmm, ms, tm, thr = _budgets(qlen)
    meta = np.zeros((n, FW_WORDS), np.int32)
    meta[:, 0] = start
    meta[:, 1] = end
    meta[:, 2] = qlen
    meta[:, 3] = ms | (tm.astype(np.int64) << 8) | (thr.astype(np.int64) << 16)
    static = dict(w=w, lmax=lmax, mpm=MPM, bp_start=10,
                  lsteps=_round_up(int(qlen.max()), 16))
    return chrom, maxmm, _pack_payload(codes, meta), static


def fused_case(name: str, seed: int = 0, reads: int = 0):
    """(kernel name, chromosome, maxmm, payload, static) of case ``name``
    (``reads``: the skewed K4 cases' narrow reads, ``far_win_case``)."""
    if name in CLOSE_CASES:
        return ("_close_kernel", *close_case(name, seed))
    if name in FAR_WIN_CASES:
        return ("_far_win_kernel", *far_win_case(name, seed, reads))
    return ("_far_kernel", *far_case(name, seed))
