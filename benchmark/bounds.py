"""The yardstick of the kernels' rooflines: the H100's published peaks and
the least time a search call of the port could take, counted from the
call's inputs.

A frozen copy of ``pindel_tpu_torch/tools/measure.py``'s ``fused_bound``
arithmetic over the benchmark's own plain reference (``refpindel``), so a
later change to the port cannot move it.  For one call of ``_close_kernel``
(K2), ``_far_kernel`` (K3) or ``_far_win_kernel`` (K4) the bound is the
larger of

* the int32 operations of the scan over the rows the search needs (K2:
  range 0 whole and range 1 only for reads with no range-0 emission; K3:
  each round only for the reads still active; K4: every row), on the seeded
  lanes of a row with two or more seeds and on every lane of [0, WE) of the
  others, at ``PEAK_INT32_OPS``; and
* the bytes it must move (the payload and the output once, one read of each
  scanned row's chromosome span) at ``PEAK_BYTES``.

The rows and lanes are decided by the plain composition run on the call's
inputs, so the count is the same whatever kernel does the work.
"""
from __future__ import annotations

import torch

from refpindel.ops import engine_fused as ef
from refpindel.ops.scan import seed_counts, sparse_rows

# the H100 SXM's published peaks (NVIDIA's H100 datasheet, at its 700 W
# limit): HBM bytes/s, and the int32 rate from the float32 rate outside the
# tensor cores (67e12 with an FMA counted as two operations: 64 int32
# operations an SM and clock, a quarter of it)
PEAK_BYTES = 3.35e12
PEAK_INT32_OPS = 67e12 / 4
# int32 operations per candidate of the scan: 7 per word of four steps of
# pass 1 (over the read's counted steps), 8 per step of pass 2 (over lsteps)
PASS1_OPS_PER_WORD = 7
PASS2_OPS = 8

KERNELS = {"close": "_close_kernel", "far": "_far_kernel",
           "far_win": "_far_win_kernel"}
_PLAIN = {"_close_kernel": "_close_kernel_ref", "_far_kernel":
          "_far_kernel_ref", "_far_win_kernel": "_far_win_kernel_ref"}


def row_classes(args, kw):
    """Seeds per row and the rows walked on the sparse branch."""
    tiles, qq, valid_w, qlen, _thr, off = args
    seeds = seed_counts(tiles, qq, valid_w, off, lmax=kw["lmax"])
    return seeds, sparse_rows(seeds, valid_w, qlen, w=kw["w"],
                              lmax=kw["lmax"], lsteps=kw["lsteps"])


def scan_ops(args, kw, seeds, sparse) -> float:
    """The int32 operations of one scan call's rows."""
    tiles, qlen = args[0], args[3]
    lsteps = kw["lsteps"] or kw["lmax"]
    we = tiles.shape[1] - kw["lmax"]
    steps1 = (torch.clamp(qlen.double(), max=lsteps) - 1).clamp(min=0)
    per_lane = steps1 * PASS1_OPS_PER_WORD / 4 + lsteps * PASS2_OPS
    lanes = torch.where(sparse, seeds, we)
    return float((lanes * per_lane).sum())


def composition(name, chromcat, payload, maxmm, static):
    """The plain composition of a call: its output, its scan calls as
    (args, kw) and, per scan call, the emission rules' (any_emit, last) of
    group 0."""
    scans, rules = [], []
    real_scan, real_rules = ef.scan_rows, ef._emit_rules

    def scan(*a, **kw):
        scans.append((a, kw))
        return real_scan(*a, **kw)

    def emit_rules(*a, **kw):
        out = real_rules(*a, **kw)
        rules.append((out[3][:, 0], out[4][:, 0]))
        return out

    ef.scan_rows, ef._emit_rules = scan, emit_rules
    try:
        with torch.inference_mode():
            out = getattr(ef, _PLAIN[name])(chromcat, payload, maxmm,
                                            **static)
    finally:
        ef.scan_rows, ef._emit_rules = real_scan, real_rules
    return out, scans, rules


def needed_rows(name, payload, static, out, rules):
    """Per scan call of the composition, the rows (two a read) the search
    needs."""
    lmax = static["lmax"]
    flags = out[:, lmax // 32 + 1]
    if name == "_far_win_kernel":
        reads = [torch.ones_like(flags, dtype=torch.bool)]
    elif name == "_close_kernel":
        reads = [torch.ones_like(flags, dtype=torch.bool)]
        if static["with_r1"]:
            reads.append((flags & 255) >= 2)
    else:
        _codes, meta = ef._unpack_payload(payload, lmax, ef.FM_WORDS)
        qlen = meta[:, 1] & 0x3ff
        close_max = (meta[:, 1] >> 10) & 0x3ff
        st_max = (meta[:, 1] >> 20) & 0x3ff
        reads = []
        for any_emit, last in rules:
            active = close_max + st_max < qlen
            reads.append(active)
            new_max = torch.where(any_emit, last + 1, 0)
            st_max = torch.where(active & (new_max >= st_max), new_max,
                                 st_max)
    return [r.repeat_interleave(2) for r in reads]


def call_bound(name, chromcat, payload, maxmm, static) -> dict:
    """The least time of one call, in seconds, what bounds it, and its
    operations and bytes."""
    out, scans, rules = composition(name, chromcat, payload, maxmm, static)
    ops = 0.0
    nbytes = payload.numel() * payload.element_size() \
        + out.numel() * out.element_size()
    for (args, kw), rows in zip(scans, needed_rows(name, payload, static,
                                                   out, rules)):
        idx = rows.nonzero().flatten()
        sub = [a.index_select(0, idx) for a in args]
        seeds, sparse = row_classes(sub, kw)
        ops += scan_ops(sub, kw, seeds, sparse)
        nbytes += len(idx) * args[0].shape[1]
    t_ops, t_bytes = ops / PEAK_INT32_OPS, nbytes / PEAK_BYTES
    return dict(seconds=max(t_ops, t_bytes), ops=ops, bytes=nbytes,
                bound_by="operations" if t_ops >= t_bytes else "bytes")
