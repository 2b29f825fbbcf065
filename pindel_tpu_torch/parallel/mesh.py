"""Window-parallel sharded search over a grid of torch devices (port of
pindel_tpu/parallel/mesh.py, K9).

The JAX module shards K8's per-lane search over a 2-D mesh: ``dp`` splits
the read batch, ``wp`` splits every lane's candidate columns, and a
``pmin``/``psum`` over ``wp`` rebuilds the global per-length statistics at
each step.  Here shard ``(i, k)`` runs on ``devices[i * wp + k]``: it takes
the rows of batch slice ``i`` and the columns ``[k * w_local, (k + 1) *
w_local)`` and returns the per-step partials of ops/sharded_search.py (the
CUDA shard kernel on a card, its plain twin on the CPU).  Every shard is
launched before any result is downloaded; then each batch slice merges its
shards' partials once, on its first device, recounts the representatives'
whole-read mismatches and applies the emission rules.  No collective runs
per step.  A device listed twice runs its shards one after the other.

Neither package's CLI reaches this backend: it is driven through
``sharded_search`` (the counterpart of ``build_sharded_search``'s function)
or ``TorchShardedBackend`` under a ``Searcher``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch

from pindel_tpu_torch.ops import sharded_search as ss
from pindel_tpu_torch.ops.engine_jax import decode_emissions, pack_lanes
from pindel_tpu_torch.parallel.mesh_fused import normalize
from pindel_tpu_torch.profiling import g_timer

W_BUCKETS = (128, 512, 2048, 8192, 32768)


@dataclasses.dataclass(frozen=True)
class Grid:
    """``dp`` x ``wp`` devices, row-major: shard (i, k) is
    ``devices[i * wp + k]``."""
    devices: Tuple[torch.device, ...]
    dp: int
    wp: int

    def shard(self, i: int, k: int) -> torch.device:
        return self.devices[i * self.wp + k]


def make_grid(devices: Sequence, dp: int = None) -> Grid:
    """The grid over ``devices`` (as ``make_mesh``: ``dp`` defaults to 2 when
    the count is even, else 1; ``wp = n // dp``)."""
    devs = tuple(normalize(d) for d in devices)
    n = len(devs)
    if n == 0:
        raise ValueError("the sharded search needs at least one device")
    if dp is None:
        dp = 2 if n % 2 == 0 else 1
    if dp < 1 or n % dp:
        raise ValueError(f"dp={dp} does not divide {n} devices")
    return Grid(devs, dp, n // dp)


def _replicas(chrom, grid: Grid):
    """The chromosome on every distinct device of the grid."""
    host = torch.from_numpy(np.array(chrom, dtype=np.int8))
    return {dev: host.to(dev) for dev in dict.fromkeys(grid.devices)}


def _search(chroms, slice_start, reverse, qq, valid_w, qlen, max_snp,
            tsec_minus, maxmm, max_allowed, *, grid: Grid, w_total: int,
            lmax: int, nl: int, mpm: int, bp_start: int):
    """``sharded_search`` over chromosome replicas ``chroms`` (device ->
    tensor); host arrays in, five host arrays out."""
    if w_total % grid.wp:
        raise ValueError(f"w_total {w_total} does not split over "
                         f"wp={grid.wp}")
    b = qq.shape[0]
    if b % grid.dp:
        raise ValueError(f"{b} rows do not split over dp={grid.dp}")
    if nl * w_total >= ss.BIGKEY:
        raise ValueError(f"keys of {nl} lanes x {w_total} columns reach "
                         "2^30")
    w_local = w_total // grid.wp
    chrom_len = next(iter(chroms.values())).shape[0]
    if chrom_len < w_local + lmax:
        raise ValueError(f"chromosome of {chrom_len} codes is shorter than "
                         f"a tile of {w_local + lmax}")
    rows = b // grid.dp
    host = dict(slice_start=np.asarray(slice_start, np.int32),
                reverse=np.asarray(reverse, bool),
                qq=np.asarray(qq, np.int8),
                valid_w=np.asarray(valid_w, np.int32),
                max_snp=np.asarray(max_snp, np.int32),
                tsec_minus=np.asarray(tsec_minus, np.int32),
                qlen=np.asarray(qlen, np.int32),
                max_allowed=np.asarray(max_allowed, np.float32))
    # budgets at and past the DEAD level as the JAX function takes them: a
    # live candidate at 127 counts with the dead ones
    t_levels, s_levels = ss.levels(int(host["max_snp"].max(initial=0)),
                                   int(host["tsec_minus"].max(initial=0)),
                                   lmax)
    kw = dict(w_total=w_total, w_local=w_local, lmax=lmax, nl=nl, mpm=mpm,
              t_levels=t_levels, s_levels=s_levels)
    with torch.inference_mode():
        # launch every shard before any download
        inputs, parts = {}, {}
        for i in range(grid.dp):
            for k in range(grid.wp):
                dev = grid.shard(i, k)
                if (i, dev) not in inputs:
                    inputs[i, dev] = {
                        name: torch.from_numpy(np.ascontiguousarray(
                            a[i * rows:(i + 1) * rows])).to(dev)
                        for name, a in host.items()}
                x = inputs[i, dev]
                parts[i, k] = ss.shard_partials(
                    chroms[dev], x["slice_start"], x["reverse"], x["qq"],
                    x["valid_w"], x["max_snp"], x["tsec_minus"],
                    off=k * w_local, **kw)
        maxmm_t = torch.from_numpy(np.array(maxmm, np.int32))
        outs = []
        for i in range(grid.dp):
            lead = grid.shard(i, 0)
            x = inputs[i, lead]
            merged = ss.merge_partials(
                [parts[i, k][0].to(lead) for k in range(grid.wp)],
                [parts[i, k][1].to(lead) for k in range(grid.wp)],
                x["max_snp"], x["tsec_minus"])
            if s_levels >= ss.DEAD:
                merged = ss.dead_rep_strict(
                    merged, chroms[lead], x["slice_start"], x["reverse"],
                    x["qq"], w_total=w_total, w_local=w_local, lmax=lmax,
                    mpm=mpm)
            full_mm = ss.recount(chroms[lead], x["slice_start"],
                                 x["reverse"], x["qq"], x["qlen"],
                                 merged[3], w_total=w_total,
                                 w_local=w_local, lmax=lmax)
            outs.append(ss.finish(merged, full_mm, x["reverse"], x["qlen"],
                                  x["max_snp"], maxmm_t.to(lead),
                                  x["max_allowed"], w_total=w_total,
                                  lmax=lmax, mpm=mpm, bp_start=bp_start))
        return tuple(np.concatenate([o[j].cpu().numpy() for o in outs])
                     for j in range(5))


def sharded_search(chrom, slice_start, reverse, qq, valid_w, qlen, max_snp,
                   tsec_minus, maxmm, max_allowed, *, grid: Grid,
                   w_total: int, lmax: int, nl: int, mpm: int,
                   bp_start: int):
    """The function ``build_sharded_search`` returns, array for array: the
    batch split over ``grid.dp``, the candidate window over ``grid.wp``.
    Returns ``emit`` (bool), ``min_mm``, ``rep_lane``, ``rep_w`` and
    ``full_mm`` (int32), each [B, lmax], as NumPy arrays."""
    return _search(_replicas(chrom, grid), slice_start, reverse, qq,
                   valid_w, qlen, max_snp, tsec_minus, maxmm, max_allowed,
                   grid=grid, w_total=w_total, lmax=lmax, nl=nl, mpm=mpm,
                   bp_start=bp_start)


class TorchShardedBackend:
    """Searcher backend over a device grid (counterpart of
    ``ShardedJaxBackend``; the lane packing is ``TorchLaneBackend``'s)."""

    def __init__(self, settings, maxmm, chrom_codes, devices: Sequence,
                 dp: int = None):
        self.mpm = settings.min_perfect_match_around_bp
        self.rate = settings.max_allowed_mismatch_rate
        self.maxmm = np.asarray(maxmm, dtype=np.int32)
        self.grid = make_grid(devices, dp)
        self.dp, self.wp = self.grid.dp, self.grid.wp
        self.chroms = _replicas(chrom_codes, self.grid)

    def _bucket(self, width: int) -> int:
        for b in W_BUCKETS:
            if width <= b:
                return (b + self.wp - 1) // self.wp * self.wp
        m = self.wp * 1024
        return (width + m - 1) // m * m

    def run(self, batch_lanes, bp_start, max_snps, tsec_minus) -> List:
        from pindel_tpu_torch.genome import SPACER
        if not batch_lanes:
            return []
        with g_timer.phase("sharded: pack lanes"):
            nl = max(len(lanes) for lanes in batch_lanes)
            widths = [max((ln.end - ln.start) for ln in lanes)
                      if lanes else 1 for lanes in batch_lanes]
            w = self._bucket(max(max(widths), 1))
            qlens = [int(lanes[0].query.shape[0]) for lanes in batch_lanes]
            lmax = (max(qlens) + 31) // 32 * 32
            if w + lmax > SPACER:
                raise ValueError(f"window bucket {w}+{lmax} exceeds the "
                                 f"spacer ({SPACER}): a tile would read "
                                 "the neighbouring chromosome")

            b = len(batch_lanes)
            b_pad = (b + self.dp - 1) // self.dp * self.dp
            (slice_start, rev, qq, valid_w, lane_fwd, lane_dir_minus,
             lane_strand_minus, lane_chr) = pack_lanes(batch_lanes, b_pad, nl,
                                                       w, lmax)

            qlen_a = np.zeros(b_pad, dtype=np.int32)
            qlen_a[:b] = qlens
            ms = np.zeros(b_pad, dtype=np.int32)
            ms[:b] = max_snps
            tm = np.zeros(b_pad, dtype=np.int32)
            tm[:b] = tsec_minus
            max_allowed = np.zeros(b_pad, dtype=np.float32)
            max_allowed[:b] = np.float32(
                np.array(qlens, dtype=np.float64) * np.float64(self.rate))
        with g_timer.phase("sharded: search+xfer"):
            emit, min_mm, rep_lane, rep_w, full_mm = _search(
                self.chroms, slice_start, rev, qq, valid_w, qlen_a, ms, tm,
                self.maxmm, max_allowed, grid=self.grid, w_total=w, lmax=lmax,
                nl=nl, mpm=self.mpm, bp_start=bp_start)
        with g_timer.phase("sharded: decode emissions"):
            emit = emit[:b]
            full_mm = full_mm[:b]
            last = np.where(emit.any(axis=1), emit.shape[1] - 1
                            - np.argmax(emit[:, ::-1], axis=1), 0)
            full_last = full_mm[np.arange(b), last]
            out = decode_emissions(
                emit, min_mm[:b], rep_lane[:b], rep_w[:b], full_last,
                slice_start[:b], w, lmax, lane_fwd[:b], lane_dir_minus[:b],
                lane_strand_minus[:b], lane_chr[:b])
        return out
