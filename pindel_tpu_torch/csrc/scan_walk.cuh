// The per-row walk of the packed-key length scan, shared by the scan kernel
// (scan.cu, which explains the design: the seed lemma, the sparse and dense
// walkers, four steps per shared load, the per-step warp reduction) and the
// fused close/far kernels (fused_search.cu), which run it on tiles read
// straight from the chromosome.
//
// A row is scanned by the nw warps of a group.  The caller
//   1. builds the row's per-step-group query words (build_meta, by the
//      group's threads) and each warp's accumulators (init_acc), then
//      synchronises the group;
//   2. has every warp of the group call walk_row, which picks the row's
//      branch and walks the warp's segments of the row into its own
//      accumulators;
//   3. synchronises the group and folds the warps' pairs (fold_step): step
//      l's kmin and k2.
// Where the row's tile bytes come from is the Tile's business: at(i) reads
// byte i, stage(buf, seg0, n, lane) copies bytes [seg0, seg0 + n) into the
// warp's shared buffer (bytes the walk reads past the tile only feed steps
// at or past lsteps, which it masks).
#pragma once

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace ptscan {

#ifndef SCAN_MAX_K
#define SCAN_MAX_K 6
#endif
#ifndef SCAN_MIN_BLOCKS
#define SCAN_MIN_BLOCKS 24
#endif
constexpr int kMaxK = SCAN_MAX_K;            // candidate slots per lane
constexpr int kMinBlocks = SCAN_MIN_BLOCKS;  // resident warps per SM
constexpr int kMaxWarps = 8;                 // warps per row, at most
// lanes staged per segment, at most: every lane of the widest close bucket
// (w = 2048 at lmax 128), so that a main-path row is one segment; and at
// least, where a row's warps split it
constexpr int kSeg = 2176;
constexpr int kMinSeg = 256;
constexpr int kCodeN = 4;
constexpr int kNever = -(1 << 20);
constexpr int kMaxi = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ constexpr int round16(int x) { return (x + 15) & ~15; }

// Shared memory of a block of nw warps, for ceil(lsteps / 4) step groups
// and segments of seg lanes: the per-group query words and masks, then for
// each warp its per-step accumulators, staged tile segment and the
// segment's seed list.
struct Layout {
  int meta, acc, tile, list, warp, total;
  __host__ __device__ Layout(int ngroups, int nw, int seg)
      : meta(16 * ngroups),
        acc(2 * 4 * 4 * ngroups),
        tile(round16(seg + 4 * ngroups + 8)),
        list(round16(2 * seg)),
        warp(acc + tile + list),
        total(meta + nw * warp) {}
};

// Fold one key into a (min, min over keys != min) pair.
__device__ __forceinline__ void push_key(int &m1, int &m2, int key) {
  if (key < m1) {
    m2 = m1;
    m1 = key;
  } else if (key != m1 && key < m2) {
    m2 = key;
  }
}

// The same for keys known to be distinct.
__device__ __forceinline__ void push_distinct(int &m1, int &m2, int key) {
  m2 = min(m2, max(m1, key));
  m1 = min(m1, key);
}

// Fold two pairs; each has m2 > m1 or m2 == kMaxi.
__device__ __forceinline__ void merge_pair(int &m1, int &m2, int o1, int o2) {
  const int m = min(m1, o1);
  const int s = min(m1 == m ? m2 : m1, o1 == m ? o2 : o1);
  m1 = m;
  m2 = s;
}

// Bit 7 of each byte set where the byte of x is nonzero.
__device__ __forceinline__ uint32_t nonzero_bytes(uint32_t x) {
  return ((x & 0x7f7f7f7fu) + 0x7f7f7f7fu) | x;
}

// What the walker needs of its row and segment (warp-uniform).
struct Row {
  const uint4 *meta;      // per step group: query word, N mask, count mask,
                          // mark mask (bit 7 of each byte)
  int *acc1, *acc2;       // per-step running (min, second min)
  const int8_t *buf;      // staged tile bytes from lane seg0 on
  const int16_t *list;    // seed positions in buf (sparse branch)
  int seg0, lo, hi, off, q0, thr, w, shift, dead, lsteps, mpm, steps1;
};

// The row's scalars: candidates lie in [lo, hi) of [0, we) (none when the
// query starts with N); counted steps are 1 .. steps1 - 1.
__device__ __forceinline__ void init_row(Row &r, int q0, int vw, int ql,
                                         int off, int thr, int we, int w,
                                         int shift, int dead, int lsteps,
                                         int mpm) {
  r.off = off;
  r.thr = thr;
  r.q0 = q0;
  r.w = w;
  r.shift = shift;
  r.dead = dead;
  r.lsteps = lsteps;
  r.mpm = mpm;
  r.steps1 = min(lsteps, ql);
  r.lo = max(off, 0);
  r.hi = q0 == kCodeN ? r.lo : max(r.lo, min(off + vw, we));
}

// Per step group g (four steps): the query word, its N mask, the count mask
// (steps 1 .. steps1 - 1) and the mark mask (steps 1 .. lsteps - 1), built
// by thread `tid` of `nthreads`.
__device__ __forceinline__ void build_meta(uint4 *meta, const int8_t *q,
                                           int lmax, int lsteps, int steps1,
                                           int tid, int nthreads) {
  const int ngroups = (lsteps + 3) >> 2;
  for (int g = tid; g < ngroups; g += nthreads) {
    uint32_t qw = 0, qn = 0, cnt = 0, mark = 0;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int l = 4 * g + s;
      const int qb = l < lmax ? q[l] : kCodeN;
      qw |= static_cast<uint32_t>(qb & 0xff) << (8 * s);
      if (qb == kCodeN) qn |= 0x80u << (8 * s);
      if (l >= 1 && l < steps1) cnt |= 0x80u << (8 * s);
      if (l >= 1 && l < lsteps) mark |= 0x80u << (8 * s);
    }
    meta[g] = make_uint4(qw, qn, cnt, mark);
  }
}

__device__ __forceinline__ void init_acc(int *acc1, int *acc2, int ngroups,
                                         int lane) {
  for (int l = lane; l < 4 * ngroups; l += 32) {
    acc1[l] = kMaxi;
    acc2[l] = kMaxi;
  }
}

// Walk candidates i0 .. i0 + m - 1 of the segment (m <= 32 * K, and
// m > 32 * (K - 1)): pass 1 for the fit bit, then pass 2 with the per-step
// warp reduction folded into the row's accumulators.
template <int K, bool kSparse>
__device__ __forceinline__ void walk(const Row &r, int i0, int m, int lane) {
  const auto *tw = reinterpret_cast<const uint32_t *>(r.buf);
  int wi[K];          // word index of the candidate's first byte
  int sh[K];          // its bit offset in that word
  int keyb[K];
  // slots j < K - 1 are full; the last one holds m - 32 * (K - 1)
  const bool last_ok = lane < m - 32 * (K - 1);
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int slot = lane + 32 * j;
    const bool ok = j < K - 1 || last_ok;
    const int p = !ok ? 0 : kSparse ? r.list[i0 + slot] : i0 + slot;
    wi[j] = p >> 2;
    sh[j] = (p & 3) * 8;
    const int c = r.seg0 + p;
    const bool seeded =
        kSparse || (r.buf[p] == r.q0 && c >= r.lo && c < r.hi);
    const int woff = min(max(c - r.off, 0), r.w - 1);
    keyb[j] = ((seeded ? 0 : r.dead) << r.shift) | (woff << 2);
  }

  // ---- pass 1: Matches() mismatch totals over steps 1 .. steps1 - 1
  uint32_t prev[K];
  int total[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    prev[j] = tw[wi[j]];
    total[j] = 0;
  }
  const int ng1 = (r.steps1 + 3) >> 2;
  for (int g = 0; g < ng1; ++g) {
    const uint4 mt = r.meta[g];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const uint32_t nxt = tw[wi[j] + g + 1];
      const uint32_t tb = __funnelshift_r(prev[j], nxt, sh[j]);
      prev[j] = nxt;
      total[j] += __popc((nonzero_bytes(tb ^ mt.x) ^ mt.y) & mt.z);
    }
  }
#pragma unroll
  for (int j = 0; j < K; ++j) keyb[j] |= total[j] < r.thr ? 1 : 0;

  // ---- pass 2: the scan proper
  int last[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    prev[j] = tw[wi[j]];
    last[j] = kNever;
  }
  const int inc = 1 << r.shift;
  const int ngroups = (r.lsteps + 3) >> 2;
  int r1 = kMaxi;     // this lane's step of the current 32-step block
  int r2 = kMaxi;
  for (int g = 0; g < ngroups; ++g) {
    const uint4 mt = r.meta[g];
    uint32_t y[K];    // bit 7 of byte s: strict mismatch at step 4g + s
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const uint32_t nxt = tw[wi[j] + g + 1];
      y[j] = nonzero_bytes(__funnelshift_r(prev[j], nxt, sh[j]) ^ mt.x);
      prev[j] = nxt;
    }
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int l = 4 * g + s;
      if (l >= r.lsteps) break;
      const uint32_t bit = 0x80u << (8 * s);
      const uint32_t count = mt.z & bit;   // the step counts
      const uint32_t mark = mt.w & bit;    // the step is marked
      const int lim = l - r.mpm;
      int m1 = kMaxi;
      int m2 = kMaxi;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        if ((y[j] ^ mt.y) & count) keyb[j] += inc;
        if (y[j] & mark) last[j] = l;
        const int key = keyb[j] + (last[j] > lim ? 2 : 0);
        if (j < K - 1 || last_ok) {
          if (kSparse) push_distinct(m1, m2, key);
          else push_key(m1, m2, key);
        }
      }
      const int mn = __reduce_min_sync(kFull, m1);
      const int sc = __reduce_min_sync(kFull, m1 == mn ? m2 : m1);
      if (lane == (l & 31)) {
        r1 = mn;
        r2 = sc;
      }
      if ((l & 31) == 31 || l == r.lsteps - 1) {
        const int lb = (l & ~31) + lane;
        if (lb <= l) {
          int a1 = r.acc1[lb];
          int a2 = r.acc2[lb];
          merge_pair(a1, a2, r1, r2);
          r.acc1[lb] = a1;
          r.acc2[lb] = a2;
        }
      }
    }
  }
}

// Walk m candidates with the least K that holds them.
template <int K, bool kSparse>
__device__ void walk_chunk(const Row &r, int i0, int m, int lane) {
  if constexpr (K < kMaxK) {
    if (m > 32 * K) {
      walk_chunk<K + 1, kSparse>(r, i0, m, lane);
      return;
    }
  }
  walk<K, kSparse>(r, i0, m, lane);
}

// One warp's share of a row: warp gw of the group's nw walks segments gw,
// gw + nw, ... of seg lanes each into its accumulators (r.acc1, r.acc2).
// Every warp counts the row's seeds (up to two) from the tile itself, so
// all of them pick the same branch.  buf and list are the warp's staged
// segment and seed list (r.buf and r.list alias them).
template <class Tile>
__device__ __forceinline__ void walk_row(Row &r, const Tile &tile, int vw,
                                         int we, int seg, int nw, int gw,
                                         int lane, int8_t *buf,
                                         int16_t *list) {
  r.buf = buf;
  r.list = list;
  int nseed = 0;
  for (int c0 = r.lo; c0 < r.hi && nseed < 2; c0 += 32) {
    const int c = c0 + lane;
    nseed += __popc(__ballot_sync(kFull, c < r.hi && tile.at(c) == r.q0));
  }
  const bool sparse = nseed >= 2 && vw <= r.w && r.steps1 <= r.dead;
  const int ngroups = (r.lsteps + 3) >> 2;

  const int end = sparse ? r.hi : we;
  for (int seg0 = gw * seg; seg0 < end; seg0 += nw * seg) {
    const int segn = min(seg, we - seg0);
    tile.stage(buf, seg0, segn + 4 * ngroups + 4, lane);
    r.seg0 = seg0;
    int n = segn;
    if (sparse) {
      // compact the segment's seeds, lanes [lo, hi) of it, in order
      const int a = max(r.lo - seg0, 0);
      const int b = min(r.hi - seg0, segn);
      n = 0;
      for (int i0 = a; i0 < b; i0 += 32) {
        const int i = i0 + lane;
        const bool seed = i < b && buf[i] == r.q0;
        const unsigned bal = __ballot_sync(kFull, seed);
        if (seed) list[n + __popc(bal & ((1u << lane) - 1))] = i;
        n += __popc(bal);
      }
      __syncwarp();
    }
    for (int i0 = 0; i0 < n; i0 += 32 * kMaxK) {
      const int m = min(32 * kMaxK, n - i0);
      if (sparse) walk_chunk<1, true>(r, i0, m, lane);
      else walk_chunk<1, false>(r, i0, m, lane);
    }
  }
}

// Step l's (kmin, k2) over the nw warps of a group whose accumulators start
// at `first`, `stride` bytes apart (acc1 at the start, acc2 4 * ngroups ints
// on); zeros at and past lsteps.
template <int NW>
__device__ __forceinline__ void fold_step(const unsigned char *first,
                                          int stride, int ngroups, int l,
                                          int lsteps, int &kmin, int &k2) {
  if (l >= lsteps) {
    kmin = 0;
    k2 = 0;
    return;
  }
  int a1 = kMaxi;
  int a2 = kMaxi;
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    const auto *acc = reinterpret_cast<const int *>(first + k * stride);
    merge_pair(a1, a2, acc[l], acc[4 * ngroups + l]);
  }
  kmin = a1;
  k2 = a2;
}

}  // namespace ptscan
