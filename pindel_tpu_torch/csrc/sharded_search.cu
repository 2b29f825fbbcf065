// Per-shard partials of the window-parallel search for Hopper (sm_90a).
//
// Replaces one shard's step of pindel_tpu/parallel/mesh.py:
// _search_step_local (XLA under shard_map, with a pmin/psum over the wp
// axis at every step), and through it the per-lane search of
// pindel_tpu/ops/engine_jax.py:_search_kernel (one shard over the whole
// window).  One call computes, for the rows of one batch slice and the
// candidate columns [off, off + w_local) of every lane, at every step
// l < lmax:
//     cnt[row, l, v]  candidates at level v, v = 0..T, and at DEAD (v = T+1)
//     key[row, l, v]  min of 2 * key + strict_bad over the candidates at
//                     level v, v = 0..S, and min of 2 * key over the DEAD
//                     candidates (v = S+1); 0x7fffffff where there is none
// with key = lane * w_total + global column.  One sum and one min of these
// over the shards rebuild the JAX function's per-step min level, counts,
// representative and its strict bit (merge_partials in
// pindel_tpu_torch/ops/sharded_search.py, whose shard_partials_ref is the
// plain version of this kernel).
//
// The seed lemma.  A candidate's level is its mismatch count while it is
// seeded (tile[u] == q[0], q[0] != N, global column < valid_w) and the
// count is at most tsec_minus, DEAD otherwise.  The count never falls, so
// an unseeded candidate is DEAD at every step and a seeded one is DEAD from
// the step its count first passes tsec_minus to the end.  So only seeded
// candidates are walked, each only until it dies, and the DEAD slots are a
// prefix over the steps of the deaths (the unseeded candidates die at step
// 0).  At step 0 every seeded candidate is at level 0 with no strict
// mismatch (the JAX ring is cleared at step 0).
//
// What bounds it: int32 operations (chip_smoke.py:shard_bound counts them
// as this design does the work: 2 a candidate for the seed test, 24 a
// seeded candidate for its first 8 steps, 13 a step walked after those);
// the bytes (each lane's tile once) take less.  About one candidate in six
// is seeded, and most die within a few steps: on random bases a step
// mismatches three times in four.
//
// Design.
//  * Seed test a word at a time: a lane takes 4 columns of one lane of the
//    row, loads their 4 bases with two aligned word loads and a funnel
//    shift, and compares them with q[0] in one byte compare.  The seeded
//    ones (ballot, popc) go, in column order, to a ring of the warp in
//    shared memory, drained 32 candidates at a time, so every lane of the
//    warp holds one.
//  * Steps 1..8 by pattern.  Where no query of the row has N in steps
//    1..8, a candidate's levels, death and strict bits there follow from
//    its 8-bit strict-mismatch pattern alone (two byte compares of words).
//    A lane adds one to its pattern's count and its key to the pattern's
//    min (256 bins a block) and passes the candidate on only if it is
//    still alive after step 8 (about a third, at the budgets of 100-base
//    reads).  At the block's end each bin adds its count and 2 * key +
//    strict_bad along its pattern's steps.  This replaces the first eight
//    steps of every candidate's walk, the bulk of it.
//  * The survivors are walked on from step 9 in lock step (from step 1 in a
//    row whose queries have N there), a warp at a time, four steps a load;
//    one shared atomic per level the warp holds at a step: __match_any_sync
//    groups the live lanes by level (or death), and the group's lowest lane
//    adds the group's size.  The rings keep the candidates in column order,
//    lanes in order of their keys, so the group's lowest lane also holds
//    its least key.  Deaths go to the DEAD slot of their step as a
//    difference; a last pass turns them into the prefix.
//  * A row splits over several blocks when the call has too few rows to
//    fill the card (K8's small calls: a few reads in a wide window): block
//    (row, part) takes columns [part * cols, (part + 1) * cols) of every
//    lane, and blocks add their partials into the row's output with
//    global atomics (a sum of counts, a min of keys and of the death
//    differences is order-free, so the split changes no bit).
//  * The histograms of a block sit in shared memory; where lmax * (T + S +
//    4) words do not fit, the block adds straight into the output in
//    device memory instead (slower, same bits).
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 4;                    // columns a lane tests at once
constexpr int kRing1 = 160;                 // seeded candidates, per warp
constexpr int kRing2 = 64;                  // survivors of step 8, per warp
constexpr int kPattern = 8;                 // steps resolved by pattern
constexpr int kBins = 1 << kPattern;
constexpr int kN = 4;                       // dna.N
constexpr int kNoKey = 0x7fffffff;
constexpr int kNever = -(1 << 20);
constexpr unsigned kFull = 0xffffffffu;

// int32 words of dynamic shared memory: per warp its two rings (key, tile
// position, lane; the second also the level and last strict step), the
// block's pattern bins and, when they fit, its histograms
constexpr int kWarpWords = 3 * kRing1 + 5 * kRing2;
constexpr int kFixedWords = kWarps * kWarpWords + 2 * kBins;
size_t hist_bytes(int lmax, int t_levels, int s_levels) {
  return sizeof(int32_t) * static_cast<size_t>(lmax) *
         (t_levels + 2 + s_levels + 2);
}

__global__ void fill_kernel(int32_t *__restrict__ cnt, size_t n_cnt,
                            int32_t *__restrict__ key, size_t n_key) {
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       i < n_cnt + n_key; i += stride) {
    if (i < n_cnt)
      cnt[i] = 0;
    else
      key[i - n_cnt] = kNoKey;
  }
}

struct Params {
  const int8_t *chrom;
  long long chrom_len;
  const int32_t *slice_start;
  const uint8_t *reverse;
  const int8_t *qq;
  const int32_t *valid_w;
  const int32_t *tsec_minus;
  int32_t *cnt;
  int32_t *key;
  int nl, w_total, w_local, off, lmax, mpm, t_levels, s_levels, splits;
};

// the shard's tile start of lane j of a row, as jax.lax.dynamic_slice takes
// it: backward tiles advance from the window's other end, a negative start
// wraps by the chromosome's length, then the start is clamped
__device__ long long tile_start(const Params &p, int idx, bool rv) {
  long long st = static_cast<long long>(p.slice_start[idx]) +
                 (rv ? (p.w_total - p.w_local - p.off) : p.off);
  if (st < 0) st += p.chrom_len;
  st = st < 0 ? 0 : st;
  const long long hi = p.chrom_len - (p.w_local + p.lmax);
  return st > hi ? hi : st;
}

// The DEAD slots of one row from its deaths per step: a prefix sum of the
// counts ``c[l * tw]`` and a prefix min of the keys ``k[l * sw]`` over the
// steps, by one warp.
__device__ void dead_prefix(int32_t *c, int32_t *k, int lmax, int tw,
                            int sw) {
  const int lane = threadIdx.x & 31;
  int carry_c = 0, carry_k = kNoKey;
  for (int base = 0; base < lmax; base += 32) {
    const int l = base + lane;
    int vc = l < lmax ? c[static_cast<size_t>(l) * tw] : 0;
    int vk = l < lmax ? k[static_cast<size_t>(l) * sw] : kNoKey;
    for (int d = 1; d < 32; d *= 2) {
      const int oc = __shfl_up_sync(kFull, vc, d);
      const int ok = __shfl_up_sync(kFull, vk, d);
      if (lane >= d) {
        vc += oc;
        vk = min(vk, ok);
      }
    }
    vc += carry_c;
    vk = min(vk, carry_k);
    if (l < lmax) {
      c[static_cast<size_t>(l) * tw] = vc;
      k[static_cast<size_t>(l) * sw] = vk;
    }
    carry_c = __shfl_sync(kFull, vc, 31);
    carry_k = __shfl_sync(kFull, vk, 31);
  }
}

// a slot of a ring of n entries
__device__ __forceinline__ int wrap(int i, int n) { return i >= n ? i - n : i; }

// a warp's two rings and its place in them (heads and counts, the same in
// every lane)
struct Rings {
  int32_t *key1, *pos1, *lane1;                  // seeded candidates
  int32_t *key2, *pos2, *lane2, *cum2, *last2;   // alive after the pattern
  int head1, n1, head2, n2;
};

// The lanes' candidates in lock step (``live`` says which lanes hold one;
// lanes hold increasing keys) from step ``start`` at level ``cum`` (last
// strict mismatch at step ``last``) until each dies or lmax - 1.  The query
// word and the tile bases of four steps are loaded together, so that their
// latency is paid once for four steps (lmax is a multiple of 4).
__device__ void walk(const Params &p, int row, int tm, bool live, int key,
                     int pos, int j, int start, int cum, int last,
                     int32_t *h_cnt, int32_t *h_key) {
  const int lane = threadIdx.x & 31;
  const int tw = p.t_levels + 2, sw = p.s_levels + 2;
  const int key2 = key * 2;
  bool rv = false;
  const uint32_t *q = reinterpret_cast<const uint32_t *>(p.qq);
  if (live) {
    rv = p.reverse[row * p.nl + j] != 0;
    q += (static_cast<size_t>(row) * p.nl + j) * (p.lmax / 4);
  }
  const int dir = rv ? -1 : 1;
  for (int l0 = start & ~3; l0 < p.lmax; l0 += 4) {
    if (!__any_sync(kFull, live)) break;
    uint32_t qw = 0;
    int8_t r[4] = {0, 0, 0, 0};
    if (live) {
      qw = __ldg(q + l0 / 4);
#pragma unroll
      for (int k = 0; k < 4; ++k) r[k] = __ldg(p.chrom + pos + dir * (l0 + k));
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int l = l0 + k;
      const unsigned act = __ballot_sync(kFull, live);
      if (l < start || !live) continue;
      const int qb = (qw >> (8 * k)) & 0xff;
      const int strict = r[k] != qb;
      cum += strict ^ (qb == kN);
      last = strict ? l : last;
      const bool dead = cum > tm;
      const int slot = dead ? p.t_levels + 1 : cum;
      const unsigned grp = __match_any_sync(act, slot);
      if (__ffs(grp) - 1 == lane) {
        atomicAdd(&h_cnt[l * tw + slot], __popc(grp));
        if (dead)
          atomicMin(&h_key[l * sw + p.s_levels + 1], key2);
        else if (cum <= p.s_levels)
          atomicMin(&h_key[l * sw + cum],
                    key2 | (last > l - p.mpm ? 1 : 0));
      }
      live = !dead;
    }
  }
}

// Walks ``n`` (at most 32) candidates of the warp's second ring on from
// step ``steps`` + 1.
__device__ void drain2(const Params &p, int row, int tm, Rings &g, int n,
                       int steps, int32_t *h_cnt, int32_t *h_key) {
  const int lane = threadIdx.x & 31;
  const bool live = lane < n;
  const int s = wrap(g.head2 + lane, kRing2);
  walk(p, row, tm, live, live ? g.key2[s] : 0, live ? g.pos2[s] : 0,
       live ? g.lane2[s] : 0, steps + 1, live ? g.cum2[s] : 0,
       live ? g.last2[s] : kNever, h_cnt, h_key);
  g.head2 = wrap(g.head2 + n, kRing2);
  g.n2 -= n;
}

// Resolves ``n`` (at most 32) candidates of the warp's first ring over
// steps 1..steps by their strict-mismatch pattern: each adds itself to its
// pattern's bin, and those still alive after ``steps`` go to the second
// ring, which is walked on whenever it holds 32.
__device__ void drain1(const Params &p, int row, int tm, Rings &g, int n,
                       int steps, int32_t *bin_cnt, int32_t *bin_key,
                       int32_t *h_cnt, int32_t *h_key) {
  const int lane = threadIdx.x & 31;
  const bool live = lane < n;
  const int s = wrap(g.head1 + lane, kRing1);
  int key = 0, pos = 0, j = 0;
  unsigned pattern = 0;                     // bit l - 1: step l strict
  if (live) {
    key = g.key1[s];
    pos = g.pos1[s];
    j = g.lane1[s];
    const bool rv = p.reverse[row * p.nl + j] != 0;
    const int8_t *q = p.qq + (static_cast<size_t>(row) * p.nl + j) * p.lmax;
    // the 8 bases of steps 1..8 as two words: three aligned loads of the
    // tile and of the query, funnel shifts, byte compares
    const int lo = rv ? pos - kPattern : pos + 1;
    const int al = lo & ~3;
    if (steps == kPattern && p.lmax >= 12 && al >= 0 &&
        al + 12 <= p.chrom_len) {
      const uint32_t *w = reinterpret_cast<const uint32_t *>(p.chrom + al);
      const uint32_t *qw = reinterpret_cast<const uint32_t *>(q);
      const uint32_t w0 = __ldg(w), w1 = __ldg(w + 1), w2 = __ldg(w + 2);
      const uint32_t q0 = __ldg(qw), q1 = __ldg(qw + 1), q2 = __ldg(qw + 2);
      uint32_t a = __funnelshift_r(w0, w1, 8 * (lo - al));
      uint32_t b = __funnelshift_r(w1, w2, 8 * (lo - al));
      if (rv) {        // step l is base pos - l: the words reversed, swapped
        const uint32_t t = __byte_perm(a, 0, 0x0123);
        a = __byte_perm(b, 0, 0x0123);
        b = t;
      }
      const uint32_t ne1 =
          __vcmpne4(a, __funnelshift_r(q0, q1, 8)) & 0x08040201u;
      const uint32_t ne2 =
          __vcmpne4(b, __funnelshift_r(q1, q2, 8)) & 0x08040201u;
      pattern = ((ne1 * 0x01010101u) >> 24) |
                (((ne2 * 0x01010101u) >> 24) << 4);
    } else {
      const int dir = rv ? -1 : 1;
      for (int l = 1; l <= steps; ++l)
        pattern |= static_cast<unsigned>(__ldg(p.chrom + pos + dir * l) !=
                                         __ldg(q + l)) << (l - 1);
    }
    if (steps) {
      atomicAdd(&bin_cnt[pattern], 1);
      atomicMin(&bin_key[pattern], key * 2);
    }
  }
  g.head1 = wrap(g.head1 + n, kRing1);
  g.n1 -= n;
  // no N in these steps: the level is the number of strict mismatches
  const bool alive = live && __popc(pattern) <= tm;
  const unsigned m = __ballot_sync(kFull, alive);
  if (alive) {
    const int t = wrap(g.head2 + g.n2 + __popc(m & ((1u << lane) - 1)),
                       kRing2);
    g.key2[t] = key;
    g.pos2[t] = pos;
    g.lane2[t] = j;
    g.cum2[t] = __popc(pattern);
    g.last2[t] = pattern ? 32 - __clz(pattern) : kNever;
  }
  g.n2 += __popc(m);
  __syncwarp();
  if (g.n2 >= 32) drain2(p, row, tm, g, 32, steps, h_cnt, h_key);
}

// kShared: the block's histograms sit in shared memory (a template
// parameter, so that the compiler sees shared pointers and issues shared
// atomics)
template <bool kShared>
__global__ void __launch_bounds__(kThreads) shard_kernel(Params p) {
  extern __shared__ __align__(16) int32_t smem[];
  const int row = blockIdx.x / p.splits;
  const int part = blockIdx.x - row * p.splits;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tw = p.t_levels + 2, sw = p.s_levels + 2;
  const int hist_cnt = p.lmax * tw, hist_key = p.lmax * sw;
  Rings g;
  g.key1 = smem + warp * kWarpWords;
  g.pos1 = g.key1 + kRing1;
  g.lane1 = g.pos1 + kRing1;
  g.key2 = g.lane1 + kRing1;
  g.pos2 = g.key2 + kRing2;
  g.lane2 = g.pos2 + kRing2;
  g.cum2 = g.lane2 + kRing2;
  g.last2 = g.cum2 + kRing2;
  g.head1 = g.n1 = g.head2 = g.n2 = 0;
  int32_t *bin_cnt = smem + kWarps * kWarpWords;
  int32_t *bin_key = bin_cnt + kBins;
  for (int i = tid; i < kBins; i += kThreads) {
    bin_cnt[i] = 0;
    bin_key[i] = kNoKey;
  }
  int32_t *cnt_row = p.cnt + static_cast<size_t>(row) * hist_cnt;
  int32_t *key_row = p.key + static_cast<size_t>(row) * hist_key;
  int32_t *h_cnt = cnt_row, *h_key = key_row;
  if (kShared) {
    h_cnt = smem + kFixedWords;
    h_key = h_cnt + hist_cnt;
    for (int i = tid; i < hist_cnt; i += kThreads) h_cnt[i] = 0;
    for (int i = tid; i < hist_key; i += kThreads) h_key[i] = kNoKey;
  }
  const int tm = p.tsec_minus[row];
  // steps resolved by pattern: the first kPattern, where no query of the
  // row has N there (a query's N turns a match into a mismatch)
  const int steps_max = min(kPattern, p.lmax - 1);
  int has_n = 0;
  for (int i = tid; i < p.nl * steps_max; i += kThreads) {
    const int j = i / steps_max, l = 1 + i - j * steps_max;
    has_n |= p.qq[(static_cast<size_t>(row) * p.nl + j) * p.lmax + l] == kN;
  }
  // (also the barrier after the initialisations above)
  const int steps = __syncthreads_or(has_n) ? 0 : steps_max;

  const int cols = (p.w_local + p.splits - 1) / p.splits;
  const int c_lo = part * cols;
  const int c_hi = min(c_lo + cols, p.w_local);
  const int tile_len = p.w_local + p.lmax;
  const unsigned lt = (1u << lane) - 1;
  int n_unseeded = 0, min_unseeded = kNoKey, n_zero = 0, min_zero = kNoKey;
  for (int j = 0; j < p.nl; ++j) {
    const int idx = row * p.nl + j;
    const bool rv = p.reverse[idx] != 0;
    const int st = static_cast<int>(tile_start(p, idx, rv));
    const int8_t q0 = p.qq[static_cast<size_t>(idx) * p.lmax];
    // columns at or past this one are outside the valid window
    const int seed_hi =
        (q0 == kN || tm < 0) ? 0 : min(max(p.valid_w[idx] - p.off, 0), c_hi);
    const int key_base = j * p.w_total + p.off;
    // tile index u -> chromosome position: st + u, or rev0 - u backward
    const int rev0 = st + tile_len - 1;
    for (int base = c_lo + warp * 32 * kCols; base < c_hi;
         base += kThreads * kCols) {
      const int u0 = base + lane * kCols;
      // bit k: column u0 + k (in the shard's columns; seeded)
      const unsigned in = (1u << min(max(c_hi - u0, 0), kCols)) - 1;
      unsigned seed = 0;
      const int n_valid = min(max(seed_hi - u0, 0), kCols);
      if (n_valid) {
        // the 4 bases as one word, byte k for column u0 + k: two aligned
        // loads and a funnel shift (bytes next to the chromosome's ends
        // one at a time)
        const int lo = rv ? rev0 - u0 - (kCols - 1) : st + u0;
        const int al = lo & ~3;
        uint32_t word = 0;
        if (al >= 0 && al + 8 <= p.chrom_len) {
          const uint32_t *w = reinterpret_cast<const uint32_t *>(p.chrom + al);
          word = __funnelshift_r(__ldg(w), __ldg(w + 1), 8 * (lo - al));
        } else {
          for (int k = 0; k < kCols; ++k)
            if (lo + k >= 0 && lo + k < p.chrom_len)
              word |= static_cast<uint32_t>(
                          static_cast<uint8_t>(__ldg(p.chrom + lo + k)))
                      << (8 * k);
        }
        if (rv) word = __byte_perm(word, 0, 0x0123);
        // equal bytes to bits 0..3
        const uint32_t eq =
            __vcmpeq4(word, static_cast<uint8_t>(q0) * 0x01010101u) &
            0x08040201u;
        seed = ((eq * 0x01010101u) >> 24) & ((1u << n_valid) - 1);
      }
      const unsigned unseeded = in & ~seed;
      // a warp meets its columns in key order: its first is its least
      const unsigned m_un = __ballot_sync(kFull, unseeded != 0);
      if (m_un) {
        if (n_unseeded == 0) {
          const int f = __ffs(m_un) - 1;
          const unsigned bits = __shfl_sync(kFull, unseeded, f);
          min_unseeded = (key_base + base + f * kCols + __ffs(bits) - 1) * 2;
        }
        n_unseeded += __reduce_add_sync(kFull, __popc(unseeded));
      }
      const unsigned m_seed = __ballot_sync(kFull, seed != 0);
      if (!m_seed) continue;
      if (n_zero == 0) {
        const int f = __ffs(m_seed) - 1;
        const unsigned bits = __shfl_sync(kFull, seed, f);
        min_zero = (key_base + base + f * kCols + __ffs(bits) - 1) * 2;
      }
      // ring slots in column order: lanes below, then this lane's bits
      int at = g.n1, total = 0;
#pragma unroll
      for (int k = 0; k < kCols; ++k) {
        const unsigned b = __ballot_sync(kFull, (seed >> k) & 1);
        at += __popc(b & lt);
        total += __popc(b);
      }
      n_zero += total;
      for (unsigned bits = seed; bits; bits &= bits - 1) {
        const int u = u0 + __ffs(bits) - 1;
        const int t = wrap(g.head1 + at, kRing1);
        g.key1[t] = key_base + u;
        g.pos1[t] = rv ? rev0 - u : st + u;
        g.lane1[t] = j;
        ++at;
      }
      g.n1 += total;
      __syncwarp();
      while (g.n1 >= 32)
        drain1(p, row, tm, g, 32, steps, bin_cnt, bin_key, h_cnt, h_key);
    }
  }
  if (g.n1 > 0)
    drain1(p, row, tm, g, g.n1, steps, bin_cnt, bin_key, h_cnt, h_key);
  if (g.n2 > 0) drain2(p, row, tm, g, g.n2, steps, h_cnt, h_key);
  // step 0: the unseeded candidates die, the seeded ones sit at level 0
  if (lane == 0) {
    if (n_unseeded) {
      atomicAdd(&h_cnt[p.t_levels + 1], n_unseeded);
      atomicMin(&h_key[p.s_levels + 1], min_unseeded);
    }
    if (n_zero) {
      atomicAdd(&h_cnt[0], n_zero);
      atomicMin(&h_key[0], min_zero);
    }
  }
  __syncthreads();
  // steps 1..steps of every seeded candidate, by pattern: a thread a bin,
  // the bins at one cell summed (and their keys' least taken) in the warp
  // before one atomic each
  static_assert(kBins == kThreads, "one pattern bin a thread");
  if (steps) {
    const int c = bin_cnt[tid], k2 = bin_key[tid];
    bool alive = c > 0;
    int cum = 0;
    for (int l = 1; l <= steps; ++l) {
      int slot = -1, kval = kNoKey, kslot = 0;
      if (alive) {
        cum += (tid >> (l - 1)) & 1;
        if (cum > tm) {
          slot = p.t_levels + 1;
          kslot = p.s_levels + 1;
          kval = k2;
          alive = false;
        } else {
          slot = kslot = cum;
          // a strict mismatch at one of the steps (l - mpm, l]: bits
          // lo..l-1 of the pattern
          const int lo = max(l - p.mpm, 0);
          const unsigned ring = l > lo ? ((1u << (l - lo)) - 1) << lo : 0u;
          if (cum <= p.s_levels) kval = k2 | ((tid & ring) ? 1 : 0);
        }
      }
      const unsigned act = __ballot_sync(kFull, slot >= 0);
      if (slot >= 0) {
        const unsigned grp = __match_any_sync(act, slot);
        const int sum = __reduce_add_sync(grp, c);
        const int least = __reduce_min_sync(grp, kval);
        if (__ffs(grp) - 1 == lane) {
          atomicAdd(&h_cnt[l * tw + slot], sum);
          if (least != kNoKey) atomicMin(&h_key[l * sw + kslot], least);
        }
      }
    }
  }
  if (!kShared) return;
  __syncthreads();
  if (p.splits == 1) {
    // the block owns its row: it turns the deaths into the DEAD slots
    if (warp == 0)
      dead_prefix(h_cnt + p.t_levels + 1, h_key + p.s_levels + 1, p.lmax, tw,
                  sw);
    __syncthreads();
    for (int i = tid; i < hist_cnt; i += kThreads) cnt_row[i] = h_cnt[i];
    for (int i = tid; i < hist_key; i += kThreads) key_row[i] = h_key[i];
  } else {
    for (int i = tid; i < hist_cnt; i += kThreads)
      if (h_cnt[i]) atomicAdd(&cnt_row[i], h_cnt[i]);
    for (int i = tid; i < hist_key; i += kThreads)
      if (h_key[i] != kNoKey) atomicMin(&key_row[i], h_key[i]);
  }
}

// the DEAD slots of rows whose blocks added into device memory, one warp a
// row
__global__ void dead_prefix_kernel(int32_t *__restrict__ cnt,
                                   int32_t *__restrict__ key, int rows,
                                   int lmax, int t_levels, int s_levels) {
  const int row = blockIdx.x * (blockDim.x / 32) + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int tw = t_levels + 2, sw = s_levels + 2;
  dead_prefix(cnt + static_cast<size_t>(row) * lmax * tw + t_levels + 1,
              key + static_cast<size_t>(row) * lmax * sw + s_levels + 1,
              lmax, tw, sw);
}

}  // namespace

// dynamic shared memory of a block that keeps its histograms there
extern "C" size_t pt_shard_smem(int lmax, int t_levels, int s_levels) {
  return sizeof(int32_t) * kFixedWords + hist_bytes(lmax, t_levels, s_levels);
}

extern "C" int pt_shard_partials(const void *chrom, long long chrom_len,
                                 const void *slice_start,
                                 const void *reverse, const void *qq,
                                 const void *valid_w, const void *tsec_minus,
                                 void *cnt, void *key, int rows, int nl,
                                 int w_total, int w_local, int off, int lmax,
                                 int mpm, int t_levels, int s_levels,
                                 int splits, int use_smem, void *stream) {
  if (rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Params p{static_cast<const int8_t *>(chrom), chrom_len,
           static_cast<const int32_t *>(slice_start),
           static_cast<const uint8_t *>(reverse),
           static_cast<const int8_t *>(qq),
           static_cast<const int32_t *>(valid_w),
           static_cast<const int32_t *>(tsec_minus),
           static_cast<int32_t *>(cnt), static_cast<int32_t *>(key), nl,
           w_total, w_local, off, lmax, mpm, t_levels, s_levels, splits};
  const size_t n_cnt = static_cast<size_t>(rows) * lmax * (t_levels + 2);
  const size_t n_key = static_cast<size_t>(rows) * lmax * (s_levels + 2);
  // a block that owns its row in shared memory writes every cell of it,
  // DEAD slots done; the others add into a filled output, and a last pass
  // turns its deaths into the DEAD slots
  const bool owned = splits == 1 && use_smem;
  if (!owned) {
    const size_t blocks = (n_cnt + n_key + kThreads - 1) / kThreads;
    fill_kernel<<<static_cast<unsigned>(blocks < 65536 ? blocks : 65536),
                  kThreads, 0, s>>>(p.cnt, n_cnt, p.key, n_key);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const size_t smem = sizeof(int32_t) * kFixedWords +
                      (use_smem ? hist_bytes(lmax, t_levels, s_levels) : 0);
  auto kernel = use_smem ? shard_kernel<true> : shard_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(rows) * splits, kThreads, smem, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || owned) return static_cast<int>(err);
  constexpr int kRowsPerBlock = kThreads / 32;
  dead_prefix_kernel<<<(rows + kRowsPerBlock - 1) / kRowsPerBlock, kThreads,
                       0, s>>>(p.cnt, p.key, rows, lmax, t_levels, s_levels);
  return static_cast<int>(cudaGetLastError());
}
