// Fused close-end and far-end searches for Hopper (sm_90a).
//
// Replace the fused search's device calls of the JAX package, which reach
// the Pallas scan (pindel_tpu/ops/pallas_scan.py:_kernel) through
// _scan_lanes:
// * close_kernel: pindel_tpu/ops/engine_fused.py:_close_kernel (K2): the
//   four close-end attempts of a read, two per range, range 0 before range
//   1, the first emitting attempt kept.  Output row: lmax / 32 emission
//   words, the representative, winner | uniform << 8.
// * far_kernel: pindel_tpu/ops/engine_fused.py:_far_kernel (K3): every
//   geometric far-end round, a forward and a backward lane each, with the
//   NewUPFarIsBetter replacement between rounds.  Output row: the words,
//   the representative, round | replaced << 8 | uniform << 9.
// * far_win_kernel: pindel_tpu/ops/engine_fused.py:_far_win_kernel (K4): one
//   far-end round over each read's own window [start, end) (a BreakDancer
//   or read-pair evidence window) in place of K3's geometric span.  Output
//   row: the words, the representative, any_emit | uniform << 1.
// The plain versions are _close_kernel_ref, _far_kernel_ref and
// _far_win_kernel_ref in pindel_tpu_torch/ops/engine_fused.py; the outputs
// are equal bit for bit.
//
// What bounds them on this card.  The scan inside is K1's (scan.cu): int32
// ALU work on the candidates a row needs.  Around it the torch composition
// moved every lane's tile, kmin/k2 and five [B, G, lmax] intermediates
// through device memory in about a hundred small launches a call; the least
// traffic is the payload, one read of each scanned tile's chromosome span
// and the output, far below the operations' time.  So the bound is K1's
// operations over the rows these kernels scan (tools/measure.py:
// fused_bound).
//
// Design.
// * One launch a call, one block a read.  A block is two groups of NW warps,
//   one group per scan row: K2's two attempts of a range side by side, or
//   the two lanes of a K3 or K4 round (far_round, shared by both).  NW is
//   1 on the main path (thousands of reads); a launch of too few reads to
//   fill the card gives each row up to kMaxFusedWarps warps, which split
//   its lanes into segments as K1 does.
// * No tile tensor.  A lane's tile is nr consecutive 128-byte rows of the
//   [2 * NR, 128] chromosome layout (the forward chromosome, then its
//   reverse), the row index clamped into [0, 2 * NR - 1] as the JAX
//   row-take's mode="clip" does: a forward tile past the forward half reads
//   the reverse half's first rows, and only rows past the last are clamped.
//   A warp stages its segment from there with 16-byte cp.async copies (a
//   segment starts at a multiple of 16 bytes, so each copy lies in one row
//   and takes that row's clamped index); the start is floor-divided, so a
//   negative start_log takes the right rows and offset.
// * K1's walk (scan_walk.cuh) runs on the staged segments; kmin and k2 stay
//   in the warps' shared accumulators and never reach device memory.
// * The epilogue runs in one warp with lengths on lanes, 32 at a time: the
//   emission rules (_emit_rules), a stop's prefix over the lengths from a
//   ballot, each emission word one __ballot_sync (bit i of word j is length
//   index 32 j + i, little-endian, as _pack_words packs it), the last
//   emission from the highest set bit, uniformity as a vote against the
//   first emitted representative.  K3 and K4 merge their two lanes in
//   lane-major order per length first (lane 0 wins equal levels).
// * Only work the output never reads is skipped:
//   - K2 scans range 1 only for a read with no emission in range 0: the
//     torch version reads range 1 only where use1 = ~has0.
//   - K3 stops a read at its first inactive round: active = close_max +
//     st_max < qlen, st_max changes only where a round replaces, and a round
//     replaces only an active read, so no later round is active.
//   - Attempt 0 of a range that is scanned is always scanned whole: a read
//     with no emission still takes its rep_key at length 1.
//   - K4 skips nothing: every read's window is scanned on both lanes, and a
//     read with no emission writes the merged rep_key at length 1 and
//     uniform 1, as _emit_rules gives them.
// * K4 keeps one block a read in caller order.  On the main path's calls
//   (BreakDancer windows of one bucket, widths within about 4x of each
//   other) the widest read does not set the call's time: timing the call
//   without its widest 1% of reads saves nothing (tools/kernel_bench.py
//   --far-win-tail, PERF.md).  A schedule of widest reads first, with wide
//   reads cut across blocks and folded, pays only where a call mixes
//   windows of very different widths (testing/fused_cases.py:
//   far_win_skewed), which no workload of the repo produces.
#include <algorithm>
#include <atomic>
#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#include "scan_walk.cuh"

namespace {

using namespace ptscan;

constexpr int kSpacer = 100000;       // genome.SPACER
constexpr int kDeadLive = 1000000;    // a dead min_mm counts as 10^6
constexpr int kMaxRounds = 16;
constexpr int kMaxFusedWarps = 4;     // warps per scan row, at most
constexpr int kCloseWords = 3;        // meta words of a close payload row
constexpr int kFarWords = 4;          // meta words of a far payload row
constexpr int kFarWinWords = 4;       // meta words of a far_win payload row
constexpr int kMaxDevices = 64;

// shared scalars: per group any, rep, uniform; then K3's kept state
enum Scalar {
  kAny = 0, kRep = 1, kUni = 2,   // + 4 * group
  kStMax = 8, kStRep, kStUni, kStRound, kStReplaced, kNumScalars
};

// What both kernels take besides their own geometry.
struct Common {
  int nrows2;    // rows of the [2 * NR, 128] chromosome layout
  int lmax, lsteps, mpm, bp_start, dead, seg;
  int cap;       // MAX_READ_LENGTH - 1: maxmm is indexed at min(len, cap)
};

struct CloseArgs {
  Common c;
  int w[2], shift[2];
  int with_r1;
};

struct FarArgs {
  Common c;
  int nrounds;
  int span[kMaxRounds], w[kMaxRounds], shift[kMaxRounds];
};

struct FarWinArgs {
  Common c;
  int w, shift;
};

// Shared memory of a block of two groups of nw warps: the two queries,
// each group's query words, each warp's accumulators, segment and seed
// list (scan_walk.cuh's Layout), three sets of emission words (one per
// group, and K3's kept result) and the scalars.
struct FusedLayout {
  Layout row;
  int q, meta, warps, words, scalars, total;
  __host__ __device__ FusedLayout(int lmax, int ngroups, int nw, int seg)
      : row(ngroups, 1, seg),
        q(0),
        meta(round16(2 * lmax)),
        warps(meta + 2 * row.meta),
        words(warps + 2 * nw * row.warp),
        scalars(words + round16(3 * (lmax / 32) * 4)),
        total(scalars + round16(4 * kNumScalars)) {}
};

// A lane's tile, read straight from the chromosome layout: tile byte i is
// byte i % 128 of row clamp(arow + i / 128, 0, nrows2 - 1).
struct ChromTile {
  const int8_t *cat;
  int arow, nrows2;

  __device__ __forceinline__ int row_of(int i) const {
    return min(max(arow + (i >> 7), 0), nrows2 - 1);
  }
  __device__ __forceinline__ int at(int i) const {
    return cat[static_cast<size_t>(row_of(i)) * 128 + (i & 127)];
  }
  // Copy tile bytes [seg0, seg0 + n) (n rounded up to 16) into buf with
  // 16-byte cp.async copies; seg0 is a multiple of 16.
  __device__ __forceinline__ void stage(int8_t *buf, int seg0, int n,
                                        int lane) const {
    __syncwarp();   // the walk is done with the previous segment
    const unsigned base =
        static_cast<unsigned>(__cvta_generic_to_shared(buf));
    for (int i = 16 * lane; i < n; i += 16 * 32) {
      const int p = seg0 + i;
      const int8_t *src =
          cat + static_cast<size_t>(row_of(p)) * 128 + (p & 127);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                   ::"r"(base + i), "l"(src) : "memory");
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncwarp();
  }
};

__device__ __forceinline__ int nibble(const int8_t *row, int i) {
  return (static_cast<uint8_t>(row[i >> 1]) >> ((i & 1) * 4)) & 15;
}

// _complement: 3 - c for a base, N stays N
__device__ __forceinline__ int8_t complement(int c) {
  return static_cast<int8_t>(c == kCodeN ? c : 3 - c);
}

// Where a block's pieces lie in shared memory.
struct Block {
  unsigned char *smem;
  FusedLayout lay;
  int grp, gt, gw, lane, ngroups;

  __device__ int8_t *query(int g, int lmax) const {
    return reinterpret_cast<int8_t *>(smem + lay.q) + g * lmax;
  }
  __device__ unsigned char *warp_base(int g, int nw, int w) const {
    return smem + lay.warps + (g * nw + w) * lay.row.warp;
  }
  __device__ int32_t *words(int set, int lmax) const {
    return reinterpret_cast<int32_t *>(smem + lay.words) + set * (lmax / 32);
  }
  __device__ int *scalars() const {
    return reinterpret_cast<int *>(smem + lay.scalars);
  }
};

// The tile geometry of _scan_lanes for a lane with slice start ss.
struct Geometry {
  int we, arow, off;
  __device__ Geometry(int ss, bool reverse, int w, int lmax, int nrows2) {
    const int clpad = (nrows2 / 2) * 128;
    const int tile_len = w + lmax;
    const int nr = (tile_len + 127) / 128 + 1;
    we = nr * 128 - lmax;
    const int start_log = reverse ? clpad - ss - tile_len : ss;
    // floor division and modulo, start_log may be negative
    arow = (start_log >> 7) + (reverse ? nrows2 / 2 : 0);
    off = start_log & 127;
  }
};

// Scan this group's row: query q over the lane at slice start ss.  Ends
// with every warp's accumulators complete once the caller synchronises.
template <int NW>
__device__ __forceinline__ void scan_group(const Block &bk, const Common &c,
                                           const int8_t *cat, const int8_t *q,
                                           int ss, bool reverse, int w,
                                           int shift, int vw, int qlen,
                                           int thr) {
  const Geometry geo(ss, reverse, w, c.lmax, c.nrows2);
  const ChromTile tile{cat, geo.arow, c.nrows2};
  auto *meta = reinterpret_cast<uint4 *>(bk.smem + bk.lay.meta) +
               bk.grp * bk.ngroups;
  unsigned char *mine = bk.warp_base(bk.grp, NW, bk.gw);
  int *acc1 = reinterpret_cast<int *>(mine);
  int *acc2 = acc1 + 4 * bk.ngroups;
  auto *buf = reinterpret_cast<int8_t *>(mine + bk.lay.row.acc);
  auto *list =
      reinterpret_cast<int16_t *>(mine + bk.lay.row.acc + bk.lay.row.tile);
  Row r;
  r.meta = meta;
  r.acc1 = acc1;
  r.acc2 = acc2;
  init_row(r, q[0], vw, qlen, geo.off, thr, geo.we, w, shift, c.dead,
           c.lsteps, c.mpm);
  build_meta(meta, q, c.lmax, c.lsteps, r.steps1, bk.gt, 32 * NW);
  init_acc(acc1, acc2, bk.ngroups, bk.lane);
  __syncthreads();   // both groups' query words are complete
  walk_row(r, tile, vw, geo.we, c.seg, NW, bk.gw, bk.lane, buf, list);
}

// One length's statistics, as _scan_lanes returns them.
struct Stats {
  int min_mm, lvl2, rep_key;
  bool strict_bad, fit_ok, rev_rep;
};

// One group's statistics (nlg = 1): the group's own kmin/k2.
template <int NW>
struct GroupStats {
  const Block *bk;
  int g, shift;
  bool reverse;
  __device__ Stats operator()(int l, const Common &c) const {
    int km, k2;
    fold_step<NW>(bk->warp_base(g, NW, 0), bk->lay.row.warp, bk->ngroups, l,
                  c.lsteps, km, k2);
    Stats s;
    s.min_mm = km >> shift;
    s.lvl2 = k2 >> shift;
    s.rep_key = (km >> 2) & ((1 << (shift - 2)) - 1);
    s.strict_bad = (km & 2) != 0;
    s.fit_ok = (km & 1) == 0;
    s.rev_rep = reverse;
    return s;
  }
};

// Two lanes merged in lane-major order (nlg = 2): lane 1's candidates rank
// after lane 0's at equal levels; lane 1 is the backward lane.
template <int NW>
struct MergedStats {
  const Block *bk;
  int w, shift;
  __device__ Stats operator()(int l, const Common &c) const {
    int km0, k20, km1, k21;
    fold_step<NW>(bk->warp_base(0, NW, 0), bk->lay.row.warp, bk->ngroups, l,
                  c.lsteps, km0, k20);
    fold_step<NW>(bk->warp_base(1, NW, 0), bk->lay.row.warp, bk->ngroups, l,
                  c.lsteps, km1, k21);
    const int lvl0 = km0 >> shift;
    const int lvl1 = km1 >> shift;
    const bool better = lvl1 < lvl0;
    const int km = better ? km1 : km0;
    Stats s;
    s.lvl2 = better ? min(k21 >> shift, lvl0) : min(k20 >> shift, lvl1);
    s.min_mm = km >> shift;
    s.rep_key = (better ? w : 0) + ((km >> 2) & ((1 << (shift - 2)) - 1));
    s.strict_bad = (km & 2) != 0;
    s.fit_ok = (km & 1) == 0;
    s.rev_rep = s.rep_key / w == 1;
    return s;
  }
};

// The per-read scalars of the emission rules.
struct Rules {
  int qlen, ms, tm;
  const int32_t *maxmm;
};

struct Emission {
  int any, last, rep, uni;
};

// The emission rules (_emit_rules) over every length, run by one warp with
// lengths on lanes; writes the lmax / 32 emission words to `words`.
template <class StatsFn>
__device__ Emission emit_rules(const Common &c, const Rules &u,
                               const StatsFn &stats, int32_t *words,
                               int lane) {
  bool stopped = false;   // a stop at an earlier length (warp-uniform)
  int last = -1, rep_last = 0, rep0 = 0, ref = 0;
  bool have_ref = false;
  int uni = 1;
  const unsigned upto = (2u << lane) - 1;   // lanes 0 .. lane
  for (int j = 0; j < c.lmax / 32; ++j) {
    const int l = 32 * j + lane;
    const Stats s = stats(l, c);
    const int lens = l + 1;
    const bool in_range = lens >= c.bp_start && lens <= u.qlen - 1;
    const int maxmm_l = u.maxmm[min(lens, c.cap)];
    const int min_live = s.min_mm >= c.dead ? kDeadLive : s.min_mm;
    const bool stop = in_range && min_live > maxmm_l;
    // alive: no stop at any length up to and including this one
    const unsigned stops = __ballot_sync(kFull, stop);
    const bool alive = !stopped && (stops & upto) == 0;
    stopped = stopped || stops != 0;
    const bool len_ok = s.rev_rep ? lens >= c.mpm : lens > c.mpm;
    // "exactly one candidate at the min level, none within min+additional
    // levels" == runner-up beyond min(min + add, tsec)
    const int hi = min(min_live + (u.tm - u.ms), u.tm);
    const bool emit = in_range && alive && min_live <= u.ms &&
                      lens >= c.bp_start + min_live && s.lvl2 > hi &&
                      min_live <= maxmm_l && len_ok && !s.strict_bad &&
                      s.fit_ok;
    const unsigned word = __ballot_sync(kFull, emit);
    if (lane == 0) words[j] = static_cast<int32_t>(word);
    if (j == 0) rep0 = __shfl_sync(kFull, s.rep_key, 0);
    if (word) {
      if (!have_ref) {
        ref = __shfl_sync(kFull, s.rep_key, __ffs(word) - 1);
        have_ref = true;
      }
      // uniform: every emitted representative equals the last one, i.e.
      // every one equals the first
      if (__ballot_sync(kFull, emit && s.rep_key != ref)) uni = 0;
      const int top = 31 - __clz(word);
      last = 32 * j + top;
      rep_last = __shfl_sync(kFull, s.rep_key, top);
    }
  }
  // with no emission, _emit_rules gathers rep_key at index 0
  return {last >= 0, last, last >= 0 ? rep_last : rep0, uni};
}

__device__ __forceinline__ Block make_block(unsigned char *smem,
                                            const Common &c, int nw) {
  const int ngroups = (c.lsteps + 3) >> 2;
  const int grp = threadIdx.x / (32 * nw);
  const int gt = threadIdx.x - grp * 32 * nw;
  return Block{smem, FusedLayout(c.lmax, ngroups, nw, c.seg), grp, gt,
               gt >> 5, static_cast<int>(threadIdx.x & 31), ngroups};
}

// A far payload row's queries: lane 0 scans a forward tile with the
// read's codes, lane 1 a backward tile with their complement (R(RC(cur)) =
// C(cur)).  The caller synchronises.
__device__ __forceinline__ void far_queries(const Block &bk,
                                            const int8_t *prow, int lmax) {
  int8_t *q0 = bk.query(0, lmax);
  int8_t *q1 = bk.query(1, lmax);
  for (int i = threadIdx.x; i < lmax; i += blockDim.x) {
    const int f = nibble(prow, i);
    q0[i] = static_cast<int8_t>(f);
    q1[i] = complement(f);
  }
}

// One both-strand far round over the window [start, end) in bucket w:
// group 0 scans the forward tile from start, group 1 the backward tile
// ending at end, then warp 0 runs the emission rules over the two lanes
// merged and writes the emission words to `fresh`.  Its Emission is
// warp 0's alone; the caller synchronises before another warp reads
// `fresh`.
template <int NW>
__device__ __forceinline__ Emission far_round(const Block &bk,
                                              const Common &c,
                                              const int8_t *cat,
                                              const Rules &u, int start,
                                              int end, int w, int shift,
                                              int thr, int32_t *fresh) {
  const int valid = min(max(end - start, 0), w);
  const int ss = bk.grp == 0 ? start : end - (w + c.lmax);
  scan_group<NW>(bk, c, cat, bk.query(bk.grp, c.lmax), ss, bk.grp == 1, w,
                 shift, valid, u.qlen, thr);
  __syncthreads();   // both lanes' accumulators are complete
  Emission e{0, -1, 0, 1};
  if (threadIdx.x < 32) {
    const MergedStats<NW> st{&bk, w, shift};
    e = emit_rules(c, u, st, fresh, bk.lane);
  }
  return e;
}

template <int NW>
__global__ void __launch_bounds__(64 * NW, kMinBlocks / (2 * NW)
                                               ? kMinBlocks / (2 * NW)
                                               : 1)
close_kernel(const int8_t *__restrict__ cat,
             const int8_t *__restrict__ payload,
             const int32_t *__restrict__ maxmm, int32_t *__restrict__ out,
             const CloseArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Common &c = a.c;
  const Block bk = make_block(smem, c, NW);
  const int lmax = c.lmax;
  const int read = blockIdx.x;
  // payload row: 2 * lmax 4-bit codes (the read, then the read reversed
  // within its length), then the meta words
  const int8_t *prow =
      payload + static_cast<size_t>(read) * (lmax + 4 * kCloseWords);
  const auto *m = reinterpret_cast<const int32_t *>(prow + lmax);
  const int pos = m[0];
  const int isz = m[1] & 0x1ffff;
  const int qlen = m[1] >> 17;
  const Rules u{qlen, m[2] & 0xff, (m[2] >> 8) & 0xff, maxmm};
  const int thr = (m[2] >> 16) & 0x3ff;
  const bool minus = ((m[2] >> 26) & 1) != 0;
  // query 0: the attempt with the original sequence (R(f) for '-' reads,
  // RC(f) for '+'), query 1: the attempt with the RC'd one (C(f), f)
  int8_t *q_orig = bk.query(0, lmax);
  int8_t *q_flip = bk.query(1, lmax);
  for (int i = threadIdx.x; i < lmax; i += blockDim.x) {
    const int f = nibble(prow, i);
    const int rf = nibble(prow, lmax + i);
    q_orig[i] = minus ? static_cast<int8_t>(rf) : complement(rf);
    q_flip[i] = minus ? complement(f) : static_cast<int8_t>(f);
  }
  int *sc = bk.scalars();
  __syncthreads();   // the queries are complete

  int k = 0;
  for (;; ++k) {
    // attempt windows (close_end_lane geometry, pindel.cpp:2271-2316)
    const int w = a.w[k];
    const int plus_start = pos + kSpacer - k * isz;
    const int minus_end = pos + kSpacer + k * isz;
    const int start = minus ? minus_end - (2 * k + 1) * isz : plus_start;
    const int end = minus ? minus_end : plus_start + (2 * k + 1) * isz;
    const int ss = minus ? end - (w + lmax) : start;
    const int valid = min(max(end - start, 0), w);
    // range 0 queries [orig, flip], range 1 [flip, orig]
    scan_group<NW>(bk, c, cat, bk.query(bk.grp ^ k, lmax), ss, minus, w,
                   a.shift[k], valid, qlen, thr);
    __syncthreads();   // both rows' accumulators are complete
    if (bk.gw == 0) {
      const GroupStats<NW> st{&bk, bk.grp, a.shift[k], minus};
      const Emission e =
          emit_rules(c, u, st, bk.words(bk.grp, lmax), bk.lane);
      if (bk.lane == 0) {
        sc[4 * bk.grp + kAny] = e.any;
        sc[4 * bk.grp + kRep] = e.rep;
        sc[4 * bk.grp + kUni] = e.uni;
      }
    }
    __syncthreads();   // both attempts' results are in
    // range 1 only for a read with no emission in range 0 (use1 = ~has0)
    if (k == 1 || !a.with_r1 || sc[kAny] || sc[4 + kAny]) break;
  }
  // the first emitting attempt of the range, attempt 0 when none emits
  const bool has = sc[kAny] || sc[4 + kAny];
  const int win = sc[kAny] ? 0 : sc[4 + kAny] ? 1 : 0;
  const int nw32 = lmax / 32;
  int32_t *orow = out + static_cast<size_t>(read) * (nw32 + 2);
  const int32_t *wsrc = bk.words(win, lmax);
  for (int i = threadIdx.x; i < nw32; i += blockDim.x) orow[i] = wsrc[i];
  if (threadIdx.x == 0) {
    orow[nw32] = sc[4 * win + kRep];
    orow[nw32 + 1] = (has ? win + 2 * k : 255) | (sc[4 * win + kUni] << 8);
  }
}

template <int NW>
__global__ void __launch_bounds__(64 * NW, kMinBlocks / (2 * NW)
                                               ? kMinBlocks / (2 * NW)
                                               : 1)
far_kernel(const int8_t *__restrict__ cat, const int8_t *__restrict__ payload,
           const int32_t *__restrict__ maxmm, int32_t *__restrict__ out,
           const FarArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Common &c = a.c;
  const Block bk = make_block(smem, c, NW);
  const int lmax = c.lmax;
  const int nw32 = lmax / 32;
  const int read = blockIdx.x;
  // payload row: lmax 4-bit codes, then the meta words
  const int8_t *prow =
      payload + static_cast<size_t>(read) * (lmax / 2 + 4 * kFarWords);
  const auto *m = reinterpret_cast<const int32_t *>(prow + lmax / 2);
  const int center = m[0];
  const int qlen = m[1] & 0x3ff;
  const int close_max = (m[1] >> 10) & 0x3ff;
  const Rules u{qlen, m[2] & 0xff, (m[2] >> 8) & 0xff, maxmm};
  const int thr = (m[2] >> 16) & 0x3ff;
  const int comp_size = m[3];
  far_queries(bk, prow, lmax);
  int32_t *kept = bk.words(2, lmax);
  for (int i = threadIdx.x; i < nw32; i += blockDim.x) kept[i] = 0;
  int *sc = bk.scalars();
  if (threadIdx.x == 0) {
    sc[kStMax] = (m[1] >> 20) & 0x3ff;
    sc[kStRep] = 0;
    sc[kStUni] = 1;
    sc[kStRound] = 255;
    sc[kStReplaced] = 0;
  }
  __syncthreads();

  for (int r = 0; r < a.nrounds; ++r) {
    // a read inactive now stays inactive: st_max changes only where a
    // round replaces, and only an active read is replaced
    if (close_max + sc[kStMax] >= qlen) break;
    // window geometry: search.py search_far_ends
    const int span = a.span[r];
    const int start = center > span + kSpacer ? center - span : kSpacer;
    const int end = max(min(center + span, comp_size - kSpacer), start);
    int32_t *fresh = bk.words(0, lmax);
    const Emission e = far_round<NW>(bk, c, cat, u, start, end, a.w[r],
                                     a.shift[r], thr, fresh);
    if (threadIdx.x < 32) {
      const int new_max = e.any ? e.last + 1 : 0;
      if (new_max >= sc[kStMax]) {   // warp-uniform
        __syncwarp();
        for (int i = bk.lane; i < nw32; i += 32) kept[i] = fresh[i];
        __syncwarp();
        if (bk.lane == 0) {
          sc[kStMax] = new_max;
          sc[kStRep] = e.rep;
          sc[kStUni] = e.uni;
          sc[kStRound] = r;
          sc[kStReplaced] = 1;
        }
      }
    }
    __syncthreads();   // the kept state is current
  }
  int32_t *orow = out + static_cast<size_t>(read) * (nw32 + 2);
  for (int i = threadIdx.x; i < nw32; i += blockDim.x) orow[i] = kept[i];
  if (threadIdx.x == 0) {
    orow[nw32] = sc[kStRep];
    orow[nw32 + 1] = sc[kStRound] | (sc[kStReplaced] << 8) |
                     (sc[kStUni] << 9);
  }
}

template <int NW>
__global__ void __launch_bounds__(64 * NW, kMinBlocks / (2 * NW)
                                               ? kMinBlocks / (2 * NW)
                                               : 1)
far_win_kernel(const int8_t *__restrict__ cat,
               const int8_t *__restrict__ payload,
               const int32_t *__restrict__ maxmm, int32_t *__restrict__ out,
               const FarWinArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Common &c = a.c;
  const Block bk = make_block(smem, c, NW);
  const int lmax = c.lmax;
  const int nw32 = lmax / 32;
  const int read = blockIdx.x;
  // payload row: lmax 4-bit codes, then start, end, qlen (a whole word)
  // and ms | tm << 8 | thr << 16
  const int8_t *prow =
      payload + static_cast<size_t>(read) * (lmax / 2 + 4 * kFarWinWords);
  const auto *m = reinterpret_cast<const int32_t *>(prow + lmax / 2);
  const Rules u{m[2], m[3] & 0xff, (m[3] >> 8) & 0xff, maxmm};
  const int thr = (m[3] >> 16) & 0x3ff;
  far_queries(bk, prow, lmax);
  __syncthreads();   // the queries are complete
  int32_t *fresh = bk.words(0, lmax);
  const Emission e = far_round<NW>(bk, c, cat, u, m[0], m[1], a.w, a.shift,
                                   thr, fresh);
  if (threadIdx.x < 32) {
    int32_t *orow = out + static_cast<size_t>(read) * (nw32 + 2);
    __syncwarp();   // lane 0 wrote the words
    for (int i = bk.lane; i < nw32; i += 32) orow[i] = fresh[i];
    if (bk.lane == 0) {
      orow[nw32] = e.rep;
      orow[nw32 + 1] = e.any | (e.uni << 1);
    }
  }
}

// The instantiations, by log2 of the warps per scan row.
decltype(&close_kernel<1>) const kClose[] = {close_kernel<1>,
                                             close_kernel<2>,
                                             close_kernel<4>};
decltype(&far_kernel<1>) const kFar[] = {far_kernel<1>, far_kernel<2>,
                                         far_kernel<4>};
decltype(&far_win_kernel<1>) const kFarWin[] = {
    far_win_kernel<1>, far_win_kernel<2>, far_win_kernel<4>};
static_assert(sizeof(kClose) / sizeof(kClose[0]) == 3 &&
                  kMaxFusedWarps == 4,
              "one instantiation per power of two up to kMaxFusedWarps");

// Once per device: each instantiation's dynamic shared memory limit raised
// to the device's opt-in maximum, and the SM count kept for the launchers.
cudaError_t device_setup(int *sms) {
  static std::atomic<int> sm_count[kMaxDevices];   // 0: not set up yet
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && (*sms = sm_count[dev].load()) > 0) {
    return cudaSuccess;
  }
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  }
  for (auto kernel : kClose) {
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    }
  }
  for (auto kernel : kFar) {
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    }
  }
  for (auto kernel : kFarWin) {
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    }
  }
  if (err == cudaSuccess && dev < kMaxDevices) sm_count[dev].store(*sms);
  return err;
}

// The lane space of the widest tile (we = tpad - lmax, _scan_lanes).
int lanes_of(int w, int lmax) {
  return ((w + lmax + 127) / 128 + 1) * 128 - lmax;
}

// Warps per scan row (log2) and segment lanes: as K1 picks them
// (scan.cu:pt_scan_rows), for two rows a block.
void plan(int sms, int reads, int we, int *log_nw, int *seg) {
  const int fill = (sms * kMinBlocks + 2 * reads - 1) / (2 * reads);
  const int most =
      std::min({kMaxFusedWarps, fill, std::max(we / kMinSeg, 1)});
  *log_nw = 0;
  while ((2 << *log_nw) <= most) ++*log_nw;
  const int nw = 1 << *log_nw;
  *seg = std::min(kSeg, round16((we + nw - 1) / nw));
}

}  // namespace

// C entry points: launch on `stream`, return cudaGetLastError() (0 when the
// launch was accepted).  Pointers are device pointers of contiguous tensors:
// cat [nrows2, 128] int8 (16-byte aligned), payload [reads, row bytes]
// int8, maxmm [> min(lmax, cap)] int32, out [reads, lmax / 32 + 2] int32.
extern "C" int pt_close(const void *cat, int nrows2, const void *payload,
                        const void *maxmm, void *out, int reads, int w0,
                        int w1, int shift0, int shift1, int with_r1, int lmax,
                        int lsteps, int mpm, int bp_start, int dead, int cap,
                        void *stream) {
  int sms = 0;
  cudaError_t err = device_setup(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (reads == 0) return 0;
  CloseArgs a;
  a.c = Common{nrows2, lmax, lsteps, mpm, bp_start, dead, 0, cap};
  a.w[0] = w0;
  a.w[1] = w1;
  a.shift[0] = shift0;
  a.shift[1] = shift1;
  a.with_r1 = with_r1;
  const int we = std::max(lanes_of(w0, lmax), with_r1 ? lanes_of(w1, lmax)
                                                      : 0);
  int log_nw = 0;
  plan(sms, reads, we, &log_nw, &a.c.seg);
  const int nw = 1 << log_nw;
  const size_t smem = FusedLayout(lmax, (lsteps + 3) / 4, nw, a.c.seg).total;
  kClose[log_nw]<<<reads, 64 * nw, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t *>(cat), static_cast<const int8_t *>(payload),
      static_cast<const int32_t *>(maxmm), static_cast<int32_t *>(out), a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pt_far(const void *cat, int nrows2, const void *payload,
                      const void *maxmm, void *out, int reads, int nrounds,
                      const int *spans, const int *ws, const int *shifts,
                      int lmax, int lsteps, int mpm, int bp_start, int dead,
                      int cap, void *stream) {
  int sms = 0;
  cudaError_t err = device_setup(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nrounds < 0 || nrounds > kMaxRounds) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (reads == 0) return 0;
  FarArgs a;
  a.c = Common{nrows2, lmax, lsteps, mpm, bp_start, dead, 0, cap};
  a.nrounds = nrounds;
  int we = lanes_of(128, lmax);
  for (int r = 0; r < nrounds; ++r) {
    a.span[r] = spans[r];
    a.w[r] = ws[r];
    a.shift[r] = shifts[r];
    we = std::max(we, lanes_of(ws[r], lmax));
  }
  int log_nw = 0;
  plan(sms, reads, we, &log_nw, &a.c.seg);
  const int nw = 1 << log_nw;
  const size_t smem = FusedLayout(lmax, (lsteps + 3) / 4, nw, a.c.seg).total;
  kFar[log_nw]<<<reads, 64 * nw, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t *>(cat), static_cast<const int8_t *>(payload),
      static_cast<const int32_t *>(maxmm), static_cast<int32_t *>(out), a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pt_far_win(const void *cat, int nrows2, const void *payload,
                          const void *maxmm, void *out, int reads, int w,
                          int shift, int lmax, int lsteps, int mpm,
                          int bp_start, int dead, int cap, void *stream) {
  int sms = 0;
  cudaError_t err = device_setup(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (reads == 0) return 0;
  FarWinArgs a;
  a.c = Common{nrows2, lmax, lsteps, mpm, bp_start, dead, 0, cap};
  a.w = w;
  a.shift = shift;
  int log_nw = 0;
  plan(sms, reads, lanes_of(w, lmax), &log_nw, &a.c.seg);
  const int nw = 1 << log_nw;
  const size_t smem = FusedLayout(lmax, (lsteps + 3) / 4, nw, a.c.seg).total;
  kFarWin[log_nw]<<<reads, 64 * nw, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t *>(cat), static_cast<const int8_t *>(payload),
      static_cast<const int32_t *>(maxmm), static_cast<int32_t *>(out), a);
  return static_cast<int>(cudaGetLastError());
}
