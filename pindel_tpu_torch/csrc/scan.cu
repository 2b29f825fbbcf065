// Packed-key length scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel pindel_tpu/ops/pallas_scan.py:_kernel
// (launched by pallas_scan_rows).  Output contract, bit for bit: for every
// row and every step l < lsteps, kmin = the min over the row's candidate
// lanes c in [0, we) of the packed key
//     level << shift | woff << 2 | strict_bad << 1 | fitbad
// and k2 = the min over the keys != kmin (0x7fffffff when there is none);
// zeros past lsteps.  The plain version is scan_rows_ref in
// pindel_tpu_torch/ops/scan.py.
//
// The seed lemma.  A seeded lane (c in [off, off + valid_w), tile[c] ==
// q[0], q[0] != N) starts at level 0 and gains at most one level per
// counted step, so its level stays below min(lsteps, qlen); every other lane
// starts at `dead`.  When min(lsteps, qlen) <= dead, every seeded key is
// below every unseeded key, and when valid_w <= w the seeded keys are
// distinct (their woff = c - off are).  So in a row with two or more seeds
// (and both conditions) kmin and k2 are the min and second min over the
// seeded lanes alone: about a quarter of the lanes on an ACGT genome.  A
// row with fewer seeds needs every lane (its k2, or both outputs, are
// unseeded keys).
//
// What bounds it on this card.  Per candidate and step the work is a byte
// compare, a few integer operations and a min/second-min fold: integer ALU
// work on state the scan carries in registers.  Device memory traffic is
// one tile row and one query row in and two [lmax] rows out, so the bound
// is the int32 issue rate over the operations the row needs: pass 1 at 7
// per candidate and four steps (the word below), pass 2 at 8 per candidate
// and step, over the seeded candidates in a row with two or more seeds and
// every lane of [0, we) in the other rows (chip_smoke.py:scan_bound).
//
// Design.
// * A row is one block of NW warps: one warp on the main path, where a
//   launch has thousands of rows, so a row never waits for another row of
//   its block and rows of unequal cost (the dense rows below cost about
//   four times a seeded one) hold no SM slot idle.  A launch of too few
//   rows to fill the card (a small batch, long reads, the widest evidence
//   windows) gives each row up to eight warps and cuts its lanes into
//   segments of at least kMinSeg, each warp walking every NW-th segment
//   into accumulators of its own, folded once at the end.
// * Seed pass: each warp counts the row's seeds (ballot + popc, stopping at
//   two) and picks the branch.  The tile goes into the warp's shared memory
//   a segment at a time (at most kSeg lanes: one segment up to w = 2048 at
//   lmax 128); on the sparse branch the segment's seed positions are then
//   compacted into a list (ballot + popc prefix sums).
// * The walker takes up to 32*kMaxK candidates at a time (the seed list, or
//   consecutive lanes on the dense branch), K of them per lane in
//   registers, K = ceil(candidates / 32) picked per chunk from 1..kMaxK, so
//   a row of 96 seeds walks 3 slots per lane and not kMaxK.  kMaxK and the
//   register cap (kMinBlocks warps resident per SM) trade instruction-level
//   parallelism against warps in flight; scan_bench.py sweeps both
//   (SCAN_MAX_K, SCAN_MIN_BLOCKS) and PERF.md keeps its numbers.
// * Four steps per shared load: each candidate reads four tile bytes as one
//   word (a funnel shift of two aligned words, the later one kept for the
//   next four steps), XORs them with four query bytes and turns each
//   nonzero byte into a flag bit with one add; per-row masks (query is N,
//   step counts, step >= 1) are applied to the word.  Pass 1 (the fit bit)
//   is then 7 operations per four steps: the funnel shift, a lop3 for the
//   xor and mask, the add, two lop3 for the or and the row's masks, a popc
//   and the add to the total.
// * Per step each lane folds its K keys into a (min, second min) pair (on
//   the sparse branch the keys are distinct, so the fold is three min/max),
//   and two __reduce_min_sync (redux.sync) give the warp's min M and the
//   min over each lane's (m1 == M ? m2 : m1): no shuffle tree, no
//   __syncthreads.  Lane l % 32 keeps step l's pair; every 32 steps the
//   lanes fold their pairs into the row's per-step accumulator in shared
//   memory, which goes to device memory coalesced once per row.  The fold
//   is order-free, so chunk and lane order do not change the bits.
// * Staging is a plain coalesced byte copy into shared memory, a segment
//   at a time.  It is not double-buffered across rows: a block is one row,
//   and the rows resident per SM cover one another's loads.
#include <algorithm>
#include <atomic>
#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

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
constexpr int kMaxDevices = 64;

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

// Copy tile bytes [seg0, seg0 + n) into buf, bytes at or past t read as N.
__device__ __forceinline__ void stage(int8_t *buf, const int8_t *tile,
                                      int seg0, int n, int t, int lane) {
  __syncwarp();   // the walk is done with the previous segment
  for (int i = lane; i < n; i += 32) {
    buf[i] = seg0 + i < t ? tile[seg0 + i] : static_cast<int8_t>(kCodeN);
  }
  __syncwarp();
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

template <int NW>
__global__ void __launch_bounds__(32 * NW, kMinBlocks / NW ? kMinBlocks / NW
                                                           : 1)
scan_rows_kernel(const int8_t *__restrict__ tiles,
                 const int8_t *__restrict__ qq,
                 const int32_t *__restrict__ valid_w,
                 const int32_t *__restrict__ qlen,
                 const int32_t *__restrict__ thr,
                 const int32_t *__restrict__ off,
                 int32_t *__restrict__ kmin, int32_t *__restrict__ k2,
                 int t, int we, int w, int lmax, int lsteps, int mpm,
                 int shift, int dead, int seg) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int ngroups = (lsteps + 3) >> 2;
  const Layout lay(ngroups, NW, seg);
  auto *meta = reinterpret_cast<uint4 *>(smem);
  unsigned char *mine = smem + lay.meta + warp * lay.warp;
  int *acc1 = reinterpret_cast<int *>(mine);
  int *acc2 = acc1 + 4 * ngroups;
  auto *buf = reinterpret_cast<int8_t *>(mine + lay.acc);
  auto *list = reinterpret_cast<int16_t *>(mine + lay.acc + lay.tile);
  const int row = blockIdx.x;
  const int8_t *tile = tiles + static_cast<size_t>(row) * t;
  const int8_t *q = qq + static_cast<size_t>(row) * lmax;
  Row r;
  r.meta = meta;
  r.acc1 = acc1;
  r.acc2 = acc2;
  r.buf = buf;
  r.list = list;
  const int vw = valid_w[row];
  const int ql = qlen[row];
  r.off = off[row];
  r.thr = thr[row];
  r.q0 = q[0];
  r.w = w;
  r.shift = shift;
  r.dead = dead;
  r.lsteps = lsteps;
  r.mpm = mpm;
  r.steps1 = min(lsteps, ql);   // counted steps are 1 .. steps1 - 1
  r.lo = max(r.off, 0);
  r.hi = r.q0 == kCodeN ? r.lo : max(r.lo, min(r.off + vw, we));

  for (int g = threadIdx.x; g < ngroups; g += 32 * NW) {
    uint32_t qw = 0, qn = 0, cnt = 0, mark = 0;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int l = 4 * g + s;
      const int qb = l < lmax ? q[l] : kCodeN;
      qw |= static_cast<uint32_t>(qb & 0xff) << (8 * s);
      if (qb == kCodeN) qn |= 0x80u << (8 * s);
      if (l >= 1 && l < r.steps1) cnt |= 0x80u << (8 * s);
      if (l >= 1 && l < lsteps) mark |= 0x80u << (8 * s);
    }
    meta[g] = make_uint4(qw, qn, cnt, mark);
  }
  for (int l = lane; l < 4 * ngroups; l += 32) {
    acc1[l] = kMaxi;
    acc2[l] = kMaxi;
  }
  __syncthreads();   // meta is complete

  // every warp counts the row's seeds (up to two) from device memory, so
  // all of them pick the same branch
  int nseed = 0;
  for (int c0 = r.lo; c0 < r.hi && nseed < 2; c0 += 32) {
    const int c = c0 + lane;
    nseed += __popc(__ballot_sync(kFull, c < r.hi && tile[c] == r.q0));
  }
  const bool sparse = nseed >= 2 && vw <= w && r.steps1 <= dead;

  const int end = sparse ? r.hi : we;
  for (int seg0 = warp * seg; seg0 < end; seg0 += NW * seg) {
    const int segn = min(seg, we - seg0);
    stage(buf, tile, seg0, segn + 4 * ngroups + 4, t, lane);
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
  __syncthreads();   // every warp's accumulators are complete

  // fold the warps' pairs (order-free) and write the row coalesced
  int32_t *kmin_row = kmin + static_cast<size_t>(row) * lmax;
  int32_t *k2_row = k2 + static_cast<size_t>(row) * lmax;
  for (int l = threadIdx.x; l < lmax; l += 32 * NW) {
    int a1 = 0;
    int a2 = 0;
    if (l < lsteps) {
      a1 = kMaxi;
      a2 = kMaxi;
#pragma unroll
      for (int k = 0; k < NW; ++k) {
        const auto *other =
            reinterpret_cast<const int *>(smem + lay.meta + k * lay.warp);
        merge_pair(a1, a2, other[l], other[4 * ngroups + l]);
      }
    }
    kmin_row[l] = a1;
    k2_row[l] = a2;
  }
}

// The instantiations, by log2 of the warps per row.
decltype(&scan_rows_kernel<1>) const kKernels[] = {
    scan_rows_kernel<1>, scan_rows_kernel<2>, scan_rows_kernel<4>,
    scan_rows_kernel<8>};
static_assert(sizeof(kKernels) / sizeof(kKernels[0]) == 4 && kMaxWarps == 8,
              "one instantiation per power of two up to kMaxWarps");

// Once per device: each instantiation's dynamic shared memory limit raised
// to the device's opt-in maximum (a launch that needs more is refused and
// reported by cudaGetLastError), and the SM count kept for the launcher.
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
  for (auto kernel : kKernels) {
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    }
  }
  if (err == cudaSuccess && dev < kMaxDevices) sm_count[dev].store(*sms);
  return err;
}

}  // namespace

// C entry point: launches on `stream`, returns cudaGetLastError() (0 when
// the launch was accepted).  All pointers are device pointers of contiguous
// row-major tensors: tiles [rows, t] int8, qq [rows, lmax] int8, valid_w /
// qlen / thr / off [rows] int32, kmin / k2 [rows, lmax] int32.
extern "C" int pt_scan_rows(const void *tiles, const void *qq,
                            const void *valid_w, const void *qlen,
                            const void *thr, const void *off, void *kmin,
                            void *k2, int rows, int t, int we, int w,
                            int lmax, int lsteps, int mpm, int shift,
                            int dead, void *stream) {
  int sms = 0;
  cudaError_t err = device_setup(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows == 0) return 0;
  // warps per row: as many as fill the card (kMinBlocks warps per SM), at
  // most kMaxWarps and one per kMinSeg lanes; a row's segments: at most
  // kSeg lanes, and at least one per warp
  const int fill = (sms * kMinBlocks + rows - 1) / rows;
  const int most = std::min({kMaxWarps, fill, std::max(we / kMinSeg, 1)});
  int log_nw = 0;
  while ((2 << log_nw) <= most) ++log_nw;
  const int nw = 1 << log_nw;
  const int seg = std::min(kSeg, round16((we + nw - 1) / nw));
  const size_t smem = Layout((lsteps + 3) / 4, nw, seg).total;
  const auto kernel = kKernels[log_nw];
  kernel<<<rows, 32 * nw, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t *>(tiles), static_cast<const int8_t *>(qq),
      static_cast<const int32_t *>(valid_w),
      static_cast<const int32_t *>(qlen), static_cast<const int32_t *>(thr),
      static_cast<const int32_t *>(off), static_cast<int32_t *>(kmin),
      static_cast<int32_t *>(k2), t, we, w, lmax, lsteps, mpm, shift, dead,
      seg);
  return static_cast<int>(cudaGetLastError());
}
