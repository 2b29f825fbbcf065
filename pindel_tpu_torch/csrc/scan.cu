// Packed-key length scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel pindel_tpu/ops/pallas_scan.py:_kernel
// (launched by pallas_scan_rows).  Output contract, bit for bit: for every
// row and every step l < lsteps, kmin = the min over the row's candidate
// lanes of the packed key
//     level << shift | woff << 2 | strict_bad << 1 | fitbad
// and k2 = the min over the keys != kmin (0x7fffffff when there is none);
// zeros past lsteps.  The plain version is scan_rows_ref in
// pindel_tpu_torch/ops/scan.py.
//
// What bounds it on this card.  Per candidate and step the work is a byte
// compare, a few integer ops and a min/second-min update: integer ALU work
// on state that the scan carries (keybase and lastmm, 8 B per candidate).
// At the largest window bucket a row has ~66k candidates, 525 KB of state:
// more than the 227 KB of shared memory a block can have.  Device memory
// traffic is small (one tile row and one query row in, two [lmax] rows out),
// so the kernel is bound by integer issue rate and by the per-step
// reductions, never by HBM bandwidth.
//
// Design.  One block of 256 threads per row.  The row's candidates are
// walked in chunks of 256*K; each thread keeps K candidates' state in
// registers (K is a template parameter picked from the window width), so
// the state never touches memory whatever the window.  The chunk's tile
// bytes and the query sit in shared memory.  Per step a thread folds its K
// keys into a (min, distinct second min) pair, a warp shuffle folds the
// pairs, and warp leaders park the pair per step in shared memory; after
// the chunk the block folds the parked pairs into a per-step accumulator.
// The fold is order-independent, so any chunk and reduction order gives the
// same bits.  No __syncthreads sits inside the step loop.  The TPU
// workarounds (lane rolls, 128-row padding, int32 widening of the tile)
// have no counterpart here.
#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCodeN = 4;
constexpr int kNever = -(1 << 20);
constexpr int kMaxi = 0x7fffffff;

// Fold one key into a (min, min over keys != min) pair.
__device__ __forceinline__ void push_key(int &m1, int &m2, int key) {
  if (key < m1) {
    m2 = m1;
    m1 = key;
  } else if (key != m1 && key < m2) {
    m2 = key;
  }
}

// Fold two pairs; each has m2 > m1 or m2 == kMaxi.
__device__ __forceinline__ void merge_pair(int &m1, int &m2, int o1, int o2) {
  const int m = min(m1, o1);
  const int s = min(m1 == m ? m2 : m1, o1 == m ? o2 : o1);
  m1 = m;
  m2 = s;
}

template <int K>
__global__ void __launch_bounds__(kThreads)
scan_rows_kernel(const int8_t *__restrict__ tiles,
                 const int8_t *__restrict__ qq,
                 const int32_t *__restrict__ valid_w,
                 const int32_t *__restrict__ qlen,
                 const int32_t *__restrict__ thr,
                 const int32_t *__restrict__ off,
                 int32_t *__restrict__ kmin, int32_t *__restrict__ k2,
                 int t, int we, int w, int lmax, int lsteps, int mpm,
                 int shift, int dead) {
  constexpr int kChunk = kThreads * K;
  extern __shared__ int smem[];
  int *acc1 = smem;                         // [lsteps] running min
  int *acc2 = acc1 + lsteps;                // [lsteps] running second min
  int *part1 = acc2 + lsteps;               // [kWarps][lsteps]
  int *part2 = part1 + kWarps * lsteps;     // [kWarps][lsteps]
  int8_t *sq = reinterpret_cast<int8_t *>(part2 + kWarps * lsteps);
  int8_t *stile = sq + lsteps;              // [kChunk + lsteps]

  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int8_t *tile = tiles + static_cast<size_t>(row) * t;
  const int8_t *q = qq + static_cast<size_t>(row) * lmax;
  const int vw = valid_w[row];
  const int ql = qlen[row];
  const int th = thr[row];
  const int of = off[row];
  const int q0 = q[0];
  const int steps1 = min(lsteps, ql);       // pass-1 steps that can count

  for (int l = tid; l < lsteps; l += kThreads) {
    acc1[l] = kMaxi;
    acc2[l] = kMaxi;
    sq[l] = q[l];
  }

  for (int c0 = 0; c0 < we; c0 += kChunk) {
    __syncthreads();   // the previous chunk's parked pairs are folded
    for (int i = tid; i < kChunk + lsteps; i += kThreads) {
      const int g = c0 + i;
      stile[i] = g < t ? tile[g] : static_cast<int8_t>(kCodeN);
    }
    __syncthreads();
    // candidates c0 + tid + j*kThreads with j < nvalid lie inside [0, we)
    const int rem = we - c0 - tid;
    const int nvalid = rem <= 0 ? 0 : (rem + kThreads - 1) / kThreads;

    // ---- pass 1: whole-read Matches() mismatch totals -> fit bit
    int total[K];
#pragma unroll
    for (int j = 0; j < K; ++j) total[j] = 0;
    for (int l = 1; l < steps1; ++l) {
      const int qb = sq[l];
      const int qn = qb == kCodeN;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        total[j] += (stile[tid + j * kThreads + l] != qb) ^ qn;
      }
    }

    // ---- pass 2: the scan proper
    int keyb[K];
    int last[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int c = c0 + tid + j * kThreads;
      const bool seeded = stile[tid + j * kThreads] == q0 && c >= of &&
                          c < of + vw && q0 != kCodeN;
      const int woff = min(max(c - of, 0), w - 1);
      keyb[j] = ((seeded ? 0 : dead) << shift) | (woff << 2) |
                (total[j] < th ? 1 : 0);
      last[j] = kNever;
    }
    for (int l = 0; l < lsteps; ++l) {
      const int qb = sq[l];
      const int qn = qb == kCodeN;
      const int inc = (l >= 1 && l < ql) ? (1 << shift) : 0;
      const int lim = l - mpm;
      const int mark = l >= 1 ? l : kNever;
      int m1 = kMaxi;
      int m2 = kMaxi;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const int d = stile[tid + j * kThreads + l] != qb;
        if (d ^ qn) keyb[j] += inc;
        if (d) last[j] = mark;
        const int key = keyb[j] + (last[j] > lim ? 2 : 0);
        if (j < nvalid) push_key(m1, m2, key);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const int o1 = __shfl_xor_sync(0xffffffffu, m1, o);
        const int o2 = __shfl_xor_sync(0xffffffffu, m2, o);
        merge_pair(m1, m2, o1, o2);
      }
      if (lane == 0) {
        part1[warp * lsteps + l] = m1;
        part2[warp * lsteps + l] = m2;
      }
    }
    __syncthreads();
    for (int l = tid; l < lsteps; l += kThreads) {
      int a1 = acc1[l];
      int a2 = acc2[l];
      for (int wi = 0; wi < kWarps; ++wi) {
        merge_pair(a1, a2, part1[wi * lsteps + l], part2[wi * lsteps + l]);
      }
      acc1[l] = a1;
      acc2[l] = a2;
    }
  }
  __syncthreads();
  int32_t *kmin_row = kmin + static_cast<size_t>(row) * lmax;
  int32_t *k2_row = k2 + static_cast<size_t>(row) * lmax;
  for (int l = tid; l < lmax; l += kThreads) {
    kmin_row[l] = l < lsteps ? acc1[l] : 0;
    k2_row[l] = l < lsteps ? acc2[l] : 0;
  }
}

template <int K>
cudaError_t launch(const int8_t *tiles, const int8_t *qq,
                   const int32_t *valid_w, const int32_t *qlen,
                   const int32_t *thr, const int32_t *off, int32_t *kmin,
                   int32_t *k2, int rows, int t, int we, int w, int lmax,
                   int lsteps, int mpm, int shift, int dead,
                   cudaStream_t stream) {
  const size_t smem = sizeof(int) * (2 + 2 * kWarps) * lsteps +
                      static_cast<size_t>(lsteps) + kThreads * K + lsteps;
  cudaError_t err = cudaFuncSetAttribute(
      scan_rows_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  scan_rows_kernel<K><<<rows, kThreads, smem, stream>>>(
      tiles, qq, valid_w, qlen, thr, off, kmin, k2, t, we, w, lmax, lsteps,
      mpm, shift, dead);
  return cudaGetLastError();
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
  // Candidates per thread.  A thread scans all K of its slots, valid or
  // not, so a K above `per` wastes (K - per) / K of the step work.  The K
  // set follows the window buckets (128 * 2^k and 192 * 2^k): at lmax 128,
  // w = 128 needs 1, 192-384 need 2, 512 needs 3, 768 needs 4, 1024 needs
  // 5, 1536 needs 7, 2048 needs 9 and 3072 needs 13.
  const int per = (we + kThreads - 1) / kThreads;
  const auto *a = static_cast<const int8_t *>(tiles);
  const auto *b = static_cast<const int8_t *>(qq);
  const auto *c = static_cast<const int32_t *>(valid_w);
  const auto *d = static_cast<const int32_t *>(qlen);
  const auto *e = static_cast<const int32_t *>(thr);
  const auto *f = static_cast<const int32_t *>(off);
  auto *g = static_cast<int32_t *>(kmin);
  auto *h = static_cast<int32_t *>(k2);
  auto s = static_cast<cudaStream_t>(stream);
#define PT_LAUNCH(K)                                                       \
  launch<K>(a, b, c, d, e, f, g, h, rows, t, we, w, lmax, lsteps, mpm,     \
            shift, dead, s)
  cudaError_t err;
  if (per <= 1) err = PT_LAUNCH(1);
  else if (per <= 2) err = PT_LAUNCH(2);
  else if (per <= 3) err = PT_LAUNCH(3);
  else if (per <= 4) err = PT_LAUNCH(4);
  else if (per <= 6) err = PT_LAUNCH(6);
  else if (per <= 8) err = PT_LAUNCH(8);
  else if (per <= 12) err = PT_LAUNCH(12);
  else err = PT_LAUNCH(16);   // wider windows walk several chunks
#undef PT_LAUNCH
  return static_cast<int>(err);
}
