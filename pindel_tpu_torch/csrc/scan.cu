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
//   parallelism against warps in flight; both are set at build time
//   (SCAN_MAX_K, SCAN_MIN_BLOCKS).
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
//
// The per-row walk (seed pass, sparse and dense walkers, the reduction) is
// in scan_walk.cuh, which the fused close/far kernels (fused_search.cu)
// share; this file holds the kernel over materialised tiles and its launch.
#include <algorithm>
#include <atomic>
#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#include "scan_walk.cuh"

namespace {

using namespace ptscan;

constexpr int kMaxDevices = 64;

// A row's tile as the caller materialised it: t bytes from p.
struct RowTile {
  const int8_t *p;
  int t;
  __device__ __forceinline__ int at(int i) const { return p[i]; }
  // Copy tile bytes [seg0, seg0 + n) into buf, bytes at or past t read as N.
  __device__ __forceinline__ void stage(int8_t *buf, int seg0, int n,
                                        int lane) const {
    __syncwarp();   // the walk is done with the previous segment
    for (int i = lane; i < n; i += 32) {
      buf[i] = seg0 + i < t ? p[seg0 + i] : static_cast<int8_t>(kCodeN);
    }
    __syncwarp();
  }
};

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
  const RowTile tile{tiles + static_cast<size_t>(row) * t, t};
  const int8_t *q = qq + static_cast<size_t>(row) * lmax;
  Row r;
  r.meta = meta;
  r.acc1 = acc1;
  r.acc2 = acc2;
  const int vw = valid_w[row];
  init_row(r, q[0], vw, qlen[row], off[row], thr[row], we, w, shift, dead,
           lsteps, mpm);
  build_meta(meta, q, lmax, lsteps, r.steps1, threadIdx.x, 32 * NW);
  init_acc(acc1, acc2, ngroups, lane);
  __syncthreads();   // meta is complete

  walk_row(r, tile, vw, we, seg, NW, warp, lane, buf, list);
  __syncthreads();   // every warp's accumulators are complete

  // fold the warps' pairs (order-free) and write the row coalesced
  int32_t *kmin_row = kmin + static_cast<size_t>(row) * lmax;
  int32_t *k2_row = k2 + static_cast<size_t>(row) * lmax;
  for (int l = threadIdx.x; l < lmax; l += 32 * NW) {
    int a1, a2;
    fold_step<NW>(smem + lay.meta, lay.warp, ngroups, l, lsteps, a1, a2);
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
