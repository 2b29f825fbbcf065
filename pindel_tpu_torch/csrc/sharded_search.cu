// Per-shard partials of the window-parallel search for Hopper (sm_90a).
//
// Replaces one shard's step of pindel_tpu/parallel/mesh.py:
// _search_step_local (XLA under shard_map, with a pmin/psum over the wp
// axis at every step).  One launch computes, for the rows of one batch slice
// and the candidate columns [off, off + w_local) of every lane, at every
// step l < lmax:
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
// candidates are walked, and each only until it dies: it adds its death
// step to a per-step difference array, and a prefix over the steps (plus
// the unseeded candidates, counted once) gives the DEAD slots.  Keys grow
// with the candidate index, so a thread's first unseeded candidate is its
// smallest.  At step 0 every live seeded candidate is at level 0 with no
// strict mismatch (the JAX ring is cleared at step 0); a thread sums those
// in registers and folds them in once.
//
// Design (simple first, not tuned): one block of 256 threads per row; the
// row's lane starts, directions, valid widths and queries are staged in
// shared memory; threads stride over the row's nl * w_local candidates,
// read the tile straight from the chromosome (the shard's tile start is
// wrapped and clamped as jax.lax.dynamic_slice does), and fold each live
// step into shared-memory histograms with atomicAdd / atomicMin, which are
// order-free, so the result does not depend on the schedule.  The
// histograms go to device memory once per row.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kN = 4;                       // dna.N
constexpr int kNoKey = 0x7fffffff;
constexpr int kNever = -(1 << 20);

struct Layout {
  // int32 words: cnt[lmax*(T+1)], dcnt[lmax], key[lmax*(S+1)], dkey[lmax],
  // start[nl], vw[nl], tm/unseeded count/unseeded key/level-0 count and
  // key (5); then bytes: rev[nl], qq[nl*lmax]
  int cnt, dcnt, key, dkey, start, vw, misc, words;
  size_t rev, qq, total;
  __host__ __device__ Layout(int lmax, int nl, int t_levels, int s_levels) {
    cnt = 0;
    dcnt = cnt + lmax * (t_levels + 1);
    key = dcnt + lmax;
    dkey = key + lmax * (s_levels + 1);
    start = dkey + lmax;
    vw = start + nl;
    misc = vw + nl;
    words = misc + 5;
    rev = sizeof(int32_t) * static_cast<size_t>(words);
    qq = rev + nl;
    total = qq + static_cast<size_t>(nl) * lmax;
  }
};

__global__ void __launch_bounds__(kThreads)
shard_kernel(const int8_t *__restrict__ chrom, long long chrom_len,
             const int32_t *__restrict__ slice_start,
             const uint8_t *__restrict__ reverse,
             const int8_t *__restrict__ qq,
             const int32_t *__restrict__ valid_w,
             const int32_t *__restrict__ tsec_minus,
             int32_t *__restrict__ cnt_out, int32_t *__restrict__ key_out,
             int nl, int w_total, int w_local, int off, int lmax, int mpm,
             int t_levels, int s_levels) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay(lmax, nl, t_levels, s_levels);
  int32_t *words = reinterpret_cast<int32_t *>(smem);
  int32_t *s_cnt = words + lay.cnt;
  int32_t *s_dcnt = words + lay.dcnt;
  int32_t *s_key = words + lay.key;
  int32_t *s_dkey = words + lay.dkey;
  int32_t *s_start = words + lay.start;
  int32_t *s_vw = words + lay.vw;
  int32_t *s_misc = words + lay.misc;
  uint8_t *s_rev = smem + lay.rev;
  int8_t *s_qq = reinterpret_cast<int8_t *>(smem + lay.qq);
  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int tile_len = w_local + lmax;
  const int t1 = t_levels + 1, s1 = s_levels + 1;

  for (int i = tid; i < lmax * t1; i += kThreads) s_cnt[i] = 0;
  for (int i = tid; i < lmax * s1; i += kThreads) s_key[i] = kNoKey;
  for (int i = tid; i < lmax; i += kThreads) {
    s_dcnt[i] = 0;
    s_dkey[i] = kNoKey;
  }
  for (int j = tid; j < nl; j += kThreads) {
    const int rv = reverse[row * nl + j] != 0;
    // the shard's tile start, as jax.lax.dynamic_slice takes it
    long long st = static_cast<long long>(slice_start[row * nl + j]) +
                   (rv ? (w_total - w_local - off) : off);
    if (st < 0) st += chrom_len;
    st = st < 0 ? 0 : st;
    if (st > chrom_len - tile_len) st = chrom_len - tile_len;
    s_start[j] = static_cast<int32_t>(st);
    s_rev[j] = static_cast<uint8_t>(rv);
    s_vw[j] = valid_w[row * nl + j];
  }
  for (int i = tid; i < nl * lmax; i += kThreads)
    s_qq[i] = qq[static_cast<size_t>(row) * nl * lmax + i];
  if (tid == 0) {
    s_misc[0] = tsec_minus[row];
    s_misc[1] = 0;        // unseeded (or dead-at-step-0) candidates
    s_misc[2] = kNoKey;   // their smallest 2 * key
    s_misc[3] = 0;        // live at step 0 (level 0)
    s_misc[4] = kNoKey;   // their smallest 2 * key (strict bit 0)
  }
  __syncthreads();

  const int tm = s_misc[0];
  int n_unseeded = 0, min_unseeded = kNoKey;
  int n_zero = 0, min_zero = kNoKey;
  const int n_cand = nl * w_local;
  for (int c = tid; c < n_cand; c += kThreads) {
    const int j = c / w_local;
    const int u = c - j * w_local;
    const int key2 = (j * w_total + off + u) * 2;
    const int8_t *q = s_qq + j * lmax;
    const bool rv = s_rev[j] != 0;
    const long long base = s_start[j];
    // tile index t -> chromosome position
    const long long p0 = rv ? base + tile_len - 1 - u : base + u;
    const int8_t first = chrom[p0];
    const bool seeded = off + u < s_vw[j] && q[0] != kN && first == q[0];
    if (!seeded || tm < 0) {
      if (n_unseeded++ == 0) min_unseeded = key2;
      continue;
    }
    if (n_zero++ == 0) min_zero = key2;
    int cum = 0, last = kNever;
    for (int l = 1; l < lmax; ++l) {
      const int8_t r = chrom[rv ? p0 - l : p0 + l];
      const int8_t qb = q[l];
      const int strict = r != qb;
      cum += strict ^ (qb == kN);
      if (strict) last = l;
      if (cum > tm) {
        atomicAdd(&s_dcnt[l], 1);
        atomicMin(&s_dkey[l], key2);
        break;
      }
      atomicAdd(&s_cnt[l * t1 + cum], 1);
      if (cum <= s_levels)
        atomicMin(&s_key[l * s1 + cum], key2 | (last > l - mpm ? 1 : 0));
    }
  }
  if (n_unseeded) {
    atomicAdd(&s_misc[1], n_unseeded);
    atomicMin(&s_misc[2], min_unseeded);
  }
  if (n_zero) {
    atomicAdd(&s_misc[3], n_zero);
    atomicMin(&s_misc[4], min_zero);
  }
  __syncthreads();

  if (tid == 0) {
    // DEAD at step l: the unseeded candidates and every seeded one that
    // died at a step <= l
    int dc = s_misc[1], dk = s_misc[2];
    for (int l = 0; l < lmax; ++l) {
      dc += s_dcnt[l];
      dk = min(dk, s_dkey[l]);
      s_dcnt[l] = dc;
      s_dkey[l] = dk;
    }
    s_cnt[0] = s_misc[3];
    if (s_levels >= 0) s_key[0] = s_misc[4];
  }
  __syncthreads();

  const int tw = t_levels + 2, sw = s_levels + 2;
  int32_t *cnt_row = cnt_out + static_cast<size_t>(row) * lmax * tw;
  int32_t *key_row = key_out + static_cast<size_t>(row) * lmax * sw;
  for (int i = tid; i < lmax * tw; i += kThreads) {
    const int l = i / tw, v = i - l * tw;
    cnt_row[i] = v < t1 ? s_cnt[l * t1 + v] : s_dcnt[l];
  }
  for (int i = tid; i < lmax * sw; i += kThreads) {
    const int l = i / sw, v = i - l * sw;
    key_row[i] = v < s1 ? s_key[l * s1 + v] : s_dkey[l];
  }
}

}  // namespace

extern "C" size_t pt_shard_smem(int lmax, int nl, int t_levels,
                                int s_levels) {
  return Layout(lmax, nl, t_levels, s_levels).total;
}

extern "C" int pt_shard_partials(const void *chrom, long long chrom_len,
                                 const void *slice_start,
                                 const void *reverse, const void *qq,
                                 const void *valid_w, const void *tsec_minus,
                                 void *cnt, void *key, int rows, int nl,
                                 int w_total, int w_local, int off, int lmax,
                                 int mpm, int t_levels, int s_levels,
                                 void *stream) {
  if (rows == 0) return 0;
  const size_t smem = Layout(lmax, nl, t_levels, s_levels).total;
  cudaError_t err = cudaFuncSetAttribute(
      shard_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  shard_kernel<<<rows, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t *>(chrom), chrom_len,
      static_cast<const int32_t *>(slice_start),
      static_cast<const uint8_t *>(reverse),
      static_cast<const int8_t *>(qq),
      static_cast<const int32_t *>(valid_w),
      static_cast<const int32_t *>(tsec_minus),
      static_cast<int32_t *>(cnt), static_cast<int32_t *>(key), nl, w_total,
      w_local, off, lmax, mpm, t_levels, s_levels);
  return static_cast<int>(cudaGetLastError());
}
