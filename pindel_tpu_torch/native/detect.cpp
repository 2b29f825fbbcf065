// Native anchor-pair selection for the event detectors (C ABI, ctypes).
//
// For each candidate read, the reference detectors scan close x far anchor
// pairs under an escalating mismatch budget and take the first pair passing
// a geometry predicate (SearchVariant::Search, search_variant.cpp:48-266;
// searchTandemDuplications, search_tandem_duplications.cpp:28-187;
// searchInversions, search_inversions.cpp:30-280).  The first hit of those
// loops minimizes the lexicographic key
//     (close.mm + far.mm, ci_order, fi_order)
// over pairs passing the predicate, where ci/fi_order follow each branch's
// scan direction — so one argmin pass over the ragged anchor arrays is
// bit-equivalent and replaces ~1600 Python-level pair checks per read.
//
// Anchor chains arrive as ragged struct-of-arrays (offsets + concatenated
// fields); the per-read branch code is chosen by the Python caller (it
// encodes matched strand and, for inversions, the precondition branch).

#include <cstdint>
#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

struct Best {
  int64_t summ;
  int64_t ckey;
  int64_t fkey;
  int32_t ci;
  int32_t fi;
};

inline void consider(Best& b, int64_t summ, int64_t ckey, int64_t fkey,
                     int32_t ci, int32_t fi) {
  if (summ < b.summ || (summ == b.summ && (ckey < b.ckey ||
      (ckey == b.ckey && fkey < b.fkey)))) {
    b.summ = summ;
    b.ckey = ckey;
    b.fkey = fkey;
    b.ci = ci;
    b.fi = fi;
  }
}

}  // namespace

extern "C" {

// Branch codes (see events/detect.py): 0 D+, 1 D-, 2 SI+, 3 SI-, 4 TD+,
// 5 TD-, 6 INVp1, 7 INVp2, 8 INVm1, 9 INVm2; 255 = skip this read.
//
// cl_off/fa_off: [n+1] prefix offsets into the concatenated anchor arrays.
// Outputs out_ci/out_fi get -1 when no pair qualifies.
// num_threads: OpenMP worker count (the -T flag; reads are independent,
// outputs indexed per read, so the parallel loop is deterministic —
// reference precedent: the OpenMP read loops in read_buffer.cpp:39-101).
void ptdetect_first_pairs(
    int64_t n, const uint8_t* branch, const int64_t* max_snp,
    const int64_t* rdlen, int64_t min_inv,
    const int64_t* cl_off, const int64_t* cl_len, const int64_t* cl_loc,
    const int64_t* cl_mm,
    const int64_t* fa_off, const int64_t* fa_len, const int64_t* fa_loc,
    const int64_t* fa_mm, const uint8_t* fa_dm,
    int32_t* out_ci, int32_t* out_fi, int32_t num_threads) {
  const int64_t kBig = INT64_MAX;
#ifdef _OPENMP
#pragma omp parallel for schedule(static) \
    num_threads(num_threads > 0 ? num_threads : 1)
#endif
  for (int64_t i = 0; i < n; i++) {
    out_ci[i] = -1;
    out_fi[i] = -1;
    const uint8_t br = branch[i];
    if (br > 9) continue;
    const int64_t c0 = cl_off[i], c1 = cl_off[i + 1];
    const int64_t f0 = fa_off[i], f1 = fa_off[i + 1];
    const int64_t nc = c1 - c0, nf = f1 - f0;
    if (nc == 0 || nf == 0) continue;
    const int64_t L = rdlen[i];
    const int64_t budget = max_snp[i];
    // scan orders per branch (ci ascending?, fi ascending?)
    bool ci_asc, fi_asc;
    switch (br) {
      case 0: case 2: case 4: case 7: case 9:
        ci_asc = true;  fi_asc = false; break;
      case 5: case 6: case 8:
        ci_asc = false; fi_asc = true;  break;
      default:  // 1, 3
        ci_asc = false; fi_asc = false; break;
    }
    // inversions / TD- require far dir '+', D+/SI+/TD+ require '-', etc.
    // encoded below per branch as want_dm.
    bool want_dm;
    switch (br) {
      case 0: case 2: case 4: case 8: case 9: want_dm = true; break;
      default: want_dm = false; break;
    }
    Best best{kBig, kBig, kBig, -1, -1};
    for (int64_t c = 0; c < nc; c++) {
      const int64_t clen = cl_len[c0 + c];
      const int64_t cloc = cl_loc[c0 + c];
      const int64_t cmm = cl_mm[c0 + c];
      if (cmm > budget) continue;
      const int64_t ckey = ci_asc ? c : (nc - 1 - c);
      for (int64_t f = 0; f < nf; f++) {
        if ((fa_dm[f0 + f] != 0) != want_dm) continue;
        const int64_t fmm = fa_mm[f0 + f];
        const int64_t summ = cmm + fmm;
        if (summ > budget) continue;
        const int64_t flen = fa_len[f0 + f];
        const int64_t floc = fa_loc[f0 + f];
        bool ok;
        switch (br) {
          case 0:  // D, '+' anchor (searchdeletions.cpp:38-48)
            ok = (flen + clen == L) && (floc > cloc + 1);
            break;
          case 1:  // D, '-'
            ok = (clen + flen == L) && (cloc > floc + 1);
            break;
          case 2:  // SI, '+' (searchshortinsertions.cpp:38-48)
            ok = (floc == cloc + 1) && (clen + flen < L);
            break;
          case 3:  // SI, '-'
            ok = (cloc == floc + 1) && (flen + clen < L);
            break;
          case 4:  // TD, '+' (search_tandem_duplications.cpp:60-96)
            ok = (flen + clen == L) && (floc + flen < cloc) &&
                 (floc + clen < cloc);
            break;
          case 5:  // TD, '-'
            ok = (clen + flen == L) && (cloc + clen < floc) &&
                 (cloc + flen < floc);
            break;
          case 6:  // INV '+' far-downstream (search_inversions.cpp:50-128)
            ok = (clen + flen == L) && (floc > cloc + min_inv);
            break;
          case 7:  // INV '+' far-upstream
            ok = (clen + flen == L) && (floc + min_inv < cloc);
            break;
          case 8:  // INV '-' close-downstream
            ok = (clen + flen == L) && (cloc > floc + min_inv);
            break;
          default:  // 9: INV '-' close-upstream
            ok = (clen + flen == L) && (cloc + min_inv < floc);
            break;
        }
        if (!ok) continue;
        const int64_t fkey = fi_asc ? f : (nf - 1 - f);
        consider(best, summ, ckey, fkey, static_cast<int32_t>(c),
                 static_cast<int32_t>(f));
      }
    }
    out_ci[i] = best.ci;
    out_fi[i] = best.fi;
  }
}

// SortOutputDI's in-place exchange sort (reporter.cpp:1718-1752): swaps
// on strict key order only, so the order of tied elements depends on the
// swap history and cannot be expressed as a sort key — run the literal
// loop natively.  idx is permuted in place.
void ptdetect_di_sort(int64_t n, const int64_t* bpl, const int64_t* bpr,
                      const int64_t* nts, const int64_t* bp,
                      int64_t* idx) {
  for (int64_t first = 0; first + 1 < n; first++) {
    for (int64_t second = first + 1; second < n; second++) {
      const int64_t a = idx[first], b = idx[second];
      bool swap;
      if (bpl[a] < bpl[b]) continue;
      else if (bpl[a] > bpl[b]) swap = true;
      else if (bpr[a] < bpr[b]) continue;
      else if (bpr[a] > bpr[b]) swap = true;
      else if (nts[a] < nts[b]) continue;
      else if (nts[a] > nts[b]) swap = true;
      else swap = bp[a] > bp[b];
      if (swap) {
        idx[first] = b;
        idx[second] = a;
      }
    }
  }
}

}  // extern "C"
