// Native core of ModifyRP's pairwise merge (reference bddata.cpp:386-436
// nested loop over RecipicalOverlap :180-237 and
// ProcessSameChromosomeSameStrand :302-353).  The loop is inherently
// sequential — a merge updates `first`, visible to its remaining
// reciprocal-overlap tests — so it vectorizes poorly; at C speed with a
// midpoint-interval early-out it is O(n^2) with a ~4-instruction inner
// test, microseconds at per-window discordant-pair counts.
//
// Inputs are SoA arrays AFTER InitializeA1B1; pos arrays are mutated in
// place exactly like the reference's object fields.
#include <cstdint>
#include <cstdlib>

namespace {

struct State {
  int64_t *pos_a, *pos_a1, *pos_b, *pos_b1;
  const uint8_t *da, *db;
  int64_t *lo, *hi;          // midpoint interval, maintained on merge
  const uint8_t *span_ok;    // spans <= 1000 (invariant under merges)
};

inline void refresh(State& s, int64_t i) {
  int64_t ma = (s.pos_a[i] + s.pos_a1[i]) >> 1;
  int64_t mb = (s.pos_b[i] + s.pos_b1[i]) >> 1;
  s.lo[i] = ma < mb ? ma : mb;
  s.hi[i] = ma < mb ? mb : ma;
}

// RecipicalOverlap (bddata.cpp:180-237); strand equality and the span
// test are hoisted by the caller.  Ratio compares use double division
// like the reference.
inline bool overlap(const State& s, int64_t i, int64_t j) {
  double fa = (double)s.lo[i], fb = (double)s.hi[i];
  double sa = (double)s.lo[j], sb = (double)s.hi[j];
  const double cutoff = 0.9;
  if (fa <= sa && sb <= fb) {
    if ((sb - sa) / (fb - fa) >= cutoff) return true;
  }
  if (sa <= fa && fb <= sb) {
    if ((fb - fa) / (sb - sa) >= cutoff) return true;
  }
  if (fa <= sa && sa <= fb && fb <= sb) {
    if ((fb - sa) / (fb - fa) >= cutoff && (fb - sa) / (sb - sa) >= cutoff)
      return true;
  }
  if (sa <= fa && fa <= sb && sb <= fb) {
    if ((sb - fa) / (fb - fa) >= cutoff && (sb - fa) / (sb - sa) >= cutoff)
      return true;
  }
  return false;
}

// ProcessSameChromosomeSameStrand (bddata.cpp:302-353); returns whether
// `first` changed.
inline bool process(State& s, int64_t i, int64_t j) {
  if (s.pos_a1[j] - s.pos_a[j] > 10000 || s.pos_b1[j] - s.pos_b[j] > 10000)
    return false;
  bool changed = false;
  if ((s.da[i] && s.pos_a[i] < s.pos_a[j] && s.pos_a[j] < s.pos_a1[i]
       && s.pos_a1[i] < s.pos_a1[j])
      || (!s.da[i] && s.pos_a[i] < s.pos_a1[j] && s.pos_a1[j] < s.pos_a1[i]
          && s.pos_a[j] < s.pos_a[i])) {
    s.pos_a[i] = s.pos_a[j];
    s.pos_a1[i] = s.pos_a1[j];
    changed = true;
  }
  if ((s.db[i] && s.pos_b[i] < s.pos_b[j] && s.pos_b[j] < s.pos_b1[i]
       && s.pos_b1[i] < s.pos_b1[j])
      || (!s.db[i] && s.pos_b[j] < s.pos_b[i] && s.pos_b[i] < s.pos_b1[j]
          && s.pos_b1[j] < s.pos_b1[i])) {
    s.pos_b[i] = s.pos_b[j];
    s.pos_b1[i] = s.pos_b1[j];
    changed = true;
  }
  return changed;
}

}  // namespace

extern "C" {

// Runs the full sequential merge; lo/hi are scratch outputs the caller
// allocates (final values reflect post-merge midpoints).
void ptrp_modify(int64_t n, int64_t* pos_a, int64_t* pos_a1,
                 int64_t* pos_b, int64_t* pos_b1,
                 const uint8_t* da, const uint8_t* db,
                 const uint8_t* span_ok, int64_t* lo, int64_t* hi) {
  State s{pos_a, pos_a1, pos_b, pos_b1, da, db, lo, hi, span_ok};
  for (int64_t i = 0; i < n; i++) refresh(s, i);
  for (int64_t i = 0; i < n; i++) {
    if (!span_ok[i]) continue;
    const uint8_t dai = da[i], dbi = db[i];
    for (int64_t j = 0; j < n; j++) {
      if (da[j] != dai || db[j] != dbi || !span_ok[j]) continue;
      // proximity early-out (the reference's fa > sb+200 / fb+200 < sa)
      if (s.lo[i] > s.hi[j] + 200 || s.hi[i] + 200 < s.lo[j]) continue;
      if (!overlap(s, i, j)) continue;
      if (process(s, i, j)) refresh(s, i);
    }
  }
}

}  // extern "C"
