// Native local-alignment subsequence test for DD/MEI detection (C ABI,
// loaded via ctypes).
//
// Re-implements the reference's SW-like scorer `contains_subseq`
// (search_MEI_util.cpp:188-342) exactly: two rolling rows over
// (query x db) tracking, per cell, the alignment length and mismatch
// count of the best-scoring local alignment (match +1, mismatch/gap -2),
// returning true as soon as a cell reaches length >= min_length with
// mismatches <= maxmm[length]; rows carry the same early-abandon bound
// as the reference.
//
// The any-strand wrapper (search_MEI_util.cpp:348-351) lives in Python —
// it just calls this twice, the second time with the reverse complement.

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// query/db: ASCII bases.  maxmm: table indexed by alignment length
// (maxmm_len entries; lengths beyond the table clamp to the last entry).
// Returns 1 if a qualifying local alignment exists, else 0.
int32_t ptseq_contains_subseq(const char* query, int64_t query_length,
                              const char* db, int64_t db_length,
                              int32_t min_length, const int32_t* maxmm,
                              int64_t maxmm_len) {
  if (db_length <= 0 || query_length <= 0) return 0;
  auto budget = [&](int64_t len) -> int32_t {
    if (len < 0) return 0;
    if (len >= maxmm_len) len = maxmm_len - 1;
    return maxmm[len];
  };
  // Minimum nr of matches in a valid alignment (reference :195).
  int32_t min_match_length = min_length - budget(min_length);

  std::vector<int32_t> mcA(db_length, 0), mcB(db_length, 0);
  std::vector<int32_t> alA(db_length, 0), alB(db_length, 0);
  int32_t* prev_mc = mcA.data();
  int32_t* cur_mc = mcB.data();
  int32_t* prev_al = alA.data();
  int32_t* cur_al = alB.data();

  for (int64_t i = 0; i < query_length; i++) {
    int32_t min_mm_row = 0;     // reference starts these at 0 (:228-229)
    int32_t max_al_row = 0;
    cur_mc[0] = 0;
    cur_al[0] = 0;
    if (db[0] == query[i]) {
      cur_mc[0] = 0;
      cur_al[0] = 1;
    }
    for (int64_t j = 1; j < db_length; j++) {
      int32_t max_score = 0;
      char action = 'n';
      int32_t score;
      // match of current bases
      score = (prev_al[j - 1] + 1) * 1 + prev_mc[j - 1] * -2;
      if (query[i] == db[j] && max_score < score) {
        max_score = score;
        action = 'm';
      } else {
        // substitution
        score = prev_al[j - 1] * 1 + (prev_mc[j - 1] + 1) * -2;
        if (max_score < score) {
          max_score = score;
          action = 'M';
        }
      }
      // gap on query
      score = cur_al[j - 1] * 1 + (cur_mc[j - 1] + 1) * -2;
      if (max_score < score) {
        max_score = score;
        action = 'g';
      }
      // gap on db
      score = (prev_al[j] + 1) * 1 + (prev_mc[j] + 1) * -2;
      if (max_score < score) {
        max_score = score;
        action = 'G';
      }
      switch (action) {
        case 'g':
          cur_mc[j] = cur_mc[j - 1] + 1;
          cur_al[j] = cur_al[j - 1];
          break;
        case 'G':
          cur_mc[j] = prev_mc[j] + 1;
          cur_al[j] = prev_al[j] + 1;
          break;
        case 'm':
          cur_mc[j] = prev_mc[j - 1];
          cur_al[j] = prev_al[j - 1] + 1;
          break;
        case 'M':
          cur_mc[j] = prev_mc[j - 1] + 1;
          cur_al[j] = prev_al[j - 1] + 1;
          break;
        default:  // new alignment
          if (query[i] == db[j]) {
            cur_mc[j] = 0;
            cur_al[j] = 1;
          } else {
            cur_mc[j] = 1;
            cur_al[j] = 1;
          }
          break;
      }
      if (cur_al[j] >= min_length && cur_mc[j] <= budget(cur_al[j]))
        return 1;
      if (cur_mc[j] < min_mm_row) min_mm_row = cur_mc[j];
      if (cur_al[j] > max_al_row) max_al_row = cur_al[j];
    }
    if (static_cast<int32_t>(query_length - i - 1)
            + (max_al_row - min_mm_row) < min_match_length)
      return 0;  // even a perfect remainder cannot qualify (:322-328)
    std::swap(prev_al, cur_al);
    std::swap(prev_mc, cur_mc);
  }
  return 0;
}

}  // extern "C"
