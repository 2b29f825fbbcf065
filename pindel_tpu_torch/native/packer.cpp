// Native close/far payload packer (ctypes; see ops/engine_fused.py).
//
// Builds the device upload payload for a read chunk in ONE pass over
// the concatenated ASCII sequences: 4-bit base codes of the original
// and (close path) the within-qlen-reversed sequence, nibble-packed
// exactly like _pack_payload, followed by the bit-packed int32 meta
// words.  Replaces a chain of numpy passes (encode, fancy-gather,
// reverse take_along, concatenate, nibble pack) that sat on the kernel
// dispatch critical path.
//
// Base coding matches pindel_tpu.dna: A=0 C=1 G=2 T=3, everything else
// N=4 (case-insensitive).
#include <cstdint>
#include <cstring>

namespace {

inline int8_t code_of(uint8_t c) {
  switch (c) {
    case 'A': case 'a': return 0;
    case 'C': case 'c': return 1;
    case 'G': case 'g': return 2;
    case 'T': case 't': return 3;
    default: return 4;
  }
}

}  // namespace

extern "C" {

// Close payload: rows [b, lmax + 4*nmeta] int8.  seqs = concatenated
// ASCII sequences, offs[i]..offs[i+1] row i (n rows; rows n..b are
// padding: all-N codes).  meta32 [b, nmeta] int32 row-major is appended
// verbatim.  The first lmax bytes of a row hold the nibble-packed
// [f | reverse-within-qlen(f)] code pair stream.
void pt_pack_close(const char* seqs, const int64_t* offs, int64_t n,
                   int64_t b, int64_t lmax, const int32_t* meta32,
                   int64_t nmeta, int8_t* out) {
  const int64_t row_bytes = lmax + 4 * nmeta;
  const uint8_t NN = 4 | (4 << 4);
  for (int64_t i = 0; i < b; i++) {
    int8_t* row = out + i * row_bytes;
    if (i >= n) {
      memset(row, NN, lmax);
    } else {
      const char* s = seqs + offs[i];
      int64_t q = offs[i + 1] - offs[i];
      if (q > 2 * lmax) q = 2 * lmax;  // caller guarantees q <= lmax
      // f codes: pairs (f[2k], f[2k+1]) -> byte k for k < lmax/2
      int64_t half = lmax / 2;
      for (int64_t k = 0; k < half; k++) {
        int64_t j0 = 2 * k, j1 = 2 * k + 1;
        uint8_t lo = j0 < q ? code_of(s[j0]) : 4;
        uint8_t hi = j1 < q ? code_of(s[j1]) : 4;
        row[k] = static_cast<int8_t>(lo | (hi << 4));
      }
      // rf codes: rf[j] = f[q-1-j] for j < q else N
      for (int64_t k = 0; k < half; k++) {
        int64_t j0 = 2 * k, j1 = 2 * k + 1;
        uint8_t lo = j0 < q ? code_of(s[q - 1 - j0]) : 4;
        uint8_t hi = j1 < q ? code_of(s[q - 1 - j1]) : 4;
        row[half + k] = static_cast<int8_t>(lo | (hi << 4));
      }
    }
    memcpy(row + lmax, meta32 + i * nmeta, 4 * nmeta);
  }
}

// Far payload: same layout but only the original codes (lmax/2 bytes of
// nibble-packed f).
void pt_pack_far(const char* seqs, const int64_t* offs, int64_t n,
                 int64_t b, int64_t lmax, const int32_t* meta32,
                 int64_t nmeta, int8_t* out) {
  const int64_t half = lmax / 2;
  const int64_t row_bytes = half + 4 * nmeta;
  const uint8_t NN = 4 | (4 << 4);
  for (int64_t i = 0; i < b; i++) {
    int8_t* row = out + i * row_bytes;
    if (i >= n) {
      memset(row, NN, half);
    } else {
      const char* s = seqs + offs[i];
      int64_t q = offs[i + 1] - offs[i];
      for (int64_t k = 0; k < half; k++) {
        int64_t j0 = 2 * k, j1 = 2 * k + 1;
        uint8_t lo = j0 < q ? code_of(s[j0]) : 4;
        uint8_t hi = j1 < q ? code_of(s[j1]) : 4;
        row[k] = static_cast<int8_t>(lo | (hi << 4));
      }
    }
    memcpy(row + half, meta32 + i * nmeta, 4 * nmeta);
  }
}

// Plain code matrix [b, lmax] int8 (N-padded) from concatenated ASCII —
// the _pack_codes twin for paths that need unpacked codes on host
// (decode).
void pt_codes(const char* seqs, const int64_t* offs, int64_t n,
              int64_t b, int64_t lmax, int8_t* out) {
  for (int64_t i = 0; i < b; i++) {
    int8_t* row = out + i * lmax;
    if (i >= n) {
      memset(row, 4, lmax);
      continue;
    }
    const char* s = seqs + offs[i];
    int64_t q = offs[i + 1] - offs[i];
    int64_t j = 0;
    for (; j < q && j < lmax; j++) row[j] = code_of(s[j]);
    for (; j < lmax; j++) row[j] = 4;
  }
}

}  // extern "C"

// Variants taking per-read (absolute offset, length) pairs into an
// arbitrary byte buffer (the raw record blob of the lazy text-intake
// batch) instead of a contiguous concatenation.

extern "C" {

void pt_pack_close_at(const char* buf, const int64_t* off,
                      const int64_t* len, int64_t n, int64_t b,
                      int64_t lmax, const int32_t* meta32, int64_t nmeta,
                      int8_t* out) {
  const int64_t row_bytes = lmax + 4 * nmeta;
  const uint8_t NN = 4 | (4 << 4);
  for (int64_t i = 0; i < b; i++) {
    int8_t* row = out + i * row_bytes;
    if (i >= n) {
      memset(row, NN, lmax);
    } else {
      const char* s = buf + off[i];
      int64_t q = len[i];
      int64_t half = lmax / 2;
      for (int64_t k = 0; k < half; k++) {
        int64_t j0 = 2 * k, j1 = 2 * k + 1;
        uint8_t lo = j0 < q ? code_of(s[j0]) : 4;
        uint8_t hi = j1 < q ? code_of(s[j1]) : 4;
        row[k] = static_cast<int8_t>(lo | (hi << 4));
      }
      for (int64_t k = 0; k < half; k++) {
        int64_t j0 = 2 * k, j1 = 2 * k + 1;
        uint8_t lo = j0 < q ? code_of(s[q - 1 - j0]) : 4;
        uint8_t hi = j1 < q ? code_of(s[q - 1 - j1]) : 4;
        row[half + k] = static_cast<int8_t>(lo | (hi << 4));
      }
    }
    memcpy(row + lmax, meta32 + i * nmeta, 4 * nmeta);
  }
}

void pt_codes_at(const char* buf, const int64_t* off, const int64_t* len,
                 int64_t n, int64_t b, int64_t lmax, int8_t* out) {
  for (int64_t i = 0; i < b; i++) {
    int8_t* row = out + i * lmax;
    if (i >= n) {
      memset(row, 4, lmax);
      continue;
    }
    const char* s = buf + off[i];
    int64_t q = len[i];
    int64_t j = 0;
    for (; j < q && j < lmax; j++) row[j] = code_of(s[j]);
    for (; j < lmax; j++) row[j] = 4;
  }
}

}  // extern "C"
