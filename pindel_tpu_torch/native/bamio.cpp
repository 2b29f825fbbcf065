// Native BAM ingestion for pindel_tpu (C ABI, loaded via ctypes).
//
// Re-implements the reference's split-read BAM channel semantics
// (reference: reader.cpp — ReadInBamReads_SR :483-559, fetch_func_SR
// :1099-1151, isWeirdRead :661-690, isGoodAnchor :561-613, isRefRead
// :620-656, build_record_SR :799-898, build_record_RefRead :903-922,
// parse_flags_and_tags :1258-1316, bam_cigar2len :1318-1333,
// bam_cigar2mismatch :1335-1346, HasIndel :706-718) on top of a
// from-scratch BGZF/BAM parser (no htslib).  The whole file is decoded
// once into struct-of-arrays in memory; window queries are binary
// searches.  This is the host data plane of the TPU pipeline: it feeds
// packed read batches to the JAX search engine.
//
// BGZF is a sequence of gzip members, which zlib's gzFile reads
// transparently; random access via .bai is not needed for the
// sequential full-file decode.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

#include <zlib.h>

namespace {

constexpr uint16_t FLAG_PAIRED = 0x1;
constexpr uint16_t FLAG_UNMAP = 0x4;
constexpr uint16_t FLAG_MUNMAP = 0x8;
constexpr uint16_t FLAG_REVERSE = 0x10;
constexpr uint16_t FLAG_MREVERSE = 0x20;
constexpr uint16_t FLAG_READ1 = 0x40;
constexpr uint16_t FLAG_READ2 = 0x80;
constexpr uint16_t FLAG_SECONDARY = 0x100;
constexpr uint16_t FLAG_QCFAIL = 0x200;
constexpr uint16_t FLAG_DUP = 0x400;

const char SEQ_NT16[] = "=ACMGRSVTWYHKDBN";

struct Record {
  int32_t tid;
  int64_t pos;
  int64_t endpos;       // half-open reference end (pos+1 when unmapped)
  uint16_t flag;
  uint8_t mapq;
  int32_t l_qseq;
  int32_t nm;           // NM aux value, -1 when absent
  int32_t cigar2len;    // reference bam_cigar2len: M,I,S add, D subtracts
  int32_t cigar_mm;     // reference bam_cigar2mismatch: sum of non-M lens
  uint8_t weird;        // isWeirdRead precomputed (flag-independent part)
  uint8_t has_indel;    // reference HasIndel
  uint32_t name_off, name_len;
  uint64_t seq_off;     // into seq pool (ASCII bases)
  uint32_t rg_off, rg_len;   // RG aux value (into rg pool), len 0 if absent
  uint32_t mseg_off, mseg_count;  // ref-consuming match segments when the
                                  // cigar has D/N holes (0 = solid span)
  int32_t mtid;
  int64_t mpos;
  int64_t isize;
};

// one entry per BGZF member holding >= 1 record start: raw file offset
// of the member, uncompressed offset of the first record within it, and
// that record's (tid, pos) — the same shape as a .bai virtual offset,
// built by our own first pass so no external index is required
struct BlockIx {
  int64_t raw_off;
  int64_t u_off;
  int32_t tid;
  int64_t pos;
};

struct BamFile {
  std::vector<std::string> ref_names;
  std::vector<int64_t> ref_lens;
  std::vector<Record> recs;            // file order (whole-file mode) or
                                       // the cached window (streamed)
  std::string name_pool;
  std::string seq_pool;
  std::string rg_pool;                 // RG aux values
  std::string header_text;             // SAM header text (@RG etc.)
  std::vector<int64_t> mseg_pool;      // (start, end) pairs for D/N reads
  // per-tid: [first_index, last_index) in recs (file is coordinate-sorted,
  // records grouped by tid) and max reference span for overlap queries
  std::vector<int64_t> tid_begin, tid_end, tid_max_span;
  std::string error;

  // ---- streamed mode (O(window) memory; reference precedent: htslib
  // range queries per window, reader.cpp:483-559) ----
  bool streamed = false;
  std::string path;
  std::vector<BlockIx> blocks;
  int64_t total_records = 0;
  int32_t cache_tid = -2;              // window cache coverage
  int64_t cache_lo = 0, cache_hi = 0;

  // ---- collect_sr output pools (SoA) ----
  std::string sr_names;                // '\0'-separated
  std::string sr_seqs;                 // '\0'-separated
  std::vector<int64_t> sr_pos;
  std::vector<int32_t> sr_ms;
  std::vector<int8_t> sr_dir;          // '+' or '-'
  std::vector<int64_t> ref_pos;
  std::vector<int32_t> ref_mq, ref_len;
  std::string dd_rg;                   // '\0'-separated per-read RG values
};

bool read_exact(gzFile f, void* buf, unsigned n) {
  return gzread(f, buf, n) == static_cast<int>(n);
}

template <typename T>
bool read_le(gzFile f, T* v) {
  return read_exact(f, v, sizeof(T));
}

// Streaming reader over a concatenation of gzip members (BGZF is such a
// concatenation with 64 KB members) that tracks member boundaries: the
// raw file offset of the member currently being inflated plus the
// uncompressed offset within it.  seek() resumes decoding at any member
// start, which is what makes window-ranged BAM queries possible without
// an external .bai.
class GzMembers {
 public:
  explicit GzMembers(const char* path) : in_(1 << 20) {
    f_ = fopen(path, "rb");
    if (!f_) return;
    memset(&zs_, 0, sizeof(zs_));
    ok_ = inflateInit2(&zs_, 15 + 16) == Z_OK;
  }
  ~GzMembers() {
    if (ok_) inflateEnd(&zs_);
    if (f_) fclose(f_);
  }
  bool ok() const { return ok_ && f_; }
  int64_t member_off() const { return member_off_; }
  int64_t u_off() const { return u_off_; }

  bool read(void* dst, size_t n) {
    uint8_t* out = static_cast<uint8_t*>(dst);
    while (n > 0) {
      if (in_pos_ == in_len_ && !fill()) return false;
      zs_.next_in = in_.data() + in_pos_;
      zs_.avail_in = static_cast<unsigned>(in_len_ - in_pos_);
      zs_.next_out = out;
      zs_.avail_out = static_cast<unsigned>(n);
      int rc = inflate(&zs_, Z_NO_FLUSH);
      in_pos_ += (in_len_ - in_pos_) - zs_.avail_in;
      size_t produced = n - zs_.avail_out;
      out += produced;
      n -= produced;
      u_off_ += produced;
      if (rc == Z_STREAM_END) {
        member_off_ = raw_base_ + static_cast<int64_t>(in_pos_);
        u_off_ = 0;
        if (inflateReset(&zs_) != Z_OK) return false;
      } else if (rc != Z_OK && rc != Z_BUF_ERROR) {
        return false;
      }
    }
    return true;
  }

  bool skip(size_t n) {
    uint8_t tmp[4096];
    while (n > 0) {
      size_t k = n > sizeof(tmp) ? sizeof(tmp) : n;
      if (!read(tmp, k)) return false;
      n -= k;
    }
    return true;
  }

  bool seek(int64_t raw_off) {
    if (fseek(f_, static_cast<long>(raw_off), SEEK_SET) != 0) return false;
    in_pos_ = in_len_ = 0;
    raw_base_ = member_off_ = raw_off;
    u_off_ = 0;
    return inflateReset(&zs_) == Z_OK;
  }

 private:
  bool fill() {
    raw_base_ += static_cast<int64_t>(in_len_);
    in_pos_ = 0;
    in_len_ = fread(in_.data(), 1, in_.size(), f_);
    return in_len_ > 0;
  }
  FILE* f_ = nullptr;
  z_stream zs_;
  bool ok_ = false;
  std::vector<uint8_t> in_;
  size_t in_pos_ = 0, in_len_ = 0;
  int64_t raw_base_ = 0, member_off_ = 0, u_off_ = 0;
};

// streamed-mode tid sort key: unmapped (-1) sorts last, as in
// coordinate-sorted BAMs
inline int64_t tid_key(int32_t tid) {
  return tid < 0 ? static_cast<int64_t>(1) << 40 : tid;
}

// Parse aux data for NM (returns -1 when absent) and RG (appended to
// rg_pool; rg_len stays 0 when absent).
int32_t parse_aux(const uint8_t* aux, const uint8_t* end, Record* r,
                  std::string* rg_pool) {
  int32_t nm = -1;
  while (aux + 3 <= end) {
    char t0 = aux[0], t1 = aux[1], type = aux[2];
    const uint8_t* p = aux + 3;
    int64_t value = 0;
    unsigned skip = 0;
    switch (type) {
      case 'A': case 'c': case 'C': skip = 1; break;
      case 's': case 'S': skip = 2; break;
      case 'i': case 'I': case 'f': skip = 4; break;
      case 'Z': case 'H': {
        const uint8_t* q = p;
        while (q < end && *q) q++;
        skip = (q - p) + 1;
        break;
      }
      case 'B': {
        if (p + 5 > end) return nm;
        char sub = p[0];
        uint32_t n;
        memcpy(&n, p + 1, 4);
        unsigned esz = (sub == 'c' || sub == 'C') ? 1
                       : (sub == 's' || sub == 'S') ? 2 : 4;
        skip = 5 + esz * n;
        break;
      }
      default:
        return nm;  // unknown tag type: stop scanning
    }
    if (t0 == 'N' && t1 == 'M') {
      switch (type) {
        case 'c': value = *reinterpret_cast<const int8_t*>(p); break;
        case 'C': value = *p; break;
        case 's': { int16_t x; memcpy(&x, p, 2); value = x; break; }
        case 'S': { uint16_t x; memcpy(&x, p, 2); value = x; break; }
        case 'i': { int32_t x; memcpy(&x, p, 4); value = x; break; }
        case 'I': { uint32_t x; memcpy(&x, p, 4); value = x; break; }
        default: value = 0;
      }
      nm = static_cast<int32_t>(value);
    } else if (t0 == 'R' && t1 == 'G' && type == 'Z') {
      unsigned len = skip ? skip - 1 : 0;
      r->rg_off = rg_pool->size();
      r->rg_len = len;
      rg_pool->append(reinterpret_cast<const char*>(p), len);
    }
    aux = p + skip;
  }
  return nm;
}

// Parse the BAM header (magic, SAM text, reference dictionary) from a
// member stream.  Returns false when the magic is wrong.
bool parse_header(GzMembers& src, BamFile* bf) {
  char magic[4];
  if (!src.read(magic, 4) || memcmp(magic, "BAM\1", 4) != 0) return false;
  int32_t l_text;
  if (!src.read(&l_text, 4)) return false;
  std::vector<char> text(l_text);
  if (l_text && !src.read(text.data(), l_text)) return false;
  bf->header_text.assign(text.data(), l_text);
  int32_t n_ref;
  if (!src.read(&n_ref, 4)) return false;
  for (int32_t i = 0; i < n_ref; i++) {
    int32_t l_name, l_ref;
    if (!src.read(&l_name, 4)) return false;
    std::vector<char> nm(l_name);
    if (!src.read(nm.data(), l_name)) return false;
    if (!src.read(&l_ref, 4)) return false;
    bf->ref_names.emplace_back(nm.data());
    bf->ref_lens.push_back(l_ref);
  }
  return true;
}

// Read the next record's bytes; (*m_off, *u_off) get the member-stream
// position of its first byte.  1 = record in buf, 0 = EOF/truncation.
int read_record(GzMembers& src, std::vector<uint8_t>* buf,
                int64_t* m_off, int64_t* u_off) {
  *m_off = src.member_off();
  *u_off = src.u_off();
  int32_t block_size;
  if (!src.read(&block_size, 4)) return 0;
  if (block_size < 32) return 0;
  buf->resize(block_size);
  if (!src.read(buf->data(), block_size)) return 0;
  return 1;
}

// Decode one raw record into the BamFile pools (exact reference
// semantics: bam_cigar2len/bam_cigar2mismatch/HasIndel/isWeirdRead,
// reader.cpp:661-718, 1318-1346).
void decode_record(BamFile* bf, const uint8_t* p, int32_t block_size) {
  {
    Record r{};
    int32_t refid, pos, l_seq, next_refid, next_pos, tlen;
    uint32_t bin_mq_nl, flag_nc;
    memcpy(&refid, p, 4);
    memcpy(&pos, p + 4, 4);
    memcpy(&bin_mq_nl, p + 8, 4);
    memcpy(&flag_nc, p + 12, 4);
    memcpy(&l_seq, p + 16, 4);
    memcpy(&next_refid, p + 20, 4);
    memcpy(&next_pos, p + 24, 4);
    memcpy(&tlen, p + 28, 4);
    uint8_t l_read_name = bin_mq_nl & 0xff;
    r.mapq = (bin_mq_nl >> 8) & 0xff;
    uint16_t n_cigar = flag_nc & 0xffff;
    r.flag = flag_nc >> 16;
    r.tid = refid;
    r.pos = pos;
    r.l_qseq = l_seq;
    r.mtid = next_refid;
    r.mpos = next_pos;
    r.isize = tlen;
    const char* qname = reinterpret_cast<const char*>(p + 32);
    r.name_off = bf->name_pool.size();
    r.name_len = l_read_name ? l_read_name - 1 : 0;
    bf->name_pool.append(qname, r.name_len);
    const uint8_t* cig = p + 32 + l_read_name;

    // cigar-derived values (reference reader.cpp:1318-1346, :661-718)
    int64_t ref_span = 0;
    int32_t c2l = 0, cmm = 0;
    bool nonm_idnshp = false, indel = false, has_hole = false;
    for (uint16_t k = 0; k < n_cigar; k++) {
      uint32_t cv;
      memcpy(&cv, cig + 4 * k, 4);
      uint32_t op = cv & 0xf, len = cv >> 4;
      if (op == 0 || op == 2 || op == 3 || op == 7 || op == 8)
        ref_span += len;                         // M D N = X consume ref
      if (op == 0 || op == 1 || op == 4) c2l += len;   // M I S
      if (op == 2) c2l -= len;                         // D
      if (op != 0) cmm += len;                         // non-M lengths
      if (op == 1 || op == 2 || op == 3 || op == 4 || op == 5 || op == 6)
        nonm_idnshp = true;                      // I D N S H P
      if (op == 1 || op == 2) indel = true;
      if (op == 2 || op == 3) has_hole = true;   // D N split the M span
    }
    if (has_hole) {
      // store the exact ref-consuming match segments for depth queries
      r.mseg_off = bf->mseg_pool.size();
      int64_t ref = r.pos;
      int64_t seg_start = -1;
      for (uint16_t k = 0; k < n_cigar; k++) {
        uint32_t cv;
        memcpy(&cv, cig + 4 * k, 4);
        uint32_t op = cv & 0xf, len = cv >> 4;
        bool m_like = (op == 0 || op == 7 || op == 8);
        if (m_like) {
          if (seg_start < 0) seg_start = ref;
          ref += len;
        } else if (op == 2 || op == 3) {
          if (seg_start >= 0) {
            bf->mseg_pool.push_back(seg_start);
            bf->mseg_pool.push_back(ref);
            seg_start = -1;
          }
          ref += len;
        }
      }
      if (seg_start >= 0) {
        bf->mseg_pool.push_back(seg_start);
        bf->mseg_pool.push_back(ref);
      }
      r.mseg_count = (bf->mseg_pool.size() - r.mseg_off) / 2;
    }
    r.cigar2len = c2l;
    r.cigar_mm = cmm;
    r.has_indel = (n_cigar > 2 && indel) ? 1 : 0;
    bool mapped = !(r.flag & FLAG_UNMAP);
    r.endpos = (mapped && ref_span > 0) ? r.pos + ref_span : r.pos + 1;

    const uint8_t* seq4 = cig + 4 * n_cigar;
    r.seq_off = bf->seq_pool.size();
    for (int32_t i = 0; i < l_seq; i++) {
      uint8_t code = (seq4[i / 2] >> ((i % 2) ? 0 : 4)) & 0xf;
      bf->seq_pool.push_back(SEQ_NT16[code]);
    }
    const uint8_t* aux = seq4 + (l_seq + 1) / 2 + l_seq;
    r.nm = parse_aux(aux, p + block_size, &r, &bf->rg_pool);

    // isWeirdRead (reader.cpp:661-690): unmapped, or any I/D/N/S/H/P op,
    // or NM != 0, or edits + non-M cigar length > 0
    int32_t edits = r.nm >= 0 ? r.nm : 0;
    r.weird = (!mapped || nonm_idnshp || (r.nm > 0)
               || (edits + cmm > 0)) ? 1 : 0;

    bf->recs.push_back(r);
  }
}

// Rebuild tid_begin/tid_end/(max_span) from the resident recs.
void index_tids(BamFile* bf, bool update_span) {
  size_t nt = bf->ref_names.size();
  bf->tid_begin.assign(nt, -1);
  bf->tid_end.assign(nt, -1);
  if (update_span) bf->tid_max_span.assign(nt, 1);
  for (size_t i = 0; i < bf->recs.size(); i++) {
    int32_t t = bf->recs[i].tid;
    if (t < 0 || static_cast<size_t>(t) >= nt) continue;
    if (bf->tid_begin[t] < 0) bf->tid_begin[t] = i;
    bf->tid_end[t] = i + 1;
    if (update_span) {
      int64_t span = bf->recs[i].endpos - bf->recs[i].pos;
      if (span > bf->tid_max_span[t]) bf->tid_max_span[t] = span;
    }
  }
}

// Streamed mode: make [start - max_span, end) of `tid` resident (the
// window cache every ranged query runs against).  Whole-file mode is a
// no-op.  Mirrors the reference's per-window htslib range queries
// (sam_itr_queryi, reader.cpp:483-559) over our own first-pass block
// index instead of a .bai.
bool ensure_window(BamFile* bf, int32_t tid, int64_t start, int64_t end) {
  if (!bf->streamed) return true;
  if (tid < 0 || static_cast<size_t>(tid) >= bf->ref_names.size())
    return true;
  int64_t target = start - bf->tid_max_span[tid];
  if (bf->cache_tid == tid && bf->cache_lo <= target
      && bf->cache_hi >= end)
    return true;
  bf->recs.clear();
  bf->name_pool.clear();
  bf->seq_pool.clear();
  bf->rg_pool.clear();
  bf->mseg_pool.clear();
  bf->cache_tid = tid;
  bf->cache_lo = target;
  bf->cache_hi = end;
  // last block whose first record is <= (tid, target)
  int64_t want = tid_key(tid);
  int64_t lo = 0, hi = static_cast<int64_t>(bf->blocks.size());
  while (lo < hi) {
    int64_t mid = (lo + hi) / 2;
    const BlockIx& b = bf->blocks[mid];
    if (tid_key(b.tid) < want
        || (tid_key(b.tid) == want && b.pos <= target))
      lo = mid + 1;
    else
      hi = mid;
  }
  index_tids(bf, false);
  if (lo == 0) {
    if (bf->blocks.empty()) return true;
  } else {
    lo -= 1;
  }
  GzMembers src(bf->path.c_str());
  if (!src.ok()) return false;
  if (!src.seek(bf->blocks[lo].raw_off)
      || !src.skip(static_cast<size_t>(bf->blocks[lo].u_off)))
    return false;
  std::vector<uint8_t> buf;
  int64_t m_off, u_off;
  while (read_record(src, &buf, &m_off, &u_off) == 1) {
    int32_t rtid, rpos;
    memcpy(&rtid, buf.data(), 4);
    memcpy(&rpos, buf.data() + 4, 4);
    if (tid_key(rtid) < want || (rtid == tid && rpos < target)) continue;
    if (tid_key(rtid) > want || rpos >= end) break;
    decode_record(bf, buf.data(), static_cast<int32_t>(buf.size()));
  }
  index_tids(bf, false);
  if (bf->tid_begin[tid] < 0) {
    // empty window: keep the range queryable (zero-length span)
    bf->tid_begin[tid] = 0;
    bf->tid_end[tid] = 0;
  }
  return true;
}

}  // namespace

extern "C" {

static void* ptbam_open_mode(const char* path, int streamed) {
  auto* bf = new BamFile();
  bf->streamed = streamed != 0;
  bf->path = path;
  GzMembers src(path);
  if (!src.ok()) {
    bf->error = "cannot open file";
    return bf;
  }
  if (!parse_header(src, bf)) {
    bf->error = "not a BAM file";
    return bf;
  }
  size_t nt = bf->ref_names.size();
  std::vector<uint8_t> buf;
  int64_t m_off, u_off;
  if (!streamed) {
    while (read_record(src, &buf, &m_off, &u_off) == 1)
      decode_record(bf, buf.data(), static_cast<int32_t>(buf.size()));
    index_tids(bf, true);
    bf->total_records = static_cast<int64_t>(bf->recs.size());
    return bf;
  }
  // streamed pass 1: block index + per-tid max span, records not kept
  bf->tid_begin.assign(nt, -1);
  bf->tid_end.assign(nt, -1);
  bf->tid_max_span.assign(nt, 1);
  int64_t last_member = -1;
  while (read_record(src, &buf, &m_off, &u_off) == 1) {
    const uint8_t* p = buf.data();
    int32_t rtid, rpos;
    uint32_t bin_mq_nl, flag_nc;
    memcpy(&rtid, p, 4);
    memcpy(&rpos, p + 4, 4);
    memcpy(&bin_mq_nl, p + 8, 4);
    memcpy(&flag_nc, p + 12, 4);
    if (m_off != last_member) {
      bf->blocks.push_back(BlockIx{m_off, u_off, rtid, rpos});
      last_member = m_off;
    }
    bf->total_records++;
    if (rtid >= 0 && static_cast<size_t>(rtid) < nt) {
      uint8_t l_read_name = bin_mq_nl & 0xff;
      uint16_t n_cigar = flag_nc & 0xffff;
      uint16_t flag = flag_nc >> 16;
      const uint8_t* cig = p + 32 + l_read_name;
      int64_t ref_span = 0;
      for (uint16_t k = 0; k < n_cigar; k++) {
        uint32_t cv;
        memcpy(&cv, cig + 4 * k, 4);
        uint32_t op = cv & 0xf;
        if (op == 0 || op == 2 || op == 3 || op == 7 || op == 8)
          ref_span += cv >> 4;
      }
      bool mapped = !(flag & FLAG_UNMAP);
      int64_t span = (mapped && ref_span > 0) ? ref_span : 1;
      if (span > bf->tid_max_span[rtid]) bf->tid_max_span[rtid] = span;
    }
  }
  return bf;
}

void* ptbam_open(const char* path) { return ptbam_open_mode(path, 0); }

void* ptbam_open_stream(const char* path) {
  return ptbam_open_mode(path, 1);
}

int64_t ptbam_resident_records(void* h) {
  return static_cast<BamFile*>(h)->recs.size();
}

const char* ptbam_error(void* h) {
  return static_cast<BamFile*>(h)->error.c_str();
}

void ptbam_close(void* h) { delete static_cast<BamFile*>(h); }

int32_t ptbam_n_refs(void* h) {
  return static_cast<BamFile*>(h)->ref_names.size();
}

const char* ptbam_ref_name(void* h, int32_t tid) {
  return static_cast<BamFile*>(h)->ref_names[tid].c_str();
}

int64_t ptbam_ref_len(void* h, int32_t tid) {
  return static_cast<BamFile*>(h)->ref_lens[tid];
}

int64_t ptbam_n_records(void* h) {
  return static_cast<BamFile*>(h)->total_records;
}

namespace {

// isGoodAnchor (reader.cpp:561-613)
bool good_anchor(const Record& r, int min_qual) {
  if (r.flag & FLAG_UNMAP) return false;
  if (r.mapq < min_qual) return false;
  if (min_qual == 0) return true;
  if (r.flag & (FLAG_SECONDARY | FLAG_QCFAIL | FLAG_DUP)) return false;
  return true;
}

// isRefRead (reader.cpp:620-656)
bool ref_read(const Record& r, int nm_cutoff, double mm_rate) {
  if (r.flag & (FLAG_SECONDARY | FLAG_QCFAIL | FLAG_DUP)) return false;
  if (r.nm >= 0) {
    int max_edits = static_cast<int>(r.l_qseq * mm_rate) + 1;
    if (r.nm > nm_cutoff || r.nm > max_edits) return false;
  }
  if (r.has_indel) return false;
  int32_t edits = r.nm >= 0 ? r.nm : 0;
  bool mapped = !(r.flag & FLAG_UNMAP);
  return mapped && edits <= 2 && r.cigar_mm <= 2;
}

// build_record_SR (reader.cpp:799-898); emits into the output pools.
void build_sr(BamFile* bf, const Record& mapped, const Record& unmapped,
              int min_qual, int64_t biol_size) {
  if (static_cast<int16_t>(mapped.mapq) < static_cast<int16_t>(min_qual))
    return;
  std::string seq(bf->seq_pool, unmapped.seq_off, unmapped.l_qseq);
  // N-trim both ends, then the 10% N / 22 bp gates
  size_t b = 0, e = seq.size();
  while (b < e && seq[b] == 'N') b++;
  while (e > b && seq[e - 1] == 'N') e--;
  seq = seq.substr(b, e - b);
  int64_t length = seq.size();
  int64_t n_count = 0;
  for (char c : seq)
    if (c == 'N') n_count++;
  if (n_count > static_cast<int64_t>(length * .10) || length < 22) return;
  if (unmapped.flag & FLAG_REVERSE) {
    std::string rc(length, 'N');
    for (int64_t i = 0; i < length; i++) {
      char c = seq[length - 1 - i];
      rc[i] = c == 'A' ? 'T' : c == 'T' ? 'A' : c == 'C' ? 'G'
              : c == 'G' ? 'C' : 'N';
    }
    seq.swap(rc);
  }
  int64_t rel_pos = mapped.pos;
  int8_t dir = '+';
  if (mapped.flag & FLAG_REVERSE) {
    dir = '-';
    rel_pos += mapped.cigar2len;
  }
  if (rel_pos > biol_size) rel_pos = biol_size;
  if (rel_pos < 1) rel_pos = 0;

  bf->sr_names.push_back('@');
  bf->sr_names.append(bf->name_pool, unmapped.name_off, unmapped.name_len);
  if (unmapped.flag & FLAG_READ1) bf->sr_names.append("/1");
  else if (unmapped.flag & FLAG_READ2) bf->sr_names.append("/2");
  bf->sr_names.push_back('\0');
  bf->sr_seqs.append(seq);
  bf->sr_seqs.push_back('\0');
  bf->sr_pos.push_back(rel_pos);
  bf->sr_ms.push_back(mapped.mapq);
  bf->sr_dir.push_back(dir);
}

}  // namespace

// Window query + mate pairing + record building for the split-read
// channel.  Mirrors fetch_func_SR (reader.cpp:1099-1151): first sight of
// a name stores the record and self-builds if weird; the second sight
// pairs them (self-build of the stored read again — a reference quirk —
// then anchored builds and reference-supporting reads both ways).
int64_t ptbam_collect_sr(void* h, int32_t tid, int64_t start, int64_t end,
                         int32_t min_qual, int32_t nm_cutoff,
                         double mm_rate, int64_t biol_size) {
  auto* bf = static_cast<BamFile*>(h);
  ensure_window(bf, tid, start, end);
  bf->sr_names.clear();
  bf->sr_seqs.clear();
  bf->sr_pos.clear();
  bf->sr_ms.clear();
  bf->sr_dir.clear();
  bf->ref_pos.clear();
  bf->ref_mq.clear();
  bf->ref_len.clear();
  if (tid < 0 || static_cast<size_t>(tid) >= bf->ref_names.size()
      || bf->tid_begin[tid] < 0)
    return 0;

  // binary search: first record with pos >= start - max_span
  int64_t lo = bf->tid_begin[tid], hi = bf->tid_end[tid];
  int64_t target = start - bf->tid_max_span[tid];
  while (lo < hi) {
    int64_t mid = (lo + hi) / 2;
    if (bf->recs[mid].pos < target) lo = mid + 1;
    else hi = mid;
  }

  std::unordered_map<std::string, int64_t> pending;  // qname -> rec index
  for (int64_t i = lo; i < bf->tid_end[tid]; i++) {
    const Record& r = bf->recs[i];
    if (r.pos >= end) break;
    if (r.endpos <= start) continue;              // no overlap
    std::string qname(bf->name_pool, r.name_off, r.name_len);
    auto it = pending.find(qname);
    if (it == pending.end()) {
      pending.emplace(std::move(qname), i);
      if (r.weird) build_sr(bf, r, r, min_qual, biol_size);
    } else {
      const Record& b2 = bf->recs[it->second];
      pending.erase(it);
      if (b2.weird) build_sr(bf, b2, b2, min_qual, biol_size);
      if (good_anchor(r, min_qual)) {
        if (b2.weird) build_sr(bf, r, b2, min_qual, biol_size);
        if (ref_read(b2, nm_cutoff, mm_rate) && b2.mapq >= min_qual) {
          bf->ref_pos.push_back(b2.pos);
          bf->ref_mq.push_back(b2.mapq);
          bf->ref_len.push_back(b2.l_qseq);
        }
      }
      if (good_anchor(b2, min_qual)) {
        if (r.weird) build_sr(bf, b2, r, min_qual, biol_size);
        if (ref_read(r, nm_cutoff, mm_rate) && r.mapq >= min_qual) {
          bf->ref_pos.push_back(r.pos);
          bf->ref_mq.push_back(r.mapq);
          bf->ref_len.push_back(r.l_qseq);
        }
      }
    }
  }
  return bf->sr_pos.size();
}

// Discordant read-pair discovery channel over a window.  Mirrors
// build_record_RP_Discovery (reader.cpp:982-1097): paired, quality gate,
// both mates mapped, and discordant = different chromosome OR
// |isize| > 3*insert+1000 OR same-strand mates.  Emits raw per-record
// fields; the same-chromosome PosA<PosB normalization and RP_READ
// construction happen in Python.
int64_t ptbam_collect_rp(void* h, int32_t tid, int64_t start, int64_t end,
                         int32_t min_qual, int64_t insert_size) {
  auto* bf = static_cast<BamFile*>(h);
  ensure_window(bf, tid, start, end);
  bf->ref_pos.clear();      // reuse pools: pos
  bf->sr_pos.clear();       // mpos
  bf->sr_ms.clear();        // mtid
  bf->ref_mq.clear();       // mapq
  bf->ref_len.clear();      // l_qseq
  bf->sr_dir.clear();       // packed strands: bit0 = read reverse,
                            //                 bit1 = mate reverse
  bf->sr_names.clear();
  if (tid < 0 || static_cast<size_t>(tid) >= bf->ref_names.size()
      || bf->tid_begin[tid] < 0)
    return 0;
  int64_t lo = bf->tid_begin[tid], hi = bf->tid_end[tid];
  int64_t target = start - bf->tid_max_span[tid];
  while (lo < hi) {
    int64_t mid = (lo + hi) / 2;
    if (bf->recs[mid].pos < target) lo = mid + 1;
    else hi = mid;
  }
  for (int64_t i = lo; i < bf->tid_end[tid]; i++) {
    const Record& r = bf->recs[i];
    if (r.pos >= end) break;
    if (r.endpos <= start) continue;
    if (!(r.flag & FLAG_PAIRED)) continue;
    if (r.mapq < min_qual) continue;
    if (r.flag & (FLAG_UNMAP | FLAG_MUNMAP)) continue;
    int64_t isize = r.isize < 0 ? -r.isize : r.isize;
    bool same_strand = ((r.flag & FLAG_REVERSE) != 0)
                       == ((r.flag & FLAG_MREVERSE) != 0);
    if (r.tid != r.mtid || isize > 3 * insert_size + 1000 || same_strand) {
      bf->ref_pos.push_back(r.pos);
      bf->sr_pos.push_back(r.mpos);
      bf->sr_ms.push_back(r.mtid);
      bf->ref_mq.push_back(r.mapq);
      bf->ref_len.push_back(r.l_qseq);
      bf->sr_dir.push_back(((r.flag & FLAG_REVERSE) ? 1 : 0)
                           | ((r.flag & FLAG_MREVERSE) ? 2 : 0));
      bf->sr_names.append(bf->name_pool, r.name_off, r.name_len);
      bf->sr_names.push_back('\0');
    }
  }
  return bf->ref_pos.size();
}

// Read-pair collection for genotyping (-g).  Mirrors build_record_RP
// (reader.cpp:925-980): both mates mapped and the pair discordant by the
// looser rule tid != mtid || |isize| > l_qseq + 2*insert_size.  No
// mapq or strand gate here — the genotyping step filters MQ >= 20
// (which equals the reference's MQA/MQB test: both are set to the
// record's own quality, reader.cpp:968-969).  Emits pos, mpos, mtid,
// mapq and l_qseq.
int64_t ptbam_collect_rp_gt(void* h, int32_t tid, int64_t start,
                            int64_t end, int64_t insert_size) {
  auto* bf = static_cast<BamFile*>(h);
  ensure_window(bf, tid, start, end);
  bf->ref_pos.clear();      // pos
  bf->sr_pos.clear();       // mpos
  bf->sr_ms.clear();        // mtid
  bf->ref_mq.clear();       // mapq
  bf->ref_len.clear();      // l_qseq
  if (tid < 0 || static_cast<size_t>(tid) >= bf->ref_names.size()
      || bf->tid_begin[tid] < 0)
    return 0;
  int64_t lo = bf->tid_begin[tid], hi = bf->tid_end[tid];
  int64_t target = start - bf->tid_max_span[tid];
  while (lo < hi) {
    int64_t mid = (lo + hi) / 2;
    if (bf->recs[mid].pos < target) lo = mid + 1;
    else hi = mid;
  }
  for (int64_t i = lo; i < bf->tid_end[tid]; i++) {
    const Record& r = bf->recs[i];
    if (r.pos >= end) break;
    if (r.endpos <= start) continue;
    if (r.flag & (FLAG_UNMAP | FLAG_MUNMAP)) continue;
    int64_t isize = r.isize < 0 ? -r.isize : r.isize;
    if (r.tid != r.mtid || isize > r.l_qseq + 2 * insert_size) {
      bf->ref_pos.push_back(r.pos);
      bf->sr_pos.push_back(r.mpos);
      bf->sr_ms.push_back(r.mtid);
      bf->ref_mq.push_back(r.mapq);
      bf->ref_len.push_back(r.l_qseq);
    }
  }
  return bf->ref_pos.size();
}

// Discordant-read collection for dispersed-duplication (-q) mode.
// Mirrors fetch_disc_read_callback (search_MEI.cpp:689-713): both mates
// mapped, not concordant (is_concordant, search_MEI.cpp:46-64: same tid,
// opposite strands, |isize| < l_qseq + 2*insert), and either
// cross-chromosome or |pos - mpos| > min_dd_map_distance.  Emits name,
// pos, mpos, mtid, l_qseq, packed strand/read1 bits, the full ASCII
// sequence and the RG aux value per read.
int64_t ptbam_collect_dd(void* h, int32_t tid, int64_t start, int64_t end,
                         int64_t insert_size, int64_t min_dd_map_distance) {
  auto* bf = static_cast<BamFile*>(h);
  ensure_window(bf, tid, start, end);
  bf->ref_pos.clear();      // pos
  bf->sr_pos.clear();       // mpos
  bf->sr_ms.clear();        // mtid
  bf->ref_len.clear();      // l_qseq
  bf->sr_dir.clear();       // bit0 read rev, bit1 mate rev, bit2 READ1
  bf->sr_names.clear();
  bf->sr_seqs.clear();
  bf->dd_rg.clear();
  if (tid < 0 || static_cast<size_t>(tid) >= bf->ref_names.size()
      || bf->tid_begin[tid] < 0)
    return 0;
  int64_t lo = bf->tid_begin[tid], hi = bf->tid_end[tid];
  int64_t target = start - bf->tid_max_span[tid];
  while (lo < hi) {
    int64_t mid = (lo + hi) / 2;
    if (bf->recs[mid].pos < target) lo = mid + 1;
    else hi = mid;
  }
  for (int64_t i = lo; i < bf->tid_end[tid]; i++) {
    const Record& r = bf->recs[i];
    if (r.pos >= end) break;
    if (r.endpos <= start) continue;
    if (r.flag & (FLAG_UNMAP | FLAG_MUNMAP)) continue;
    bool same_strand = ((r.flag & FLAG_REVERSE) != 0)
                       == ((r.flag & FLAG_MREVERSE) != 0);
    int64_t isize = r.isize < 0 ? -r.isize : r.isize;
    bool concordant = (r.tid == r.mtid) && !same_strand
                      && isize < r.l_qseq + 2 * insert_size;
    if (concordant) continue;
    int64_t dist = r.pos - r.mpos;
    if (dist < 0) dist = -dist;
    if (r.tid == r.mtid && dist <= min_dd_map_distance) continue;
    bf->ref_pos.push_back(r.pos);
    bf->sr_pos.push_back(r.mpos);
    bf->sr_ms.push_back(r.mtid);
    bf->ref_len.push_back(r.l_qseq);
    bf->sr_dir.push_back(((r.flag & FLAG_REVERSE) ? 1 : 0)
                         | ((r.flag & FLAG_MREVERSE) ? 2 : 0)
                         | ((r.flag & FLAG_READ1) ? 4 : 0));
    bf->sr_names.append(bf->name_pool, r.name_off, r.name_len);
    bf->sr_names.push_back('\0');
    bf->sr_seqs.append(bf->seq_pool, r.seq_off, r.l_qseq);
    bf->sr_seqs.push_back('\0');
    bf->dd_rg.append(bf->rg_pool, r.rg_off, r.rg_len);
    bf->dd_rg.push_back('\0');
  }
  return bf->ref_pos.size();
}

// Summed per-base read depth over [beg, end): for every mapped record
// with mapq >= min_mapq, add the overlap of its ref-consuming match
// segments with the window.  Equivalent to the reference's
// bam2depth pileup sum (bam2depth.cpp:37-110: mapq<min flagged unmapped,
// D/N positions excluded, base quality floor 0).
int64_t ptbam_depth_sum(void* h, int32_t tid, int64_t beg, int64_t end,
                        int32_t min_mapq) {
  auto* bf = static_cast<BamFile*>(h);
  ensure_window(bf, tid, beg, end);
  if (tid < 0 || static_cast<size_t>(tid) >= bf->ref_names.size()
      || bf->tid_begin[tid] < 0 || end <= beg)
    return 0;
  int64_t lo = bf->tid_begin[tid], hi = bf->tid_end[tid];
  int64_t target = beg - bf->tid_max_span[tid];
  while (lo < hi) {
    int64_t mid = (lo + hi) / 2;
    if (bf->recs[mid].pos < target) lo = mid + 1;
    else hi = mid;
  }
  int64_t sum = 0;
  for (int64_t i = lo; i < bf->tid_end[tid]; i++) {
    const Record& r = bf->recs[i];
    if (r.pos >= end) break;
    if (r.endpos <= beg) continue;
    if (r.flag & FLAG_UNMAP) continue;
    if (r.mapq < min_mapq) continue;
    if (r.mseg_count == 0) {
      int64_t a = r.pos > beg ? r.pos : beg;
      int64_t b = r.endpos < end ? r.endpos : end;
      if (b > a) sum += b - a;
    } else {
      for (uint32_t s = 0; s < r.mseg_count; s++) {
        int64_t a = bf->mseg_pool[r.mseg_off + 2 * s];
        int64_t b = bf->mseg_pool[r.mseg_off + 2 * s + 1];
        if (a < beg) a = beg;
        if (b > end) b = end;
        if (b > a) sum += b - a;
      }
    }
  }
  return sum;
}

const char* ptbam_header_text(void* h) {
  return static_cast<BamFile*>(h)->header_text.c_str();
}

const char* ptbam_dd_rg(void* h) {
  return static_cast<BamFile*>(h)->dd_rg.c_str();
}
int64_t ptbam_dd_rg_size(void* h) {
  return static_cast<BamFile*>(h)->dd_rg.size();
}

const char* ptbam_sr_names(void* h) {
  return static_cast<BamFile*>(h)->sr_names.c_str();
}
int64_t ptbam_sr_names_size(void* h) {
  return static_cast<BamFile*>(h)->sr_names.size();
}
const char* ptbam_sr_seqs(void* h) {
  return static_cast<BamFile*>(h)->sr_seqs.c_str();
}
int64_t ptbam_sr_seqs_size(void* h) {
  return static_cast<BamFile*>(h)->sr_seqs.size();
}
const int64_t* ptbam_sr_pos(void* h) {
  return static_cast<BamFile*>(h)->sr_pos.data();
}
const int32_t* ptbam_sr_ms(void* h) {
  return static_cast<BamFile*>(h)->sr_ms.data();
}
const int8_t* ptbam_sr_dir(void* h) {
  return static_cast<BamFile*>(h)->sr_dir.data();
}
int64_t ptbam_n_ref_reads(void* h) {
  return static_cast<BamFile*>(h)->ref_pos.size();
}
const int64_t* ptbam_ref_read_pos(void* h) {
  return static_cast<BamFile*>(h)->ref_pos.data();
}
const int32_t* ptbam_ref_read_mq(void* h) {
  return static_cast<BamFile*>(h)->ref_mq.data();
}
const int32_t* ptbam_ref_read_len(void* h) {
  return static_cast<BamFile*>(h)->ref_len.data();
}

}  // extern "C"
