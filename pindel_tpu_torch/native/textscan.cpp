// Native pindel-text record scanner (ctypes; see textindex.py).
//
// The pindel input format is 3 lines per record (reference
// pindel_read_reader.cpp / ReadInRead, reader.cpp:196-361):
//
//     @name
//     SEQUENCE
//     {+,-} <chrom> <pos> <mapq> <insert> <tag> [...]
//
// One pass over a byte buffer emits, per record: byte offsets of the
// record / name / sequence (trailing non-alphanumerics trimmed, the
// setUnmatchedSeq quirk), the parsed meta integers, and interned ids
// for the chromosome and sample-tag strings (first-seen order, packed
// '\n'-joined into names_buf).  Both the streaming index scan and the
// per-window record parse use it: the Python loop it replaces was ~40%
// of warm pipeline wall at 50k reads.
#include <cctype>
#include <cstring>
#include <string>
#include <unordered_map>

namespace {

struct Intern {
    std::unordered_map<std::string, int> map;
    std::string packed;
    int get(const char* s, long n) {
        std::string key(s, n);
        auto it = map.find(key);
        if (it != map.end()) return it->second;
        int id = (int)map.size();
        map.emplace(std::move(key), id);
        packed.append(s, n);
        packed.push_back('\n');
        return id;
    }
};

inline const char* find_nl(const char* p, const char* end) {
    const char* nl = (const char*)memchr(p, '\n', end - p);
    return nl ? nl : end;
}

inline bool parse_long(const char*& p, const char* end, long* out) {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) p++;
    bool neg = false;
    if (p < end && (*p == '-' || *p == '+')) { neg = (*p == '-'); p++; }
    if (p >= end || *p < '0' || *p > '9') return false;
    long v = 0;
    while (p < end && *p >= '0' && *p <= '9') v = v * 10 + (*p++ - '0');
    *out = neg ? -v : v;
    return true;
}

inline const char* token(const char*& p, const char* end, long* len) {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) p++;
    const char* s = p;
    while (p < end && *p != ' ' && *p != '\t' && *p != '\r') p++;
    *len = p - s;
    return s;
}

}  // namespace

extern "C" {

// Returns the record count, or -1 (framing error), -2 (cap exceeded),
// -3 (names_buf too small).  *consumed is set to the number of bytes
// covered by complete records (callers chunking a file carry the rest);
// with final != 0 a trailing record without '\n' is accepted.
long pt_scan(const char* buf, long n, long cap, int final,
             long* consumed,
             long* rec_off,
             long* name_off, long* name_len,
             long* seq_off, long* seq_len,
             signed char* dminus,
             long* pos, long* ms, long* isz,
             int* chrom_id, int* tag_id,
             char* names_buf, long* names_cap,
             char* tags_buf, long* tags_cap) {
    Intern chroms, tags;
    const char* p = buf;
    const char* end = buf + n;
    long cnt = 0;
    *consumed = 0;
    while (p < end) {
        const char* rec = p;
        // line 1: name
        const char* nl1 = find_nl(p, end);
        if (nl1 == end && !final) break;
        // line 2: sequence
        const char* l2 = nl1 < end ? nl1 + 1 : end;
        const char* nl2 = find_nl(l2, end);
        if (nl2 == end && !final) break;
        // line 3: meta
        const char* l3 = nl2 < end ? nl2 + 1 : end;
        const char* nl3 = find_nl(l3, end);
        if (nl3 == end && !final) break;
        if (l2 > end || l3 > end) return -1;
        if (cnt >= cap) return -2;
        rec_off[cnt] = rec - buf;
        name_off[cnt] = rec - buf;
        name_len[cnt] = nl1 - rec;
        seq_off[cnt] = l2 - buf;
        long sl = nl2 - l2;
        while (sl > 0 && !isalnum((unsigned char)l2[sl - 1])) sl--;
        seq_len[cnt] = sl;
        // meta tokens: d chrom pos ms insert tag
        const char* q = l3;
        long dlen;
        const char* d = token(q, nl3, &dlen);
        long clen;
        const char* chrom = token(q, nl3, &clen);
        long v_pos, v_ms, v_isz;
        bool ok = dlen == 1 && (*d == '+' || *d == '-') && clen > 0
            && parse_long(q, nl3, &v_pos) && parse_long(q, nl3, &v_ms)
            && parse_long(q, nl3, &v_isz);
        long tlen = 0;
        const char* tag = ok ? token(q, nl3, &tlen) : nullptr;
        if (ok && tlen > 0) {
            dminus[cnt] = (*d == '-');
            pos[cnt] = v_pos;
            ms[cnt] = v_ms;
            isz[cnt] = v_isz;
            chrom_id[cnt] = chroms.get(chrom, clen);
            tag_id[cnt] = tags.get(tag, tlen);
        } else {
            // short meta line: keep name/seq only (reads.py fallback)
            dminus[cnt] = 0;
            pos[cnt] = ms[cnt] = isz[cnt] = 0;
            chrom_id[cnt] = -1;
            tag_id[cnt] = -1;
        }
        cnt++;
        p = nl3 < end ? nl3 + 1 : end;
        *consumed = p - buf;
    }
    if ((long)chroms.packed.size() > *names_cap) return -3;
    if ((long)tags.packed.size() > *tags_cap) return -3;
    memcpy(names_buf, chroms.packed.data(), chroms.packed.size());
    *names_cap = chroms.packed.size();
    memcpy(tags_buf, tags.packed.data(), tags.packed.size());
    *tags_cap = tags.packed.size();
    return cnt;
}

}  // extern "C"
