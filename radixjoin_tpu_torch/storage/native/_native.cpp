// Native runtime for radixjoin_tpu: page codec, CSV ingest, string kernels.
//
// TPU-native counterpart of the reference's host-side C++ components
// (page encoders include/plan.h:151-335, decoder src/build_table.cpp:306-436,
// CSV parser src/csv_parser.cpp, string filter kernels
// include/inner_column.h:327-563) — reimplemented from scratch against the
// documented page format (README.md:88-98) and CSV dialect, operating on
// dense columnar buffers (heap + end-offsets for strings) instead of
// row-variant vectors.
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in this image).
// All functions are thread-safe on distinct outputs; callers may decode
// columns in parallel.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <string_view>
#include <vector>

namespace {

constexpr int64_t kPageSize = 8192;
constexpr uint16_t kLongFirst = 0xffff;
constexpr uint16_t kLongCont = 0xfffe;
constexpr int64_t kMaxInline = kPageSize - 7;
constexpr int64_t kMaxVarcharRows = 0xfffd;

inline uint16_t rd_u16(const uint8_t* p) {
    return static_cast<uint16_t>(p[0]) | (static_cast<uint16_t>(p[1]) << 8);
}

inline void wr_u16(uint8_t* p, uint16_t v) {
    p[0] = static_cast<uint8_t>(v & 0xff);
    p[1] = static_cast<uint8_t>(v >> 8);
}

inline bool get_bit(const uint8_t* bitmap, int64_t i) {
    return (bitmap[i >> 3] >> (i & 7)) & 1;
}

inline void set_bit(uint8_t* bitmap, int64_t i) {
    bitmap[i >> 3] |= static_cast<uint8_t>(1u << (i & 7));
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// Fixed-width pages
// ---------------------------------------------------------------------------

// Decode pages into dense values (zero at NULLs) + validity bytes.
// Returns rows decoded, or -1 on malformed input.
int64_t rjt_decode_fixed(const uint8_t* pages, int64_t n_pages,
                         int64_t num_rows, int32_t esize, int32_t dbegin,
                         uint8_t* out_values, uint8_t* out_valid) {
    int64_t row = 0;
    for (int64_t pg = 0; pg < n_pages; ++pg) {
        const uint8_t* p = pages + pg * kPageSize;
        const int64_t nr = rd_u16(p);
        const uint8_t* data = p + dbegin;
        const uint8_t* bitmap = p + kPageSize - ((nr + 7) >> 3);
        if (row + nr > num_rows) return -1;
        int64_t di = 0;
        for (int64_t i = 0; i < nr; ++i, ++row) {
            if (get_bit(bitmap, i)) {
                std::memcpy(out_values + row * esize, data + di * esize, esize);
                out_valid[row] = 1;
                ++di;
            } else {
                std::memset(out_values + row * esize, 0, esize);
                out_valid[row] = 0;
            }
        }
    }
    return row == num_rows ? row : -1;
}

// Greedy page count for the encoder (mirrors the insert-capacity rule:
// flush when header + values + bitmap would overflow).
int64_t rjt_count_pages_fixed(const uint8_t* valid, int64_t n, int32_t esize,
                              int32_t dbegin) {
    int64_t pages = 0, i = 0;
    while (i < n) {
        int64_t vals = 0, rows = 0;
        while (i < n) {
            int64_t nv = vals + (valid[i] ? 1 : 0);
            if (dbegin + nv * esize + (rows / 8 + 1) > kPageSize) break;
            vals = nv;
            ++rows;
            ++i;
        }
        ++pages;
    }
    return pages;
}

int64_t rjt_encode_fixed(const uint8_t* values, const uint8_t* valid,
                         int64_t n, int32_t esize, int32_t dbegin,
                         uint8_t* out_pages, int64_t max_pages) {
    int64_t pg = 0, i = 0;
    if (n == 0) return 0;
    while (i < n) {
        if (pg >= max_pages) return -1;
        uint8_t* p = out_pages + pg * kPageSize;
        std::memset(p, 0, kPageSize);
        uint8_t* data = p + dbegin;
        int64_t vals = 0, rows = 0;
        const int64_t start = i;
        while (i < n) {
            int64_t nv = vals + (valid[i] ? 1 : 0);
            if (dbegin + nv * esize + (rows / 8 + 1) > kPageSize) break;
            if (valid[i]) {
                std::memcpy(data + vals * esize, values + i * esize, esize);
            }
            vals = nv;
            ++rows;
            ++i;
        }
        wr_u16(p, static_cast<uint16_t>(rows));
        wr_u16(p + 2, static_cast<uint16_t>(vals));
        uint8_t* bitmap = p + kPageSize - ((rows + 7) >> 3);
        for (int64_t r = 0; r < rows; ++r) {
            if (valid[start + r]) set_bit(bitmap, r);
        }
        ++pg;
    }
    return pg;
}

// ---------------------------------------------------------------------------
// VARCHAR pages (heap + per-row end offsets; ends[i] == ends[i-1] for NULL)
// ---------------------------------------------------------------------------

// Pass 1: scan pages, fill validity + per-row byte lengths; return total
// heap bytes (or -1 on malformed input).
int64_t rjt_decode_varchar_scan(const uint8_t* pages, int64_t n_pages,
                                int64_t num_rows, uint8_t* out_valid,
                                int64_t* out_lengths) {
    int64_t row = 0;
    int64_t total = 0;
    bool in_long = false;
    for (int64_t pg = 0; pg < n_pages; ++pg) {
        const uint8_t* p = pages + pg * kPageSize;
        const uint16_t nr = rd_u16(p);
        if (nr == kLongFirst) {
            const int64_t nchars = rd_u16(p + 2);
            if (row >= num_rows) return -1;
            out_valid[row] = 1;
            out_lengths[row] = nchars;
            total += nchars;
            ++row;
            in_long = true;
            continue;
        }
        if (nr == kLongCont) {
            if (!in_long || row == 0) return -1;
            const int64_t nchars = rd_u16(p + 2);
            out_lengths[row - 1] += nchars;
            total += nchars;
            continue;
        }
        in_long = false;
        const uint16_t nv = rd_u16(p + 2);
        const uint8_t* offs = p + 4;
        const uint8_t* bitmap = p + kPageSize - ((nr + 7) >> 3);
        if (row + nr > num_rows) return -1;
        uint16_t prev = 0;
        int64_t di = 0;
        for (int64_t i = 0; i < nr; ++i, ++row) {
            if (get_bit(bitmap, i)) {
                if (di >= nv) return -1;
                const uint16_t end = rd_u16(offs + di * 2);
                out_valid[row] = 1;
                out_lengths[row] = end - prev;
                total += end - prev;
                prev = end;
                ++di;
            } else {
                out_valid[row] = 0;
                out_lengths[row] = 0;
            }
        }
    }
    return row == num_rows ? total : -1;
}

// Pass 2: copy string payloads into the heap (lengths as from pass 1).
int64_t rjt_decode_varchar_fill(const uint8_t* pages, int64_t n_pages,
                                int64_t num_rows, uint8_t* heap) {
    int64_t row = 0;
    int64_t pos = 0;
    for (int64_t pg = 0; pg < n_pages; ++pg) {
        const uint8_t* p = pages + pg * kPageSize;
        const uint16_t nr = rd_u16(p);
        if (nr == kLongFirst || nr == kLongCont) {
            const int64_t nchars = rd_u16(p + 2);
            std::memcpy(heap + pos, p + 4, nchars);
            pos += nchars;
            if (nr == kLongFirst) ++row;
            continue;
        }
        const uint16_t nv = rd_u16(p + 2);
        const uint8_t* offs = p + 4;
        const uint8_t* data = p + 4 + nv * 2;
        const uint8_t* bitmap = p + kPageSize - ((nr + 7) >> 3);
        uint16_t prev = 0;
        int64_t di = 0;
        for (int64_t i = 0; i < nr; ++i, ++row) {
            if (get_bit(bitmap, i)) {
                const uint16_t end = rd_u16(offs + di * 2);
                std::memcpy(heap + pos, data + prev, end - prev);
                pos += end - prev;
                prev = end;
                ++di;
            }
        }
    }
    return pos;
}

int64_t rjt_count_pages_varchar(const uint8_t* /*heap*/, const int64_t* ends,
                                const uint8_t* valid, int64_t n) {
    int64_t pages = 0, i = 0;
    int64_t prev_end = 0;
    while (i < n) {
        const int64_t len = ends[i] - prev_end;
        if (valid[i] && len > kMaxInline) {
            pages += (len + kPageSize - 5) / (kPageSize - 4);
            prev_end = ends[i];
            ++i;
            continue;
        }
        // pack a normal page greedily
        int64_t rows = 0, vals = 0, bytes = 0;
        while (i < n && rows < kMaxVarcharRows) {
            const int64_t l = valid[i] ? ends[i] - prev_end : 0;
            if (valid[i] && l > kMaxInline) break;
            const int64_t nv = vals + (valid[i] ? 1 : 0);
            const int64_t nb = bytes + l;
            if (4 + nv * 2 + nb + (rows / 8 + 1) > kPageSize) break;
            vals = nv;
            bytes = nb;
            prev_end = ends[i];
            ++rows;
            ++i;
        }
        if (rows == 0 && i < n && !(valid[i] && ends[i] - prev_end > kMaxInline)) {
            return -1;  // cannot make progress (should be impossible)
        }
        if (rows > 0) ++pages;
    }
    return pages;
}

// Variable-length gather: concatenate heap[starts[i] .. starts[i]+lengths[i])
// for every row into `out` (row i lands at out_ends[i] - lengths[i]).
// `out_ends` is the precomputed inclusive cumulative sum of lengths.
void rjt_gather_varlen(const uint8_t* heap, const int64_t* starts,
                       const int64_t* lengths, int64_t n,
                       const int64_t* out_ends, uint8_t* out) {
    for (int64_t i = 0; i < n; ++i) {
        const int64_t len = lengths[i];
        if (len > 0) memcpy(out + out_ends[i] - len, heap + starts[i],
                            static_cast<size_t>(len));
    }
}

int64_t rjt_encode_varchar(const uint8_t* heap, const int64_t* ends,
                           const uint8_t* valid, int64_t n, uint8_t* out_pages,
                           int64_t max_pages) {
    int64_t pg = 0, i = 0;
    int64_t prev_end = 0;
    while (i < n) {
        const int64_t len = ends[i] - prev_end;
        if (valid[i] && len > kMaxInline) {
            // long-string page chain
            int64_t off = 0;
            bool first = true;
            while (off < len) {
                if (pg >= max_pages) return -1;
                uint8_t* p = out_pages + pg * kPageSize;
                std::memset(p, 0, kPageSize);
                const int64_t chunk = std::min(len - off, kPageSize - 4);
                wr_u16(p, first ? kLongFirst : kLongCont);
                wr_u16(p + 2, static_cast<uint16_t>(chunk));
                std::memcpy(p + 4, heap + prev_end + off, chunk);
                off += chunk;
                first = false;
                ++pg;
            }
            prev_end = ends[i];
            ++i;
            continue;
        }
        if (pg >= max_pages) return -1;
        uint8_t* p = out_pages + pg * kPageSize;
        std::memset(p, 0, kPageSize);
        const int64_t start = i;
        const int64_t heap_start = prev_end;
        int64_t rows = 0, vals = 0, bytes = 0;
        while (i < n && rows < kMaxVarcharRows) {
            const int64_t l = valid[i] ? ends[i] - prev_end : 0;
            if (valid[i] && l > kMaxInline) break;
            const int64_t nv = vals + (valid[i] ? 1 : 0);
            const int64_t nb = bytes + l;
            if (4 + nv * 2 + nb + (rows / 8 + 1) > kPageSize) break;
            vals = nv;
            bytes = nb;
            prev_end = ends[i];
            ++rows;
            ++i;
        }
        wr_u16(p, static_cast<uint16_t>(rows));
        wr_u16(p + 2, static_cast<uint16_t>(vals));
        uint8_t* offs = p + 4;
        uint8_t* data = p + 4 + vals * 2;
        uint8_t* bitmap = p + kPageSize - ((rows + 7) >> 3);
        int64_t di = 0;
        int64_t cum = 0;
        int64_t hpos = heap_start;
        for (int64_t r = 0; r < rows; ++r) {
            const int64_t idx = start + r;
            if (valid[idx]) {
                const int64_t prev = (idx == 0) ? 0 : ends[idx - 1];
                const int64_t l = ends[idx] - prev;
                std::memcpy(data + cum, heap + hpos, l);
                cum += l;
                hpos += l;
                wr_u16(offs + di * 2, static_cast<uint16_t>(cum));
                set_bit(bitmap, r);
                ++di;
            }
        }
        ++pg;
    }
    return pg;
}

// ---------------------------------------------------------------------------
// String kernels: SQL LIKE (RE2-compatible: wildcards do not cross '\n'),
// comparisons against a literal
// ---------------------------------------------------------------------------

static bool like_match(const uint8_t* s, int64_t n, const uint8_t* p,
                       int64_t m) {
    int64_t si = 0, pi = 0;
    int64_t star = -1, mark = 0;
    while (si < n) {
        if (pi < m &&
            ((p[pi] == '_' && s[si] != '\n') ||
             (p[pi] != '%' && p[pi] != '_' && p[pi] == s[si]))) {
            ++pi;
            ++si;
        } else if (pi < m && p[pi] == '%') {
            star = pi++;
            mark = si;
        } else if (star >= 0) {
            if (s[mark] == '\n') return false;  // '%' cannot cross newline
            ++mark;
            si = mark;
            pi = star + 1;
        } else {
            return false;
        }
    }
    while (pi < m && p[pi] == '%') ++pi;
    return pi == m;
}

void rjt_like(const uint8_t* heap, const int64_t* ends, const uint8_t* valid,
              int64_t n, const uint8_t* pattern, int64_t patlen,
              int32_t negate, uint8_t* out) {
    int64_t prev = 0;
    for (int64_t i = 0; i < n; ++i) {
        const int64_t end = ends[i];
        if (valid[i]) {
            const bool m = like_match(heap + prev, end - prev, pattern, patlen);
            out[i] = (m != (negate != 0)) ? 1 : 0;
        } else {
            out[i] = 0;
        }
        prev = end;
    }
}

// op: 0 EQ, 1 NEQ, 2 LT, 3 GT, 4 LEQ, 5 GEQ
void rjt_str_compare(const uint8_t* heap, const int64_t* ends,
                     const uint8_t* valid, int64_t n, const uint8_t* lit,
                     int64_t litlen, int32_t op, uint8_t* out) {
    const std::string_view rhs(reinterpret_cast<const char*>(lit),
                               static_cast<size_t>(litlen));
    int64_t prev = 0;
    for (int64_t i = 0; i < n; ++i) {
        const int64_t end = ends[i];
        bool r = false;
        if (valid[i]) {
            const std::string_view lhs(
                reinterpret_cast<const char*>(heap + prev),
                static_cast<size_t>(end - prev));
            const int c = lhs.compare(rhs);
            switch (op) {
                case 0: r = (c == 0); break;
                case 1: r = (c != 0); break;
                case 2: r = (c < 0); break;
                case 3: r = (c > 0); break;
                case 4: r = (c <= 0); break;
                case 5: r = (c >= 0); break;
            }
        }
        out[i] = r ? 1 : 0;
        prev = end;
    }
}

// ---------------------------------------------------------------------------
// Dictionary encoding (sorted-unique, like np.unique) over heap+ends
// ---------------------------------------------------------------------------

struct RjtDict {
    std::vector<uint8_t> heap;
    std::vector<int64_t> ends;
};

void* rjt_dict_build(const uint8_t* heap, const int64_t* ends,
                     const uint8_t* valid, int64_t n, int32_t* out_ids) {
    std::vector<std::string_view> views;
    views.reserve(n);
    int64_t prev = 0;
    for (int64_t i = 0; i < n; ++i) {
        if (valid[i]) {
            views.emplace_back(reinterpret_cast<const char*>(heap + prev),
                               static_cast<size_t>(ends[i] - prev));
        }
        prev = ends[i];
    }
    std::vector<std::string_view> uniq(views);
    std::sort(uniq.begin(), uniq.end());
    uniq.erase(std::unique(uniq.begin(), uniq.end()), uniq.end());

    prev = 0;
    for (int64_t i = 0; i < n; ++i) {
        if (valid[i]) {
            const std::string_view v(
                reinterpret_cast<const char*>(heap + prev),
                static_cast<size_t>(ends[i] - prev));
            const auto it = std::lower_bound(uniq.begin(), uniq.end(), v);
            out_ids[i] = static_cast<int32_t>(it - uniq.begin());
        } else {
            out_ids[i] = 0;
        }
        prev = ends[i];
    }

    auto* d = new RjtDict();
    d->ends.reserve(uniq.size());
    int64_t total = 0;
    for (const auto& v : uniq) total += static_cast<int64_t>(v.size());
    d->heap.reserve(total);
    for (const auto& v : uniq) {
        d->heap.insert(d->heap.end(), v.begin(), v.end());
        d->ends.push_back(static_cast<int64_t>(d->heap.size()));
    }
    return d;
}

int64_t rjt_dict_size(void* h) {
    return static_cast<int64_t>(static_cast<RjtDict*>(h)->ends.size());
}

int64_t rjt_dict_heap_bytes(void* h) {
    return static_cast<int64_t>(static_cast<RjtDict*>(h)->heap.size());
}

void rjt_dict_export(void* h, uint8_t* heap_out, int64_t* ends_out) {
    auto* d = static_cast<RjtDict*>(h);
    if (!d->heap.empty()) std::memcpy(heap_out, d->heap.data(), d->heap.size());
    if (!d->ends.empty())
        std::memcpy(ends_out, d->ends.data(), d->ends.size() * sizeof(int64_t));
}

void rjt_dict_free(void* h) { delete static_cast<RjtDict*>(h); }

// ---------------------------------------------------------------------------
// CSV ingest (reference dialect: ',' sep, '"' quotes, '\\' escape inside
// quotes, CRLF, empty field = NULL; embedded newlines inside quotes)
// ---------------------------------------------------------------------------

struct CsvTable {
    int64_t rows = 0;
    std::string error;
    // fixed columns: packed values + validity; varchar: heap + ends + validity
    std::vector<std::vector<uint8_t>> fixed_values;
    std::vector<std::vector<uint8_t>> heaps;
    std::vector<std::vector<int64_t>> ends;
    std::vector<std::vector<uint8_t>> valids;
    std::vector<int32_t> types;  // 0 i32, 1 i64, 2 f64, 3 varchar
};

static bool csv_push_field(CsvTable* t, int32_t col, const std::string& field) {
    const int32_t ty = t->types[col];
    const bool null = field.empty();
    t->valids[col].push_back(null ? 0 : 1);
    switch (ty) {
        case 0: {
            int32_t v = 0;
            if (!null) v = static_cast<int32_t>(std::strtol(field.c_str(), nullptr, 10));
            const uint8_t* b = reinterpret_cast<const uint8_t*>(&v);
            t->fixed_values[col].insert(t->fixed_values[col].end(), b, b + 4);
            break;
        }
        case 1: {
            int64_t v = 0;
            if (!null) v = std::strtoll(field.c_str(), nullptr, 10);
            const uint8_t* b = reinterpret_cast<const uint8_t*>(&v);
            t->fixed_values[col].insert(t->fixed_values[col].end(), b, b + 8);
            break;
        }
        case 2: {
            double v = 0;
            if (!null) v = std::strtod(field.c_str(), nullptr);
            const uint8_t* b = reinterpret_cast<const uint8_t*>(&v);
            t->fixed_values[col].insert(t->fixed_values[col].end(), b, b + 8);
            break;
        }
        case 3: {
            auto& heap = t->heaps[col];
            heap.insert(heap.end(), field.begin(), field.end());
            t->ends[col].push_back(static_cast<int64_t>(heap.size()));
            break;
        }
    }
    return true;
}

void* rjt_csv_parse(const char* path, int32_t ncols, const int32_t* types) {
    auto* t = new CsvTable();
    t->types.assign(types, types + ncols);
    t->fixed_values.resize(ncols);
    t->heaps.resize(ncols);
    t->ends.resize(ncols);
    t->valids.resize(ncols);

    FILE* f = std::fopen(path, "rb");
    if (!f) {
        t->error = "cannot open file";
        return t;
    }
    std::string buf;
    std::fseek(f, 0, SEEK_END);
    const long fsize = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    buf.resize(static_cast<size_t>(fsize));
    if (fsize > 0 && std::fread(buf.data(), 1, buf.size(), f) != buf.size()) {
        std::fclose(f);
        t->error = "short read";
        return t;
    }
    std::fclose(f);

    std::string field;
    int32_t col = 0;
    bool quoted = false;
    const char escape = '\\';
    size_t i = 0;
    const size_t len = buf.size();
    bool row_has_data = false;
    while (i < len) {
        const char c = buf[i];
        if (c == '"') {
            quoted = !quoted;
            ++i;
            row_has_data = true;
        } else if (c == escape && quoted) {
            // escape applies inside quotes: next '"' or '\\' is literal,
            // otherwise the backslash itself is kept
            if (i + 1 < len && (buf[i + 1] == '"' || buf[i + 1] == escape)) {
                field.push_back(buf[i + 1]);
                i += 2;
            } else {
                field.push_back(escape);
                ++i;
            }
        } else if (c == ',' && !quoted) {
            if (col >= ncols) {
                t->error = "too many columns at row " + std::to_string(t->rows);
                return t;
            }
            csv_push_field(t, col, field);
            field.clear();
            ++col;
            ++i;
            row_has_data = true;
        } else if ((c == '\n' || c == '\r') && !quoted) {
            if (c == '\r' && i + 1 < len && buf[i + 1] == '\n') ++i;
            ++i;
            if (col == 0 && field.empty() && !row_has_data) continue;  // blank line
            if (col != ncols - 1) {
                t->error = "wrong column count at row " + std::to_string(t->rows);
                return t;
            }
            csv_push_field(t, col, field);
            field.clear();
            col = 0;
            ++t->rows;
            row_has_data = false;
        } else {
            field.push_back(c);
            ++i;
            row_has_data = true;
        }
    }
    if (quoted) {
        t->error = "unterminated quote";
        return t;
    }
    if (col != 0 || !field.empty() || row_has_data) {
        if (col != ncols - 1) {
            t->error = "wrong column count at final row";
            return t;
        }
        csv_push_field(t, col, field);
        ++t->rows;
    }
    return t;
}

int64_t rjt_csv_rows(void* h) { return static_cast<CsvTable*>(h)->rows; }

const char* rjt_csv_error(void* h) {
    auto* t = static_cast<CsvTable*>(h);
    return t->error.empty() ? nullptr : t->error.c_str();
}

void rjt_csv_get_fixed(void* h, int32_t col, uint8_t* values, uint8_t* valid) {
    auto* t = static_cast<CsvTable*>(h);
    if (!t->fixed_values[col].empty())
        std::memcpy(values, t->fixed_values[col].data(),
                    t->fixed_values[col].size());
    if (!t->valids[col].empty())
        std::memcpy(valid, t->valids[col].data(), t->valids[col].size());
}

int64_t rjt_csv_heap_bytes(void* h, int32_t col) {
    return static_cast<int64_t>(static_cast<CsvTable*>(h)->heaps[col].size());
}

void rjt_csv_get_varchar(void* h, int32_t col, uint8_t* heap, int64_t* ends,
                         uint8_t* valid) {
    auto* t = static_cast<CsvTable*>(h);
    if (!t->heaps[col].empty())
        std::memcpy(heap, t->heaps[col].data(), t->heaps[col].size());
    if (!t->ends[col].empty())
        std::memcpy(ends, t->ends[col].data(),
                    t->ends[col].size() * sizeof(int64_t));
    if (!t->valids[col].empty())
        std::memcpy(valid, t->valids[col].data(), t->valids[col].size());
}

void rjt_csv_free(void* h) { delete static_cast<CsvTable*>(h); }

}  // extern "C"
