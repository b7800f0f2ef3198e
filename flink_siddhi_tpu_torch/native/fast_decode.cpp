// Host-side columnar event decode: newline-delimited JSON / CSV -> columns.
//
// The reference does per-event row serialization in the JVM
// (StreamSerializer.java:38-66, uncached reflection per field per event —
// its own TODO at :69 calls the cost out). Here the performance-critical
// host path is native: one pass over the input buffer fills preallocated
// numpy-owned column arrays, and string values are dictionary-interned into
// persistent per-column interners whose codes mirror the Python StringTable
// (see flink_siddhi_tpu/native/__init__.py for the sync protocol).
//
// Exposed as a plain C ABI for ctypes — no pybind11 dependency.
//
// Field kinds: 0 = int64, 1 = double, 2 = string (-> int64 code), 3 = bool.

#include <algorithm>
#include <cerrno>
#include <charconv>
#if !defined(__cpp_lib_to_chars)
#include <locale.h>  // newlocale / strtod_l for the strtod fallback
#endif
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

// Locale-independent numeric parsing (std::from_chars): strtod/strtoll are
// LC_NUMERIC-sensitive — an embedding process with a comma-decimal locale
// would silently parse "1.5" as 1 + trailing garbage and flag the row
// invalid, diverging from the Python fallback. from_chars is also bounded
// by an explicit end pointer (the input buffer is not NUL-terminated).
// Out-of-range magnitudes are treated as parse failures (invalid row).
// GCC 10's libstdc++ ships integer from_chars only (__cpp_lib_to_chars
// unset); the fallback copies the bounded token (NUL-terminated, heap
// copy for tokens that outgrow the stack buffer so nothing truncates)
// and parses with strtod_l pinned to a process-independent "C" numeric
// locale, so a comma-decimal embedding process parses identically to
// the from_chars build. Only if newlocale itself fails does it fall
// back to plain locale-sensitive strtod.
#if defined(__cpp_lib_to_chars)
inline bool parse_f64(const char* p, const char* end, double& v,
                      const char*& ep) {
    auto r = std::from_chars(p, end, v, std::chars_format::general);
    if (r.ec != std::errc()) return false;
    ep = r.ptr;
    return true;
}
#else
inline bool parse_f64(const char* p, const char* end, double& v,
                      const char*& ep) {
    static const locale_t c_loc =
        newlocale(LC_NUMERIC_MASK, "C", static_cast<locale_t>(0));
    // match the from_chars grammar exactly, not strtod's wider one:
    // no leading whitespace (ALL isspace forms — strtod also skips
    // \r \v \f \n), no '+', and a hex prefix parses as the leading
    // "0" only (from_chars stops at 'x'; strtod would eat a whole
    // hexfloat)
    if (p == end || *p == ' ' || *p == '\t' || *p == '\r' ||
        *p == '\v' || *p == '\f' || *p == '\n' || *p == '+')
        return false;
    {
        const char* q = p + (*p == '-' ? 1 : 0);
        if (q + 1 < end && q[0] == '0' &&
            (q[1] == 'x' || q[1] == 'X')) {
            v = (*p == '-') ? -0.0 : 0.0;
            ep = q + 1;
            return true;
        }
    }
    char buf[64];
    std::string big;
    const size_t n = static_cast<size_t>(end - p);
    const char* src;
    if (n < sizeof(buf)) {
        std::memcpy(buf, p, n);
        buf[n] = '\0';
        src = buf;
    } else {
        big.assign(p, n);
        src = big.c_str();
    }
    errno = 0;
    char* out = nullptr;
    double parsed = c_loc != static_cast<locale_t>(0)
                        ? strtod_l(src, &out, c_loc)
                        : std::strtod(src, &out);
    if (out == src || errno == ERANGE) return false;
    v = parsed;
    ep = p + (out - src);
    return true;
}
#endif

inline bool parse_i64(const char* p, const char* end, long long& v,
                      const char*& ep) {
    auto r = std::from_chars(p, end, v, 10);
    if (r.ec != std::errc()) return false;
    ep = r.ptr;
    return true;
}

// Case-insensitive "true"/"false" for bool cells (kind 3). The JSON path
// accepts the literals; CSV must too, or 'true' cells invalidate the row.
inline bool parse_bool_word(const char* p, const char* end, long long& v) {
    size_t len = static_cast<size_t>(end - p);
    if (len == 4 && (p[0] == 't' || p[0] == 'T') &&
        (p[1] == 'r' || p[1] == 'R') && (p[2] == 'u' || p[2] == 'U') &&
        (p[3] == 'e' || p[3] == 'E')) {
        v = 1;
        return true;
    }
    if (len == 5 && (p[0] == 'f' || p[0] == 'F') &&
        (p[1] == 'a' || p[1] == 'A') && (p[2] == 'l' || p[2] == 'L') &&
        (p[3] == 's' || p[3] == 'S') && (p[4] == 'e' || p[4] == 'E')) {
        v = 0;
        return true;
    }
    return false;
}

struct Interner {
    std::unordered_map<std::string, int64_t> codes;
    std::vector<std::string> values;

    int64_t intern(const char* s, size_t len) {
        std::string key(s, len);
        auto it = codes.find(key);
        if (it != codes.end()) return it->second;
        int64_t code = static_cast<int64_t>(values.size());
        codes.emplace(std::move(key), code);
        values.emplace_back(s, len);
        return code;
    }
};

struct Cursor {
    const char* p;
    const char* end;

    bool done() const { return p >= end; }
    char peek() const { return *p; }
    void skip_ws() {
        while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
    }
};

// Parse a JSON string starting at the opening quote; append decoded bytes
// to out. Returns false on malformed input. Handles \" \\ \/ \b \f \n \r
// \t and \uXXXX (encoded as UTF-8, surrogate pairs supported).
bool parse_json_string(Cursor& c, std::string& out) {
    if (c.done() || c.peek() != '"') return false;
    ++c.p;
    while (!c.done()) {
        char ch = *c.p++;
        if (ch == '"') return true;
        if (ch != '\\') {
            out.push_back(ch);
            continue;
        }
        if (c.done()) return false;
        char esc = *c.p++;
        switch (esc) {
            case '"': out.push_back('"'); break;
            case '\\': out.push_back('\\'); break;
            case '/': out.push_back('/'); break;
            case 'b': out.push_back('\b'); break;
            case 'f': out.push_back('\f'); break;
            case 'n': out.push_back('\n'); break;
            case 'r': out.push_back('\r'); break;
            case 't': out.push_back('\t'); break;
            case 'u': {
                if (c.end - c.p < 4) return false;
                auto hex4 = [](const char* q, uint32_t& v) {
                    v = 0;
                    for (int i = 0; i < 4; ++i) {
                        char h = q[i];
                        v <<= 4;
                        if (h >= '0' && h <= '9') v |= h - '0';
                        else if (h >= 'a' && h <= 'f') v |= h - 'a' + 10;
                        else if (h >= 'A' && h <= 'F') v |= h - 'A' + 10;
                        else return false;
                    }
                    return true;
                };
                uint32_t cp;
                if (!hex4(c.p, cp)) return false;
                c.p += 4;
                if (cp >= 0xD800 && cp <= 0xDBFF) {  // high surrogate
                    if (c.end - c.p < 6 || c.p[0] != '\\' || c.p[1] != 'u')
                        return false;
                    uint32_t lo;
                    if (!hex4(c.p + 2, lo)) return false;
                    if (lo < 0xDC00 || lo > 0xDFFF) return false;
                    c.p += 6;
                    cp = 0x10000 + ((cp - 0xD800) << 10) + (lo - 0xDC00);
                }
                if (cp < 0x80) {
                    out.push_back(static_cast<char>(cp));
                } else if (cp < 0x800) {
                    out.push_back(static_cast<char>(0xC0 | (cp >> 6)));
                    out.push_back(static_cast<char>(0x80 | (cp & 0x3F)));
                } else if (cp < 0x10000) {
                    out.push_back(static_cast<char>(0xE0 | (cp >> 12)));
                    out.push_back(
                        static_cast<char>(0x80 | ((cp >> 6) & 0x3F)));
                    out.push_back(static_cast<char>(0x80 | (cp & 0x3F)));
                } else {
                    out.push_back(static_cast<char>(0xF0 | (cp >> 18)));
                    out.push_back(
                        static_cast<char>(0x80 | ((cp >> 12) & 0x3F)));
                    out.push_back(
                        static_cast<char>(0x80 | ((cp >> 6) & 0x3F)));
                    out.push_back(static_cast<char>(0x80 | (cp & 0x3F)));
                }
                break;
            }
            default: return false;
        }
    }
    return false;  // unterminated
}

// Skip any JSON value (used for fields the schema doesn't ask for and for
// nested containers). Returns false on malformed input.
bool skip_json_value(Cursor& c) {
    c.skip_ws();
    if (c.done()) return false;
    char ch = c.peek();
    if (ch == '"') {
        std::string sink;
        return parse_json_string(c, sink);
    }
    if (ch == '{' || ch == '[') {
        char open = ch, close = (ch == '{') ? '}' : ']';
        int depth = 0;
        while (!c.done()) {
            char k = *c.p;
            if (k == '"') {
                std::string sink;
                if (!parse_json_string(c, sink)) return false;
                continue;
            }
            ++c.p;
            if (k == open) ++depth;
            else if (k == close) {
                if (--depth == 0) return true;
            }
        }
        return false;
    }
    // number / true / false / null: consume until delimiter
    while (!c.done()) {
        char k = c.peek();
        if (k == ',' || k == '}' || k == ']' || k == ' ' || k == '\t' ||
            k == '\r' || k == '\n')
            break;
        ++c.p;
    }
    return true;
}

struct FieldSpec {
    std::string name;
    int kind;  // 0 int64, 1 double, 2 string, 3 bool
    void* out;
    Interner* interner;
};

void store_default(const FieldSpec& f, long row) {
    if (f.kind == 1) static_cast<double*>(f.out)[row] = 0.0;
    else static_cast<int64_t*>(f.out)[row] = f.kind == 2 && f.interner
        ? f.interner->intern("", 0) : 0;
}

bool store_value(const FieldSpec& f, long row, Cursor& c) {
    c.skip_ws();
    if (c.done()) return false;
    char ch = c.peek();
    if (ch == 'n') {  // null -> default, any kind
        if (c.end - c.p < 4 || std::memcmp(c.p, "null", 4) != 0)
            return false;
        c.p += 4;
        store_default(f, row);
        return true;
    }
    if (f.kind == 2) {  // string
        if (ch != '"') return false;
        std::string s;
        if (!parse_json_string(c, s)) return false;
        static_cast<int64_t*>(f.out)[row] =
            f.interner->intern(s.data(), s.size());
        return true;
    }
    if (ch == 't' || ch == 'f') {
        bool istrue = ch == 't';
        const char* word = istrue ? "true" : "false";
        size_t wl = istrue ? 4 : 5;
        if (static_cast<size_t>(c.end - c.p) < wl ||
            std::memcmp(c.p, word, wl) != 0)
            return false;
        c.p += wl;
        if (f.kind == 1) static_cast<double*>(f.out)[row] = istrue;
        else static_cast<int64_t*>(f.out)[row] = istrue;
        return true;
    }
    // number
    const char* endptr = nullptr;
    if (f.kind == 1) {
        double v;
        if (!parse_f64(c.p, c.end, v, endptr)) return false;
        static_cast<double*>(f.out)[row] = v;
    } else {
        // ints may still arrive as "1.5e3" — fall back through double
        long long v;
        if (!parse_i64(c.p, c.end, v, endptr)) return false;
        if (endptr < c.end && (*endptr == '.' || *endptr == 'e' ||
                               *endptr == 'E')) {
            double dv;
            if (!parse_f64(c.p, c.end, dv, endptr)) return false;
            v = static_cast<long long>(dv);
        }
        static_cast<int64_t*>(f.out)[row] = v;
    }
    c.p = endptr;
    return true;
}

}  // namespace

extern "C" {

void* fd_interner_new() { return new Interner(); }

void fd_interner_free(void* h) { delete static_cast<Interner*>(h); }

long long fd_interner_add(void* h, const char* s, long long len) {
    return static_cast<Interner*>(h)->intern(s, static_cast<size_t>(len));
}

long long fd_interner_size(void* h) {
    return static_cast<long long>(static_cast<Interner*>(h)->values.size());
}

const char* fd_interner_get(void* h, long long i, long long* len_out) {
    Interner* in = static_cast<Interner*>(h);
    if (i < 0 || static_cast<size_t>(i) >= in->values.size()) {
        *len_out = 0;
        return nullptr;
    }
    const std::string& v = in->values[static_cast<size_t>(i)];
    *len_out = static_cast<long long>(v.size());
    return v.data();
}

// Decode newline-delimited JSON objects. Outputs are preallocated arrays of
// max_rows: int64 for kinds 0/2/3, double for kind 1. valid[r] = 1 when row
// r parsed cleanly (malformed rows keep defaults, valid 0). Returns rows
// consumed (== lines seen, capped at max_rows), or -1 on bad arguments.
long long fd_decode_json(const char* buf, long long buflen,
                         const char** names, const long long* name_lens,
                         const int* kinds, int nf, void** interners,
                         long long max_rows, void** outs,
                         unsigned char* valid) {
    if (!buf || nf < 0 || max_rows < 0) return -1;
    std::vector<FieldSpec> fields(static_cast<size_t>(nf));
    for (int i = 0; i < nf; ++i) {
        fields[i].name.assign(names[i], static_cast<size_t>(name_lens[i]));
        fields[i].kind = kinds[i];
        fields[i].out = outs[i];
        fields[i].interner = static_cast<Interner*>(interners[i]);
    }
    const char* p = buf;
    const char* end = buf + buflen;
    long long row = 0;
    std::string key;
    std::vector<char> seen(static_cast<size_t>(nf));
    while (p < end && row < max_rows) {
        const char* nl = static_cast<const char*>(
            std::memchr(p, '\n', static_cast<size_t>(end - p)));
        const char* line_end = nl ? nl : end;
        Cursor c{p, line_end};
        p = nl ? nl + 1 : end;

        c.skip_ws();
        if (c.done()) continue;  // blank line: no row
        bool ok = !c.done() && c.peek() == '{';
        std::fill(seen.begin(), seen.end(), 0);
        if (ok) {
            ++c.p;
            c.skip_ws();
            if (!c.done() && c.peek() == '}') {
                ++c.p;
            } else {
                while (true) {
                    c.skip_ws();
                    key.clear();
                    if (!parse_json_string(c, key)) { ok = false; break; }
                    c.skip_ws();
                    if (c.done() || *c.p++ != ':') { ok = false; break; }
                    c.skip_ws();
                    int fi = -1;
                    for (int i = 0; i < nf; ++i) {
                        if (key.size() == fields[i].name.size() &&
                            std::memcmp(key.data(), fields[i].name.data(),
                                        key.size()) == 0) {
                            fi = i;
                            break;
                        }
                    }
                    if (fi >= 0) {
                        if (!store_value(fields[fi], row, c)) {
                            ok = false;
                            break;
                        }
                        seen[fi] = 1;
                    } else if (!skip_json_value(c)) {
                        ok = false;
                        break;
                    }
                    c.skip_ws();
                    if (c.done()) { ok = false; break; }
                    char nxt = *c.p++;
                    if (nxt == '}') break;
                    if (nxt != ',') { ok = false; break; }
                }
            }
        }
        for (int i = 0; i < nf; ++i)
            if (!ok || !seen[i]) store_default(fields[i], row);
        valid[row] = ok ? 1 : 0;
        ++row;
    }
    return row;
}

// Decode delimiter-separated rows (no quoting/escaping beyond a double-quote
// wrapper; embedded delimiters inside quotes are honored). Column i of each
// line maps to field i. Same output conventions as fd_decode_json.
long long fd_decode_csv(const char* buf, long long buflen, const int* kinds,
                        int nf, void** interners, char delim,
                        long long max_rows, void** outs,
                        unsigned char* valid) {
    if (!buf || nf < 0 || max_rows < 0) return -1;
    std::vector<FieldSpec> fields(static_cast<size_t>(nf));
    for (int i = 0; i < nf; ++i) {
        fields[i].kind = kinds[i];
        fields[i].out = outs[i];
        fields[i].interner = static_cast<Interner*>(interners[i]);
    }
    const char* p = buf;
    const char* end = buf + buflen;
    long long row = 0;
    while (p < end && row < max_rows) {
        const char* nl = static_cast<const char*>(
            std::memchr(p, '\n', static_cast<size_t>(end - p)));
        const char* line_end = nl ? nl : end;
        if (line_end > p && line_end[-1] == '\r') --line_end;
        const char* q = p;
        p = nl ? nl + 1 : end;
        if (q == line_end) continue;  // blank line

        bool ok = true;
        for (int i = 0; i < nf; ++i) {
            const char* cell = q;
            const char* cell_end;
            if (q < line_end && *q == '"') {
                ++cell;
                const char* close = static_cast<const char*>(
                    std::memchr(cell, '"',
                                static_cast<size_t>(line_end - cell)));
                if (!close) { ok = false; break; }
                cell_end = close;
                q = close + 1;
                if (q < line_end && *q == delim) ++q;
            } else {
                const char* d = static_cast<const char*>(
                    std::memchr(q, delim,
                                static_cast<size_t>(line_end - q)));
                cell_end = d ? d : line_end;
                q = d ? d + 1 : line_end;
            }
            const FieldSpec& f = fields[i];
            size_t len = static_cast<size_t>(cell_end - cell);
            if (f.kind == 2) {
                static_cast<int64_t*>(f.out)[row] =
                    f.interner->intern(cell, len);
            } else if (cell == cell_end) {
                ok = false;  // empty numeric cell: invalid row
                break;
            } else {
                // parity with the Python fallback's int()/float(): strip
                // surrounding whitespace and accept one leading '+'
                // (from_chars itself recognizes neither)
                while (cell < cell_end &&
                       (*cell == ' ' || *cell == '\t')) ++cell;
                while (cell_end > cell && (cell_end[-1] == ' ' ||
                                           cell_end[-1] == '\t' ||
                                           cell_end[-1] == '\r')) --cell_end;
                const char* num = cell;
                if (num < cell_end && *num == '+') ++num;
                if (f.kind == 1) {
                    const char* ep = nullptr;
                    double v;
                    if (num == cell_end || !parse_f64(num, cell_end, v, ep) ||
                        ep != cell_end) { ok = false; break; }
                    static_cast<double*>(f.out)[row] = v;
                } else {
                    long long v;
                    if (f.kind == 3 && parse_bool_word(cell, cell_end, v)) {
                        static_cast<int64_t*>(f.out)[row] = v;
                        continue;
                    }
                    const char* ep = nullptr;
                    if (num == cell_end || !parse_i64(num, cell_end, v, ep) ||
                        ep != cell_end) { ok = false; break; }
                    static_cast<int64_t*>(f.out)[row] = v;
                }
            }
        }
        if (!ok)
            for (int i = 0; i < nf; ++i) store_default(fields[i], row);
        valid[row] = ok ? 1 : 0;
        ++row;
    }
    return row;
}

}  // extern "C"
