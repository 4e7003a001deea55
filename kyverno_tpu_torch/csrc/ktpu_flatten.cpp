// ktpu_flatten: resource JSON -> leaf slot tensors, the native twin of
// the Python flattener in models/flatten.py (same layout, byte for byte —
// tests/test_torch_native_flatten.py diffs the packed output against it
// and against the JAX package's own native flattener).
//
// Host code: nothing here runs on the card. Turning admission payloads
// and scan chunks into the packed transfer blob is the host's share of
// every evaluation. It parses a JSON array of documents (one json.dumps
// for the whole batch on the Python side), enumerates the compiled path
// dictionary against each document, interns the string dictionary, and
// decomposes numbers/quantities/durations into exact i64 micro-units —
// mirroring models/flatten.py semantics including phantom slots,
// null-break chains, prefix-presence masks, request-envelope and
// effective-namespace roots, host-lane flags, and Go-style float
// stringification (utils/gofmt.py).
//
// C ABI only (consumed via ctypes). The one Python-aware entry
// (ktpu_flatten_packed_py, walking live dicts to skip json.dumps) is
// guarded by KTPU_NO_PYTHON for builds without Python headers and is
// loaded via ctypes.PyDLL (GIL held). models/native_flatten.py builds
// this file with g++ into build/torch_kernels/ at first use.

#ifndef KTPU_NO_PYTHON
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#endif

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <cstdio>
#include <cstdlib>
#include <charconv>
#include <deque>
#include <memory>
#include <string>
#include <string_view>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

constexpr char SEP = '\x1f';
constexpr int64_t NUM_SCALE_POW10 = 6;          // micro-units
constexpr int64_t NUM_MAX = int64_t(1) << 62;

// type tags (models/flatten.py)
enum : int8_t { T_ABSENT = 0, T_NULL, T_BOOL, T_NUM, T_STR, T_OBJ, T_LIST };

// ------------------------------------------------------------------ JSON

struct Value {
    enum Type : uint8_t { Null, Bool, Num, Str, Obj, Arr } t = Null;
    bool b = false;
    std::string_view raw;                       // Num: literal token text
    std::string str;                            // Str: decoded text
    std::vector<std::pair<std::string, Value*>> obj;
    std::vector<Value*> arr;
};

// Value pool: reset() reuses nodes (and their vector/string capacity)
// across documents, so steady-state parsing does no heap allocation.
struct Arena {
    std::deque<Value> store;
    size_t used = 0;

    Value* alloc() {
        if (used < store.size()) {
            Value* v = &store[used++];
            v->t = Value::Null;
            v->b = false;
            v->raw = {};
            v->str.clear();
            v->obj.clear();
            v->arr.clear();
            return v;
        }
        store.emplace_back();
        ++used;
        return &store.back();
    }

    void reset() { used = 0; }
};

struct Parser {
    const char* p;
    const char* end;
    Arena* arena;
    bool ok = true;

    Value* alloc() { return arena->alloc(); }

    void skip_ws() {
        while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r')) ++p;
    }

    bool lit(const char* s, size_t n) {
        if (size_t(end - p) < n || memcmp(p, s, n) != 0) return false;
        p += n;
        return true;
    }

    Value* parse() {
        skip_ws();
        if (p >= end) { ok = false; return nullptr; }
        switch (*p) {
            case '{': return parse_obj();
            case '[': return parse_arr();
            case '"': return parse_str();
            case 't': { Value* v = alloc(); v->t = Value::Bool; v->b = true;
                        if (!lit("true", 4)) ok = false; return v; }
            case 'f': { Value* v = alloc(); v->t = Value::Bool; v->b = false;
                        if (!lit("false", 5)) ok = false; return v; }
            case 'n': { Value* v = alloc(); v->t = Value::Null;
                        if (!lit("null", 4)) ok = false; return v; }
            default:  return parse_num();
        }
    }

    Value* parse_obj() {
        Value* v = alloc(); v->t = Value::Obj;
        ++p;  // '{'
        skip_ws();
        if (p < end && *p == '}') { ++p; return v; }
        while (ok) {
            skip_ws();
            if (p >= end || *p != '"') { ok = false; break; }
            Value* key = parse_str();
            if (!ok) break;
            skip_ws();
            if (p >= end || *p != ':') { ok = false; break; }
            ++p;
            Value* val = parse();
            if (!ok) break;
            v->obj.emplace_back(std::move(key->str), val);
            skip_ws();
            if (p < end && *p == ',') { ++p; continue; }
            if (p < end && *p == '}') { ++p; break; }
            ok = false;
        }
        return v;
    }

    Value* parse_arr() {
        Value* v = alloc(); v->t = Value::Arr;
        ++p;  // '['
        skip_ws();
        if (p < end && *p == ']') { ++p; return v; }
        while (ok) {
            Value* el = parse();
            if (!ok) break;
            v->arr.push_back(el);
            skip_ws();
            if (p < end && *p == ',') { ++p; continue; }
            if (p < end && *p == ']') { ++p; break; }
            ok = false;
        }
        return v;
    }

    Value* parse_str() {
        Value* v = alloc(); v->t = Value::Str;
        ++p;  // opening '"'
        std::string& out = v->str;
        while (p < end && *p != '"') {
            if (*p == '\\') {
                ++p;
                if (p >= end) { ok = false; return v; }
                switch (*p) {
                    case '"': out += '"'; break;
                    case '\\': out += '\\'; break;
                    case '/': out += '/'; break;
                    case 'b': out += '\b'; break;
                    case 'f': out += '\f'; break;
                    case 'n': out += '\n'; break;
                    case 'r': out += '\r'; break;
                    case 't': out += '\t'; break;
                    case 'u': {
                        if (end - p < 5) { ok = false; return v; }
                        unsigned cp = 0;
                        for (int i = 1; i <= 4; ++i) {
                            char c = p[i];
                            cp <<= 4;
                            if (c >= '0' && c <= '9') cp |= unsigned(c - '0');
                            else if (c >= 'a' && c <= 'f') cp |= unsigned(c - 'a' + 10);
                            else if (c >= 'A' && c <= 'F') cp |= unsigned(c - 'A' + 10);
                            else { ok = false; return v; }
                        }
                        p += 4;
                        // surrogate pairs
                        if (cp >= 0xD800 && cp <= 0xDBFF && end - p >= 7 &&
                            p[1] == '\\' && p[2] == 'u') {
                            unsigned lo = 0;
                            bool lo_ok = true;
                            for (int i = 3; i <= 6; ++i) {
                                char c = p[i];
                                lo <<= 4;
                                if (c >= '0' && c <= '9') lo |= unsigned(c - '0');
                                else if (c >= 'a' && c <= 'f') lo |= unsigned(c - 'a' + 10);
                                else if (c >= 'A' && c <= 'F') lo |= unsigned(c - 'A' + 10);
                                else { lo_ok = false; break; }
                            }
                            if (lo_ok && lo >= 0xDC00 && lo <= 0xDFFF) {
                                cp = 0x10000 + ((cp - 0xD800) << 10) + (lo - 0xDC00);
                                p += 6;
                            }
                        }
                        // utf-8 encode
                        if (cp < 0x80) out += char(cp);
                        else if (cp < 0x800) {
                            out += char(0xC0 | (cp >> 6));
                            out += char(0x80 | (cp & 0x3F));
                        } else if (cp < 0x10000) {
                            out += char(0xE0 | (cp >> 12));
                            out += char(0x80 | ((cp >> 6) & 0x3F));
                            out += char(0x80 | (cp & 0x3F));
                        } else {
                            out += char(0xF0 | (cp >> 18));
                            out += char(0x80 | ((cp >> 12) & 0x3F));
                            out += char(0x80 | ((cp >> 6) & 0x3F));
                            out += char(0x80 | (cp & 0x3F));
                        }
                        break;
                    }
                    default: ok = false; return v;
                }
                ++p;
            } else {
                out += *p++;
            }
        }
        if (p >= end) { ok = false; return v; }
        ++p;  // closing '"'
        return v;
    }

    Value* parse_num() {
        Value* v = alloc(); v->t = Value::Num;
        const char* start = p;
        if (p < end && (*p == '-' || *p == '+')) ++p;
        while (p < end && ((*p >= '0' && *p <= '9') || *p == '.' || *p == 'e' ||
                           *p == 'E' || *p == '+' || *p == '-')) ++p;
        if (p == start) { ok = false; return v; }
        v->raw = std::string_view(start, size_t(p - start));
        return v;
    }
};

const Value* obj_get(const Value* v, std::string_view key) {
    if (v == nullptr || v->t != Value::Obj) return nullptr;
    for (const auto& kv : v->obj)
        if (kv.first == key) return kv.second;
    return nullptr;
}

// ------------------------------------------------------------ quantities

// Exact micro-unit decomposition of a quantity token (utils/quantity.py
// parse_quantity + models/flatten._value_to_micro). Returns false when not
// a quantity or not exactly representable in micro-units <= NUM_MAX.
bool quantity_to_micro(std::string_view s, int64_t* out,
                       bool* capped = nullptr) {
    // str.strip() (ASCII whitespace set is what occurs in JSON strings)
    auto is_ws = [](char c) {
        return c == ' ' || c == '\t' || c == '\n' || c == '\r' ||
               c == '\f' || c == '\v';
    };
    while (!s.empty() && is_ws(s.front())) s.remove_prefix(1);
    while (!s.empty() && is_ws(s.back())) s.remove_suffix(1);
    if (s.empty()) return false;

    size_t i = 0;
    bool neg = false;
    if (s[i] == '+' || s[i] == '-') { neg = s[i] == '-'; ++i; }

    __int128 digits = 0;
    int n_int = 0, n_frac = 0;
    bool seen_dot = false;
    int total_digits = 0;
    for (; i < s.size(); ++i) {
        char c = s[i];
        if (c >= '0' && c <= '9') {
            if (++total_digits > 36) {
                // beyond the exact __int128 range; the Python tier has no
                // digit cap, so such leaves route to the host lane
                if (capped) *capped = true;
                return false;
            }
            digits = digits * 10 + (c - '0');
            if (seen_dot) ++n_frac; else ++n_int;
        } else if (c == '.' && !seen_dot) {
            seen_dot = true;
        } else {
            break;
        }
    }
    // _QUANTITY_RE: \d+(\.\d*)? | \.\d+  — a bare "." or ".suffix" is invalid
    if (n_int == 0 && n_frac == 0) return false;

    std::string_view suffix = s.substr(i);
    int pow10 = 0;
    int pow2 = 0;
    if (!suffix.empty()) {
        if (suffix == "Ki") pow2 = 10;
        else if (suffix == "Mi") pow2 = 20;
        else if (suffix == "Gi") pow2 = 30;
        else if (suffix == "Ti") pow2 = 40;
        else if (suffix == "Pi") pow2 = 50;
        else if (suffix == "Ei") pow2 = 60;
        else if (suffix == "n") pow10 = -9;
        else if (suffix == "u") pow10 = -6;
        else if (suffix == "m") pow10 = -3;
        else if (suffix == "k") pow10 = 3;
        else if (suffix == "M") pow10 = 6;
        else if (suffix == "G") pow10 = 9;
        else if (suffix == "T") pow10 = 12;
        else if (suffix == "P") pow10 = 15;
        else if (suffix == "E") pow10 = 18;
        else if (suffix[0] == 'e' || suffix[0] == 'E') {
            int exp = 0;
            bool eneg = false;
            size_t j = 1;
            if (j < suffix.size() && (suffix[j] == '+' || suffix[j] == '-')) {
                eneg = suffix[j] == '-';
                ++j;
            }
            if (j >= suffix.size()) return false;
            for (; j < suffix.size(); ++j) {
                if (suffix[j] < '0' || suffix[j] > '9') return false;
                exp = exp * 10 + (suffix[j] - '0');
                if (exp > 40) return false;
            }
            pow10 = eneg ? -exp : exp;
        } else {
            return false;
        }
    }

    // value = digits * 10^(-n_frac) * 2^pow2 * 10^pow10; micro = value*10^6
    __int128 num = digits;
    for (int k = 0; k < pow2; ++k) {
        num <<= 1;
        if (num > (__int128(1) << 100)) return false;
    }
    int scale = -n_frac + pow10 + int(NUM_SCALE_POW10);
    while (scale > 0) {
        num *= 10;
        --scale;
        if (num > (__int128(1) << 110)) return false;
    }
    while (scale < 0) {
        if (num % 10 != 0) return false;  // sub-micro precision
        num /= 10;
        ++scale;
    }
    if (num > __int128(NUM_MAX)) return false;
    *out = neg ? -int64_t(num) : int64_t(num);
    return true;
}

// std::from_chars for double is absent in libstdc++ < 11; strtod on the
// NUL-terminated copy parses the same token (callers pre-validate the
// digit shape, and LC_NUMERIC stays "C" inside extension modules).
inline double parse_double_tok(const std::string& tok) {
#if defined(__cpp_lib_to_chars) && __cpp_lib_to_chars >= 201611L
    double v = 0.0;
    std::from_chars(tok.data(), tok.data() + tok.size(), v);
    return v;
#else
    return strtod(tok.c_str(), nullptr);
#endif
}

// Go strconv.FormatFloat(v,'E',-1,64) — shortest mantissa, E+NN exponent
// (utils/gofmt.py format_float_sci).
std::string format_float_sci(double v) {
    if (v != v) return "NaN";
    if (v == __builtin_inf()) return "+Inf";
    if (v == -__builtin_inf()) return "-Inf";
    char buf[64];
#if defined(__cpp_lib_to_chars) && __cpp_lib_to_chars >= 201611L
    auto res = std::to_chars(buf, buf + sizeof buf, v);  // shortest repr
    std::string shortest(buf, res.ptr);
#else
    // libstdc++ < 11 has no floating-point to_chars: find the shortest
    // %g precision that round-trips — same digits as to_chars (minimal
    // length, correctly rounded), so byte parity with gofmt.py holds
    for (int prec = 1; prec <= 17; ++prec) {
        snprintf(buf, sizeof buf, "%.*g", prec, v);
        if (strtod(buf, nullptr) == v) break;
    }
    std::string shortest(buf);
#endif

    bool neg = false;
    std::string digits = shortest;
    if (!digits.empty() && digits[0] == '-') { neg = true; digits.erase(0, 1); }

    std::string mant_digits;
    int iexp = 0;
    auto epos = digits.find_first_of("eE");
    if (epos != std::string::npos) {
        std::string m = digits.substr(0, epos);
        iexp = atoi(digits.c_str() + epos + 1);
        auto dot = m.find('.');
        if (dot != std::string::npos) m.erase(dot, 1);
        while (m.size() > 1 && m.back() == '0') m.pop_back();
        mant_digits = m;
    } else {
        auto dot = digits.find('.');
        std::string int_part = dot == std::string::npos ? digits : digits.substr(0, dot);
        std::string frac = dot == std::string::npos ? "" : digits.substr(dot + 1);
        if (frac == "0") frac = "";
        while (!frac.empty() && frac.back() == '0') frac.pop_back();
        if (int_part == "0") {
            size_t nz = frac.find_first_not_of('0');
            if (nz == std::string::npos) return neg ? "-0E+00" : "0E+00";
            iexp = -int(nz) - 1;
            mant_digits = frac.substr(nz);
        } else {
            iexp = int(int_part.size()) - 1;
            mant_digits = int_part + frac;
            while (mant_digits.size() > 1 && mant_digits.back() == '0')
                mant_digits.pop_back();
        }
    }
    std::string out;
    if (neg) out += '-';
    out += mant_digits[0];
    if (mant_digits.size() > 1) {
        out += '.';
        out += mant_digits.substr(1);
    }
    out += 'E';
    out += iexp >= 0 ? '+' : '-';
    int a = iexp >= 0 ? iexp : -iexp;
    char eb[8];
    snprintf(eb, sizeof eb, "%02d", a);
    out += eb;
    return out;
}

// value_to_string_for_equality for a Num token: ints keep their text,
// floats format the Go way.
bool num_token_is_int(std::string_view raw) {
    for (char c : raw)
        if (c == '.' || c == 'e' || c == 'E') return false;
    return true;
}

// ------------------------------------------------------------ durations

// utils/duration.py parse_duration twin: Go time.ParseDuration dialect.
// Returns seconds; summation order and unit constants match the Python so
// the doubles (and the banker's rounding to micro below) agree bit-exactly.
bool parse_duration_secs(std::string_view s, double* out) {
    auto is_ws = [](char c) {
        return c == ' ' || c == '\t' || c == '\n' || c == '\r' ||
               c == '\f' || c == '\v';
    };
    while (!s.empty() && is_ws(s.front())) s.remove_prefix(1);
    while (!s.empty() && is_ws(s.back())) s.remove_suffix(1);
    bool neg = false;
    if (!s.empty() && (s.front() == '+' || s.front() == '-')) {
        neg = s.front() == '-';
        s.remove_prefix(1);
    }
    if (s == "0") { *out = 0.0; return true; }
    if (s.empty()) return false;
    double total = 0.0;
    size_t i = 0;
    while (i < s.size()) {
        // number: \d+(\.\d*)? | \.\d+
        size_t start = i;
        int nd = 0, nf = 0;
        bool dot = false;
        while (i < s.size()) {
            char c = s[i];
            if (c >= '0' && c <= '9') { ++i; if (dot) ++nf; else ++nd; }
            else if (c == '.' && !dot) { dot = true; ++i; }
            else break;
        }
        if (nd == 0 && nf == 0) return false;
        double v = parse_double_tok(std::string(s.substr(start, i - start)));
        // unit (longest match first): ns us µs μs ms s m h
        double unit;
        if (s.compare(i, 2, "ns") == 0) { unit = 1e-9; i += 2; }
        else if (s.compare(i, 2, "us") == 0) { unit = 1e-6; i += 2; }
        else if (s.compare(i, 3, "\xc2\xb5s") == 0) { unit = 1e-6; i += 3; }
        else if (s.compare(i, 3, "\xce\xbcs") == 0) { unit = 1e-6; i += 3; }
        else if (s.compare(i, 2, "ms") == 0) { unit = 1e-3; i += 2; }
        else if (s.compare(i, 1, "s") == 0) { unit = 1.0; i += 1; }
        else if (s.compare(i, 1, "m") == 0) { unit = 60.0; i += 1; }
        else if (s.compare(i, 1, "h") == 0) { unit = 3600.0; i += 1; }
        else return false;
        total += v * unit;
    }
    *out = neg ? -total : total;
    return true;
}

// models/flatten._duration_micro: round(secs * 1e6) — Python round() is
// round-half-to-even, which nearbyint reproduces in the default FP mode.
bool duration_micro(std::string_view s, int64_t* out) {
    double secs;
    if (!parse_duration_secs(s, &secs)) return false;
    double m = std::nearbyint(secs * 1e6);
    if (std::fabs(m) > double(NUM_MAX)) return false;
    *out = int64_t(m);
    return true;
}

// Python float() acceptance (num_plain flag for string leaves). Mirrors
// CPython's float_from_string: optional ws, sign, inf/infinity/nan, or
// decimal with single underscores *between* digits.
bool py_float_ok(std::string_view s) {
    auto is_ws = [](char c) {
        return c == ' ' || c == '\t' || c == '\n' || c == '\r' ||
               c == '\f' || c == '\v';
    };
    while (!s.empty() && is_ws(s.front())) s.remove_prefix(1);
    while (!s.empty() && is_ws(s.back())) s.remove_suffix(1);
    if (s.empty()) return false;
    size_t i = 0;
    if (s[i] == '+' || s[i] == '-') ++i;
    auto ci_is = [&](const char* word) {
        size_t n = strlen(word);
        if (s.size() - i != n) return false;
        for (size_t k = 0; k < n; ++k)
            if (tolower(s[i + k]) != word[k]) return false;
        return true;
    };
    if (ci_is("inf") || ci_is("infinity") || ci_is("nan")) return true;
    // digit run with single underscores between digits
    auto digits = [&](bool* any) {
        *any = false;
        bool prev_digit = false;
        while (i < s.size()) {
            char c = s[i];
            if (c >= '0' && c <= '9') { prev_digit = true; *any = true; ++i; }
            else if (c == '_') {
                if (!prev_digit || i + 1 >= s.size() ||
                    s[i + 1] < '0' || s[i + 1] > '9') return false;
                prev_digit = false;
                ++i;
            } else break;
        }
        return true;
    };
    bool int_any = false, frac_any = false;
    if (!digits(&int_any)) return false;
    if (i < s.size() && s[i] == '.') {
        ++i;
        if (!digits(&frac_any)) return false;
    }
    if (!int_any && !frac_any) return false;
    if (i < s.size() && (s[i] == 'e' || s[i] == 'E')) {
        ++i;
        if (i < s.size() && (s[i] == '+' || s[i] == '-')) ++i;
        bool exp_any = false;
        if (!digits(&exp_any) || !exp_any) return false;
    }
    return i == s.size();
}

// The Python tier parses strings with unicode-aware rules (str.strip()
// whitespace, regex \d, float()) while this library parses ASCII. The two
// can only disagree when the string contains a unicode whitespace or a
// non-ASCII decimal digit (ASCII success implies the string is pure ASCII)
// — or the \x1c-\x1f controls Python's str.isspace() accepts. Such leaves
// route the resource to the host lane, where the Python flattener is
// authoritative.
struct CpRange { uint32_t lo, hi; };
constexpr CpRange UNI_WS_OR_DIGIT[] = {
    {0x85,0x85},{0xA0,0xA0},{0x660,0x669},{0x6F0,0x6F9},{0x7C0,0x7C9},
    {0x966,0x96F},{0x9E6,0x9EF},{0xA66,0xA6F},{0xAE6,0xAEF},{0xB66,0xB6F},
    {0xBE6,0xBEF},{0xC66,0xC6F},{0xCE6,0xCEF},{0xD66,0xD6F},{0xDE6,0xDEF},
    {0xE50,0xE59},{0xED0,0xED9},{0xF20,0xF29},{0x1040,0x1049},
    {0x1090,0x1099},{0x1680,0x1680},{0x17E0,0x17E9},{0x1810,0x1819},
    {0x1946,0x194F},{0x19D0,0x19D9},{0x1A80,0x1A89},{0x1A90,0x1A99},
    {0x1B50,0x1B59},{0x1BB0,0x1BB9},{0x1C40,0x1C49},{0x1C50,0x1C59},
    {0x2000,0x200A},{0x2028,0x2029},{0x202F,0x202F},{0x205F,0x205F},
    {0x3000,0x3000},{0xA620,0xA629},{0xA8D0,0xA8D9},{0xA900,0xA909},
    {0xA9D0,0xA9D9},{0xA9F0,0xA9F9},{0xAA50,0xAA59},{0xABF0,0xABF9},
    {0xFF10,0xFF19},{0x104A0,0x104A9},{0x10D30,0x10D39},{0x11066,0x1106F},
    {0x110F0,0x110F9},{0x11136,0x1113F},{0x111D0,0x111D9},
    {0x112F0,0x112F9},{0x11450,0x11459},{0x114D0,0x114D9},
    {0x11650,0x11659},{0x116C0,0x116C9},{0x11730,0x11739},
    {0x118E0,0x118E9},{0x11950,0x11959},{0x11C50,0x11C59},
    {0x11D50,0x11D59},{0x11DA0,0x11DA9},{0x11F50,0x11F59},
    {0x16A60,0x16A69},{0x16AC0,0x16AC9},{0x16B50,0x16B59},
    {0x1D7CE,0x1D7FF},{0x1E140,0x1E149},{0x1E2F0,0x1E2F9},
    {0x1E4F0,0x1E4F9},{0x1E950,0x1E959},{0x1FBF0,0x1FBF9},
};

bool needs_python_parse(const std::string& s) {
    for (size_t i = 0; i < s.size();) {
        unsigned char c = s[i];
        if (c < 0x80) {
            if (c >= 0x1c && c <= 0x1f) return true;
            ++i;
            continue;
        }
        // decode one UTF-8 codepoint (already validated by the JSON layer)
        uint32_t cp;
        size_t n;
        if ((c & 0xE0) == 0xC0) { cp = c & 0x1F; n = 2; }
        else if ((c & 0xF0) == 0xE0) { cp = c & 0x0F; n = 3; }
        else if ((c & 0xF8) == 0xF0) { cp = c & 0x07; n = 4; }
        else { ++i; continue; }
        if (i + n > s.size()) return true;  // malformed: be conservative
        for (size_t k = 1; k < n; ++k) cp = (cp << 6) | (s[i + k] & 0x3F);
        i += n;
        for (const auto& r : UNI_WS_OR_DIGIT)
            if (cp >= r.lo && cp <= r.hi) return true;
    }
    return false;
}

// Python int(s, 10) acceptance (num_int lane for string leaves):
// whitespace strip, optional sign, digit runs with single underscores
// strictly between digits.
bool py_int_ok(std::string_view s) {
    auto is_ws = [](char c) {
        return c == ' ' || c == '\t' || c == '\n' || c == '\r' ||
               c == '\f' || c == '\v';
    };
    while (!s.empty() && is_ws(s.front())) s.remove_prefix(1);
    while (!s.empty() && is_ws(s.back())) s.remove_suffix(1);
    if (s.empty()) return false;
    size_t i = 0;
    if (s[i] == '+' || s[i] == '-') ++i;
    bool any = false;
    bool prev_digit = false;
    while (i < s.size()) {
        char c = s[i];
        if (c >= '0' && c <= '9') { any = true; prev_digit = true; ++i; }
        else if (c == '_') {
            if (!prev_digit || i + 1 >= s.size() ||
                s[i + 1] < '0' || s[i + 1] > '9') return false;
            prev_digit = false;
            ++i;
        } else return false;
    }
    return any;
}

// ------------------------------------------------------------------ ctx

struct Ctx {
    std::vector<std::vector<std::string>> paths;   // split segments
    std::unordered_map<std::string, int32_t> kinds;
    std::string req_mark, nseff_mark;
    int str_len_cap = 64;
};

struct Interner {
    std::unordered_map<std::string, int32_t> index;
    std::vector<std::string> strings;

    int32_t intern(const std::string& s) {
        auto it = index.find(s);
        if (it != index.end()) return it->second;
        int32_t id = int32_t(strings.size());
        index.emplace(s, id);
        strings.push_back(s);
        return id;
    }
};

struct Slot {
    uint16_t mask;
    int32_t elem0;
    const Value* leaf;      // non-null only when leaf_present
    bool leaf_present;      // distinguishes JSON null leaf from phantom
    bool null_break;        // chain broke at an existing non-map node
};

// _enumerate_slots walk(): identical traversal and bit layout.
void walk_slots(const Value* node, const std::vector<std::string>& segs,
                size_t i, size_t offset, uint16_t mask, int32_t elem0,
                std::vector<Slot>& out, int cap) {
    if (int(out.size()) > cap) return;
    if (i == segs.size()) {
        out.push_back({mask, elem0, node, true, false});
        return;
    }
    const std::string& seg = segs[i];
    uint16_t bit = uint16_t(1u << (i + 1 + offset));
    if (seg == "*") {
        if (node == nullptr || node->t != Value::Arr) {
            // list pattern over an existing non-list node: structural break
            out.push_back({mask, elem0, nullptr, false, true});
            return;
        }
        int32_t idx = 0;
        for (const Value* el : node->arr) {
            walk_slots(el, segs, i + 1, offset, uint16_t(mask | bit),
                       elem0 < 0 ? idx : elem0, out, cap);
            ++idx;
        }
    } else {
        if (node == nullptr || node->t != Value::Obj) {
            out.push_back({mask, elem0, nullptr, false, true});
            return;
        }
        const Value* child = obj_get(node, seg);
        if (child == nullptr) {
            out.push_back({mask, elem0, nullptr, false, false});
            return;
        }
        walk_slots(child, segs, i + 1, offset, uint16_t(mask | bit), elem0, out, cap);
    }
}

}  // namespace

extern "C" {

// paths: '\n'-joined SEP-separated generalized paths
// kinds: '\n'-joined kind names (index == id, matching tensors.kind_index)
// req_mark / nseff_mark: the ir.REQ_MARK / ir.NSEFF_MARK sentinel segments
void* ktpu_create(const char* paths, const char* kinds, int str_len_cap,
                  const char* req_mark, const char* nseff_mark) {
    auto* ctx = new Ctx;
    ctx->str_len_cap = str_len_cap;
    ctx->req_mark = req_mark ? req_mark : "";
    ctx->nseff_mark = nseff_mark ? nseff_mark : "";
    std::string_view pv(paths ? paths : "");
    size_t start = 0;
    while (start <= pv.size() && !pv.empty()) {
        size_t nl = pv.find('\n', start);
        std::string_view line = pv.substr(
            start, nl == std::string_view::npos ? pv.size() - start : nl - start);
        if (!line.empty()) {
            std::vector<std::string> segs;
            size_t s0 = 0;
            while (true) {
                size_t sp = line.find(SEP, s0);
                if (sp == std::string_view::npos) {
                    segs.emplace_back(line.substr(s0));
                    break;
                }
                segs.emplace_back(line.substr(s0, sp - s0));
                s0 = sp + 1;
            }
            ctx->paths.push_back(std::move(segs));
        }
        if (nl == std::string_view::npos) break;
        start = nl + 1;
    }
    std::string_view kv(kinds ? kinds : "");
    start = 0;
    int32_t kid = 0;
    while (start <= kv.size() && !kv.empty()) {
        size_t nl = kv.find('\n', start);
        std::string_view line = kv.substr(
            start, nl == std::string_view::npos ? kv.size() - start : nl - start);
        if (!line.empty()) ctx->kinds.emplace(std::string(line), kid++);
        if (nl == std::string_view::npos) break;
        start = nl + 1;
    }
    return ctx;
}

void ktpu_destroy(void* handle) { delete static_cast<Ctx*>(handle); }

// Streams the next element out of a top-level JSON array: consumes '[' on
// the first call, then one value and its ',' / ']' delimiter per call.
// Keeps memory flat: one document's tree lives in the arena at a time.
struct ArrayStream {
    Parser parser;
    bool started = false;
    bool done = false;

    Value* next() {
        parser.skip_ws();
        if (!started) {
            if (parser.p >= parser.end || *parser.p != '[') {
                parser.ok = false;
                return nullptr;
            }
            ++parser.p;
            started = true;
            parser.skip_ws();
            if (parser.p < parser.end && *parser.p == ']') {
                ++parser.p;
                done = true;
                return nullptr;
            }
        }
        if (done) return nullptr;
        Value* v = parser.parse();
        if (!parser.ok) return nullptr;
        parser.skip_ws();
        if (parser.p < parser.end && *parser.p == ',') ++parser.p;
        else if (parser.p < parser.end && *parser.p == ']') done = true;
        else parser.ok = false;
        return parser.ok ? v : nullptr;
    }
};

// Flatten a batch. ``docs`` is a JSON *array* of resource documents
// (one json.dumps of the whole batch); ``reqs`` optionally a same-length
// JSON array of admission envelopes (or NULL). [B,P,e_cap] arrays are laid
// out row-major; slot lists are truncated to max_slots (host_flag beyond
// that, as in flatten.py). Returns e_used (>=1, <= e_cap), or
//  -1  string dictionary exceeded str_cap (*n_strings = size needed)
//  -2  top-level parse failure
//  -3  array length != n_docs
//  -4  a slot list exceeded e_cap (*e_needed = stride to retry with)
int ktpu_flatten_batch(
    void* handle,
    const char* docs, int64_t docs_len,
    const char* reqs, int64_t reqs_len,
    int n_docs, int max_slots, int e_cap, int32_t* e_needed,
    uint16_t* mask, uint8_t* slot_valid, uint8_t* null_break,
    int8_t* type_tag, int32_t* str_id,
    int64_t* num_val, uint8_t* num_ok, uint8_t* num_plain, uint8_t* num_int,
    int64_t* dur_val, uint8_t* dur_ok, uint8_t* dur_any,
    uint8_t* bool_val, int32_t* elem0,
    int32_t* kind_id, uint8_t* host_flag,
    uint8_t* str_bytes, int32_t* str_lens, uint8_t* str_glob,
    int32_t* n_strings, int str_cap) {

    Ctx* ctx = static_cast<Ctx*>(handle);
    const int P = int(ctx->paths.size());
    const int E = e_cap;
    const int L = ctx->str_len_cap;

    Arena arena;
    ArrayStream doc_stream{Parser{docs, docs + docs_len, &arena}};
    ArrayStream req_stream{Parser{reqs, reqs + (reqs ? reqs_len : 0), &arena}};

    Interner interner;
    int e_used = 1;
    std::vector<Slot> slots;
    Value nseff_leaf;          // synthetic Str node for NSEFF slots
    nseff_leaf.t = Value::Str;

    for (int b = 0; b < n_docs; ++b) {
        arena.reset();         // previous document's tree: memory stays flat
        const Value* root = doc_stream.next();
        if (!doc_stream.parser.ok) return -2;
        if (root == nullptr) return -3;  // array shorter than n_docs
        const Value* env = nullptr;
        if (reqs != nullptr) {
            env = req_stream.next();
            if (!req_stream.parser.ok) return -2;
            if (env == nullptr) return -3;
        }
        const bool env_nonempty =
            env != nullptr && env->t == Value::Obj && !env->obj.empty();

        // kind id + effective namespace (flatten.py _effective_namespace)
        kind_id[b] = -1;
        std::string ns_eff;
        if (root != nullptr && root->t == Value::Obj) {
            const Value* kind_v = obj_get(root, "kind");
            std::string kind = kind_v && kind_v->t == Value::Str ? kind_v->str : "";
            auto it = ctx->kinds.find(kind);
            if (it != ctx->kinds.end()) kind_id[b] = it->second;
            const Value* meta = obj_get(root, "metadata");
            const Value* nv = obj_get(
                meta, kind == "Namespace" ? "name" : "namespace");
            if (nv != nullptr && nv->t == Value::Str) ns_eff = nv->str;
        }

        for (int p = 0; p < P; ++p) {
            slots.clear();
            const auto& segs = ctx->paths[p];
            if (!segs.empty() && segs[0] == ctx->nseff_mark) {
                nseff_leaf.str = ns_eff;
                slots.push_back({0b11, -1, &nseff_leaf, true, false});
            } else if (!segs.empty() && segs[0] == ctx->req_mark) {
                uint16_t base_mask = env_nonempty ? 0b11 : 0b1;
                if (segs.size() == 1 || !env_nonempty) {
                    slots.push_back({base_mask, -1, nullptr, false, false});
                } else {
                    // start at segment 1 with offset 0: bit = 1 << (i + 1)
                    // equals the Python rest-walk's 1 << (j + 1 + offset)
                    walk_slots(env, segs, 1, 0, base_mask, -1, slots, max_slots);
                }
            } else if (root == nullptr || root->t == Value::Null) {
                // flatten.py: `if root is None` -> single phantom slot
                slots.push_back({0b1, -1, nullptr, false, false});
            } else {
                walk_slots(root, segs, 0, 0, 0b1, -1, slots, max_slots);
            }

            if (int(slots.size()) > max_slots) {
                host_flag[b] = 1;
                slots.resize(size_t(max_slots));
            }
            if (int(slots.size()) > E) {
                *e_needed = int(slots.size());
                return -4;     // caller re-allocates with a larger stride
            }
            if (int(slots.size()) > e_used) e_used = int(slots.size());

            for (int e = 0; e < int(slots.size()); ++e) {
                const size_t o = (size_t(b) * P + p) * E + size_t(e);
                const Slot& slot = slots[size_t(e)];
                mask[o] = slot.mask;
                slot_valid[o] = 1;
                null_break[o] = slot.null_break ? 1 : 0;
                elem0[o] = slot.elem0;
                if (!slot.leaf_present) continue;  // phantom: T_ABSENT default
                const Value* v = slot.leaf;
                switch (v->t) {
                    case Value::Null:
                        type_tag[o] = T_NULL;
                        break;
                    case Value::Bool: {
                        type_tag[o] = T_BOOL;
                        bool_val[o] = v->b ? 1 : 0;
                        str_id[o] = interner.intern(v->b ? "true" : "false");
                        break;
                    }
                    case Value::Num: {
                        type_tag[o] = T_NUM;
                        const bool is_int = num_token_is_int(v->raw);
                        num_int[o] = is_int ? 1 : 0;
                        std::string text;
                        if (is_int) {
                            text = std::string(v->raw);
                            if (!text.empty() && text[0] == '+') text.erase(0, 1);
                        } else {
                            double fv = parse_double_tok(std::string(v->raw));
                            text = format_float_sci(fv);
                        }
                        if (int(text.size()) <= L) str_id[o] = interner.intern(text);
                        int64_t micro;
                        if (quantity_to_micro(v->raw, &micro)) {
                            num_val[o] = micro;
                            num_ok[o] = 1;
                            num_plain[o] = 1;
                        } else {
                            host_flag[b] = 1;
                        }
                        break;
                    }
                    case Value::Str: {
                        type_tag[o] = T_STR;
                        if (int(v->str.size()) <= L) str_id[o] = interner.intern(v->str);
                        else host_flag[b] = 1;
                        if (needs_python_parse(v->str)) {
                            // unicode-sensitive parse: empty numeric lanes,
                            // oracle evaluates this resource (host lane)
                            host_flag[b] = 1;
                            break;
                        }
                        int64_t micro;
                        bool capped = false;
                        const bool q_ok =
                            quantity_to_micro(v->str, &micro, &capped);
                        if (!q_ok && capped) {
                            // >36-digit number part: exact range exceeded
                            host_flag[b] = 1;
                            break;
                        }
                        num_int[o] = py_int_ok(v->str) ? 1 : 0;
                        if (q_ok) {
                            num_val[o] = micro;
                            num_ok[o] = 1;
                            if (py_float_ok(v->str)) num_plain[o] = 1;
                        }
                        int64_t dmicro;
                        if (duration_micro(v->str, &dmicro)) {
                            dur_val[o] = dmicro;
                            dur_any[o] = 1;
                            dur_ok[o] = v->str != "0" ? 1 : 0;
                        }
                        break;
                    }
                    case Value::Obj:
                        type_tag[o] = T_OBJ;
                        break;
                    case Value::Arr:
                        type_tag[o] = T_LIST;
                        break;
                }
            }
        }
    }

    if (!doc_stream.done) {
        // n_docs == 0 with "[]" still pending, or extra elements: check
        if (doc_stream.next() != nullptr || !doc_stream.done) return -3;
        if (!doc_stream.parser.ok) return -2;
    }

    const int V = int(interner.strings.size());
    *n_strings = V;  // on overflow: tells the caller the exact size to retry
    if (V > str_cap) return -1;
    for (int v = 0; v < V; ++v) {
        const std::string& s = interner.strings[size_t(v)];
        int len = int(s.size()) < L ? int(s.size()) : L;
        memcpy(str_bytes + size_t(v) * size_t(L), s.data(), size_t(len));
        str_lens[v] = len;
        str_glob[v] =
            s.find('*') != std::string::npos || s.find('?') != std::string::npos
                ? 1 : 0;
    }
    return e_used;
}

}  // extern "C"

// ------------------------------------------------- packed transfer format

namespace {

// Per-unique-string dictionary row (models/flatten.py pack_batch layout):
//   d0: num_lo(31) | num_ok<<31        d1: num_hi (two's complement)
//   d2: dur_lo(31) | dur_ok<<31        d3: dur_hi (two's complement)
//   d4: str_len(7) | has_glob<<7 | bool_val<<8 | dur_any<<9 | num_plain<<10
// plus flattener-internal bits (never emitted): host (string routes the
// resource to the CPU oracle) and pyint (int(s, 10)-parseable — the
// num_int *cell* bit for T_STR leaves).
struct DictRow {
    uint32_t d[5] = {0, 0, 0, 0, 0};
    bool host = false;
    bool pyint = false;
};

DictRow analyze_string(const std::string& s, int L) {
    DictRow r;
    uint32_t ln = uint32_t(int(s.size()) < L ? int(s.size()) : L);
    bool glob = s.find('*') != std::string::npos ||
                s.find('?') != std::string::npos;
    r.d[4] = ln | (uint32_t(glob) << 7) | (uint32_t(s == "true") << 8);
    // mirror the T_STR leaf branch order exactly: a host-parse or
    // digit-capped string leaves every value lane empty (incl. num_int)
    if (needs_python_parse(s)) { r.host = true; return r; }
    int64_t micro;
    bool capped = false;
    const bool q_ok = quantity_to_micro(s, &micro, &capped);
    if (!q_ok && capped) { r.host = true; return r; }
    r.pyint = py_int_ok(s);
    if (q_ok) {
        r.d[0] = uint32_t(micro & 0x7FFFFFFF) | (uint32_t(1) << 31);
        r.d[1] = uint32_t(uint64_t(micro >> 31) & 0xFFFFFFFFu);
        if (py_float_ok(s)) r.d[4] |= uint32_t(1) << 10;
    }
    int64_t dmicro;
    if (duration_micro(s, &dmicro)) {
        r.d[2] = uint32_t(dmicro & 0x7FFFFFFF) |
                 (uint32_t(s != "0") << 31);
        r.d[3] = uint32_t(uint64_t(dmicro >> 31) & 0xFFFFFFFFu);
        r.d[4] |= uint32_t(1) << 9;
    }
    return r;
}

// Interner that analyzes each unique string once — the per-leaf value
// parsing (quantity/duration/int/float) that dominated the unpacked
// flattener's leaf loop amortizes across every repeated occurrence.
struct PackedInterner {
    std::unordered_map<std::string, int32_t> index;
    std::vector<std::string> strings;
    std::vector<DictRow> rows;
    int L;

    explicit PackedInterner(int cap) : L(cap) {}

    int32_t intern(const std::string& s) {
        auto it = index.find(s);
        if (it != index.end()) return it->second;
        int32_t id = int32_t(strings.size());
        index.emplace(s, id);
        strings.push_back(s);
        rows.push_back(analyze_string(s, L));
        return id;
    }
};

constexpr uint32_t ELEM0_CAP = 254;  // mirrors flatten.ELEM0_CAP

// Per-document packed flatten: one instance per (sequential run | thread
// shard), writing cells/bmeta rows for the documents it is handed and
// interning into its own dictionary. Shared by the JSON-stream, threaded,
// and PyObject entry points so the cell semantics exist exactly once.
struct PackedCore {
    Ctx* ctx;
    int P, E, L, max_slots;
    uint32_t* cells;        // global [n_docs, P, E, 2] base pointer
    uint32_t* bmeta;        // global [n_docs]
    PackedInterner interner;
    int e_used = 1;
    std::vector<Slot> slots;
    Value nseff_leaf;

    PackedCore(Ctx* c, int e_cap, int max_slots_,
               uint32_t* cells_, uint32_t* bmeta_)
        : ctx(c), P(int(c->paths.size())), E(e_cap), L(c->str_len_cap),
          max_slots(max_slots_), cells(cells_), bmeta(bmeta_),
          interner(c->str_len_cap) {
        nseff_leaf.t = Value::Str;
    }

    // 0 ok; -4 slot list exceeded the stride (*e_needed = required)
    int doc(const Value* root, const Value* env, int b, int32_t* e_needed) {
        const bool env_nonempty =
            env != nullptr && env->t == Value::Obj && !env->obj.empty();

        int32_t kid = -1;
        bool host = false;
        std::string ns_eff;
        if (root != nullptr && root->t == Value::Obj) {
            const Value* kind_v = obj_get(root, "kind");
            std::string kind = kind_v && kind_v->t == Value::Str ? kind_v->str : "";
            auto it = ctx->kinds.find(kind);
            if (it != ctx->kinds.end()) kid = it->second;
            const Value* meta = obj_get(root, "metadata");
            const Value* nv = obj_get(
                meta, kind == "Namespace" ? "name" : "namespace");
            if (nv != nullptr && nv->t == Value::Str) ns_eff = nv->str;
        }

        for (int p = 0; p < P; ++p) {
            slots.clear();
            const auto& segs = ctx->paths[p];
            if (!segs.empty() && segs[0] == ctx->nseff_mark) {
                nseff_leaf.str = ns_eff;
                slots.push_back({0b11, -1, &nseff_leaf, true, false});
            } else if (!segs.empty() && segs[0] == ctx->req_mark) {
                uint16_t base_mask = env_nonempty ? 0b11 : 0b1;
                if (segs.size() == 1 || !env_nonempty) {
                    slots.push_back({base_mask, -1, nullptr, false, false});
                } else {
                    walk_slots(env, segs, 1, 0, base_mask, -1, slots, max_slots);
                }
            } else if (root == nullptr || root->t == Value::Null) {
                slots.push_back({0b1, -1, nullptr, false, false});
            } else {
                walk_slots(root, segs, 0, 0, 0b1, -1, slots, max_slots);
            }

            if (int(slots.size()) > max_slots) {
                host = true;
                slots.resize(size_t(max_slots));
            }
            if (int(slots.size()) > E) {
                *e_needed = int(slots.size());
                return -4;
            }
            if (int(slots.size()) > e_used) e_used = int(slots.size());

            uint32_t* row = cells + (size_t(b) * P + p) * size_t(E) * 2;
            for (int e = 0; e < int(slots.size()); ++e) {
                const Slot& slot = slots[size_t(e)];
                uint32_t e0w;
                if (slot.elem0 < 0) {
                    e0w = 0;
                } else if (uint32_t(slot.elem0) >= ELEM0_CAP) {
                    e0w = 255;
                    host = true;
                } else {
                    e0w = uint32_t(slot.elem0) + 1;
                }
                uint32_t tag = T_ABSENT;
                int32_t sid = -1;
                uint32_t numint = 0;
                if (slot.leaf_present) {
                    const Value* v = slot.leaf;
                    switch (v->t) {
                        case Value::Null:
                            tag = T_NULL;
                            break;
                        case Value::Bool:
                            tag = T_BOOL;
                            sid = interner.intern(v->b ? "true" : "false");
                            break;
                        case Value::Num: {
                            tag = T_NUM;
                            numint = num_token_is_int(v->raw) ? 1 : 0;
                            std::string text;
                            if (numint) {
                                text = std::string(v->raw);
                                if (!text.empty() && text[0] == '+')
                                    text.erase(0, 1);
                            } else {
                                double fv =
                                    parse_double_tok(std::string(v->raw));
                                text = format_float_sci(fv);
                            }
                            if (int(text.size()) <= L) {
                                sid = interner.intern(text);
                            } else {
                                // the packed value lanes live on the
                                // dictionary row; without one the number
                                // is unrepresentable -> CPU oracle
                                host = true;
                            }
                            int64_t micro;
                            if (!quantity_to_micro(v->raw, &micro))
                                host = true;
                            break;
                        }
                        case Value::Str: {
                            tag = T_STR;
                            if (int(v->str.size()) <= L) {
                                sid = interner.intern(v->str);
                                const DictRow& r = interner.rows[size_t(sid)];
                                host |= r.host;
                                numint = r.pyint ? 1 : 0;
                            } else {
                                host = true;
                            }
                            break;
                        }
                        case Value::Obj:
                            tag = T_OBJ;
                            break;
                        case Value::Arr:
                            tag = T_LIST;
                            break;
                    }
                }
                row[size_t(e) * 2] = uint32_t(sid + 1);
                row[size_t(e) * 2 + 1] =
                    uint32_t(slot.mask)
                    | (tag << 16)
                    | (uint32_t(1) << 19)                     // slot_valid
                    | (uint32_t(slot.null_break ? 1 : 0) << 20)
                    | (numint << 21)
                    | (e0w << 22);
            }
        }
        bmeta[b] = uint32_t(kid + 1)
                   | (uint32_t(host ? 1 : 0) << 16)
                   | (uint32_t(1) << 17);                     // live
        return 0;
    }
};

// Emit the interner's dictionary into the output arrays; -1 on overflow.
int emit_dict(const PackedInterner& interner, uint32_t* dictv,
              uint8_t* str_bytes, int32_t* n_strings, int str_cap, int L) {
    const int V = int(interner.strings.size());
    *n_strings = V;
    if (V > str_cap) return -1;
    for (int v = 0; v < V; ++v) {
        const std::string& s = interner.strings[size_t(v)];
        int len = int(s.size()) < L ? int(s.size()) : L;
        memcpy(str_bytes + size_t(v) * size_t(L), s.data(), size_t(len));
        memcpy(dictv + size_t(v) * 5, interner.rows[size_t(v)].d,
               5 * sizeof(uint32_t));
    }
    return 0;
}

// Byte ranges of the elements of a top-level JSON array (no validation of
// the element bodies — the per-shard Parser does that). False: malformed
// at the array level.
bool scan_array_elements(
    const char* p, const char* end,
    std::vector<std::pair<const char*, const char*>>& out) {
    auto ws = [](char c) {
        return c == ' ' || c == '\t' || c == '\n' || c == '\r';
    };
    while (p < end && ws(*p)) ++p;
    if (p >= end || *p != '[') return false;
    ++p;
    while (true) {
        while (p < end && ws(*p)) ++p;
        if (p >= end) return false;
        if (*p == ']') return true;
        const char* start = p;
        int depth = 0;
        bool in_str = false;
        while (p < end) {
            char c = *p;
            if (in_str) {
                if (c == '\\') { p += 2; continue; }
                if (c == '"') in_str = false;
                ++p;
            } else if (c == '"') { in_str = true; ++p; }
            else if (c == '{' || c == '[') { ++depth; ++p; }
            else if (c == '}' || c == ']') {
                if (depth == 0) break;       // the array's own ']'
                --depth; ++p;
            } else if (c == ',' && depth == 0) break;
            else ++p;
        }
        if (p > end) return false;
        out.emplace_back(start, p);
        while (p < end && ws(*p)) ++p;
        if (p >= end) return false;
        if (*p == ',') { ++p; continue; }
        if (*p == ']') return true;
        return false;
    }
}

int flatten_threads() {
    const char* env = getenv("KTPU_FLATTEN_THREADS");
    if (env != nullptr && *env != '\0') {
        int n = atoi(env);
        if (n >= 1) return n < 64 ? n : 64;
    }
    unsigned hw = std::thread::hardware_concurrency();
    int n = hw == 0 ? 1 : int(hw);
    return n < 8 ? n : 8;
}

// Threaded packed flatten over pre-scanned element ranges. Byte-parity
// with the sequential path: each shard interns locally in document order,
// and the shard-order first-wins merge reproduces the sequential
// first-appearance interning order exactly (all strings first seen in
// shard k precede — in the same relative order — those first seen in
// shard k+1, because shard k's documents do).
int packed_parallel(
    Ctx* ctx,
    const std::vector<std::pair<const char*, const char*>>& doc_spans,
    const std::vector<std::pair<const char*, const char*>>& req_spans,
    bool have_reqs, int n_docs, int max_slots, int e_cap, int32_t* e_needed,
    uint32_t* cells, uint32_t* bmeta, uint32_t* dictv, uint8_t* str_bytes,
    int32_t* n_strings, int str_cap, int T) {

    const int P = int(ctx->paths.size());
    const int L = ctx->str_len_cap;
    std::vector<std::unique_ptr<PackedCore>> cores;
    cores.resize(size_t(T));
    std::vector<int> shard_lo, shard_hi;
    shard_lo.resize(size_t(T));
    shard_hi.resize(size_t(T));
    std::atomic<int> err{0};
    std::atomic<int> need{0};
    const int per = (n_docs + T - 1) / T;

    auto shard_run = [&](int t) {
        const int lo = t * per;
        const int hi = lo + per < n_docs ? lo + per : n_docs;
        shard_lo[size_t(t)] = lo;
        shard_hi[size_t(t)] = hi;
        auto core = std::make_unique<PackedCore>(
            ctx, e_cap, max_slots, cells, bmeta);
        Arena arena;
        for (int b = lo; b < hi && err.load(std::memory_order_relaxed) == 0;
             ++b) {
            arena.reset();
            Parser dp{doc_spans[size_t(b)].first,
                      doc_spans[size_t(b)].second, &arena};
            const Value* root = dp.parse();
            if (!dp.ok) { err.store(-2); break; }
            const Value* env = nullptr;
            if (have_reqs) {
                Parser rp{req_spans[size_t(b)].first,
                          req_spans[size_t(b)].second, &arena};
                env = rp.parse();
                if (!rp.ok) { err.store(-2); break; }
            }
            int32_t en = 0;
            int rc = core->doc(root, env, b, &en);
            if (rc == -4) {
                int cur = need.load();
                while (en > cur && !need.compare_exchange_weak(cur, en)) {}
                err.store(-4);
                break;
            }
        }
        cores[size_t(t)] = std::move(core);
    };

    std::vector<std::thread> threads;
    threads.reserve(size_t(T - 1));
    for (int t = 1; t < T; ++t) threads.emplace_back(shard_run, t);
    shard_run(0);
    for (auto& th : threads) th.join();

    if (err.load() != 0) {
        if (err.load() == -4) *e_needed = need.load();
        return err.load();
    }

    // order-preserving first-wins merge of the shard dictionaries
    PackedInterner global(L);
    std::vector<std::vector<int32_t>> remap;
    remap.resize(size_t(T));
    int e_used = 1;
    for (int t = 0; t < T; ++t) {
        PackedInterner& loc = cores[size_t(t)]->interner;
        if (cores[size_t(t)]->e_used > e_used) e_used = cores[size_t(t)]->e_used;
        auto& rm = remap[size_t(t)];
        rm.resize(loc.strings.size());
        for (size_t i = 0; i < loc.strings.size(); ++i) {
            const std::string& s = loc.strings[i];
            auto it = global.index.find(s);
            int32_t gid;
            if (it == global.index.end()) {
                gid = int32_t(global.strings.size());
                global.index.emplace(s, gid);
                global.strings.push_back(s);
                // the row is a pure function of the string: carry it over
                global.rows.push_back(loc.rows[i]);
            } else {
                gid = it->second;
            }
            rm[i] = gid;
        }
    }

    // remap cell word0 (local sid + 1 -> global sid + 1), in parallel
    auto remap_run = [&](int t) {
        const auto& rm = remap[size_t(t)];
        const size_t row_words = size_t(P) * size_t(e_cap) * 2;
        for (int b = shard_lo[size_t(t)]; b < shard_hi[size_t(t)]; ++b) {
            uint32_t* row = cells + size_t(b) * row_words;
            for (size_t i = 0; i < row_words; i += 2) {
                uint32_t w0 = row[i];
                if (w0 != 0) row[i] = uint32_t(rm[size_t(w0 - 1)]) + 1;
            }
        }
    };
    threads.clear();
    for (int t = 1; t < T; ++t) threads.emplace_back(remap_run, t);
    remap_run(0);
    for (auto& th : threads) th.join();

    int rc = emit_dict(global, dictv, str_bytes, n_strings, str_cap, L);
    return rc < 0 ? rc : e_used;
}

}  // namespace

extern "C" {

// Flatten a batch straight into the packed transfer form
// (flatten.PACKED_BATCH_ARRAYS): cells uint32 [B,P,e_cap,2], bmeta uint32
// [B], dictv uint32 [str_cap,5], str_bytes uint8 [str_cap,L]. Same input
// conventions and -1/-2/-3/-4 retry protocol as ktpu_flatten_batch.
// Differences from the unpacked form are exactly the packed-lane caps:
// a resource hosts when elem0 exceeds ELEM0_CAP or a numeric/duration
// value lives on a string too long to intern (the cell lanes that carried
// such values are gone; the CPU oracle re-walks the document instead).
// Batches large enough to amortize a thread fan-out shard across
// std::thread workers (KTPU_FLATTEN_THREADS overrides the count; the
// result is byte-identical to the sequential path).
int ktpu_flatten_packed(
    void* handle,
    const char* docs, int64_t docs_len,
    const char* reqs, int64_t reqs_len,
    int n_docs, int max_slots, int e_cap, int32_t* e_needed,
    uint32_t* cells, uint32_t* bmeta, uint32_t* dictv,
    uint8_t* str_bytes,
    int32_t* n_strings, int str_cap) {

    Ctx* ctx = static_cast<Ctx*>(handle);
    const int L = ctx->str_len_cap;

    const int T = flatten_threads();
    if (T > 1 && n_docs >= 2 * T && n_docs >= 64) {
        std::vector<std::pair<const char*, const char*>> doc_spans;
        doc_spans.reserve(size_t(n_docs));
        if (scan_array_elements(docs, docs + docs_len, doc_spans) &&
            int(doc_spans.size()) == n_docs) {
            std::vector<std::pair<const char*, const char*>> req_spans;
            bool reqs_ok = true;
            if (reqs != nullptr) {
                req_spans.reserve(size_t(n_docs));
                reqs_ok = scan_array_elements(
                              reqs, reqs + reqs_len, req_spans) &&
                          int(req_spans.size()) == n_docs;
            }
            if (reqs_ok) {
                int threads = T;
                if (n_docs / threads < 32) threads = n_docs / 32;
                if (threads < 2) threads = 2;
                return packed_parallel(
                    ctx, doc_spans, req_spans, reqs != nullptr, n_docs,
                    max_slots, e_cap, e_needed, cells, bmeta, dictv,
                    str_bytes, n_strings, str_cap, threads);
            }
        }
        // array-level scan failed: fall through to the sequential parser,
        // which reports the precise -2/-3
    }

    Arena arena;
    ArrayStream doc_stream{Parser{docs, docs + docs_len, &arena}};
    ArrayStream req_stream{Parser{reqs, reqs + (reqs ? reqs_len : 0), &arena}};

    PackedCore core(ctx, e_cap, max_slots, cells, bmeta);
    for (int b = 0; b < n_docs; ++b) {
        arena.reset();
        const Value* root = doc_stream.next();
        if (!doc_stream.parser.ok) return -2;
        if (root == nullptr) return -3;
        const Value* env = nullptr;
        if (reqs != nullptr) {
            env = req_stream.next();
            if (!req_stream.parser.ok) return -2;
            if (env == nullptr) return -3;
        }
        int rc = core.doc(root, env, b, e_needed);
        if (rc != 0) return rc;
    }

    if (!doc_stream.done) {
        if (doc_stream.next() != nullptr || !doc_stream.done) return -3;
        if (!doc_stream.parser.ok) return -2;
    }

    int rc = emit_dict(core.interner, dictv, str_bytes, n_strings,
                       str_cap, L);
    return rc < 0 ? rc : core.e_used;
}

}  // extern "C"

// ------------------------------------------------ PyObject direct walk

#ifndef KTPU_NO_PYTHON

namespace {

// Python object -> Value tree, matching what parsing json.dumps(obj)
// produces: dict insertion order, bool-before-int dispatch, repr() float
// tokens (shortest round-trip, '.0' forced), str(int) integer tokens.
// Unsupported types and non-finite floats fail the conversion (the JSON
// path fails on Infinity/NaN tokens the same way) — the caller falls
// back to the serialize-then-parse route.
Value* py_to_value(PyObject* o, Arena* arena, bool* ok) {
    Value* v = arena->alloc();
    if (o == Py_None) { v->t = Value::Null; return v; }
    if (o == Py_True || o == Py_False) {
        v->t = Value::Bool;
        v->b = o == Py_True;
        return v;
    }
    if (PyLong_Check(o)) {
        v->t = Value::Num;
        int ovf = 0;
        long long ll = PyLong_AsLongLongAndOverflow(o, &ovf);
        if (ovf == 0 && !(ll == -1 && PyErr_Occurred())) {
            char buf[24];
            auto res = std::to_chars(buf, buf + sizeof buf, ll);
            v->str.assign(buf, res.ptr);
        } else {
            PyErr_Clear();
            PyObject* s = PyObject_Str(o);     // arbitrary precision
            if (s == nullptr) { PyErr_Clear(); *ok = false; return v; }
            Py_ssize_t n = 0;
            const char* u = PyUnicode_AsUTF8AndSize(s, &n);
            if (u == nullptr) { PyErr_Clear(); Py_DECREF(s); *ok = false; return v; }
            v->str.assign(u, size_t(n));
            Py_DECREF(s);
        }
        v->raw = v->str;
        return v;
    }
    if (PyFloat_Check(o)) {
        double d = PyFloat_AS_DOUBLE(o);
        if (!std::isfinite(d)) { *ok = false; return v; }
        v->t = Value::Num;
        char* s = PyOS_double_to_string(d, 'r', 0, Py_DTSF_ADD_DOT_0, nullptr);
        if (s == nullptr) { PyErr_Clear(); *ok = false; return v; }
        v->str = s;
        PyMem_Free(s);
        v->raw = v->str;
        return v;
    }
    if (PyUnicode_Check(o)) {
        v->t = Value::Str;
        Py_ssize_t n = 0;
        const char* u = PyUnicode_AsUTF8AndSize(o, &n);
        if (u == nullptr) { PyErr_Clear(); *ok = false; return v; }
        v->str.assign(u, size_t(n));
        return v;
    }
    if (PyDict_Check(o)) {
        v->t = Value::Obj;
        PyObject* key;
        PyObject* val;
        Py_ssize_t pos = 0;
        while (PyDict_Next(o, &pos, &key, &val)) {
            if (!PyUnicode_Check(key)) { *ok = false; return v; }
            Py_ssize_t n = 0;
            const char* u = PyUnicode_AsUTF8AndSize(key, &n);
            if (u == nullptr) { PyErr_Clear(); *ok = false; return v; }
            Value* child = py_to_value(val, arena, ok);
            if (!*ok) return v;
            v->obj.emplace_back(std::string(u, size_t(n)), child);
        }
        return v;
    }
    if (PyList_Check(o)) {
        v->t = Value::Arr;
        Py_ssize_t n = PyList_GET_SIZE(o);
        v->arr.reserve(size_t(n));
        for (Py_ssize_t i = 0; i < n; ++i) {
            Value* child = py_to_value(PyList_GET_ITEM(o, i), arena, ok);
            if (!*ok) return v;
            v->arr.push_back(child);
        }
        return v;
    }
    if (PyTuple_Check(o)) {                    // json.dumps serializes as array
        v->t = Value::Arr;
        Py_ssize_t n = PyTuple_GET_SIZE(o);
        v->arr.reserve(size_t(n));
        for (Py_ssize_t i = 0; i < n; ++i) {
            Value* child = py_to_value(PyTuple_GET_ITEM(o, i), arena, ok);
            if (!*ok) return v;
            v->arr.push_back(child);
        }
        return v;
    }
    *ok = false;
    return v;
}

}  // namespace

extern "C" {

// Packed flatten straight from live Python lists of dicts — no
// json.dumps, no JSON parse. Loaded via ctypes.PyDLL (the GIL stays
// held; the walk touches refcounted objects throughout). Same output
// and -1/-4 retry protocol as ktpu_flatten_packed; -5 = an object the
// JSON model can't express (caller falls back to the dumps path).
int ktpu_flatten_packed_py(
    void* handle, PyObject* docs, PyObject* reqs,
    int n_docs, int max_slots, int e_cap, int32_t* e_needed,
    uint32_t* cells, uint32_t* bmeta, uint32_t* dictv,
    uint8_t* str_bytes,
    int32_t* n_strings, int str_cap) {

    Ctx* ctx = static_cast<Ctx*>(handle);
    if (!PyList_Check(docs) || PyList_GET_SIZE(docs) != n_docs) return -3;
    if (reqs != nullptr && reqs != Py_None &&
        (!PyList_Check(reqs) || PyList_GET_SIZE(reqs) != n_docs)) return -3;
    const bool have_reqs = reqs != nullptr && reqs != Py_None;

    Arena arena;
    PackedCore core(ctx, e_cap, max_slots, cells, bmeta);
    for (int b = 0; b < n_docs; ++b) {
        arena.reset();
        bool ok = true;
        const Value* root = py_to_value(PyList_GET_ITEM(docs, b), &arena, &ok);
        if (!ok) return -5;
        const Value* env = nullptr;
        if (have_reqs) {
            env = py_to_value(PyList_GET_ITEM(reqs, b), &arena, &ok);
            if (!ok) return -5;
        }
        int rc = core.doc(root, env, b, e_needed);
        if (rc != 0) return rc;
    }
    int rc = emit_dict(core.interner, dictv, str_bytes, n_strings,
                       str_cap, ctx->str_len_cap);
    return rc < 0 ? rc : core.e_used;
}

}  // extern "C"

#endif  // KTPU_NO_PYTHON
