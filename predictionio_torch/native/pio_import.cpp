// Native JSON-lines event import for predictionio_torch (an own copy of
// the reference's predictionio_tpu/native/pio_import.cpp: same semantics,
// same C ABI).
//
// `pio import` parity target is «tools/imprt/FileToEvents.scala» [U]; the
// Python path (tools/transfer.py) is parse-bound at ~33k events/s — at
// ML-20M scale that is ~10 minutes of pure Python before training can
// even be scheduled. This translation unit parses the JSON-lines file and
// inserts event rows straight into the SQLite store via the sqlite3 C API
// (same dlopen strategy as pio_scan.cpp), one transaction per chunk.
//
// FIDELITY CONTRACT — the fast path must produce exactly what the Python
// path (Event.from_dict → validate_event → SQLiteLEvents._row_of) would:
//   - validation rules: required fields, reserved $-events and pio_
//     prefixes, special-event constraints;
//   - properties/tags re-serialized like json.dumps(..., sort_keys=True):
//     sorted keys (code-point order), ensure_ascii \uXXXX escapes,
//     ", "/": " separators, Python float repr;
//   - timestamps normalized to fixed-width UTC ISO-8601 ("...Z");
//   - fresh 32-hex event ids (import never reuses file ids).
// Any line using a construct whose Python-identical rendering this parser
// cannot GUARANTEE (exotic float tokens, NaN/Infinity, non-string tags,
// unusual time formats, ...) is returned as a FALLBACK line — the Python
// wrapper re-processes just those lines through the slow path, so the
// fast path never has to be clever at the expense of being right.
//
// C ABI (two calls):
//   pio_import_file(json_path, db_path, app_id, channel_id /* -1=NULL */,
//                   &imported, &skipped, &fallback_lines, &n_fallback)
//       -> 0 ok / nonzero hard failure (caller falls back entirely)
//   pio_import_free_lines(fallback_lines)
// fallback_lines are 1-based line numbers needing the Python path.

#include <algorithm>
#include <charconv>
#include <cinttypes>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <ctime>
#include <map>
#include <string>
#include <vector>

#include <dlfcn.h>

namespace {

// -- minimal sqlite3 C API surface (stable ABI, declared locally) -------
typedef struct sqlite3 sqlite3;
typedef struct sqlite3_stmt sqlite3_stmt;
typedef int (*sqlite3_open_v2_t)(const char*, sqlite3**, int, const char*);
typedef int (*sqlite3_close_t)(sqlite3*);
typedef int (*sqlite3_prepare_v2_t)(sqlite3*, const char*, int,
                                    sqlite3_stmt**, const char**);
typedef int (*sqlite3_bind_text_t)(sqlite3_stmt*, int, const char*, int,
                                   void (*)(void*));
typedef int (*sqlite3_bind_int64_t)(sqlite3_stmt*, int, long long);
typedef int (*sqlite3_bind_null_t)(sqlite3_stmt*, int);
typedef int (*sqlite3_step_t)(sqlite3_stmt*);
typedef int (*sqlite3_reset_t)(sqlite3_stmt*);
typedef int (*sqlite3_finalize_t)(sqlite3_stmt*);
typedef int (*sqlite3_exec_t)(sqlite3*, const char*,
                              int (*)(void*, int, char**, char**), void*,
                              char**);
typedef const unsigned char* (*sqlite3_column_text_t)(sqlite3_stmt*, int);
typedef long long (*sqlite3_column_int64_t)(sqlite3_stmt*, int);

constexpr int kSqliteOk = 0;
constexpr int kSqliteRowBusy = 5;  // SQLITE_BUSY
constexpr int kSqliteDone = 101;
constexpr int kOpenReadWrite = 0x2;
#define SQLITE_TRANSIENT ((void (*)(void*))(-1))

struct SqliteApi {
  void* dl = nullptr;
  sqlite3_open_v2_t open_v2 = nullptr;
  sqlite3_close_t close = nullptr;
  sqlite3_prepare_v2_t prepare = nullptr;
  sqlite3_bind_text_t bind_text = nullptr;
  sqlite3_bind_int64_t bind_int64 = nullptr;
  sqlite3_bind_null_t bind_null = nullptr;
  sqlite3_step_t step = nullptr;
  sqlite3_reset_t reset = nullptr;
  sqlite3_finalize_t finalize = nullptr;
  sqlite3_exec_t exec = nullptr;
  sqlite3_column_text_t column_text = nullptr;
  sqlite3_column_int64_t column_int64 = nullptr;

  bool load() {
    if (dl) return true;
    for (const char* name : {"libsqlite3.so.0", "libsqlite3.so"}) {
      dl = dlopen(name, RTLD_NOW | RTLD_GLOBAL);
      if (dl) break;
    }
    if (!dl) return false;
    open_v2 = (sqlite3_open_v2_t)dlsym(dl, "sqlite3_open_v2");
    close = (sqlite3_close_t)dlsym(dl, "sqlite3_close");
    prepare = (sqlite3_prepare_v2_t)dlsym(dl, "sqlite3_prepare_v2");
    bind_text = (sqlite3_bind_text_t)dlsym(dl, "sqlite3_bind_text");
    bind_int64 = (sqlite3_bind_int64_t)dlsym(dl, "sqlite3_bind_int64");
    bind_null = (sqlite3_bind_null_t)dlsym(dl, "sqlite3_bind_null");
    step = (sqlite3_step_t)dlsym(dl, "sqlite3_step");
    reset = (sqlite3_reset_t)dlsym(dl, "sqlite3_reset");
    finalize = (sqlite3_finalize_t)dlsym(dl, "sqlite3_finalize");
    exec = (sqlite3_exec_t)dlsym(dl, "sqlite3_exec");
    column_text = (sqlite3_column_text_t)dlsym(dl, "sqlite3_column_text");
    column_int64 = (sqlite3_column_int64_t)dlsym(dl, "sqlite3_column_int64");
    return open_v2 && close && prepare && bind_text && bind_int64 &&
           bind_null && step && reset && finalize && exec && column_text &&
           column_int64;
  }
};

// ---------------------------------------------------------------- JSON --

// Parsed JSON value. Numbers keep their raw token so integer re-emission
// is exact (Python bignums print their digits unchanged).
struct JValue {
  enum Kind { Null, Bool, Int, Float, Str, Arr, Obj } kind = Null;
  bool b = false;
  std::string raw;             // Int/Float: raw token
  double d = 0.0;              // Float: parsed value
  std::string s;               // Str: UTF-8, unescaped
  std::vector<JValue> arr;     // Arr
  std::vector<std::pair<std::string, JValue>> obj;  // Obj, document order
};

struct Parser {
  const char* p;
  const char* end;
  bool fallback = false;  // construct we won't guarantee — use Python

  explicit Parser(const char* s, size_t n) : p(s), end(s + n) {}

  void ws() {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r'))
      ++p;
  }

  bool fail() { return false; }

  bool parse_hex4(unsigned& cp) {
    if (end - p < 4) return fail();
    cp = 0;
    for (int i = 0; i < 4; i++) {
      char c = *p++;
      cp <<= 4;
      if (c >= '0' && c <= '9') cp |= (unsigned)(c - '0');
      else if (c >= 'a' && c <= 'f') cp |= (unsigned)(c - 'a' + 10);
      else if (c >= 'A' && c <= 'F') cp |= (unsigned)(c - 'A' + 10);
      else return fail();
    }
    return true;
  }

  static void utf8_append(std::string& out, unsigned cp) {
    if (cp < 0x80) out.push_back((char)cp);
    else if (cp < 0x800) {
      out.push_back((char)(0xC0 | (cp >> 6)));
      out.push_back((char)(0x80 | (cp & 0x3F)));
    } else if (cp < 0x10000) {
      out.push_back((char)(0xE0 | (cp >> 12)));
      out.push_back((char)(0x80 | ((cp >> 6) & 0x3F)));
      out.push_back((char)(0x80 | (cp & 0x3F)));
    } else {
      out.push_back((char)(0xF0 | (cp >> 18)));
      out.push_back((char)(0x80 | ((cp >> 12) & 0x3F)));
      out.push_back((char)(0x80 | ((cp >> 6) & 0x3F)));
      out.push_back((char)(0x80 | (cp & 0x3F)));
    }
  }

  bool parse_string(std::string& out) {
    if (p >= end || *p != '"') return fail();
    ++p;
    out.clear();
    while (p < end) {
      unsigned char c = (unsigned char)*p;
      if (c == '"') { ++p; return true; }
      if (c == '\\') {
        ++p;
        if (p >= end) return fail();
        char e = *p++;
        switch (e) {
          case '"': out.push_back('"'); break;
          case '\\': out.push_back('\\'); break;
          case '/': out.push_back('/'); break;
          case 'b': out.push_back('\b'); break;
          case 'f': out.push_back('\f'); break;
          case 'n': out.push_back('\n'); break;
          case 'r': out.push_back('\r'); break;
          case 't': out.push_back('\t'); break;
          case 'u': {
            unsigned cp;
            if (!parse_hex4(cp)) return fail();
            if (cp >= 0xD800 && cp <= 0xDBFF && end - p >= 6 &&
                p[0] == '\\' && p[1] == 'u') {
              p += 2;
              unsigned lo;
              if (!parse_hex4(lo)) return fail();
              if (lo >= 0xDC00 && lo <= 0xDFFF)
                cp = 0x10000 + ((cp - 0xD800) << 10) + (lo - 0xDC00);
              else {
                // unpaired surrogate pair halves — Python keeps them as
                // lone surrogates; we can't render that identically
                fallback = true;
                utf8_append(out, cp);
                utf8_append(out, lo);
                break;
              }
            } else if (cp >= 0xD800 && cp <= 0xDFFF) {
              fallback = true;  // lone surrogate
            }
            utf8_append(out, cp);
            break;
          }
          default:
            return fail();
        }
      } else if (c < 0x20) {
        return fail();  // raw control char — invalid JSON
      } else {
        out.push_back((char)c);
        ++p;
      }
    }
    return fail();
  }

  bool parse_number(JValue& v) {
    const char* start = p;
    if (p < end && *p == '-') ++p;
    bool is_float = false;
    // JSON int grammar: 0 | [1-9][0-9]* (json.loads rejects leading zeros)
    const char* int_start = p;
    while (p < end && *p >= '0' && *p <= '9') ++p;
    if (p == int_start) return fail();
    if (*int_start == '0' && p - int_start > 1) return fail();
    if (p < end && *p == '.') {
      is_float = true;
      ++p;
      while (p < end && *p >= '0' && *p <= '9') ++p;
    }
    if (p < end && (*p == 'e' || *p == 'E')) {
      is_float = true;
      ++p;
      if (p < end && (*p == '+' || *p == '-')) ++p;
      while (p < end && *p >= '0' && *p <= '9') ++p;
    }
    if (p == start || (p == start + 1 && *start == '-')) return fail();
    v.raw.assign(start, (size_t)(p - start));
    if (!is_float && v.raw == "-0") v.raw = "0";  // json.dumps(int("-0"))
    if (is_float) {
      v.kind = JValue::Float;
      double d = 0;
      auto r = std::from_chars(start, p, d);
      if (r.ec != std::errc() || r.ptr != p) { fallback = true; }
      v.d = d;
    } else {
      v.kind = JValue::Int;
    }
    return true;
  }

  bool parse_value(JValue& v, int depth) {
    if (depth > 64) return fail();
    ws();
    if (p >= end) return fail();
    char c = *p;
    if (c == '{') {
      ++p;
      v.kind = JValue::Obj;
      ws();
      if (p < end && *p == '}') { ++p; return true; }
      while (true) {
        std::string key;
        ws();
        if (!parse_string(key)) return fail();
        ws();
        if (p >= end || *p != ':') return fail();
        ++p;
        JValue child;
        if (!parse_value(child, depth + 1)) return fail();
        v.obj.emplace_back(std::move(key), std::move(child));
        ws();
        if (p < end && *p == ',') { ++p; continue; }
        if (p < end && *p == '}') { ++p; return true; }
        return fail();
      }
    }
    if (c == '[') {
      ++p;
      v.kind = JValue::Arr;
      ws();
      if (p < end && *p == ']') { ++p; return true; }
      while (true) {
        JValue child;
        if (!parse_value(child, depth + 1)) return fail();
        v.arr.push_back(std::move(child));
        ws();
        if (p < end && *p == ',') { ++p; continue; }
        if (p < end && *p == ']') { ++p; return true; }
        return fail();
      }
    }
    if (c == '"') { v.kind = JValue::Str; return parse_string(v.s); }
    if (c == 't') {
      if (end - p >= 4 && !memcmp(p, "true", 4)) {
        v.kind = JValue::Bool; v.b = true; p += 4; return true;
      }
      return fail();
    }
    if (c == 'f') {
      if (end - p >= 5 && !memcmp(p, "false", 5)) {
        v.kind = JValue::Bool; v.b = false; p += 5; return true;
      }
      return fail();
    }
    if (c == 'n') {
      if (end - p >= 4 && !memcmp(p, "null", 4)) {
        v.kind = JValue::Null; p += 4; return true;
      }
      return fail();
    }
    // json.loads also accepts NaN/Infinity/-Infinity; their re-emission
    // is Python-specific — punt those lines to the Python path
    if (c == 'N' || c == 'I' ||
        (c == '-' && p + 1 < end && p[1] == 'I')) {
      fallback = true;
      return fail();
    }
    if (c == '-' || (c >= '0' && c <= '9')) return parse_number(v);
    return fail();
  }
};

// -- json.dumps-compatible re-serialization (sort_keys=True) ------------

// Python repr() of a double. CPython formats the SHORTEST round-trip
// digits, then picks fixed notation when the decimal exponent is in
// [-4, 16) and scientific otherwise (with a >=2-digit exponent) — the
// presentation choice differs from std::to_chars's shortest-string rule
// (to_chars prints 1e5 as "1e+05"; Python prints "100000.0"), so the
// digits come from to_chars scientific form and the presentation is
// rebuilt per Python's rules. Returns false for nan/inf.
bool py_float_repr(double d, std::string& out) {
  if (!(d == d) || d > 1.7976931348623157e308 || d < -1.7976931348623157e308)
    return false;
  char buf[64];
  auto r = std::to_chars(buf, buf + sizeof(buf), d, std::chars_format::scientific);
  if (r.ec != std::errc()) return false;
  std::string sci(buf, r.ptr);
  bool neg = false;
  size_t i = 0;
  if (sci[0] == '-') { neg = true; i = 1; }
  size_t epos = sci.find('e');
  std::string digits;
  for (size_t k = i; k < epos; k++)
    if (sci[k] != '.') digits.push_back(sci[k]);
  int exp10 = atoi(sci.c_str() + epos + 1);  // exponent of the first digit
  std::string body;
  if (exp10 >= 16 || exp10 < -4) {
    // scientific, Python-style: d[.ddd]e±NN
    body = digits.substr(0, 1);
    if (digits.size() > 1) body += "." + digits.substr(1);
    char eb[8];
    snprintf(eb, sizeof(eb), "e%c%02d", exp10 < 0 ? '-' : '+',
             exp10 < 0 ? -exp10 : exp10);
    body += eb;
  } else if (exp10 < 0) {
    body = "0.";
    body.append((size_t)(-exp10 - 1), '0');
    body += digits;
  } else if ((size_t)exp10 >= digits.size() - 1) {
    body = digits;
    body.append((size_t)exp10 - (digits.size() - 1), '0');
    body += ".0";
  } else {
    body = digits.substr(0, (size_t)exp10 + 1) + "." +
           digits.substr((size_t)exp10 + 1);
  }
  out = neg ? "-" + body : body;
  return true;
}

void json_escape_py(const std::string& s, std::string& out, bool& fb) {
  out.push_back('"');
  size_t i = 0, n = s.size();
  char buf[16];
  while (i < n) {
    unsigned char c = (unsigned char)s[i];
    if (c < 0x80) {
      switch (c) {
        case '"': out += "\\\""; break;
        case '\\': out += "\\\\"; break;
        case '\b': out += "\\b"; break;
        case '\f': out += "\\f"; break;
        case '\n': out += "\\n"; break;
        case '\r': out += "\\r"; break;
        case '\t': out += "\\t"; break;
        default:
          if (c < 0x20) {
            snprintf(buf, sizeof(buf), "\\u%04x", c);
            out += buf;
          } else {
            out.push_back((char)c);
          }
      }
      ++i;
      continue;
    }
    // decode UTF-8 → \uXXXX (ensure_ascii)
    unsigned cp = 0;
    int len = 0;
    if ((c & 0xE0) == 0xC0) { cp = c & 0x1F; len = 2; }
    else if ((c & 0xF0) == 0xE0) { cp = c & 0x0F; len = 3; }
    else if ((c & 0xF8) == 0xF0) { cp = c & 0x07; len = 4; }
    else { fb = true; out.push_back((char)c); ++i; continue; }
    if (i + (size_t)len > n) { fb = true; break; }
    bool ok = true;
    for (int k = 1; k < len; k++) {
      unsigned char cc = (unsigned char)s[i + (size_t)k];
      if ((cc & 0xC0) != 0x80) { ok = false; break; }
      cp = (cp << 6) | (cc & 0x3F);
    }
    if (!ok) { fb = true; ++i; continue; }
    i += (size_t)len;
    if (cp < 0x10000) {
      snprintf(buf, sizeof(buf), "\\u%04x", cp);
      out += buf;
    } else {
      unsigned v2 = cp - 0x10000;
      snprintf(buf, sizeof(buf), "\\u%04x\\u%04x",
               0xD800 + (v2 >> 10), 0xDC00 + (v2 & 0x3FF));
      out += buf;
    }
  }
  out.push_back('"');
}

bool dump_py(const JValue& v, std::string& out, bool sort_keys, bool& fb) {
  switch (v.kind) {
    case JValue::Null: out += "null"; return true;
    case JValue::Bool: out += v.b ? "true" : "false"; return true;
    case JValue::Int: out += v.raw; return true;  // exact, any width
    case JValue::Float: {
      std::string f;
      if (!py_float_repr(v.d, f)) return false;
      out += f;
      return true;
    }
    case JValue::Str: json_escape_py(v.s, out, fb); return true;
    case JValue::Arr: {
      out.push_back('[');
      for (size_t i = 0; i < v.arr.size(); i++) {
        if (i) out += ", ";
        if (!dump_py(v.arr[i], out, sort_keys, fb)) return false;
      }
      out.push_back(']');
      return true;
    }
    case JValue::Obj: {
      // json.dumps: last duplicate key wins; sort_keys sorts code points
      // (== UTF-8 byte order)
      std::vector<std::pair<std::string, const JValue*>> items;
      {
        std::map<std::string, const JValue*> last;
        for (const auto& kv : v.obj) last[kv.first] = &kv.second;
        if (sort_keys) {
          for (const auto& kv : last) items.emplace_back(kv.first, kv.second);
        } else {
          // preserve document order of last occurrences
          for (const auto& kv : v.obj)
            if (last[kv.first] == &kv.second)
              items.emplace_back(kv.first, &kv.second);
        }
      }
      out.push_back('{');
      for (size_t i = 0; i < items.size(); i++) {
        if (i) out += ", ";
        json_escape_py(items[i].first, out, fb);
        out += ": ";
        if (!dump_py(*items[i].second, out, sort_keys, fb)) return false;
      }
      out.push_back('}');
      return true;
    }
  }
  return false;
}

// ---------------------------------------------------------------- time --

// days-from-civil (Howard Hinnant's public-domain algorithm)
long long days_from_civil(int y, int m, int d) {
  y -= m <= 2;
  long long era = (y >= 0 ? y : y - 399) / 400;
  unsigned yoe = (unsigned)(y - era * 400);
  unsigned doy = (unsigned)((153 * (m + (m > 2 ? -3 : 9)) + 2) / 5 + d - 1);
  unsigned doe = yoe * 365 + yoe / 4 - yoe / 100 + doy;
  return era * 146097 + (long long)doe - 719468;
}

void civil_from_days(long long z, int& y, unsigned& m, unsigned& d) {
  z += 719468;
  long long era = (z >= 0 ? z : z - 146096) / 146097;
  unsigned doe = (unsigned)(z - era * 146097);
  unsigned yoe = (doe - doe / 1460 + doe / 36524 - doe / 146096) / 365;
  long long yy = (long long)yoe + era * 400;
  unsigned doy = doe - (365 * yoe + yoe / 4 - yoe / 100);
  unsigned mp = (5 * doy + 2) / 153;
  d = doy - (153 * mp + 2) / 5 + 1;
  m = mp + (mp < 10 ? 3 : -9);
  y = (int)(yy + (m <= 2));
}

bool two_digits(const char*& q, const char* qe, int& v) {
  if (qe - q < 2 || q[0] < '0' || q[0] > '9' || q[1] < '0' || q[1] > '9')
    return false;
  v = (q[0] - '0') * 10 + (q[1] - '0');
  q += 2;
  return true;
}

// Parse the ISO-8601 forms the event wire format uses into UTC
// microseconds-since-epoch. Conservative: unusual shapes → false (the
// line falls back to Python's fromisoformat).
bool parse_iso_utc(const std::string& in, long long& usec_out) {
  const char* q = in.c_str();
  const char* qe = q + in.size();
  while (q < qe && (*q == ' ')) ++q;
  while (qe > q && qe[-1] == ' ') --qe;
  if (qe - q < 10) return false;
  int year = 0;
  for (int i = 0; i < 4; i++) {
    if (q[i] < '0' || q[i] > '9') return false;
    year = year * 10 + (q[i] - '0');
  }
  q += 4;
  if (q >= qe || *q != '-') return false;
  ++q;
  int mon, day;
  if (!two_digits(q, qe, mon)) return false;
  if (q >= qe || *q != '-') return false;
  ++q;
  if (!two_digits(q, qe, day)) return false;
  if (mon < 1 || mon > 12 || day < 1) return false;
  static const int kDim[12] = {31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31};
  int dim = kDim[mon - 1];
  if (mon == 2 && ((year % 4 == 0 && year % 100 != 0) || year % 400 == 0))
    dim = 29;
  if (day > dim) return false;  // fromisoformat rejects e.g. Feb 30
  int hh = 0, mm = 0, ss = 0;
  long long frac_us = 0;
  long long off_s = 0;
  if (q < qe) {
    if (*q != 'T' && *q != ' ') return false;
    ++q;
    if (!two_digits(q, qe, hh)) return false;
    if (q >= qe || *q != ':') return false;
    ++q;
    if (!two_digits(q, qe, mm)) return false;
    if (q < qe && *q == ':') {
      ++q;
      if (!two_digits(q, qe, ss)) return false;
      if (q < qe && (*q == '.' || *q == ',')) {
        ++q;
        int nd = 0;
        long long f = 0;
        while (q < qe && *q >= '0' && *q <= '9' && nd < 6) {
          f = f * 10 + (*q - '0');
          ++q;
          ++nd;
        }
        if (nd == 0) return false;
        // >6 digits: fromisoformat(3.11+) truncates... actually it
        // rejects >6; be conservative and fall back
        if (q < qe && *q >= '0' && *q <= '9') return false;
        while (nd < 6) { f *= 10; ++nd; }
        frac_us = f;
      }
    }
    if (hh > 23 || mm > 59 || ss > 59) return false;
    if (q < qe) {
      char c = *q;
      if (c == 'Z' || c == 'z') {
        ++q;
      } else if (c == '+' || c == '-') {
        ++q;
        int oh, om = 0;
        if (!two_digits(q, qe, oh)) return false;
        if (oh > 23) return false;  // Python: offsets strictly < 24h
        if (q < qe && *q == ':') ++q;
        if (q < qe) {
          if (!two_digits(q, qe, om)) return false;
          if (om > 59) return false;
          if (q < qe && *q == ':') {
            // offsets with seconds: rare; fall back
            return false;
          }
        }
        off_s = (long long)oh * 3600 + om * 60;
        if (c == '-') off_s = -off_s;
      } else {
        return false;
      }
    }
  }
  if (q != qe) return false;
  long long days = days_from_civil(year, mon, day);
  long long sec = days * 86400LL + hh * 3600LL + mm * 60LL + ss - off_s;
  usec_out = sec * 1000000LL + frac_us;
  return true;
}

void format_utc(long long usec, std::string& out) {
  long long sec = usec / 1000000LL;
  long long us = usec % 1000000LL;
  if (us < 0) { us += 1000000LL; sec -= 1; }
  long long days = sec / 86400LL;
  long long rem = sec % 86400LL;
  if (rem < 0) { rem += 86400LL; days -= 1; }
  int y;
  unsigned m, d;
  civil_from_days(days, y, m, d);
  char buf[40];
  snprintf(buf, sizeof(buf), "%04d-%02u-%02uT%02lld:%02lld:%02lld.%06lldZ",
           y, m, d, rem / 3600, (rem % 3600) / 60, rem % 60, us);
  out = buf;
}

// ---------------------------------------------------------------- misc --

struct Rng {
  uint64_t s[2];
  Rng() {
    FILE* f = fopen("/dev/urandom", "rb");
    if (!f || fread(s, sizeof(s), 1, f) != 1) {
      s[0] = 0x9E3779B97F4A7C15ull ^ (uint64_t)(uintptr_t)this;
      s[1] = 0xBF58476D1CE4E5B9ull ^ (uint64_t)time(nullptr);
    }
    if (f) fclose(f);
  }
  uint64_t next() {  // xorshift128+
    uint64_t a = s[0], b = s[1];
    s[0] = b;
    a ^= a << 23;
    s[1] = a ^ b ^ (a >> 18) ^ (b >> 5);
    return s[1] + b;
  }
  // Import ids are time-prefixed (16 hex monotonic microseconds+counter,
  // then 16 random hex): uniqueness matches uuid4-hex for practical
  // purposes, but the PRIMARY KEY B-tree gets append-ordered inserts —
  // random ids made the PK index the import bottleneck (measured 30k/s vs
  // 61k/s insert rate at 500k rows).
  uint64_t seq = 0;
  void hex32(char* out) {
    static const char* h = "0123456789abcdef";
    uint64_t pre = seq++;
    for (int i = 0; i < 16; i++) out[i] = h[(pre >> (60 - 4 * i)) & 0xF];
    uint64_t v = next();
    for (int i = 0; i < 16; i++) out[16 + i] = h[(v >> (60 - 4 * i)) & 0xF];
  }
};

// Python truthiness of a JSON value (for `x or default` coercions)
bool is_falsy(const JValue& v) {
  switch (v.kind) {
    case JValue::Null: return true;
    case JValue::Bool: return !v.b;
    case JValue::Int: return v.raw == "0" || v.raw == "-0";
    case JValue::Float: return v.d == 0.0;
    case JValue::Str: return v.s.empty();
    case JValue::Arr: return v.arr.empty();
    case JValue::Obj: return v.obj.empty();
  }
  return false;
}

const JValue* find(const JValue& obj, const char* key) {
  // last occurrence wins (json.loads dict semantics)
  const JValue* r = nullptr;
  for (const auto& kv : obj.obj)
    if (kv.first == key) r = &kv.second;
  return r;
}

bool starts_with(const std::string& s, const char* pre) {
  size_t n = strlen(pre);
  return s.size() >= n && !memcmp(s.data(), pre, n);
}

enum LineResult { kInserted, kSkipped, kFallback };

struct Row {
  std::string id, event, etype, eid, props, etime, tags, ctime;
  std::string tetype, teid, prid;  // empty + flag = NULL
  bool has_tetype = false, has_teid = false, has_prid = false;
};

// Python str() of an id value: strings pass through; integer tokens are
// exact as-is; float tokens would need repr(float) — guarantee only the
// integral cases and punt the rest.
bool id_to_string(const JValue& v, std::string& out, bool required) {
  if (v.kind == JValue::Str) {
    if (v.s.empty() && required) return false;  // validation error, not fb
    out = v.s;
    return true;
  }
  if (v.kind == JValue::Int) { out = v.raw; return true; }
  return false;
}

// Per-line "now" stamping: the Python path stamps datetime.now() per
// event, so stamped times are distinct and ORDER BY event_time,
// creation_time stays stable. Advancing one microsecond per line keeps
// that property; the formatted string is cached per distinct value so
// lines with both times present pay nothing.
struct Stamper {
  long long base_us;
  long long cached_us = -1;
  std::string cached;
  const std::string& at(long long lineno) {
    long long v = base_us + lineno;
    if (v != cached_us) {
      cached_us = v;
      format_utc(v, cached);
    }
    return cached;
  }
};

LineResult process_line(const char* line, size_t len, Rng& rng,
                        Stamper& stamp, long long lineno, Row& row) {
  row = Row();  // the caller reuses one Row across lines
  Parser ps(line, len);
  JValue root;
  if (!ps.parse_value(root, 0)) return ps.fallback ? kFallback : kSkipped;
  ps.ws();
  if (ps.p != ps.end) return kSkipped;  // trailing garbage
  if (ps.fallback) return kFallback;
  if (root.kind != JValue::Obj) return kSkipped;

  const JValue* v_event = find(root, "event");
  const JValue* v_etype = find(root, "entityType");
  const JValue* v_eid = find(root, "entityId");
  if (!v_event || !v_etype || !v_eid) return kSkipped;
  if (v_event->kind != JValue::Str || v_event->s.empty()) return kSkipped;
  if (v_etype->kind != JValue::Str || v_etype->s.empty()) return kSkipped;
  // entityId: non-empty string or number (from_dict coerces)
  if (v_eid->kind == JValue::Null) return kSkipped;
  if (v_eid->kind == JValue::Str && v_eid->s.empty()) return kSkipped;
  if (!id_to_string(*v_eid, row.eid, true)) {
    // non-str/int JSON values: Python imports str(value) — Python-specific
    // rendering, so those lines go to the fallback path
    return kFallback;
  }
  row.event = v_event->s;
  row.etype = v_etype->s;

  const JValue* v_te_t = find(root, "targetEntityType");
  const JValue* v_te_i = find(root, "targetEntityId");
  if (v_te_t && v_te_t->kind != JValue::Null) {
    if (v_te_t->kind != JValue::Str) return kFallback;  // str() of object?
    row.tetype = v_te_t->s;
    row.has_tetype = true;
  }
  if (v_te_i && v_te_i->kind != JValue::Null) {
    if (!id_to_string(*v_te_i, row.teid, false)) return kFallback;
    row.has_teid = true;
  }

  // properties
  const JValue* v_props = find(root, "properties");
  static const JValue kEmptyObj = [] {
    JValue v;
    v.kind = JValue::Obj;
    return v;
  }();
  const JValue* props = &kEmptyObj;
  if (v_props && v_props->kind != JValue::Null && !is_falsy(*v_props)) {
    // from_dict: `d.get("properties") or {}` — any FALSY value ([], 0,
    // false, "", 0.0) coerces to {}; non-falsy non-objects are errors
    if (v_props->kind != JValue::Obj) return kSkipped;
    props = v_props;
  }

  // validation (EventValidation parity)
  if (row.event[0] == '$' && row.event != "$set" && row.event != "$unset" &&
      row.event != "$delete")
    return kSkipped;
  if (starts_with(row.event, "pio_") || starts_with(row.etype, "pio_"))
    return kSkipped;
  if (row.has_tetype && starts_with(row.tetype, "pio_")) return kSkipped;
  for (const auto& kv : props->obj)
    if (starts_with(kv.first, "pio_")) return kSkipped;
  bool special = row.event[0] == '$';
  if (special) {
    if (row.has_tetype || row.has_teid) return kSkipped;
    if (row.event == "$unset" && props->obj.empty()) return kSkipped;
    if (row.event == "$delete" && !props->obj.empty()) return kSkipped;
  }

  bool fb = false;
  row.props.clear();
  if (!dump_py(*props, row.props, /*sort_keys=*/true, fb)) return kFallback;
  if (fb) return kFallback;

  // tags: from_dict takes list(d.get("tags") or []); the row stores
  // json.dumps(list) with NO sort_keys (the Python path passes none)
  const JValue* v_tags = find(root, "tags");
  row.tags = "[]";
  if (v_tags && v_tags->kind != JValue::Null) {
    if (v_tags->kind != JValue::Arr) return kFallback;  // list(str) etc.
    row.tags.clear();
    if (!dump_py(*v_tags, row.tags, /*sort_keys=*/false, fb))
      return kFallback;
    if (fb) return kFallback;
  }

  const JValue* v_prid = find(root, "prId");
  if (v_prid && v_prid->kind != JValue::Null) {
    if (v_prid->kind != JValue::Str) return kFallback;
    row.prid = v_prid->s;
    row.has_prid = true;
  }

  // times: from_dict gates on `if d.get(...)` — FALSY values (missing,
  // null, "", 0, false) all mean "stamp now"; non-falsy non-strings fail
  // parse_time → skip
  const JValue* v_et = find(root, "eventTime");
  if (v_et && v_et->kind != JValue::Null && !is_falsy(*v_et)) {
    if (v_et->kind != JValue::Str) return kSkipped;
    long long us;
    if (!parse_iso_utc(v_et->s, us)) return kFallback;
    format_utc(us, row.etime);
  } else {
    row.etime = stamp.at(lineno);
  }
  const JValue* v_ct = find(root, "creationTime");
  if (v_ct && v_ct->kind != JValue::Null && !is_falsy(*v_ct)) {
    if (v_ct->kind != JValue::Str) return kSkipped;
    long long us;
    if (!parse_iso_utc(v_ct->s, us)) return kFallback;
    format_utc(us, row.ctime);
  } else {
    row.ctime = stamp.at(lineno);
  }

  char hex[33];
  hex[32] = 0;
  rng.hex32(hex);
  row.id.assign(hex, 32);
  return kInserted;
}

SqliteApi g_api;

}  // namespace

extern "C" {

int pio_import_file(const char* json_path, const char* db_path,
                    long long app_id, long long channel_id,
                    long long* imported, long long* skipped,
                    long long** fallback_lines, long long* n_fallback,
                    long long* resume_from_line) {
  *imported = 0;
  *skipped = 0;
  *fallback_lines = nullptr;
  *n_fallback = 0;
  *resume_from_line = 0;  // 0 = completed; N = caller must re-run lines
                          // >= N through the Python path (this call's
                          // counts cover only lines < N)
  if (!g_api.load()) return 1;
  FILE* f = fopen(json_path, "rb");
  if (!f) return 2;

  sqlite3* db = nullptr;
  if (g_api.open_v2(db_path, &db, kOpenReadWrite, nullptr) != kSqliteOk) {
    fclose(f);
    return 3;
  }
  g_api.exec(db, "PRAGMA busy_timeout=30000", nullptr, nullptr, nullptr);
  // WAL is set by the store; NORMAL durability matches the store's own
  // setting (storage/sqlite.py _connect)
  g_api.exec(db, "PRAGMA synchronous=NORMAL", nullptr, nullptr, nullptr);
  sqlite3_stmt* st = nullptr;
  if (g_api.prepare(db,
                    "INSERT INTO events VALUES (?,?,?,?,?,?,?,?,?,?,?,?,?)",
                    -1, &st, nullptr) != kSqliteOk) {
    g_api.close(db);
    fclose(f);
    return 4;
  }

  // import-time "now" (matches Python's per-event datetime.now(utc) only
  // in spirit; the Python path stamps each event separately — both are
  // "time of import", test code never compares them across paths)
  long long now_us = 0;
  {
    struct timespec ts;
    clock_gettime(CLOCK_REALTIME, &ts);
    now_us = (long long)ts.tv_sec * 1000000LL + ts.tv_nsec / 1000;
  }
  Stamper stamp{now_us};

  // Fresh-table fast path: when the events table is empty (initial bulk
  // load — the quickstart/benchmark case), drop the secondary indexes and
  // rebuild them after the load. B-tree maintenance during random-ish
  // inserts costs more than one sorted bulk build; on a non-empty table
  // rebuild cost scales with TABLE size, not import size, so keep them.
  std::vector<std::string> index_ddl;
  {
    sqlite3_stmt* cnt = nullptr;
    bool empty = false;
    if (g_api.prepare(db, "SELECT count(*) FROM events", -1, &cnt,
                      nullptr) == kSqliteOk) {
      if (g_api.step(cnt) == 100 /* SQLITE_ROW */)
        empty = g_api.column_int64(cnt, 0) == 0;
      g_api.finalize(cnt);
    }
    if (empty) {
      sqlite3_stmt* ix = nullptr;
      // only the _SCHEMA-owned idx_events_* indexes: a crash between
      // drop and rebuild is healed by the next backend init's
      // IF NOT EXISTS DDL for those, while a user-created index dropped
      // here would be lost forever
      if (g_api.prepare(db,
                        "SELECT name, sql FROM sqlite_master WHERE "
                        "type='index' AND tbl_name='events' AND sql IS "
                        "NOT NULL AND name LIKE 'idx\\_events\\_%' "
                        "ESCAPE '\\'",
                        -1, &ix, nullptr) == kSqliteOk) {
        std::vector<std::string> names;
        while (g_api.step(ix) == 100) {
          names.push_back((const char*)g_api.column_text(ix, 0));
          index_ddl.push_back((const char*)g_api.column_text(ix, 1));
        }
        g_api.finalize(ix);
        for (const auto& nm : names)
          g_api.exec(db, ("DROP INDEX IF EXISTS \"" + nm + "\"").c_str(),
                     nullptr, nullptr, nullptr);
      }
    }
  }

  Rng rng;
  rng.seq = (uint64_t)now_us;  // monotonic id prefix base (see hex32)
  std::vector<long long> fallbacks;
  char* line = nullptr;
  size_t cap = 0;
  long long lineno = 0;
  int in_chunk = 0;
  const int kChunk = 5000;
  bool hard_fail = false;
  // committed-state checkpoint: on a mid-import failure only the current
  // chunk rolls back, and earlier chunks are DURABLY imported — the
  // caller must not re-run the whole file (that would duplicate them),
  // so report counts as of the last commit plus the line to resume from
  long long chunk_start_line = 1;
  long long skipped_at_commit = 0;
  size_t fallbacks_at_commit = 0;

  auto bind_text = [&](int i, const std::string& s) {
    g_api.bind_text(st, i, s.data(), (int)s.size(), SQLITE_TRANSIENT);
  };

  g_api.exec(db, "BEGIN", nullptr, nullptr, nullptr);
  ssize_t n;
  Row row;
  while ((n = getline(&line, &cap, f)) != -1) {
    ++lineno;
    // strip trailing newline + surrounding whitespace (Python .strip())
    size_t len = (size_t)n;
    while (len && (line[len - 1] == '\n' || line[len - 1] == '\r' ||
                   line[len - 1] == ' ' || line[len - 1] == '\t'))
      --len;
    size_t off = 0;
    while (off < len && (line[off] == ' ' || line[off] == '\t')) ++off;
    if (off >= len) continue;  // blank line: not counted at all

    LineResult r;
    try {
      r = process_line(line + off, len - off, rng, stamp, lineno, row);
    } catch (const std::bad_alloc&) {
      hard_fail = true;
      break;
    }
    if (r == kSkipped) {
      ++*skipped;
      continue;
    }
    if (r == kFallback) {
      fallbacks.push_back(lineno);
      continue;
    }
    bind_text(1, row.id);
    g_api.bind_int64(st, 2, app_id);
    if (channel_id >= 0) g_api.bind_int64(st, 3, channel_id);
    else g_api.bind_null(st, 3);
    bind_text(4, row.event);
    bind_text(5, row.etype);
    bind_text(6, row.eid);
    if (row.has_tetype) bind_text(7, row.tetype);
    else g_api.bind_null(st, 7);
    if (row.has_teid) bind_text(8, row.teid);
    else g_api.bind_null(st, 8);
    bind_text(9, row.props);
    bind_text(10, row.etime);
    bind_text(11, row.tags);
    if (row.has_prid) bind_text(12, row.prid);
    else g_api.bind_null(st, 12);
    bind_text(13, row.ctime);
    int rc = g_api.step(st);
    g_api.reset(st);
    if (rc != kSqliteDone) {
      hard_fail = true;
      break;
    }
    ++*imported;
    if (++in_chunk >= kChunk) {
      g_api.exec(db, "COMMIT", nullptr, nullptr, nullptr);
      g_api.exec(db, "BEGIN", nullptr, nullptr, nullptr);
      in_chunk = 0;
      chunk_start_line = lineno + 1;
      skipped_at_commit = *skipped;
      fallbacks_at_commit = fallbacks.size();
    }
  }
  if (hard_fail) {
    // roll back the interrupted chunk and report committed state only;
    // everything from the chunk's first line onward is the caller's to
    // redo (Python path), so nothing is lost OR duplicated
    *imported -= in_chunk;
    *skipped = skipped_at_commit;
    fallbacks.resize(fallbacks_at_commit);
    *resume_from_line = chunk_start_line;
    g_api.exec(db, "ROLLBACK", nullptr, nullptr, nullptr);
  } else {
    g_api.exec(db, "COMMIT", nullptr, nullptr, nullptr);
  }
  // rebuild any indexes dropped for the fresh-table bulk path (also after
  // a failed import: the schema must never stay degraded)
  for (const auto& ddl : index_ddl)
    g_api.exec(db, ddl.c_str(), nullptr, nullptr, nullptr);
  free(line);
  g_api.finalize(st);
  g_api.close(db);
  fclose(f);

  if (!fallbacks.empty()) {
    *fallback_lines =
        (long long*)malloc(fallbacks.size() * sizeof(long long));
    if (!*fallback_lines) {
      // result-list allocation failed (8 bytes/line — effectively never).
      // The imported lines are durably committed, so a blanket redo would
      // DUPLICATE them; report the loss explicitly instead: rc=6 →
      // wrapper logs which count of lines was not imported.
      *n_fallback = (long long)fallbacks.size();
      return 6;
    }
    memcpy(*fallback_lines, fallbacks.data(),
           fallbacks.size() * sizeof(long long));
    *n_fallback = (long long)fallbacks.size();
  }
  return 0;
}

void pio_import_free_lines(long long* fallback_lines) {
  free(fallback_lines);
}

}  // extern "C"
