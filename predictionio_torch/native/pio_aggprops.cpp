// Native $set/$unset/$delete property aggregation for predictionio_torch
// (an own copy of the reference's predictionio_tpu/native/pio_aggprops.cpp:
// same semantics, same C ABI).
//
// The reference folds special events into per-entity property maps with
// an HBase scan + per-row fold inside `aggregateProperties`
// («data/.../storage/LEvents :: aggregateProperties» — SURVEY.md §2.2
// [U], mount empty). The rebuild's Python fold
// (data/datamap.py::aggregate_properties) materializes one Event +
// DataMap per row — the exact per-event cost the columnar ratings scan
// (pio_scan.cpp) eliminated. This TU gives the property-read path the
// same treatment: stream the filtered rows once via the sqlite3 C API in
// (event_time, creation_time) order, fold $set/$unset/$delete in C++
// with raw JSON value spans (no JSON value parse at all — values are
// spliced back verbatim, so the Python side parses one object per
// ENTITY, not one per event), and hand back a packed blob of
//   entity_id \0 first_updated \0 last_updated \0 folded_json \0
// per surviving entity.
//
// Fold semantics (must match data/datamap.py::aggregate_properties):
//   - rows arrive ordered by (event_time, creation_time, id) ascending
//     (unique id as final tiebreak — exact-timestamp ties must resolve
//     the same way in every tier);
//   - $set creates/updates keys (later sets win per key); creation
//     stamps first_updated, every $set stamps last_updated;
//   - $unset drops the named keys IF the entity exists, and stamps
//     last_updated even when the keys are absent or the bag is empty;
//   - $delete removes the entity entirely; a later $set recreates it
//     with a fresh first_updated.
//
// Keys are fully JSON-decoded (\uXXXX incl. surrogate pairs) so a
// $unset spelled with escapes matches a $set spelled raw, exactly as
// Python's json.loads-ed dict keys do; output keys are re-encoded pure
// ASCII (\uXXXX) so even lone-surrogate keys survive the round trip.
// Any surprise — malformed JSON, non-object properties, bad escape —
// aborts the whole scan (rc != 0) and the wrapper falls back to the
// bit-identical per-event Python fold.
//
// Same two-phase C ABI and dlopen'd sqlite3 pattern as pio_scan.cpp.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <map>
#include <string>
#include <unordered_map>
#include <unordered_set>
#include <vector>

#include <dlfcn.h>

namespace {

// -- minimal sqlite3 C API surface (stable ABI, declared locally; each
// native TU carries its own copy — no cross-TU coupling) ----------------
typedef struct sqlite3 sqlite3;
typedef struct sqlite3_stmt sqlite3_stmt;
constexpr int kSqliteOk = 0;
constexpr int kSqliteRow = 100;
constexpr int kSqliteDone = 101;
constexpr int kOpenReadonly = 0x00000001;

struct SqliteApi {
    int (*open_v2)(const char*, sqlite3**, int, const char*);
    int (*close_v2)(sqlite3*);
    int (*prepare_v2)(sqlite3*, const char*, int, sqlite3_stmt**,
                      const char**);
    int (*step)(sqlite3_stmt*);
    int (*finalize)(sqlite3_stmt*);
    int (*bind_text)(sqlite3_stmt*, int, const char*, int, void*);
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
        a.column_text = reinterpret_cast<decltype(a.column_text)>(
            sym("sqlite3_column_text"));
        a.column_bytes = reinterpret_cast<decltype(a.column_bytes)>(
            sym("sqlite3_column_bytes"));
        a.errmsg = reinterpret_cast<decltype(a.errmsg)>(
            sym("sqlite3_errmsg"));
        a.ok = a.open_v2 && a.close_v2 && a.prepare_v2 && a.step &&
               a.finalize && a.bind_text && a.column_text &&
               a.column_bytes && a.errmsg;
        return a;
    }();
    return api;
}

thread_local std::string g_error;

// -- JSON string decoding (full, json.loads-equivalent) -----------------
// Decodes a JSON string starting at *p == '"'. \uXXXX escapes combine
// surrogate pairs into astral codepoints; a LONE surrogate is encoded
// WTF-8 style (json.loads accepts lone surrogates into Python strs, and
// key identity must match that). Returns false on any malformed input.
inline void append_utf8(uint32_t cp, std::string* out) {
    if (cp < 0x80) {
        out->push_back(static_cast<char>(cp));
    } else if (cp < 0x800) {
        out->push_back(static_cast<char>(0xC0 | (cp >> 6)));
        out->push_back(static_cast<char>(0x80 | (cp & 0x3F)));
    } else if (cp < 0x10000) {
        out->push_back(static_cast<char>(0xE0 | (cp >> 12)));
        out->push_back(static_cast<char>(0x80 | ((cp >> 6) & 0x3F)));
        out->push_back(static_cast<char>(0x80 | (cp & 0x3F)));
    } else {
        out->push_back(static_cast<char>(0xF0 | (cp >> 18)));
        out->push_back(static_cast<char>(0x80 | ((cp >> 12) & 0x3F)));
        out->push_back(static_cast<char>(0x80 | ((cp >> 6) & 0x3F)));
        out->push_back(static_cast<char>(0x80 | (cp & 0x3F)));
    }
}

inline bool parse_hex4(const char* s, uint32_t* out) {
    uint32_t v = 0;
    for (int i = 0; i < 4; ++i) {
        char c = s[i];
        v <<= 4;
        if (c >= '0' && c <= '9') v |= c - '0';
        else if (c >= 'a' && c <= 'f') v |= c - 'a' + 10;
        else if (c >= 'A' && c <= 'F') v |= c - 'A' + 10;
        else return false;
    }
    *out = v;
    return true;
}

bool decode_json_string(const char*& p, const char* end, std::string* out) {
    if (p >= end || *p != '"') return false;
    ++p;
    while (p < end) {
        unsigned char c = static_cast<unsigned char>(*p);
        if (c == '"') {
            ++p;
            return true;
        }
        if (c == '\\') {
            if (p + 1 >= end) return false;
            char e = p[1];
            p += 2;
            switch (e) {
                case '"': if (out) out->push_back('"'); break;
                case '\\': if (out) out->push_back('\\'); break;
                case '/': if (out) out->push_back('/'); break;
                case 'b': if (out) out->push_back('\b'); break;
                case 'f': if (out) out->push_back('\f'); break;
                case 'n': if (out) out->push_back('\n'); break;
                case 'r': if (out) out->push_back('\r'); break;
                case 't': if (out) out->push_back('\t'); break;
                case 'u': {
                    if (p + 4 > end) return false;
                    uint32_t cp;
                    if (!parse_hex4(p, &cp)) return false;
                    p += 4;
                    if (cp >= 0xD800 && cp < 0xDC00 && p + 6 <= end &&
                        p[0] == '\\' && p[1] == 'u') {
                        uint32_t lo;
                        if (!parse_hex4(p + 2, &lo)) return false;
                        if (lo >= 0xDC00 && lo < 0xE000) {
                            cp = 0x10000 + ((cp - 0xD800) << 10) +
                                 (lo - 0xDC00);
                            p += 6;
                        }
                        // else: lone high surrogate, keep as-is (WTF-8)
                    }
                    if (out) append_utf8(cp, out);
                    break;
                }
                default: return false;
            }
            continue;
        }
        if (out) out->push_back(static_cast<char>(c));
        ++p;
    }
    return false;  // unterminated
}

// Re-encode a decoded (WTF-8) key as a pure-ASCII JSON string so the
// assembled object is loadable by json.loads regardless of what the key
// contained (incl. lone surrogates, which raw WTF-8 bytes would break).
bool encode_json_string_ascii(const std::string& k, std::string* out) {
    static const char* hex = "0123456789abcdef";
    out->push_back('"');
    const unsigned char* p = reinterpret_cast<const unsigned char*>(k.data());
    const unsigned char* end = p + k.size();
    while (p < end) {
        unsigned char c = *p;
        uint32_t cp;
        int len;
        if (c < 0x80) { cp = c; len = 1; }
        else if ((c & 0xE0) == 0xC0) { cp = c & 0x1F; len = 2; }
        else if ((c & 0xF0) == 0xE0) { cp = c & 0x0F; len = 3; }
        else if ((c & 0xF8) == 0xF0) { cp = c & 0x07; len = 4; }
        else return false;
        if (p + len > end) return false;
        for (int i = 1; i < len; ++i) {
            if ((p[i] & 0xC0) != 0x80) return false;
            cp = (cp << 6) | (p[i] & 0x3F);
        }
        p += len;
        if (cp == '"') { out->append("\\\""); }
        else if (cp == '\\') { out->append("\\\\"); }
        else if (cp >= 0x20 && cp < 0x7F) {
            out->push_back(static_cast<char>(cp));
        } else if (cp < 0x10000) {
            out->append("\\u");
            out->push_back(hex[(cp >> 12) & 0xF]);
            out->push_back(hex[(cp >> 8) & 0xF]);
            out->push_back(hex[(cp >> 4) & 0xF]);
            out->push_back(hex[cp & 0xF]);
        } else {
            uint32_t v = cp - 0x10000;
            uint32_t hi = 0xD800 + (v >> 10), lo = 0xDC00 + (v & 0x3FF);
            for (uint32_t s : {hi, lo}) {
                out->append("\\u");
                out->push_back(hex[(s >> 12) & 0xF]);
                out->push_back(hex[(s >> 8) & 0xF]);
                out->push_back(hex[(s >> 4) & 0xF]);
                out->push_back(hex[s & 0xF]);
            }
        }
    }
    out->push_back('"');
    return true;
}

// -- JSON object splitter -----------------------------------------------
// Splits a top-level JSON object into (decoded key, raw value span)
// pairs. Values are NOT parsed beyond bracket/string balancing — the
// raw span is spliced verbatim into the folded output. Duplicate keys:
// later wins (matches json.loads). Returns false on anything that is
// not a well-formed object.
struct Splitter {
    const char* p;
    const char* end;

    void skip_ws() {
        while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' ||
                           *p == '\r'))
            ++p;
    }

    bool skip_value() {
        skip_ws();
        if (p >= end) return false;
        if (*p == '"') return decode_json_string(p, end, nullptr);
        if (*p == '{' || *p == '[') {
            int depth = 0;
            while (p < end) {
                if (*p == '"') {
                    if (!decode_json_string(p, end, nullptr)) return false;
                    continue;
                }
                if (*p == '{' || *p == '[') ++depth;
                else if (*p == '}' || *p == ']') {
                    --depth;
                    if (depth < 0) return false;
                    if (depth == 0) { ++p; return true; }
                }
                ++p;
            }
            return false;
        }
        // number / true / false / null: advance to a delimiter
        const char* start = p;
        while (p < end && *p != ',' && *p != '}' && *p != ']' &&
               *p != ' ' && *p != '\t' && *p != '\n' && *p != '\r')
            ++p;
        return p > start;
    }

    bool split(std::vector<std::pair<std::string, std::string>>* out) {
        skip_ws();
        if (p >= end || *p != '{') return false;
        ++p;
        skip_ws();
        if (p < end && *p == '}') { ++p; return true; }
        while (p < end) {
            skip_ws();
            std::string key;
            if (!decode_json_string(p, end, &key)) return false;
            skip_ws();
            if (p >= end || *p != ':') return false;
            ++p;
            skip_ws();
            const char* vstart = p;
            if (!skip_value()) return false;
            out->emplace_back(std::move(key), std::string(vstart, p - vstart));
            skip_ws();
            if (p < end && *p == ',') { ++p; continue; }
            if (p < end && *p == '}') { ++p; return true; }
            return false;
        }
        return false;
    }
};

// -- fold state ---------------------------------------------------------
// Keys are interned once into dense uint32 ids (property keys repeat
// massively — a 2M-event stream typically has <100 distinct keys), so
// per-entity state is a flat vector of (key id, raw value span) probed
// linearly instead of a per-entity hash map — no bucket allocations,
// cache-friendly for the usual <20 keys per entity.
struct AggEntity {
    std::vector<std::pair<uint32_t, std::string>> kv;
    std::string first, last;  // raw event_time text (Python parses once)
};

struct AggResult {
    std::string blob;       // eid\0 first\0 last\0 json\0 per entity
    int64_t n_entities = 0;
};

}  // namespace

extern "C" {

const char* pio_agg_error() { return g_error.c_str(); }

// Runs the whole fold. `sql` must select
//   0 entity_id TEXT, 1 event TEXT, 2 properties TEXT, 3 event_time TEXT
// ordered by (event_time, creation_time, id) ascending — the fold is
// order-sensitive and trusts the statement's ORDER BY. Returns 0 with a
// handle + sizes, or -1 (pio_agg_error() has the reason; the caller
// falls back to the per-event Python fold).
int64_t pio_agg_open(const char* db_path, const char* sql,
                     const char** params, int64_t n_params,
                     const char** required, int64_t n_required,
                     void** out_handle, int64_t* out_n,
                     int64_t* out_bytes) {
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
        if (api.bind_text(stmt, static_cast<int>(i + 1), params[i], -1,
                          reinterpret_cast<void*>(-1)) != kSqliteOk) {
            g_error = api.errmsg(db);
            api.finalize(stmt);
            api.close_v2(db);
            return -1;
        }
    }

    std::unordered_map<std::string, AggEntity> state;
    std::unordered_map<std::string, uint32_t> key_ids;
    std::vector<std::string> key_names;
    std::vector<std::pair<std::string, std::string>> kvs;
    std::string eid_buf;
    auto intern_key = [&](std::string&& k) -> uint32_t {
        auto it = key_ids.find(k);
        if (it != key_ids.end()) return it->second;
        uint32_t id = static_cast<uint32_t>(key_names.size());
        key_names.push_back(k);
        key_ids.emplace(std::move(k), id);
        return id;
    };
    int rc;
    bool failed = false;
    while ((rc = api.step(stmt)) == kSqliteRow) {
        const char* eid =
            reinterpret_cast<const char*>(api.column_text(stmt, 0));
        int eid_n = api.column_bytes(stmt, 0);
        const char* ev =
            reinterpret_cast<const char*>(api.column_text(stmt, 1));
        const char* props =
            reinterpret_cast<const char*>(api.column_text(stmt, 2));
        int props_n = api.column_bytes(stmt, 2);
        const char* t =
            reinterpret_cast<const char*>(api.column_text(stmt, 3));
        if (!eid || !ev || !t) {
            g_error = "NULL entity_id/event/event_time";
            failed = true;
            break;
        }
        eid_buf.assign(eid, eid_n);  // reused buffer: no per-row malloc
        if (std::strcmp(ev, "$delete") == 0) {
            state.erase(eid_buf);
            continue;
        }
        const bool is_set = std::strcmp(ev, "$set") == 0;
        const bool is_unset = !is_set && std::strcmp(ev, "$unset") == 0;
        if (!is_set && !is_unset) {
            g_error = std::string("unexpected event '") + ev +
                      "' (WHERE must filter to special events)";
            failed = true;
            break;
        }
        kvs.clear();
        Splitter sp{props ? props : "", (props ? props : "") + props_n};
        if (!sp.split(&kvs)) {
            g_error = "unparseable properties JSON — Python fallback";
            failed = true;
            break;
        }
        if (is_set) {
            auto it = state.find(eid_buf);
            if (it == state.end()) {
                it = state.emplace(eid_buf, AggEntity{}).first;
                it->second.first.assign(t);
            }
            auto& entkv = it->second.kv;
            for (auto& kv : kvs) {
                uint32_t id = intern_key(std::move(kv.first));
                bool found = false;
                for (auto& e : entkv) {
                    if (e.first == id) {
                        e.second = std::move(kv.second);
                        found = true;
                        break;
                    }
                }
                if (!found) entkv.emplace_back(id, std::move(kv.second));
            }
            it->second.last.assign(t);
        } else {  // $unset: only touches entities that exist
            auto it = state.find(eid_buf);
            if (it != state.end()) {
                auto& entkv = it->second.kv;
                for (auto& kv : kvs) {
                    auto kit = key_ids.find(kv.first);
                    if (kit == key_ids.end()) continue;  // never $set
                    for (size_t i = 0; i < entkv.size(); ++i) {
                        if (entkv[i].first == kit->second) {
                            entkv[i] = std::move(entkv.back());
                            entkv.pop_back();
                            break;
                        }
                    }
                }
                it->second.last.assign(t);
            }
        }
    }
    api.finalize(stmt);
    if (!failed && rc != kSqliteDone) {
        g_error = api.errmsg(db);
        failed = true;
    }
    api.close_v2(db);
    if (failed) return -1;

    // -- required filter + deterministic assembly -----------------------
    // required keys → interned ids; a required key never seen in any
    // $set cannot be on any entity, so the result is empty
    std::vector<uint32_t> req_ids;
    bool req_impossible = false;
    for (int64_t i = 0; i < n_required; ++i) {
        auto it = key_ids.find(required[i]);
        if (it == key_ids.end()) {
            req_impossible = true;
            break;
        }
        req_ids.push_back(it->second);
    }
    std::vector<const std::pair<const std::string, AggEntity>*> items;
    if (!req_impossible) {
        items.reserve(state.size());
        for (auto& kv : state) {
            bool ok = true;
            for (uint32_t rid : req_ids) {
                bool has = false;
                for (auto& e : kv.second.kv) {
                    if (e.first == rid) { has = true; break; }
                }
                if (!has) { ok = false; break; }
            }
            if (ok) items.push_back(&kv);
        }
    }
    std::sort(items.begin(), items.end(),
              [](auto* a, auto* b) { return a->first < b->first; });

    // pre-encode each interned key's ASCII-escaped JSON form once
    std::vector<std::string> key_json(key_names.size());
    for (size_t i = 0; i < key_names.size(); ++i) {
        if (!encode_json_string_ascii(key_names[i], &key_json[i])) {
            g_error = "invalid WTF-8 in decoded key";
            return -1;
        }
    }

    auto* res = new AggResult();
    std::vector<const std::pair<uint32_t, std::string>*> keys;
    for (auto* item : items) {
        res->blob.append(item->first);
        res->blob.push_back('\0');
        res->blob.append(item->second.first);
        res->blob.push_back('\0');
        res->blob.append(item->second.last);
        res->blob.push_back('\0');
        keys.clear();
        for (auto& kv : item->second.kv) keys.push_back(&kv);
        std::sort(keys.begin(), keys.end(),
                  [&](auto* a, auto* b) {
                      return key_names[a->first] < key_names[b->first];
                  });
        res->blob.push_back('{');
        bool first = true;
        for (auto* kv : keys) {
            if (!first) res->blob.push_back(',');
            first = false;
            res->blob.append(key_json[kv->first]);
            res->blob.push_back(':');
            res->blob.append(kv->second);
        }
        res->blob.push_back('}');
        res->blob.push_back('\0');
        ++res->n_entities;
    }
    *out_handle = res;
    *out_n = res->n_entities;
    *out_bytes = static_cast<int64_t>(res->blob.size());
    return 0;
}

int64_t pio_agg_fill(void* handle, char* buf) {
    auto* res = static_cast<AggResult*>(handle);
    if (!res) return -1;
    std::memcpy(buf, res->blob.data(), res->blob.size());
    return 0;
}

void pio_agg_free(void* handle) {
    delete static_cast<AggResult*>(handle);
}

}  // extern "C"
