// Native bulk event export for predictionio_torch (an own copy of the
// reference's predictionio_tpu/native/pio_export.cpp: same semantics, same
// C ABI).
//
// «tools/.../export/EventsToFile.scala» [U] streams the event store to a
// JSON-lines file via a Spark job; the rebuild's Python path builds one
// Event object + DataMap per row and re-serializes — ~30k rows/s and
// O(n) memory (find() materializes every row). This TU walks the SQLite
// table once (same dlopen'd C-ABI pattern as pio_scan.cpp) and SPLICES
// the stored JSON columns into each output line:
//
//   - `properties` and `tags` are stored as the exact text
//     `DataMap.to_json()` / `json.dumps(tags)` wrote at insert
//     (sort_keys properties, ensure_ascii — pure printable ASCII), and
//     `json.loads` → `json.dumps` round-trips that text byte-identically
//     (key order preserved, same separators), so the stored text IS what
//     the Python exporter would emit;
//   - `event_time` / `creation_time` are stored in `format_time`'s
//     canonical fixed-width UTC form, which parse→format round-trips to
//     itself;
//   - remaining string columns are escaped exactly like
//     `json.dumps(ensure_ascii=True)` (\uXXXX + surrogate pairs).
//
// Field order matches Event.to_dict: event, entityType, entityId,
// eventTime, properties, creationTime, eventId, targetEntityType,
// targetEntityId, tags (when non-empty), prId (when present).
//
// All-or-nothing fidelity contract: on ANY surprise (unloadable sqlite,
// NULL in a NOT NULL column, invalid UTF-8, suspicious stored JSON) the
// function returns nonzero and the caller re-runs the whole export
// through the Python path — unlike pio_import.cpp there is no per-line
// fallback, because a partial output file is useless.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>

#include <dlfcn.h>

namespace {

// -- minimal sqlite3 C API surface (stable ABI, declared locally) -------
typedef struct sqlite3 sqlite3;
typedef struct sqlite3_stmt sqlite3_stmt;
constexpr int kSqliteOk = 0;
constexpr int kSqliteRow = 100;
constexpr int kOpenReadonly = 0x00000001;
constexpr int kColNull = 5;

struct SqliteApi {
    int (*open_v2)(const char*, sqlite3**, int, const char*);
    int (*close_v2)(sqlite3*);
    int (*prepare_v2)(sqlite3*, const char*, int, sqlite3_stmt**,
                      const char**);
    int (*step)(sqlite3_stmt*);
    int (*finalize)(sqlite3_stmt*);
    int (*bind_int64)(sqlite3_stmt*, int, long long);
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
        a.bind_int64 = reinterpret_cast<decltype(a.bind_int64)>(
            sym("sqlite3_bind_int64"));
        a.column_type = reinterpret_cast<decltype(a.column_type)>(
            sym("sqlite3_column_type"));
        a.column_text = reinterpret_cast<decltype(a.column_text)>(
            sym("sqlite3_column_text"));
        a.column_bytes = reinterpret_cast<decltype(a.column_bytes)>(
            sym("sqlite3_column_bytes"));
        a.errmsg = reinterpret_cast<decltype(a.errmsg)>(sym("sqlite3_errmsg"));
        a.ok = a.open_v2 && a.close_v2 && a.prepare_v2 && a.step &&
               a.finalize && a.bind_int64 && a.column_type &&
               a.column_text && a.column_bytes && a.errmsg;
        return a;
    }();
    return api;
}

thread_local std::string g_error;

// Append `s` (UTF-8, length n) to out as a Python-json.dumps
// (ensure_ascii=True) double-quoted string. Returns false on invalid
// UTF-8 or codepoints > U+10FFFF.
bool append_json_string(std::string& out, const unsigned char* s,
                        int n) {
    static const char* hex = "0123456789abcdef";
    out += '"';
    int i = 0;
    while (i < n) {
        unsigned char c = s[i];
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
                        out += "\\u00";
                        out += hex[c >> 4];
                        out += hex[c & 0xf];
                    } else {
                        out += static_cast<char>(c);
                    }
            }
            ++i;
            continue;
        }
        // multi-byte UTF-8 → codepoint
        int extra;
        uint32_t cp;
        if ((c & 0xE0) == 0xC0) { extra = 1; cp = c & 0x1F; }
        else if ((c & 0xF0) == 0xE0) { extra = 2; cp = c & 0x0F; }
        else if ((c & 0xF8) == 0xF0) { extra = 3; cp = c & 0x07; }
        else return false;
        if (i + extra >= n) return false;
        for (int k = 1; k <= extra; ++k) {
            unsigned char cc = s[i + k];
            if ((cc & 0xC0) != 0x80) return false;
            cp = (cp << 6) | (cc & 0x3F);
        }
        i += extra + 1;
        if (cp > 0x10FFFF || (cp >= 0xD800 && cp <= 0xDFFF)) return false;
        auto emit4 = [&](uint32_t u) {
            out += "\\u";
            out += hex[(u >> 12) & 0xf];
            out += hex[(u >> 8) & 0xf];
            out += hex[(u >> 4) & 0xf];
            out += hex[u & 0xf];
        };
        if (cp < 0x10000) {
            emit4(cp);
        } else {  // surrogate pair, like Python's ensure_ascii
            cp -= 0x10000;
            emit4(0xD800 + (cp >> 10));
            emit4(0xDC00 + (cp & 0x3FF));
        }
    }
    out += '"';
    return true;
}

struct Col {
    const unsigned char* text;
    int bytes;
    bool is_null;
};

Col get_col(const SqliteApi& api, sqlite3_stmt* st, int idx) {
    Col c;
    c.is_null = api.column_type(st, idx) == kColNull;
    c.text = c.is_null ? nullptr : api.column_text(st, idx);
    c.bytes = c.is_null ? 0 : api.column_bytes(st, idx);
    return c;
}

}  // namespace

extern "C" {

const char* pio_export_error() { return g_error.c_str(); }

// Export app/channel events as JSON lines, byte-identical to the Python
// exporter. channel_id < 0 selects channel IS NULL. Returns 0 on
// success with *out_count set; nonzero = caller must use the Python
// path (g_error says why).
int pio_export_events(const char* db_path, const char* out_path,
                      long long app_id, long long channel_id,
                      long long* out_count) {
    const SqliteApi& api = sqlite_api();
    if (!api.ok) {
        g_error = "sqlite3 C API unavailable";
        return 1;
    }
    sqlite3* db = nullptr;
    if (api.open_v2(db_path, &db, kOpenReadonly, nullptr) != kSqliteOk) {
        g_error = db ? api.errmsg(db) : "cannot open db";
        if (db) api.close_v2(db);
        return 2;
    }
    // SELECT column order mirrors the schema; ORDER BY matches
    // storage/sqlite.py find() so line order is identical
    std::string sql =
        "SELECT id, event, entity_type, entity_id, target_entity_type, "
        "target_entity_id, properties, event_time, tags, pr_id, "
        "creation_time FROM events WHERE app_id=? AND ";
    sql += (channel_id < 0) ? "channel_id IS NULL" : "channel_id=?";
    sql += " ORDER BY event_time ASC, creation_time ASC";
    sqlite3_stmt* st = nullptr;
    if (api.prepare_v2(db, sql.c_str(), -1, &st, nullptr) != kSqliteOk) {
        g_error = api.errmsg(db);
        api.close_v2(db);
        return 3;
    }
    api.bind_int64(st, 1, app_id);
    if (channel_id >= 0) api.bind_int64(st, 2, channel_id);

    FILE* out = std::fopen(out_path, "wb");
    if (!out) {
        g_error = "cannot open output file";
        api.finalize(st);
        api.close_v2(db);
        return 4;
    }

    long long count = 0;
    int rc_out = 0;
    std::string line;
    line.reserve(1024);
    int rc;
    while ((rc = api.step(st)) == kSqliteRow) {
        Col id = get_col(api, st, 0);
        Col event = get_col(api, st, 1);
        Col etype = get_col(api, st, 2);
        Col eid = get_col(api, st, 3);
        Col ttype = get_col(api, st, 4);
        Col tid = get_col(api, st, 5);
        Col props = get_col(api, st, 6);
        Col etime = get_col(api, st, 7);
        Col tags = get_col(api, st, 8);
        Col prid = get_col(api, st, 9);
        Col ctime = get_col(api, st, 10);
        if (id.is_null || event.is_null || etype.is_null || eid.is_null ||
            props.is_null || etime.is_null || tags.is_null ||
            ctime.is_null || props.bytes < 2 || tags.bytes < 2 ||
            props.text[0] != '{' || tags.text[0] != '[') {
            g_error = "unexpected NULL / malformed stored JSON";
            rc_out = 5;
            break;
        }
        line.clear();
        line += "{\"event\": ";
        bool ok = append_json_string(line, event.text, event.bytes);
        line += ", \"entityType\": ";
        ok = ok && append_json_string(line, etype.text, etype.bytes);
        line += ", \"entityId\": ";
        ok = ok && append_json_string(line, eid.text, eid.bytes);
        line += ", \"eventTime\": ";
        ok = ok && append_json_string(line, etime.text, etime.bytes);
        line += ", \"properties\": ";
        line.append(reinterpret_cast<const char*>(props.text), props.bytes);
        line += ", \"creationTime\": ";
        ok = ok && append_json_string(line, ctime.text, ctime.bytes);
        line += ", \"eventId\": ";
        ok = ok && append_json_string(line, id.text, id.bytes);
        if (!ttype.is_null) {
            line += ", \"targetEntityType\": ";
            ok = ok && append_json_string(line, ttype.text, ttype.bytes);
        }
        if (!tid.is_null) {
            line += ", \"targetEntityId\": ";
            ok = ok && append_json_string(line, tid.text, tid.bytes);
        }
        if (!(tags.bytes == 2 && tags.text[1] == ']')) {
            line += ", \"tags\": ";
            line.append(reinterpret_cast<const char*>(tags.text),
                        tags.bytes);
        }
        if (!prid.is_null) {
            line += ", \"prId\": ";
            ok = ok && append_json_string(line, prid.text, prid.bytes);
        }
        if (!ok) {
            g_error = "invalid UTF-8 in stored text";
            rc_out = 6;
            break;
        }
        line += "}\n";
        if (std::fwrite(line.data(), 1, line.size(), out) != line.size()) {
            g_error = "short write to output file";
            rc_out = 7;
            break;
        }
        ++count;
    }
    if (rc_out == 0 && rc != 101 /* SQLITE_DONE */) {
        g_error = api.errmsg(db);
        rc_out = 8;
    }
    api.finalize(st);
    api.close_v2(db);
    if (std::fclose(out) != 0 && rc_out == 0) {
        g_error = "close failed";
        rc_out = 9;
    }
    if (rc_out != 0) std::remove(out_path);
    *out_count = count;
    return rc_out;
}

}  // extern "C"
