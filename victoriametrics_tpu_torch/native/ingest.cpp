// Native ingest kernels: snappy decode, remote-write protobuf parse,
// influx line-protocol parse, and a raw-key -> dense-id hash map.
//
// The reference treats every ingest protocol as a hot path with pooled
// zero-copy scanners (lib/protoparser/promremotewrite/parser.go,
// lib/protoparser/influx/parser.go, lib/easyproto); the Python parsers top
// out near 20k rows/s and dominate ingest cost. These kernels parse whole
// request bodies in one call and emit COLUMNAR rows:
//   keybuf[key_off[i] : key_off[i]+key_len[i]]  canonical `name{l="v"}` key
//   values[i], tss[i]
// so the Python layer never touches individual rows. The key map assigns
// dense int ids to distinct key byte-strings (vm_keymap_resolve), letting
// storage keep per-id TSID/date state in numpy arrays and resolve an
// entire batch with one native call (the MarshaledMetricNameRaw fast path
// of the reference's storage.go:1874, vectorized).
//
// Fallback contract: parsers return -1 when the payload contains shapes
// the canonical text key cannot round-trip (label names with text-format
// metacharacters, missing __name__); callers fall back to the Python
// parser for the whole body. -2 means an output buffer was too small
// (caller retries with a bigger one).
//
// Build: linked with codec.cpp into one library by
// victoriametrics_tpu_torch/native/__init__.py (g++ on first use, into
// victoriametrics_tpu_torch/_build/).

#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

// ---------------------------------------------------------------- snappy --

inline bool read_uvarint(const uint8_t* p, int64_t len, int64_t* pos,
                         uint64_t* out) {
    uint64_t v = 0;
    int shift = 0;
    while (*pos < len && shift < 64) {
        uint8_t b = p[(*pos)++];
        v |= (uint64_t)(b & 0x7f) << shift;
        if (!(b & 0x80)) { *out = v; return true; }
        shift += 7;
    }
    return false;
}

}  // namespace

extern "C" {

// Uncompressed length of a snappy block, or -1 if malformed.
int64_t vm_snappy_uncompressed_len(const uint8_t* src, int64_t len) {
    int64_t pos = 0;
    uint64_t n;
    if (!read_uvarint(src, len, &pos, &n)) return -1;
    return (int64_t)n;
}

// Snappy block-format decompress. Returns bytes written or -1 on malformed
// input / undersized dst.
int64_t vm_snappy_uncompress(const uint8_t* src, int64_t len,
                             uint8_t* dst, int64_t dst_cap) {
    int64_t pos = 0;
    uint64_t want;
    if (!read_uvarint(src, len, &pos, &want)) return -1;
    if ((int64_t)want > dst_cap) return -1;
    int64_t d = 0;
    while (pos < len) {
        uint8_t tag = src[pos++];
        uint32_t kind = tag & 3;
        if (kind == 0) {  // literal
            int64_t n = (tag >> 2) + 1;
            if (n > 60) {
                int extra = (int)(n - 60);
                if (pos + extra > len) return -1;
                uint32_t v = 0;
                for (int i = 0; i < extra; i++) v |= (uint32_t)src[pos + i] << (8 * i);
                pos += extra;
                n = (int64_t)v + 1;
            }
            if (pos + n > len || d + n > dst_cap) return -1;
            memcpy(dst + d, src + pos, n);
            pos += n;
            d += n;
        } else {
            int64_t n, off;
            if (kind == 1) {
                if (pos >= len) return -1;
                n = ((tag >> 2) & 7) + 4;
                off = ((int64_t)(tag >> 5) << 8) | src[pos++];
            } else if (kind == 2) {
                if (pos + 2 > len) return -1;
                n = (tag >> 2) + 1;
                off = (int64_t)src[pos] | ((int64_t)src[pos + 1] << 8);
                pos += 2;
            } else {
                if (pos + 4 > len) return -1;
                n = (tag >> 2) + 1;
                off = (int64_t)src[pos] | ((int64_t)src[pos + 1] << 8) |
                      ((int64_t)src[pos + 2] << 16) | ((int64_t)src[pos + 3] << 24);
                pos += 4;
            }
            if (off <= 0 || off > d || d + n > dst_cap) return -1;
            // copies may overlap (run-length encoding): byte loop when close
            if (off >= n) {
                memcpy(dst + d, dst + d - off, n);
            } else {
                for (int64_t i = 0; i < n; i++) dst[d + i] = dst[d + i - off];
            }
            d += n;
        }
    }
    return d == (int64_t)want ? d : -1;
}

}  // extern "C"

namespace {

// -------------------------------------------------- canonical key writing --

// Label NAMES and metric names must survive a prometheus-text round-trip
// (ingest/parsers.labels_from_series_key re-parses the key on TSID-cache
// misses), so text metacharacters in them force the Python fallback.
inline bool name_ok(const uint8_t* p, int64_t n) {
    if (n == 0) return false;
    for (int64_t i = 0; i < n; i++) {
        uint8_t c = p[i];
        if (c == '{' || c == '}' || c == '"' || c == '=' || c == ',' ||
            c == ' ' || c == '\t' || c == '\n' || c == '\r' || c == '\\')
            return false;
    }
    return true;
}

// Escapes a label VALUE into out (prometheus text escaping). Returns bytes
// written or -1 when cap is exhausted.
inline int64_t write_escaped(const uint8_t* p, int64_t n, uint8_t* out,
                             int64_t cap) {
    int64_t w = 0;
    for (int64_t i = 0; i < n; i++) {
        uint8_t c = p[i];
        if (c == '\\' || c == '"') {
            if (w + 2 > cap) return -1;
            out[w++] = '\\';
            out[w++] = c;
        } else if (c == '\n') {
            if (w + 2 > cap) return -1;
            out[w++] = '\\';
            out[w++] = 'n';
        } else {
            if (w + 1 > cap) return -1;
            out[w++] = c;
        }
    }
    return w;
}

struct Span { const uint8_t* p; int64_t n; };

// Writes `name{k1="v1",...}` (no braces when no labels). Returns bytes
// written or -1 (cap exhausted).
inline int64_t write_key(const Span& name, const Span* lk, const Span* lv,
                         int nlabels, uint8_t* out, int64_t cap) {
    int64_t w = 0;
    if (name.n > cap) return -1;
    memcpy(out, name.p, name.n);
    w = name.n;
    if (nlabels == 0) return w;
    if (w + 1 > cap) return -1;
    out[w++] = '{';
    for (int i = 0; i < nlabels; i++) {
        if (i) {
            if (w + 1 > cap) return -1;
            out[w++] = ',';
        }
        if (w + lk[i].n + 2 > cap) return -1;
        memcpy(out + w, lk[i].p, lk[i].n);
        w += lk[i].n;
        out[w++] = '=';
        out[w++] = '"';
        int64_t e = write_escaped(lv[i].p, lv[i].n, out + w, cap - w);
        if (e < 0) return -1;
        w += e;
        if (w + 1 > cap) return -1;
        out[w++] = '"';
    }
    if (w + 1 > cap) return -1;
    out[w++] = '}';
    return w;
}

// ------------------------------------------------------------- protobuf --

struct PbReader {
    const uint8_t* p;
    int64_t len, pos;
    bool ok;

    uint64_t uvarint() {
        uint64_t v;
        if (!read_uvarint(p, len, &pos, &v)) { ok = false; return 0; }
        return v;
    }
    // Returns field number, sets wire type; false at end / error.
    bool field(uint32_t* fnum, uint32_t* wt) {
        if (pos >= len || !ok) return false;
        uint64_t tag = uvarint();
        if (!ok) return false;
        *fnum = (uint32_t)(tag >> 3);
        *wt = (uint32_t)(tag & 7);
        return true;
    }
    Span bytes_field() {  // wire type 2
        uint64_t n = uvarint();
        if (!ok || pos + (int64_t)n > len) { ok = false; return {nullptr, 0}; }
        Span s{p + pos, (int64_t)n};
        pos += (int64_t)n;
        return s;
    }
    uint64_t fixed64() {
        if (pos + 8 > len) { ok = false; return 0; }
        uint64_t v;
        memcpy(&v, p + pos, 8);
        pos += 8;
        return v;
    }
    void skip(uint32_t wt) {
        switch (wt) {
            case 0: uvarint(); break;
            case 1: pos += 8; if (pos > len) ok = false; break;
            case 2: bytes_field(); break;
            case 5: pos += 4; if (pos > len) ok = false; break;
            default: ok = false;
        }
    }
};

constexpr int kMaxLabels = 128;
constexpr int64_t kTsAbsent = INT64_MIN;

}  // namespace

extern "C" {

// Parses a prompb.WriteRequest (uncompressed) into columnar rows.
// Sample timestamps of 0/absent become default_ts (the HTTP handler's
// `ts or now`). Returns rows written, -1 = fall back to the Python
// parser, -2 = keybuf too small, -3 = max_rows too small.
int64_t vm_parse_rw(const uint8_t* data, int64_t len, int64_t default_ts,
                    uint8_t* keybuf, int64_t keybuf_cap,
                    int64_t* key_off, int64_t* key_len,
                    double* values, int64_t* tss, int64_t max_rows) {
    PbReader top{data, len, 0, true};
    int64_t n = 0, kw = 0;
    uint32_t fnum, wt;
    Span lk[kMaxLabels], lv[kMaxLabels];
    // per-series sample buffer (order of labels/samples fields is free)
    int64_t scap = 1024;
    double* sv = (double*)malloc(scap * sizeof(double));
    int64_t* st = (int64_t*)malloc(scap * sizeof(int64_t));
    if (!sv || !st) { free(sv); free(st); return -1; }
    while (top.field(&fnum, &wt)) {
        if (!(fnum == 1 && wt == 2)) { top.skip(wt); continue; }
        PbReader ts_r{nullptr, 0, 0, true};
        {
            Span s = top.bytes_field();
            if (!top.ok) break;
            ts_r = {s.p, s.n, 0, true};
        }
        int nlabels = 0;
        int64_t nsamples = 0;
        Span name{nullptr, 0};
        bool bad = false;
        uint32_t f2, w2;
        while (ts_r.field(&f2, &w2)) {
            if (f2 == 1 && w2 == 2) {  // Label
                Span lb = ts_r.bytes_field();
                if (!ts_r.ok) break;
                PbReader lr{lb.p, lb.n, 0, true};
                Span ln{nullptr, 0}, lval{nullptr, 0};
                uint32_t f3, w3;
                while (lr.field(&f3, &w3)) {
                    if (f3 == 1 && w3 == 2) ln = lr.bytes_field();
                    else if (f3 == 2 && w3 == 2) lval = lr.bytes_field();
                    else lr.skip(w3);
                }
                if (!lr.ok) { bad = true; break; }
                if (ln.n == 8 && memcmp(ln.p, "__name__", 8) == 0) {
                    name = lval;
                } else {
                    if (nlabels >= kMaxLabels || !name_ok(ln.p, ln.n)) {
                        bad = true;
                        break;
                    }
                    lk[nlabels] = ln;
                    lv[nlabels] = lval;
                    nlabels++;
                }
            } else if (f2 == 2 && w2 == 2) {  // Sample
                Span sb = ts_r.bytes_field();
                if (!ts_r.ok) break;
                PbReader sr{sb.p, sb.n, 0, true};
                double val = 0;
                int64_t t = 0;
                uint32_t f3, w3;
                while (sr.field(&f3, &w3)) {
                    if (f3 == 1 && w3 == 1) {
                        uint64_t bits = sr.fixed64();
                        memcpy(&val, &bits, 8);
                    } else if (f3 == 2 && w3 == 0) {
                        t = (int64_t)sr.uvarint();
                    } else {
                        sr.skip(w3);
                    }
                }
                if (!sr.ok) { bad = true; break; }
                if (nsamples == scap) {
                    scap *= 2;
                    double* nsv = (double*)realloc(sv, scap * sizeof(double));
                    int64_t* nst = (int64_t*)realloc(st, scap * sizeof(int64_t));
                    if (!nsv || !nst) { free(nsv ? nsv : sv); free(nst ? nst : st); return -1; }
                    sv = nsv;
                    st = nst;
                }
                sv[nsamples] = val;
                st[nsamples] = t;
                nsamples++;
            } else {
                ts_r.skip(w2);
            }
        }
        if (bad || !ts_r.ok || !name_ok(name.p, name.n)) {
            free(sv); free(st);
            return -1;  // fallback: Python path decides what to do
        }
        if (nsamples == 0) continue;
        int64_t klen = write_key(name, lk, lv, nlabels, keybuf + kw,
                                 keybuf_cap - kw);
        if (klen < 0) { free(sv); free(st); return -2; }
        if (n + nsamples > max_rows) { free(sv); free(st); return -3; }
        for (int64_t i = 0; i < nsamples; i++) {
            key_off[n] = kw;
            key_len[n] = klen;
            values[n] = sv[i];
            tss[n] = st[i] == 0 ? default_ts : st[i];
            n++;
        }
        kw += klen;
    }
    free(sv);
    free(st);
    if (!top.ok) return -1;
    return n;
}

}  // extern "C"

namespace {

// --------------------------------------------------------------- influx --

// Influx escape: `\X` protects X when X is one of , = space \ (tag/field
// sections). Unescape into tmp; returns length or -1 (too long).
inline int64_t influx_unescape(const uint8_t* p, int64_t n, uint8_t* out,
                               int64_t cap) {
    int64_t w = 0;
    for (int64_t i = 0; i < n; i++) {
        if (p[i] == '\\' && i + 1 < n &&
            (p[i + 1] == ',' || p[i + 1] == '=' || p[i + 1] == ' ' ||
             p[i + 1] == '\\')) {
            i++;
        }
        if (w >= cap) return -1;
        out[w++] = p[i];
    }
    return w;
}

// Scans to the next unescaped `sep` (space/comma/=) outside quotes when
// honor_quotes. Returns index of sep within [i, n) or n.
inline int64_t scan_to(const uint8_t* p, int64_t n, int64_t i, uint8_t sep,
                       bool honor_quotes) {
    bool q = false;
    while (i < n) {
        uint8_t c = p[i];
        if (c == '\\' && i + 1 < n) { i += 2; continue; }
        if (honor_quotes && c == '"') q = !q;
        else if (c == sep && !q) return i;
        i++;
    }
    return n;
}

// Numeric influx field value -> *out. Returns: 1 parsed, 0 skip (string /
// non-numeric).
inline int influx_field_value(const uint8_t* p, int64_t n, double* out) {
    if (n == 0) return 0;
    if (p[0] == '"') return 0;  // string field: not a sample
    if ((n == 1 && (p[0] == 't' || p[0] == 'T')) ||
        (n == 4 && (memcmp(p, "true", 4) == 0 || memcmp(p, "True", 4) == 0 ||
                    memcmp(p, "TRUE", 4) == 0))) {
        *out = 1.0;
        return 1;
    }
    if ((n == 1 && (p[0] == 'f' || p[0] == 'F')) ||
        (n == 5 && (memcmp(p, "false", 5) == 0 || memcmp(p, "False", 5) == 0 ||
                    memcmp(p, "FALSE", 5) == 0))) {
        *out = 0.0;
        return 1;
    }
    if (p[n - 1] == 'i' || p[n - 1] == 'u') n--;
    if (n <= 0 || n >= 63) return 0;
    char buf[64];
    memcpy(buf, p, n);
    buf[n] = 0;
    char* endp = nullptr;
    double v = strtod(buf, &endp);
    if (endp != buf + n) return 0;
    *out = v;
    return 1;
}

constexpr int kMaxTags = 126;   // + db + __name__ headroom vs kMaxLabels
constexpr int kMaxFields = 256;

}  // namespace

extern "C" {

// Parses influx line protocol into columnar rows. Metric name is
// `{measurement}_{field}` (`measurement` alone for the `value` field); tags
// become labels with an optional leading db label. ts is ns -> ms
// (floor-divided); absent -> default_ts. Returns rows written, -1 = fall
// back to Python (metachar names, non-integer timestamps, oversized
// shapes), -2 = keybuf too small, -3 = max_rows too small.
int64_t vm_parse_influx(const uint8_t* data, int64_t len,
                        const uint8_t* db, int64_t db_len,
                        int64_t default_ts,
                        uint8_t* keybuf, int64_t keybuf_cap,
                        int64_t* key_off, int64_t* key_len,
                        double* values, int64_t* tss, int64_t max_rows) {
    int64_t n = 0, kw = 0;
    int64_t i = 0;
    // scratch for unescaped names/tags (bounded per line)
    static thread_local uint8_t* tmp = nullptr;
    static thread_local int64_t tmp_cap = 0;
    if (tmp_cap < 1 << 16) {
        free(tmp);
        tmp_cap = 1 << 16;
        tmp = (uint8_t*)malloc(tmp_cap);
        if (!tmp) { tmp_cap = 0; return -1; }
    }
    Span lk[kMaxLabels], lv[kMaxLabels];
    Span fk[kMaxFields];
    double fv[kMaxFields];
    while (i < len && n < max_rows) {
        int64_t eol = i;
        while (eol < len && data[eol] != '\n') eol++;
        int64_t a = i, b = eol;
        i = eol + 1;
        while (a < b && (data[a] == ' ' || data[a] == '\t' || data[a] == '\r')) a++;
        while (b > a && (data[b - 1] == ' ' || data[b - 1] == '\t' ||
                         data[b - 1] == '\r')) b--;
        if (a >= b || data[a] == '#') continue;
        // sections: key [space] fields [space] ts — first two unescaped,
        // quote-aware spaces split (parsers._parse_influx_line)
        int64_t s1 = scan_to(data, b, a, ' ', true);
        if (s1 >= b) continue;  // no fields section
        int64_t s2 = scan_to(data, b, s1 + 1, ' ', true);
        // timestamp
        int64_t ts = default_ts;
        if (s2 < b) {
            int64_t t0 = s2 + 1;
            while (t0 < b && data[t0] == ' ') t0++;
            if (t0 < b) {
                char buf[32];
                int64_t tn = b - t0;
                if (tn >= (int64_t)sizeof(buf)) return -1;
                memcpy(buf, data + t0, tn);
                buf[tn] = 0;
                char* endp = nullptr;
                long long tv = strtoll(buf, &endp, 10);
                if (endp != buf + tn) return -1;  // Python int() would raise
                // ns -> ms, floor semantics (Python // )
                ts = tv >= 0 ? tv / 1000000
                             : -((-tv + 999999) / 1000000);
            }
        }
        // measurement + tags
        int64_t tw = 0;  // tmp write cursor
        int64_t mend = scan_to(data, s1, a, ',', false);
        int64_t mn = influx_unescape(data + a, mend - a, tmp + tw, tmp_cap - tw);
        if (mn < 0) return -1;
        Span meas{tmp + tw, mn};
        tw += mn;
        if (!name_ok(meas.p, meas.n)) return -1;
        int ntags = 0;
        if (db_len > 0) {
            lk[ntags] = {(const uint8_t*)"db", 2};
            lv[ntags] = {db, db_len};
            ntags++;
        }
        int64_t tp = mend;
        while (tp < s1) {
            tp++;  // skip ','
            int64_t te = scan_to(data, s1, tp, ',', false);
            int64_t eq = scan_to(data, te, tp, '=', false);
            if (eq < te && eq + 1 < te) {  // skip empty values (parity)
                if (ntags >= kMaxTags) return -1;
                int64_t kn = influx_unescape(data + tp, eq - tp, tmp + tw,
                                             tmp_cap - tw);
                if (kn < 0) return -1;
                lk[ntags] = {tmp + tw, kn};
                tw += kn;
                if (!name_ok(lk[ntags].p, lk[ntags].n)) return -1;
                int64_t vn = influx_unescape(data + eq + 1, te - eq - 1,
                                             tmp + tw, tmp_cap - tw);
                if (vn < 0) return -1;
                lv[ntags] = {tmp + tw, vn};
                tw += vn;
                ntags++;
            }
            tp = te;
        }
        // fields
        int nfields = 0;
        int64_t fp = s1 + 1;
        int64_t fend = s2 < b ? s2 : b;
        while (fp < fend) {
            int64_t fe = scan_to(data, fend, fp, ',', true);
            int64_t eq = scan_to(data, fe, fp, '=', false);
            if (eq < fe) {
                double v;
                if (influx_field_value(data + eq + 1, fe - eq - 1, &v)) {
                    if (nfields >= kMaxFields) return -1;
                    int64_t kn = influx_unescape(data + fp, eq - fp, tmp + tw,
                                                 tmp_cap - tw);
                    if (kn < 0) return -1;
                    fk[nfields] = {tmp + tw, kn};
                    tw += kn;
                    fv[nfields] = v;
                    nfields++;
                }
            }
            fp = fe + 1;
        }
        // emit one row per numeric field
        for (int f = 0; f < nfields; f++) {
            Span name;
            uint8_t* nb = tmp + tw;
            if (fk[f].n == 5 && memcmp(fk[f].p, "value", 5) == 0) {
                name = meas;
            } else {
                if (tw + meas.n + 1 + fk[f].n > tmp_cap) return -1;
                memcpy(nb, meas.p, meas.n);
                nb[meas.n] = '_';
                memcpy(nb + meas.n + 1, fk[f].p, fk[f].n);
                name = {nb, meas.n + 1 + fk[f].n};
                tw += name.n;
            }
            if (!name_ok(name.p, name.n)) return -1;
            int64_t klen = write_key(name, lk, lv, ntags, keybuf + kw,
                                     keybuf_cap - kw);
            if (klen < 0) return -2;
            if (n >= max_rows) return -3;
            key_off[n] = kw;
            key_len[n] = klen;
            values[n] = fv[f];
            tss[n] = ts;
            kw += klen;
            n++;
        }
    }
    if (i < len) return -3;  // ran out of row capacity mid-body
    return n;
}

}  // extern "C"

namespace {

// --------------------------------------------------------------- keymap --

struct KeyMap {
    // open addressing, power-of-2 table of dense ids; arena owns key bytes
    int64_t* slots;       // id+1 (0 = empty)
    uint64_t cap, size;
    uint8_t* arena;
    int64_t arena_len, arena_cap;
    int64_t* offs;        // per id: offset into arena
    int32_t* lens;        // per id: key length
    uint64_t* hashes;     // per id: full hash
    int64_t ids_cap;
};

inline uint64_t fnv1a(const uint8_t* p, int64_t n) {
    uint64_t h = 1469598103934665603ULL;
    for (int64_t i = 0; i < n; i++) {
        h ^= p[i];
        h *= 1099511628211ULL;
    }
    return h;
}

bool km_grow(KeyMap* m) {
    uint64_t ncap = m->cap * 2;
    int64_t* ns = (int64_t*)calloc(ncap, sizeof(int64_t));
    if (!ns) return false;
    for (uint64_t i = 0; i < m->cap; i++) {
        int64_t id1 = m->slots[i];
        if (!id1) continue;
        uint64_t h = m->hashes[id1 - 1];
        uint64_t j = h & (ncap - 1);
        while (ns[j]) j = (j + 1) & (ncap - 1);
        ns[j] = id1;
    }
    free(m->slots);
    m->slots = ns;
    m->cap = ncap;
    return true;
}

}  // namespace

extern "C" {

int64_t vm_keymap_new() {
    KeyMap* m = (KeyMap*)calloc(1, sizeof(KeyMap));
    if (!m) return 0;
    m->cap = 1 << 16;
    m->slots = (int64_t*)calloc(m->cap, sizeof(int64_t));
    m->arena_cap = 1 << 20;
    m->arena = (uint8_t*)malloc(m->arena_cap);
    m->ids_cap = 1 << 14;
    m->offs = (int64_t*)malloc(m->ids_cap * sizeof(int64_t));
    m->lens = (int32_t*)malloc(m->ids_cap * sizeof(int32_t));
    m->hashes = (uint64_t*)malloc(m->ids_cap * sizeof(uint64_t));
    if (!m->slots || !m->arena || !m->offs || !m->lens || !m->hashes) {
        free(m->slots); free(m->arena); free(m->offs); free(m->lens);
        free(m->hashes); free(m);
        return 0;
    }
    return (int64_t)(intptr_t)m;
}

void vm_keymap_free(int64_t h) {
    KeyMap* m = (KeyMap*)(intptr_t)h;
    if (!m) return;
    free(m->slots);
    free(m->arena);
    free(m->offs);
    free(m->lens);
    free(m->hashes);
    free(m);
}

int64_t vm_keymap_size(int64_t h) {
    return ((KeyMap*)(intptr_t)h)->size;
}

// Resolves n keys (base[off[i]:off[i]+len[i]]) to dense ids (ids[i]).
// Unknown keys are ADDED with consecutive ids in first-occurrence order.
// Returns number of new ids, or -1 on allocation failure.
int64_t vm_keymap_resolve(int64_t handle, const uint8_t* base,
                          const int64_t* off, const int64_t* klen, int64_t n,
                          int64_t* ids) {
    KeyMap* m = (KeyMap*)(intptr_t)handle;
    int64_t added = 0;
    for (int64_t r = 0; r < n; r++) {
        const uint8_t* kp = base + off[r];
        int64_t kn = klen[r];
        uint64_t hsh = fnv1a(kp, kn);
        uint64_t j = hsh & (m->cap - 1);
        int64_t id = -1;
        while (m->slots[j]) {
            int64_t cand = m->slots[j] - 1;
            if (m->hashes[cand] == hsh && m->lens[cand] == kn &&
                memcmp(m->arena + m->offs[cand], kp, kn) == 0) {
                id = cand;
                break;
            }
            j = (j + 1) & (m->cap - 1);
        }
        if (id < 0) {
            // insert
            if (m->size == (uint64_t)m->ids_cap) {
                int64_t ncap = m->ids_cap * 2;
                int64_t* no = (int64_t*)realloc(m->offs, ncap * sizeof(int64_t));
                int32_t* nl = (int32_t*)realloc(m->lens, ncap * sizeof(int32_t));
                uint64_t* nh = (uint64_t*)realloc(m->hashes, ncap * sizeof(uint64_t));
                if (!no || !nl || !nh) {
                    if (no) m->offs = no;
                    if (nl) m->lens = nl;
                    if (nh) m->hashes = nh;
                    return -1;
                }
                m->offs = no; m->lens = nl; m->hashes = nh;
                m->ids_cap = ncap;
            }
            while (m->arena_len + kn > m->arena_cap) {
                int64_t ncap = m->arena_cap * 2;
                uint8_t* na = (uint8_t*)realloc(m->arena, ncap);
                if (!na) return -1;
                m->arena = na;
                m->arena_cap = ncap;
            }
            memcpy(m->arena + m->arena_len, kp, kn);
            id = (int64_t)m->size;
            m->offs[id] = m->arena_len;
            m->lens[id] = (int32_t)kn;
            m->hashes[id] = hsh;
            m->arena_len += kn;
            m->size++;
            m->slots[j] = id + 1;
            added++;
            if (m->size * 10 >= m->cap * 7) {
                if (!km_grow(m)) return -1;
            }
        }
        ids[r] = id;
    }
    return added;
}

}  // extern "C"
