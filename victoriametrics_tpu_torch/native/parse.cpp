// Native Prometheus exposition-format line parser.
//
// The reference parses ingest protocols in Go with hand-rolled scanners
// (lib/protoparser/prometheus/parser.go) that run at hundreds of MB/s; the
// Python line parser tops out near 100k rows/s and dominates HTTP ingest
// cost. This scanner extracts, per sample line, the SERIES KEY byte range
// (the `name{labels}` prefix, quote-aware), the float value and the
// optional millisecond timestamp. Label decomposition is deferred to the
// slow path: the storage layer keys its TSID cache on the raw series bytes,
// so a cache hit never materializes labels at all (the
// MarshaledMetricNameRaw fast path of storage.go:1874, taken to its
// logical end).
//
// Build: linked with codec.cpp into one library by
// victoriametrics_tpu_torch/native/__init__.py (g++ on first use, into
// victoriametrics_tpu_torch/_build/).

#include <cstdint>
#include <cstdlib>
#include <cstring>

extern "C" {

// Parses prometheus text exposition lines from data[0..len).
// For each accepted sample row i:
//   key_off[i], key_len[i]  — byte range of the series key within data
//   values[i]               — sample value (strtod semantics: inf/nan ok)
//   tss[i]                  — timestamp in ms, or INT64_MIN when absent
// Returns the number of rows written (<= max_rows); stops early when
// max_rows is reached (caller re-invokes with a bigger buffer).
int64_t vm_parse_prom(const char* data, int64_t len,
                      int32_t* key_off, int32_t* key_len,
                      double* values, int64_t* tss, int64_t max_rows) {
    int64_t n = 0;
    int64_t i = 0;
    while (i < len && n < max_rows) {
        // line bounds
        int64_t eol = i;
        while (eol < len && data[eol] != '\n') eol++;
        int64_t a = i, b = eol;
        i = eol + 1;
        // trim
        while (a < b && (data[a] == ' ' || data[a] == '\t' ||
                         data[a] == '\r')) a++;
        while (b > a && (data[b - 1] == ' ' || data[b - 1] == '\t' ||
                         data[b - 1] == '\r')) b--;
        if (a >= b || data[a] == '#') continue;
        // series key: up to the quote-aware closing '}' when a '{' appears
        // before any whitespace, else up to the first whitespace
        int64_t k = a;
        int64_t key_end = -1;
        while (k < b && data[k] != ' ' && data[k] != '\t' &&
               data[k] != '{') k++;
        if (k < b && data[k] == '{') {
            bool in_q = false;
            int64_t j = k + 1;
            for (; j < b; j++) {
                char c = data[j];
                if (in_q) {
                    if (c == '\\') { j++; continue; }
                    if (c == '"') in_q = false;
                } else if (c == '"') {
                    in_q = true;
                } else if (c == '}') {
                    break;
                }
            }
            if (j >= b) continue;  // unterminated label set
            key_end = j + 1;
        } else {
            key_end = k;
        }
        if (key_end <= a) continue;
        // value
        int64_t v = key_end;
        while (v < b && (data[v] == ' ' || data[v] == '\t')) v++;
        if (v >= b) continue;  // no value field
        char buf[64];
        int64_t vend = v;
        while (vend < b && data[vend] != ' ' && data[vend] != '\t') vend++;
        int64_t vlen = vend - v;
        if (vlen <= 0 || vlen >= (int64_t)sizeof(buf)) continue;
        memcpy(buf, data + v, vlen);
        buf[vlen] = 0;
        char* endp = nullptr;
        double val = strtod(buf, &endp);
        if (endp == buf || *endp != 0) continue;  // not a number
        // optional timestamp (ms; may be float like 1.7e12)
        int64_t ts = INT64_MIN;
        int64_t t = vend;
        while (t < b && (data[t] == ' ' || data[t] == '\t')) t++;
        if (t < b) {
            int64_t tend = t;
            while (tend < b && data[tend] != ' ' && data[tend] != '\t')
                tend++;
            int64_t tlen = tend - t;
            if (tlen > 0 && tlen < (int64_t)sizeof(buf)) {
                memcpy(buf, data + t, tlen);
                buf[tlen] = 0;
                char* tp = nullptr;
                double tsd = strtod(buf, &tp);
                if (tp != buf && *tp == 0) ts = (int64_t)tsd;
            }
        }
        key_off[n] = (int32_t)a;
        key_len[n] = (int32_t)(key_end - a);
        values[n] = val;
        tss[n] = ts;
        n++;
    }
    return n;
}

}  // extern "C"
