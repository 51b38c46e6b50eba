// Native host codecs: bulk zigzag-varint + delta2 encode/decode.
//
// The reference's hot host loops are hand-tuned Go (lib/encoding/int.go
// varint bulk codecs, nearest_delta2.go) with its only native code being cgo
// zstd (SURVEY §2.9). Here the ingest/scan hot loops get a real native
// implementation, exposed through a C ABI consumed via ctypes
// (victoriametrics_tpu_torch/native/__init__.py, which builds this file
// with g++ on first use into victoriametrics_tpu_torch/_build/).
//
// All functions are thread-safe (no global state) and release-the-GIL safe
// (pure C, no Python API).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#include <dlfcn.h>

#ifdef VM_HAVE_ZSTD
#include <zstd.h>
#endif

// ---------------------------------------------------------------------------
// runtime payload codecs: zstd + zlib
//
// Compressed block payloads (MarshalType 5/6) are zstd frames when the
// Python side has a zstd binding and zlib streams otherwise
// (ops/compress.py falls back to stdlib zlib and sniffs the frame magic on
// read). Minimal containers ship libzstd.so.1 / libz.so.1 without the dev
// headers, so instead of requiring -lzstd at build time the needed entry
// points are resolved with dlopen on first use; a build against real
// headers (VM_HAVE_ZSTD) binds them directly. Everything is one-shot
// stateless API, safe from concurrent GIL-released callers.
// ---------------------------------------------------------------------------

namespace {

struct VmRtCodecs {
    // zstd one-shot API (resolved lazily; null = unavailable)
    size_t (*zd)(void*, size_t, const void*, size_t) = nullptr;
    unsigned (*zerr)(size_t) = nullptr;
    size_t (*zc)(void*, size_t, const void*, size_t, int) = nullptr;
    size_t (*zbound)(size_t) = nullptr;
    unsigned long long (*zsize)(const void*, size_t) = nullptr;
    // zlib one-shot inflate
    int (*inflate_buf)(unsigned char*, unsigned long*, const unsigned char*,
                       unsigned long) = nullptr;

    VmRtCodecs() {
#ifdef VM_HAVE_ZSTD
        zd = ZSTD_decompress;
        zerr = ZSTD_isError;
        zc = ZSTD_compress;
        zbound = ZSTD_compressBound;
        zsize = ZSTD_getFrameContentSize;
#else
        void* hz = dlopen("libzstd.so.1", RTLD_NOW | RTLD_LOCAL);
        if (!hz) hz = dlopen("libzstd.so", RTLD_NOW | RTLD_LOCAL);
        if (hz) {
            zd = reinterpret_cast<size_t (*)(void*, size_t, const void*,
                                             size_t)>(
                dlsym(hz, "ZSTD_decompress"));
            zerr = reinterpret_cast<unsigned (*)(size_t)>(
                dlsym(hz, "ZSTD_isError"));
            zc = reinterpret_cast<size_t (*)(void*, size_t, const void*,
                                             size_t, int)>(
                dlsym(hz, "ZSTD_compress"));
            zbound = reinterpret_cast<size_t (*)(size_t)>(
                dlsym(hz, "ZSTD_compressBound"));
            zsize = reinterpret_cast<unsigned long long (*)(const void*,
                                                            size_t)>(
                dlsym(hz, "ZSTD_getFrameContentSize"));
            if (!zd || !zerr) {  // partial API: treat as absent
                zd = nullptr;
                zc = nullptr;
            }
        }
#endif
        void* hl = dlopen("libz.so.1", RTLD_NOW | RTLD_LOCAL);
        if (!hl) hl = dlopen("libz.so", RTLD_NOW | RTLD_LOCAL);
        if (hl) {
            inflate_buf = reinterpret_cast<int (*)(
                unsigned char*, unsigned long*, const unsigned char*,
                unsigned long)>(dlsym(hl, "uncompress"));
        }
    }
};

const VmRtCodecs& vm_rt() {
    static VmRtCodecs c;  // C++11 thread-safe init
    return c;
}

// Inflate one compressed block payload into dst[0:cap], sniffing the
// producer exactly like ops/compress.py decompress(): zstd frames start
// 28 B5 2F FD, anything else is the zlib fallback stream. Returns
// decompressed size, or -1 (codec unavailable / malformed / overflow).
int64_t vm_inflate(const uint8_t* p, int64_t sz, uint8_t* dst, int64_t cap) {
    const VmRtCodecs& c = vm_rt();
    if (sz >= 4 && p[0] == 0x28 && p[1] == 0xb5 && p[2] == 0x2f &&
        p[3] == 0xfd) {
        if (!c.zd) return -1;
        size_t got = c.zd(dst, (size_t)cap, p, (size_t)sz);
        if (c.zerr(got)) return -1;
        return (int64_t)got;
    }
    if (!c.inflate_buf) return -1;
    unsigned long dlen = (unsigned long)cap;
    if (c.inflate_buf(dst, &dlen, p, (unsigned long)sz) != 0) return -1;
    return (int64_t)dlen;
}

}  // namespace

extern "C" {

// Bitmask of payload codecs the native decode path can inflate: bit 0 =
// zstd frames, bit 1 = zlib streams. The Python gate peeks each
// compressed block's leading byte and checks the matching bit.
int32_t vm_decompress_caps(void) {
    const VmRtCodecs& c = vm_rt();
    return (c.zd ? 1 : 0) | (c.inflate_buf ? 2 : 0);
}

// 1 when zstd frames decode natively (built against libzstd OR resolved
// from libzstd.so.1 at runtime); historical name kept for the ctypes ABI.
int32_t vm_has_zstd(void) {
    return vm_decompress_caps() & 1;
}

// One-shot zstd compress/decompress for ops/compress.py when the Python
// `zstandard` binding is absent but the runtime library exists. Returns
// bytes written, or -1 (unavailable / error / cap exceeded).
int64_t vm_zstd_compress_bound(int64_t n) {
    const VmRtCodecs& c = vm_rt();
    if (!c.zbound) return -1;
    return (int64_t)c.zbound((size_t)n);
}

int64_t vm_zstd_compress(const uint8_t* src, int64_t n, uint8_t* dst,
                         int64_t cap, int32_t level) {
    const VmRtCodecs& c = vm_rt();
    if (!c.zc) return -1;
    size_t got = c.zc(dst, (size_t)cap, src, (size_t)n, (int)level);
    if (c.zerr(got)) return -1;
    return (int64_t)got;
}

// Claimed decompressed size of a zstd frame; -1 = unknown/error (callers
// must then refuse rather than guess — the size caps allocation).
int64_t vm_zstd_content_size(const uint8_t* src, int64_t n) {
    const VmRtCodecs& c = vm_rt();
    if (!c.zsize) return -1;
    unsigned long long s = c.zsize(src, (size_t)n);
    if (s == (unsigned long long)-1 || s == (unsigned long long)-2)
        return -1;
    return (int64_t)s;
}

int64_t vm_zstd_decompress(const uint8_t* src, int64_t n, uint8_t* dst,
                           int64_t cap) {
    const VmRtCodecs& c = vm_rt();
    if (!c.zd) return -1;
    size_t got = c.zd(dst, (size_t)cap, src, (size_t)n);
    if (c.zerr(got)) return -1;
    return (int64_t)got;
}

// ---------------------------------------------------------------------------
// zigzag varint
// ---------------------------------------------------------------------------

// Encode n int64s as zigzag varints into out (caller provides >= 10*n bytes).
// Returns bytes written.
int64_t vm_varint_encode(const int64_t* vals, int64_t n, uint8_t* out) {
    uint8_t* p = out;
    for (int64_t i = 0; i < n; i++) {
        uint64_t u = ((uint64_t)vals[i] << 1) ^ (uint64_t)(vals[i] >> 63);
        while (u >= 0x80) {
            *p++ = (uint8_t)(u) | 0x80;
            u >>= 7;
        }
        *p++ = (uint8_t)u;
    }
    return (int64_t)(p - out);
}

// Decode up to max_vals zigzag varints from data[0:len]. Returns number of
// values decoded, or -1 on malformed input (truncated / overlong varint).
int64_t vm_varint_decode(const uint8_t* data, int64_t len, int64_t* out,
                         int64_t max_vals) {
    const uint8_t* p = data;
    const uint8_t* end = data + len;
    int64_t count = 0;
    while (p < end && count < max_vals) {
        uint64_t u = 0;
        int shift = 0;
        for (;;) {
            if (p >= end || shift > 63) return -1;
            uint8_t b = *p++;
            u |= (uint64_t)(b & 0x7F) << shift;
            if (!(b & 0x80)) break;
            shift += 7;
        }
        out[count++] = (int64_t)(u >> 1) ^ -(int64_t)(u & 1);
    }
    if (p != end && count < max_vals) return -1;
    return count;
}

// ---------------------------------------------------------------------------
// delta2 (double-delta) + varint, fused: the block encode/decode hot path
// ---------------------------------------------------------------------------

// vals[0..n) -> first, first_delta, varint(d2 stream) in out.
// Returns payload bytes written; first/first_delta via out params.
int64_t vm_delta2_encode(const int64_t* vals, int64_t n, uint8_t* out,
                         int64_t* first, int64_t* first_delta) {
    if (n < 2) return -1;
    *first = vals[0];
    int64_t prev_d = (int64_t)((uint64_t)vals[1] - (uint64_t)vals[0]);
    *first_delta = prev_d;
    uint8_t* p = out;
    for (int64_t i = 2; i < n; i++) {
        int64_t d = (int64_t)((uint64_t)vals[i] - (uint64_t)vals[i - 1]);
        int64_t d2 = (int64_t)((uint64_t)d - (uint64_t)prev_d);
        prev_d = d;
        uint64_t u = ((uint64_t)d2 << 1) ^ (uint64_t)(d2 >> 63);
        while (u >= 0x80) {
            *p++ = (uint8_t)(u) | 0x80;
            u >>= 7;
        }
        *p++ = (uint8_t)u;
    }
    return (int64_t)(p - out);
}

// Inverse: reconstruct n values from first, first_delta and the d2 varint
// stream. Returns n on success, -1 on malformed input.
int64_t vm_delta2_decode(const uint8_t* data, int64_t len, int64_t first,
                         int64_t first_delta, int64_t* out, int64_t n) {
    if (n < 1) return -1;
    out[0] = first;
    if (n == 1) return 1;
    int64_t v = first;
    int64_t d = first_delta;
    const uint8_t* p = data;
    const uint8_t* end = data + len;
    v = (int64_t)((uint64_t)v + (uint64_t)d);
    out[1] = v;
    for (int64_t i = 2; i < n; i++) {
        uint64_t u = 0;
        int shift = 0;
        for (;;) {
            if (p >= end || shift > 63) return -1;
            uint8_t b = *p++;
            u |= (uint64_t)(b & 0x7F) << shift;
            if (!(b & 0x80)) break;
            shift += 7;
        }
        int64_t d2 = (int64_t)(u >> 1) ^ -(int64_t)(u & 1);
        d = (int64_t)((uint64_t)d + (uint64_t)d2);
        v = (int64_t)((uint64_t)v + (uint64_t)d);
        out[i] = v;
    }
    return (p == end) ? n : -1;
}

// ---------------------------------------------------------------------------
// delta1 (single delta) + varint
// ---------------------------------------------------------------------------

int64_t vm_delta_encode(const int64_t* vals, int64_t n, uint8_t* out,
                        int64_t* first) {
    if (n < 1) return -1;
    *first = vals[0];
    uint8_t* p = out;
    for (int64_t i = 1; i < n; i++) {
        int64_t d = (int64_t)((uint64_t)vals[i] - (uint64_t)vals[i - 1]);
        uint64_t u = ((uint64_t)d << 1) ^ (uint64_t)(d >> 63);
        while (u >= 0x80) {
            *p++ = (uint8_t)(u) | 0x80;
            u >>= 7;
        }
        *p++ = (uint8_t)u;
    }
    return (int64_t)(p - out);
}

int64_t vm_delta_decode(const uint8_t* data, int64_t len, int64_t first,
                        int64_t* out, int64_t n) {
    if (n < 1) return -1;
    out[0] = first;
    int64_t v = first;
    const uint8_t* p = data;
    const uint8_t* end = data + len;
    for (int64_t i = 1; i < n; i++) {
        uint64_t u = 0;
        int shift = 0;
        for (;;) {
            if (p >= end || shift > 63) return -1;
            uint8_t b = *p++;
            u |= (uint64_t)(b & 0x7F) << shift;
            if (!(b & 0x80)) break;
            shift += 7;
        }
        int64_t d = (int64_t)(u >> 1) ^ -(int64_t)(u & 1);
        v = (int64_t)((uint64_t)v + (uint64_t)d);
        out[i] = v;
    }
    return (p == end) ? n : -1;
}


// ---------------------------------------------------------------------------
// batched block marshal: type choice + encode for K blocks in one call
// ---------------------------------------------------------------------------

// Marshal types (mirror ops/encoding.py MarshalType)
#define VM_MT_CONST 1
#define VM_MT_DELTA_CONST 2
#define VM_MT_NEAREST_DELTA 3
#define VM_MT_NEAREST_DELTA2 4

// For each block i with values vals[offsets[i]..offsets[i+1]):
// choose CONST / DELTA_CONST / NEAREST_DELTA (gauge: >1/8 negative deltas)
// / NEAREST_DELTA2 exactly like ops/encoding.py marshal_int64_array, encode
// the payload contiguously into out, and record (type, first_value,
// payload_len). Returns total bytes written, or -1 when out_cap would be
// exceeded. offsets has n_blocks+1 entries.
int64_t vm_marshal_i64_many(const int64_t* vals, const int64_t* offsets,
                            int64_t n_blocks, uint8_t* out, int64_t out_cap,
                            int32_t* types, int64_t* firsts, int64_t* lens) {
    int64_t pos = 0;
    for (int64_t i = 0; i < n_blocks; i++) {
        const int64_t* v = vals + offsets[i];
        int64_t n = offsets[i + 1] - offsets[i];
        if (n <= 0) return -1;
        // worst case: 10 bytes per varint
        if (pos + (n + 1) * 10 > out_cap) return -1;
        bool is_const = true;
        for (int64_t j = 1; j < n; j++) {
            if (v[j] != v[0]) { is_const = false; break; }
        }
        if (is_const) {
            types[i] = VM_MT_CONST;
            firsts[i] = v[0];
            lens[i] = 0;
            continue;
        }
        // delta-const (wrapping two's-complement deltas, like np.int64)
        if (n >= 2) {
            uint64_t d0 = (uint64_t)v[1] - (uint64_t)v[0];
            bool dconst = true;
            for (int64_t j = 2; j < n; j++) {
                if ((uint64_t)v[j] - (uint64_t)v[j - 1] != d0) {
                    dconst = false;
                    break;
                }
            }
            if (dconst) {
                int64_t d = (int64_t)d0;
                int64_t len = vm_varint_encode(&d, 1, out + pos);
                types[i] = VM_MT_DELTA_CONST;
                firsts[i] = v[0];
                lens[i] = len;
                pos += len;
                continue;
            }
        }
        int64_t neg = 0;
        for (int64_t j = 1; j < n; j++) {
            if (v[j] < v[j - 1]) neg++;
        }
        if (neg * 8 > n) {
            // gauge: first-order deltas
            int64_t first;
            int64_t len = vm_delta_encode(v, n, out + pos, &first);
            types[i] = VM_MT_NEAREST_DELTA;
            firsts[i] = first;
            lens[i] = len;
            pos += len;
        } else {
            // counter: varint(first_delta) + delta2 stream
            int64_t first, first_delta;
            uint8_t tmp[10];
            int64_t d2len = vm_delta2_encode(v, n, out + pos, &first,
                                             &first_delta);
            int64_t fdlen = vm_varint_encode(&first_delta, 1, tmp);
            // shift payload right to prepend the first_delta varint
            memmove(out + pos + fdlen, out + pos, d2len);
            memcpy(out + pos, tmp, fdlen);
            types[i] = VM_MT_NEAREST_DELTA2;
            firsts[i] = first;
            lens[i] = fdlen + d2len;
            pos += fdlen + d2len;
        }
    }
    return pos;
}

// ---------------------------------------------------------------------------
// batched block decode: the cold-query scan hot path
// ---------------------------------------------------------------------------

#define VM_MT_ZSTD_NEAREST_DELTA 5
#define VM_MT_ZSTD_NEAREST_DELTA2 6

// Decode one plain (non-zstd) payload into out[0..n). Returns n or -1.
static int64_t vm_decode_plain(const uint8_t* p, int64_t sz, int32_t mt,
                               int64_t first, int64_t n, int64_t* out) {
    switch (mt) {
    case VM_MT_CONST:
        for (int64_t i = 0; i < n; i++) out[i] = first;
        return n;
    case VM_MT_DELTA_CONST: {
        int64_t d;
        if (vm_varint_decode(p, sz, &d, 1) != 1) return -1;
        int64_t v = first;
        for (int64_t i = 0; i < n; i++) {
            out[i] = v;
            v = (int64_t)((uint64_t)v + (uint64_t)d);
        }
        return n;
    }
    case VM_MT_NEAREST_DELTA:
        return vm_delta_decode(p, sz, first, out, n);
    case VM_MT_NEAREST_DELTA2: {
        if (n == 1) { out[0] = first; return 1; }
        // leading varint = first_delta, remainder = d2 stream
        const uint8_t* q = p;
        const uint8_t* end = p + sz;
        uint64_t u = 0;
        int shift = 0;
        for (;;) {
            if (q >= end || shift > 63) return -1;
            uint8_t b = *q++;
            u |= (uint64_t)(b & 0x7F) << shift;
            if (!(b & 0x80)) break;
            shift += 7;
        }
        int64_t fd = (int64_t)(u >> 1) ^ -(int64_t)(u & 1);
        return vm_delta2_decode(q, (int64_t)(end - q), first, fd, out, n);
    }
    default:
        return -1;
    }
}

// Decode K blocks in one call. Block i's payload lives at base[off[i]..
// off[i]+sz[i]) (zstd-compressed for types 5/6), decodes to cnt[i] int64s
// written contiguously into out (caller lays out offsets as cumsum(cnt)).
// validate_ts != 0 additionally clamps decoded sequences of the lossy
// UNcompressed types (3/4) to be non-decreasing, mirroring
// ops/encoding.py unmarshal_timestamps needs_validation.
// Returns total values decoded, or -(i+1) when block i is malformed.
int64_t vm_decode_blocks(const uint8_t* base, const int64_t* off,
                         const int64_t* sz, const int32_t* mt,
                         const int64_t* first, const int64_t* cnt,
                         int64_t k, int64_t* out, int32_t validate_ts) {
    int64_t pos = 0;
    std::vector<uint8_t> scratch;
    for (int64_t i = 0; i < k; i++) {
        int32_t t = mt[i];
        const uint8_t* p = base + off[i];
        int64_t n = cnt[i];
        int64_t s = sz[i];
        if (n <= 0) return -(i + 1);
        int64_t r;
        if (t == VM_MT_ZSTD_NEAREST_DELTA || t == VM_MT_ZSTD_NEAREST_DELTA2) {
            // decompressed payload is <= 10 bytes per varint (+lead varint)
            size_t cap = (size_t)(n + 1) * 10 + 16;
            if (scratch.size() < cap) scratch.resize(cap);
            int64_t got = vm_inflate(p, s, scratch.data(), (int64_t)cap);
            if (got < 0) return -(i + 1);
            r = vm_decode_plain(scratch.data(), got, t - 2, first[i],
                                n, out + pos);
        } else {
            r = vm_decode_plain(p, s, t, first[i], n, out + pos);
        }
        if (r != n) return -(i + 1);
        if (validate_ts &&
            (t == VM_MT_NEAREST_DELTA || t == VM_MT_NEAREST_DELTA2)) {
            int64_t* o = out + pos;
            for (int64_t j = 1; j < n; j++) {
                if (o[j] < o[j - 1]) o[j] = o[j - 1];
            }
        }
        pos += n;
    }
    return pos;
}

// ---------------------------------------------------------------------------
// decimal mantissas -> float64, batched over blocks with per-block exponents
// ---------------------------------------------------------------------------

#define VM_V_NAN       INT64_MIN
#define VM_V_STALE_NAN (INT64_MIN + 1)
#define VM_V_INF_NEG   (INT64_MIN + 2)
#define VM_V_INF_POS   INT64_MAX

// Convert n mantissas sharing decimal exponent `e` into float64, replicating
// ops/decimal.py decimal_to_float: exact integer division for e in [-18, -1]
// when it divides evenly (bit-exact round-trips for typical decimal values).
static void vm_d2f_one(const int64_t* m, int64_t n, int64_t e, double* out) {
    double stale;
    {
        uint64_t bits = 0x7FF0000000000002ULL;
        memcpy(&stale, &bits, 8);
    }
    double pos_scale = 1.0, neg_scale = 1.0;
    int64_t ipow = 1;
    bool have_ipow = false;
    if (e > 0) {
        // single pow call, matching np.power(10.0, e) bit-for-bit (same
        // libm; overflows to +inf above e=308 exactly like numpy)
        pos_scale = pow(10.0, (double)e);
    } else if (e < 0) {
        neg_scale = pow(10.0, (double)(-e));
        if (e >= -18) {
            ipow = 1;
            for (int64_t i = 0; i < -e; i++) ipow *= 10;
            have_ipow = true;
        }
    }
    for (int64_t i = 0; i < n; i++) {
        int64_t v = m[i];
        if (v == VM_V_STALE_NAN) { out[i] = stale; continue; }
        if (v == VM_V_NAN) { out[i] = NAN; continue; }
        if (v == VM_V_INF_POS) { out[i] = INFINITY; continue; }
        if (v == VM_V_INF_NEG) { out[i] = -INFINITY; continue; }
        if (e == 0) { out[i] = (double)v; continue; }
        if (e < 0) {
            if (e >= -22) {
                double r = (double)v / neg_scale;
                if (have_ipow) {
                    int64_t q = v / ipow;
                    // python floor-div semantics only differ for negatives
                    // with remainder, which also fail the exactness test
                    if (q * ipow == v) r = (double)q;
                }
                out[i] = r;
            } else {
                out[i] = (double)v * pow(10.0, (double)e);
            }
        } else {
            out[i] = (double)v * pos_scale;
        }
    }
}

// Batched: K groups; group i covers mantissas [go[i], go[i+1]) with exponent
// exps[i]. go has k+1 entries.
void vm_decimal_to_float_blocks(const int64_t* m, const int64_t* go,
                                const int64_t* exps, int64_t k, double* out) {
    for (int64_t i = 0; i < k; i++) {
        int64_t a = go[i];
        vm_d2f_one(m + a, go[i + 1] - a, exps[i], out + a);
    }
}

// ---------------------------------------------------------------------------
// per-block time clipping: the part_search.go block-pruning analog at ROW
// granularity. For K blocks over the concatenated timestamp column, find the
// [lo, hi]-inclusive kept row range of each block by binary search (each
// block's timestamps are sorted). Blocks fully inside the range cost two
// ~20-compare searches; the caller gathers only kept rows, so a tail fetch
// of M samples costs O(M + K log rows) instead of O(total decoded rows).
// ---------------------------------------------------------------------------

void vm_clip_blocks(const int64_t* ts, const int64_t* bstart,
                    const int64_t* bend, int64_t k, int64_t lo, int64_t hi,
                    int64_t* out_lo, int64_t* out_hi) {
    for (int64_t i = 0; i < k; i++) {
        int64_t a = bstart[i], b = bend[i];
        // first index with ts >= lo
        int64_t l = a, r = b;
        while (l < r) {
            int64_t m = l + ((r - l) >> 1);
            if (ts[m] < lo) l = m + 1; else r = m;
        }
        out_lo[i] = l;
        // first index with ts > hi
        r = b;
        while (l < r) {
            int64_t m = l + ((r - l) >> 1);
            if (ts[m] <= hi) l = m + 1; else r = m;
        }
        out_hi[i] = l;
    }
}

// Gather the kept row ranges of two parallel int64 columns into dense
// output (the companion of vm_clip_blocks): out gets a[keep_lo[i]:
// keep_hi[i]] for each block, concatenated. Pure per-segment memcpy — no
// index arrays materialize.
void vm_gather_rows2(const int64_t* a, const int64_t* b,
                     const int64_t* keep_lo, const int64_t* keep_hi,
                     int64_t k, int64_t* out_a, int64_t* out_b) {
    int64_t o = 0;
    for (int64_t i = 0; i < k; i++) {
        int64_t n = keep_hi[i] - keep_lo[i];
        if (n <= 0) continue;
        memcpy(out_a + o, a + keep_lo[i], (size_t)n * sizeof(int64_t));
        memcpy(out_b + o, b + keep_lo[i], (size_t)n * sizeof(int64_t));
        o += n;
    }
}

// Scatter K pre-grouped blocks into the padded (S, N) tile layout: block k
// appends its cnts[k] samples to row rows[k] (input order within a row is
// preserved), then every row's tail is padded (pad_ts / 0.0). fill must be
// zeroed S-sized scratch; it ends up holding the per-row valid counts.
void vm_scatter_pad(const int64_t* ts, const double* vals,
                    const int64_t* cnts, const int64_t* rows, int64_t K,
                    int64_t S, int64_t N, int64_t pad_ts,
                    int64_t* ts2, double* v2, int64_t* fill) {
    int64_t off = 0;
    for (int64_t k = 0; k < K; k++) {
        int64_t r = rows[k], n = cnts[k];
        memcpy(ts2 + r * N + fill[r], ts + off, (size_t)n * sizeof(int64_t));
        memcpy(v2 + r * N + fill[r], vals + off, (size_t)n * sizeof(double));
        fill[r] += n;
        off += n;
    }
    for (int64_t s = 0; s < S; s++) {
        for (int64_t j = fill[s]; j < N; j++) {
            ts2[s * N + j] = pad_ts;
            v2[s * N + j] = 0.0;
        }
    }
}

// ---------------------------------------------------------------------------
// counter-reset removal (rollup.go:921 removeCounterResets), row-batched
// ---------------------------------------------------------------------------

// For each of S rows of length N: out = v + shifted-cumsum(drop) where
// drop_j = (d<0) ? ((-d*8 < prev) ? -d : prev) : 0, d = v[j]-v[j-1].
// Bit-exact with the numpy diff/where/cumsum formulation in
// ops/rollup_np.py remove_counter_resets (sequential adds, NaN d -> 0).
void vm_counter_resets_2d(const double* v, int64_t S, int64_t N,
                          double* out) {
    for (int64_t s = 0; s < S; s++) {
        const double* r = v + s * N;
        double* o = out + s * N;
        if (N == 0) continue;
        double corr = 0.0;
        o[0] = r[0];
        for (int64_t j = 1; j < N; j++) {
            double d = r[j] - r[j - 1];
            if (d < 0.0) {  // false for NaN, matching np.where
                double md = -d;
                corr += (md * 8.0 < r[j - 1]) ? md : r[j - 1];
            }
            o[j] = r[j] + corr;
        }
    }
}

// ---------------------------------------------------------------------------
// fused window-walk for the counter/derivative rollup family
// ---------------------------------------------------------------------------

#define VM_RF_RATE 1
#define VM_RF_INCREASE 2
#define VM_RF_DELTA 3
#define VM_RF_DERIV_FAST 4
#define VM_RF_IRATE 5
#define VM_RF_IDELTA 6
#define VM_RF_INCREASE_PURE 7

// delta/increase baseline for a series whose first sample lies inside the
// window (no sample precedes it): assume the counter was born at 0 — unless
// the first value dwarfs the first in-window step, which marks an
// already-running counter surfacing mid-window (rollup.go:2129 rollupDelta).
// Mirrors _new_series_base in ops/rollup_np.py (must stay bit-exact).
static inline double vm_new_series_base(const double* w, int64_t nwin) {
    double d = nwin > 1 ? w[1] - w[0] : 0.0;
    return (fabs(w[0]) < 10.0 * (fabs(d) + 1.0)) ? 0.0 : w[0];
}

// One pass per row: counter-reset correction into scratch, then a
// two-pointer window walk over the T output steps. Semantics and float-op
// order mirror ops/rollup_np.py rollup_batch_packed's counter family
// (verified bit-exact by the batch-vs-oracle differential tests).
// ts: (S, N) int64 padded with INT64_MAX; v: (S, N) float64; counts (S,);
// mpi: (S,) maxPrevInterval for the gated-prev rule; out: (S, T).
// scratch: N doubles.
void vm_rollup_counter_2d(const int64_t* ts, const double* v,
                          const int64_t* counts, int64_t S, int64_t N,
                          int64_t start, int64_t end, int64_t step,
                          int64_t lookback, const int64_t* mpi, int32_t func,
                          double* out, double* scratch) {
    int64_t T = (end - start) / step + 1;
    bool needs_reset = (func == VM_RF_RATE || func == VM_RF_INCREASE ||
                        func == VM_RF_INCREASE_PURE || func == VM_RF_IRATE);
    for (int64_t s = 0; s < S; s++) {
        const int64_t* t = ts + s * N;
        const double* r = v + s * N;
        double* o = out + s * T;
        int64_t n = counts[s];
        const double* c = r;
        if (needs_reset && n > 0) {
            double corr = 0.0;
            scratch[0] = r[0];
            for (int64_t j = 1; j < n; j++) {
                double d = r[j] - r[j - 1];
                if (d < 0.0) {
                    double md = -d;
                    corr += (md * 8.0 < r[j - 1]) ? md : r[j - 1];
                }
                scratch[j] = r[j] + corr;
            }
            c = scratch;
        }
        int64_t a = 0, b = 0;
        for (int64_t j = 0; j < T; j++) {
            int64_t tj = start + j * step;
            int64_t w_lo = tj - lookback;
            while (a < n && t[a] <= w_lo) a++;
            if (b < a) b = a;
            while (b < n && t[b] <= tj) b++;
            double res = NAN;
            int64_t nwin = b - a;
            bool have = nwin > 0;
            int64_t prev = a - 1;
            bool has_prev = prev >= 0;
            bool gated = has_prev && t[prev] > w_lo - mpi[s];
            switch (func) {
            case VM_RF_DELTA:
                if (have) {
                    double base = has_prev ? r[prev]
                                           : vm_new_series_base(r + a, nwin);
                    res = r[b - 1] - base;
                }
                break;
            case VM_RF_INCREASE:
                if (have) {
                    double base = has_prev ? c[prev]
                                           : vm_new_series_base(c + a, nwin);
                    res = c[b - 1] - base;
                }
                break;
            case VM_RF_INCREASE_PURE:
                if (have) {
                    double base = has_prev ? c[prev] : 0.0;
                    res = c[b - 1] - base;
                }
                break;
            case VM_RF_RATE:
            case VM_RF_DERIV_FAST: {
                const double* arr = (func == VM_RF_RATE) ? c : r;
                if (have && (gated || nwin >= 2)) {
                    int64_t pi = gated ? prev : a;
                    double dt = (double)(t[b - 1] - t[pi]) / 1e3;
                    double dv = arr[b - 1] - arr[pi];
                    res = (dt > 0.0) ? dv / dt : NAN;
                }
                break;
            }
            case VM_RF_IRATE: {
                bool two = nwin >= 2;
                if (have && (two || gated)) {
                    int64_t hi2 = two ? b - 2 : prev;
                    double dt = (double)(t[b - 1] - t[hi2]) / 1e3;
                    double dv = c[b - 1] - c[hi2];
                    res = (dt > 0.0) ? dv / dt : NAN;
                }
                break;
            }
            case VM_RF_IDELTA:
                if (have) {
                    if (nwin >= 2) res = r[b - 1] - r[b - 2];
                    else if (gated) res = r[b - 1] - r[prev];
                }
                break;
            }
            o[j] = res;
        }
    }
}

// ---------------------------------------------------------------------------
// grouped float64 -> decimal (int64 mantissas + per-group common exponent)
// ---------------------------------------------------------------------------
// Mirrors ops/decimal.float_to_decimal_grouped exactly (the flush hot
// path): element-wise mantissa extraction (integer fast path, 15-digit
// round-trip check, 17-digit fallback, trailing-zero strip), then per-group
// common-exponent unification and rescale. Sentinels and rounding modes
// (nearbyint == np.round half-to-even under the default FP environment)
// match the Python pipeline bit for bit.

#define VM_F2D_MAX_MANTISSA 100000000000000000LL  // 10^17
#define VM_F2D_MIN_EXP (-320)
#define VM_F2D_MAX_EXP 310
#define VM_V_NAN INT64_MIN
#define VM_V_STALE_NAN (INT64_MIN + 1)
#define VM_V_INF_NEG (INT64_MIN + 2)
#define VM_V_INF_POS INT64_MAX

enum { VM_K_NORM = 0, VM_K_ZERO, VM_K_STALE, VM_K_NAN, VM_K_PINF,
       VM_K_NINF };

// Power-of-ten table built by the SAME recurrence as ops/decimal.py's
// _POW10_TABLE (T[k] = T[k-1]*10; T[-k] = 1/T[k] while finite, then /10
// into the subnormals): libm pow and numpy's SIMD pow differ by an ulp at
// large exponents, so a shared table is the only way both pipelines
// produce bit-identical mantissas.
#define VM_POW10_MAX 340
struct VmPow10Table {
    double t[2 * VM_POW10_MAX + 1];
    VmPow10Table() {
        t[VM_POW10_MAX] = 1.0;
        for (int k = 1; k <= VM_POW10_MAX; k++) {
            t[VM_POW10_MAX + k] = t[VM_POW10_MAX + k - 1] * 10.0;
            if (!std::isinf(t[VM_POW10_MAX + k]))
                t[VM_POW10_MAX - k] = 1.0 / t[VM_POW10_MAX + k];
            else
                t[VM_POW10_MAX - k] = t[VM_POW10_MAX - k + 1] / 10.0;
        }
    }
};
static const double* vm_pow10_table() {
    static VmPow10Table p;  // C++11 thread-safe init
    return p.t;
}

static inline double vm_pow10d(int64_t e) {
    if (e > VM_POW10_MAX) e = VM_POW10_MAX;
    if (e < -VM_POW10_MAX) e = -VM_POW10_MAX;
    return vm_pow10_table()[e + VM_POW10_MAX];
}

// x * 10^e for e >= 0 without overflowing the pow (split at 300), matching
// decimal._scale_up
static inline double vm_scale_up(double x, int64_t e) {
    int64_t e1 = e < 300 ? e : 300;
    return x * vm_pow10d(e1) * vm_pow10d(e - e1);
}

static void vm_f2d_decompose(double v, int64_t exp10, int digits,
                             int64_t* mo, int64_t* eo) {
    int64_t ei = exp10 - (digits - 1);
    if (ei < VM_F2D_MIN_EXP) ei = VM_F2D_MIN_EXP;
    if (ei > VM_F2D_MAX_EXP) ei = VM_F2D_MAX_EXP;
    double scaled = (ei < 0) ? vm_scale_up(v, -ei) : v / vm_pow10d(ei);
    double mi = nearbyint(scaled);
    double lim = vm_pow10d(digits);
    if (fabs(mi) >= lim) {  // 1-off exponent from floor(log10) at edges
        ei += 1;
        scaled = (ei < 0) ? vm_scale_up(v, -ei) : v / vm_pow10d(ei);
        mi = nearbyint(scaled);
    }
    if (mi > (double)VM_F2D_MAX_MANTISSA) mi = (double)VM_F2D_MAX_MANTISSA;
    if (mi < -(double)VM_F2D_MAX_MANTISSA) mi = -(double)VM_F2D_MAX_MANTISSA;
    *mo = (int64_t)mi;
    *eo = ei;
}

static inline void vm_f2d_elem(double x, int64_t* m, int64_t* e,
                               int* kind) {
    *m = 0;
    *e = 0;
    if (x != x) {
        uint64_t bits;
        memcpy(&bits, &x, 8);
        *kind = (bits == 0x7FF0000000000002ULL) ? VM_K_STALE : VM_K_NAN;
        return;
    }
    if (std::isinf(x)) { *kind = x > 0 ? VM_K_PINF : VM_K_NINF; return; }
    if (x == 0.0) { *kind = VM_K_ZERO; return; }
    *kind = VM_K_NORM;
    double ax = fabs(x);
    int64_t exp10 = (int64_t)floor(log10(ax));
    if (x == floor(x) && ax <= (double)VM_F2D_MAX_MANTISSA) {
        *m = (int64_t)x;
        *e = 0;
    } else {
        int64_t m15, e15;
        vm_f2d_decompose(x, exp10, 15, &m15, &e15);
        double recon = (e15 < 0) ? (double)m15 / vm_pow10d(-e15)
                                 : (double)m15 * vm_pow10d(e15);
        if (recon == x) {
            *m = m15;
            *e = e15;
        } else {
            vm_f2d_decompose(x, exp10, 17, m, e);
        }
    }
    while (*m != 0 && *m % 10 == 0) {
        *m /= 10;
        *e += 1;
    }
}

// v[n] float64 -> m_out[n] int64 mantissas + exps_out[n_groups]; group g
// covers v[starts[g]..starts[g+1]) (starts[n_groups] == n implied).
void vm_f2d_grouped(const double* v, const int64_t* starts,
                    int64_t n_groups, int64_t n, int64_t* m_out,
                    int64_t* exps_out) {
    std::vector<int64_t> es(n);
    std::vector<signed char> kinds(n);
    for (int64_t i = 0; i < n; i++) {
        int kind;
        vm_f2d_elem(v[i], &m_out[i], &es[i], &kind);
        kinds[i] = (signed char)kind;
    }
    for (int64_t g = 0; g < n_groups; g++) {
        int64_t a = starts[g];
        int64_t b = (g + 1 < n_groups) ? starts[g + 1] : n;
        int64_t emin = INT64_MAX, efloor = INT64_MIN;
        bool has_norm = false;
        for (int64_t i = a; i < b; i++) {
            if (kinds[i] != VM_K_NORM) continue;
            has_norm = true;
            if (es[i] < emin) emin = es[i];
            double absm = (double)(m_out[i] < 0 ? -m_out[i] : m_out[i]);
            if (absm < 1.0) absm = 1.0;
            int64_t allowed_up = (int64_t)floor(
                log10((double)VM_F2D_MAX_MANTISSA / absm));
            int64_t fl = es[i] - allowed_up;
            if (fl > efloor) efloor = fl;
        }
        int64_t exp = emin < VM_F2D_MAX_EXP ? emin : VM_F2D_MAX_EXP;
        if (efloor > exp) exp = efloor;
        if (exp > VM_F2D_MAX_EXP) exp = VM_F2D_MAX_EXP;
        if (exp < VM_F2D_MIN_EXP) exp = VM_F2D_MIN_EXP;
        if (!has_norm) exp = 0;
        exps_out[g] = exp;
        for (int64_t i = a; i < b; i++) {
            switch (kinds[i]) {
                case VM_K_STALE: m_out[i] = VM_V_STALE_NAN; continue;
                case VM_K_NAN: m_out[i] = VM_V_NAN; continue;
                case VM_K_PINF: m_out[i] = VM_V_INF_POS; continue;
                case VM_K_NINF: m_out[i] = VM_V_INF_NEG; continue;
                case VM_K_ZERO: m_out[i] = 0; continue;
            }
            int64_t shift = es[i] - exp;
            if (shift > 0) {
                int64_t factor = 1;
                for (int64_t k = 0; k < shift; k++) factor *= 10;
                m_out[i] *= factor;
            } else if (shift < 0) {
                int64_t dshift = -shift < 19 ? -shift : 19;
                m_out[i] = (int64_t)nearbyint(
                    (double)m_out[i] / vm_pow10d(dshift));
            }
        }
    }
}

// ---------------------------------------------------------------------------
// fused part assemble: fetch -> decode -> clip -> float, one call per part
// ---------------------------------------------------------------------------
// The served-read-path kernel (ROADMAP item 1): for K (header-selected)
// blocks of one immutable part, decode the timestamp stream, clamp lossy
// sequences, row-clip each block to the [lo, hi]-inclusive query range by
// binary search, decode the value stream ONLY for blocks that kept rows,
// convert the kept mantissas to float64 with the block's decimal exponent
// (vm_d2f_one — bit-exact with ops/decimal.decimal_to_float), and write the
// surviving rows densely into caller-provided columnar buffers.
//
// Buffer contract (the zero-copy handoff): out_ts / out_vals hold at least
// sum(cnt) entries — block i may be decoded in place at the current write
// head before compaction, which fits because the head only advances by
// kept rows. out_cnt[i] receives block i's kept-row count (callers drop
// zero-count blocks from their per-block id/exponent columns, mirroring
// clip_piece). Returns total kept rows, or -(i+1) when block i is
// malformed / needs an unavailable payload codec.
int64_t vm_assemble_part(
    const uint8_t* ts_base, const uint8_t* val_base,
    const int64_t* ts_off, const int64_t* ts_sz, const int32_t* ts_mt,
    const int64_t* ts_first,
    const int64_t* val_off, const int64_t* val_sz, const int32_t* val_mt,
    const int64_t* val_first,
    const int64_t* cnt, const int64_t* exps, int64_t k,
    int64_t lo, int64_t hi,
    int64_t* out_ts, double* out_vals, int64_t* out_cnt) {
    int64_t opos = 0;
    std::vector<int64_t> mant;
    std::vector<uint8_t> infl;
    for (int64_t i = 0; i < k; i++) {
        int64_t n = cnt[i];
        if (n <= 0) return -(i + 1);
        // timestamps decode straight into the output at the write head
        int32_t t = ts_mt[i];
        const uint8_t* p = ts_base + ts_off[i];
        int64_t r;
        if (t == VM_MT_ZSTD_NEAREST_DELTA || t == VM_MT_ZSTD_NEAREST_DELTA2) {
            int64_t cap = (n + 1) * 10 + 16;
            if ((int64_t)infl.size() < cap) infl.resize((size_t)cap);
            int64_t got = vm_inflate(p, ts_sz[i], infl.data(), cap);
            if (got < 0) return -(i + 1);
            r = vm_decode_plain(infl.data(), got, t - 2, ts_first[i], n,
                                out_ts + opos);
        } else {
            r = vm_decode_plain(p, ts_sz[i], t, ts_first[i], n,
                                out_ts + opos);
        }
        if (r != n) return -(i + 1);
        if (t == VM_MT_NEAREST_DELTA || t == VM_MT_NEAREST_DELTA2) {
            // lossy uncompressed types carry no checksum: re-validate
            // non-decreasing order (ops/encoding.py needs_validation)
            int64_t* o = out_ts + opos;
            for (int64_t j = 1; j < n; j++) {
                if (o[j] < o[j - 1]) o[j] = o[j - 1];
            }
        }
        // row clip to [lo, hi] inclusive (vm_clip_blocks semantics)
        int64_t* bt = out_ts + opos;
        int64_t a, b;
        {
            int64_t l = 0, r2 = n;
            while (l < r2) {
                int64_t m = l + ((r2 - l) >> 1);
                if (bt[m] < lo) l = m + 1; else r2 = m;
            }
            a = l;
            r2 = n;
            while (l < r2) {
                int64_t m = l + ((r2 - l) >> 1);
                if (bt[m] <= hi) l = m + 1; else r2 = m;
            }
            b = l;
        }
        int64_t kept = b - a;
        out_cnt[i] = kept;
        if (kept == 0) continue;  // fully clipped: value decode skipped
        if (a > 0) memmove(bt, bt + a, (size_t)kept * sizeof(int64_t));
        // values: full-block decode to scratch, convert only kept rows
        t = val_mt[i];
        p = val_base + val_off[i];
        if ((int64_t)mant.size() < n) mant.resize((size_t)n);
        if (t == VM_MT_ZSTD_NEAREST_DELTA || t == VM_MT_ZSTD_NEAREST_DELTA2) {
            int64_t cap = (n + 1) * 10 + 16;
            if ((int64_t)infl.size() < cap) infl.resize((size_t)cap);
            int64_t got = vm_inflate(p, val_sz[i], infl.data(), cap);
            if (got < 0) return -(i + 1);
            r = vm_decode_plain(infl.data(), got, t - 2, val_first[i], n,
                                mant.data());
        } else {
            r = vm_decode_plain(p, val_sz[i], t, val_first[i], n,
                                mant.data());
        }
        if (r != n) return -(i + 1);
        vm_d2f_one(mant.data() + a, kept, exps[i], out_vals + opos);
        opos += kept;
    }
    return opos;
}

// ---------------------------------------------------------------------------
// per-row query-time dedup over the padded (S, N) layout
// ---------------------------------------------------------------------------

static inline bool vm_is_stale(double x) {
    uint64_t b;
    memcpy(&b, &x, 8);
    return b == 0x7FF0000000000002ULL;
}

// right-inclusive dedup window id, bit-exact with storage/dedup.py
// _buckets (numpy // is floor division, C++ / truncates: adjust)
static inline int64_t vm_bucket(int64_t ts, int64_t interval) {
    int64_t x = ts + interval - 1;
    int64_t q = x / interval;
    if ((x % interval != 0) && ((x < 0) != (interval < 0))) q--;
    return q;
}

// For each listed row of the (S, N) ts/vals layout: apply interval dedup
// (keep the max-ts sample per window; on timestamp ties prefer the max
// non-stale value via the reference's backward scan — dedup.go:30-121 as
// mirrored by storage/dedup.py), then drop exact-duplicate timestamps
// keeping the LAST sample, compact the row in place, pad the freed tail
// with (pad_ts, 0.0) and rewrite counts[row]. Row strides are in elements
// (the arrays may be column-sliced views). interval <= 0 runs only the
// exact-duplicate pass — byte-for-byte what columnar.assemble()'s per-row
// Python loop does.
void vm_dedup_rows(int64_t* ts, int64_t ts_stride, double* v,
                   int64_t v_stride, int64_t* counts, const int64_t* rows,
                   int64_t n_rows, int64_t interval, int64_t pad_ts) {
    for (int64_t ri = 0; ri < n_rows; ri++) {
        int64_t s = rows[ri];
        int64_t n = counts[s];
        int64_t* t = ts + s * ts_stride;
        double* vv = v + s * v_stride;
        int64_t m = n;
        if (interval > 0 && n >= 2) {
            bool need = false;
            int64_t bprev = vm_bucket(t[0], interval);
            for (int64_t j = 1; j < n; j++) {
                int64_t bj = vm_bucket(t[j], interval);
                if (bj == bprev) { need = true; break; }
                bprev = bj;
            }
            if (need) {
                m = 0;
                int64_t a = 0;
                while (a < n) {
                    int64_t ba = vm_bucket(t[a], interval);
                    int64_t b = a + 1;
                    while (b < n && vm_bucket(t[b], interval) == ba) b++;
                    int64_t tmax = t[b - 1];
                    double val = vv[b - 1];
                    // tie run: rows are time-sorted, so the equal-tmax
                    // samples are the window's suffix
                    int64_t f = b - 1;
                    while (f > a && t[f - 1] == tmax) f--;
                    if (b - f >= 2) {
                        double vprev = vv[b - 1];
                        bool vprev_stale = vm_is_stale(vprev);
                        for (int64_t j = b - 2; j >= f; j--) {
                            if (vm_is_stale(vv[j])) continue;
                            if (vprev_stale) {
                                vprev = vv[j];
                                vprev_stale = false;
                            } else if (vv[j] > vprev) {
                                vprev = vv[j];
                            }
                        }
                        val = vprev;
                    }
                    t[m] = tmax;  // m <= a: never clobbers unread input
                    vv[m] = val;
                    m++;
                    a = b;
                }
            }
        }
        // exact-duplicate timestamps (replica merges): keep the LAST
        int64_t w = 0;
        for (int64_t j = 0; j < m; j++) {
            if (j + 1 < m && t[j + 1] == t[j]) continue;
            t[w] = t[j];
            vv[w] = vv[j];
            w++;
        }
        m = w;
        if (m != n) {
            for (int64_t j = m; j < n; j++) {
                t[j] = pad_ts;
                vv[j] = 0.0;
            }
            counts[s] = m;
        }
    }
}


// ---------------------------------------------------------------------------
// xxHash64 / xxHash32 (the XXH64 and XXH32 specifications): the TSID's
// clustering hashes (storage/tsid.py) and the storage's memo keys.  Equal
// to the xxhash package's xxh64_intdigest / xxh32_intdigest.
// ---------------------------------------------------------------------------

static const uint64_t kP64_1 = 11400714785074694791ULL;
static const uint64_t kP64_2 = 14029467366897019727ULL;
static const uint64_t kP64_3 = 1609587929392839161ULL;
static const uint64_t kP64_4 = 9650029242287828579ULL;
static const uint64_t kP64_5 = 2870177450012600261ULL;
static const uint32_t kP32_1 = 2654435761U;
static const uint32_t kP32_2 = 2246822519U;
static const uint32_t kP32_3 = 3266489917U;
static const uint32_t kP32_4 = 668265263U;
static const uint32_t kP32_5 = 374761393U;

static inline uint64_t vm_rotl64(uint64_t x, int r) {
    return (x << r) | (x >> (64 - r));
}
static inline uint32_t vm_rotl32(uint32_t x, int r) {
    return (x << r) | (x >> (32 - r));
}
static inline uint64_t vm_rd64(const uint8_t* p) {
    uint64_t v;
    memcpy(&v, p, 8);  // little-endian hosts (x86-64, aarch64)
    return v;
}
static inline uint32_t vm_rd32(const uint8_t* p) {
    uint32_t v;
    memcpy(&v, p, 4);
    return v;
}
static inline uint64_t vm_xxh64_round(uint64_t acc, uint64_t in) {
    acc += in * kP64_2;
    acc = vm_rotl64(acc, 31);
    return acc * kP64_1;
}
static inline uint64_t vm_xxh64_merge(uint64_t acc, uint64_t v) {
    acc ^= vm_xxh64_round(0, v);
    return acc * kP64_1 + kP64_4;
}

uint64_t vm_xxh64(const uint8_t* p, int64_t len, uint64_t seed) {
    const uint8_t* end = p + len;
    uint64_t h;
    if (len >= 32) {
        uint64_t v1 = seed + kP64_1 + kP64_2, v2 = seed + kP64_2;
        uint64_t v3 = seed, v4 = seed - kP64_1;
        const uint8_t* limit = end - 32;
        do {
            v1 = vm_xxh64_round(v1, vm_rd64(p));
            v2 = vm_xxh64_round(v2, vm_rd64(p + 8));
            v3 = vm_xxh64_round(v3, vm_rd64(p + 16));
            v4 = vm_xxh64_round(v4, vm_rd64(p + 24));
            p += 32;
        } while (p <= limit);
        h = vm_rotl64(v1, 1) + vm_rotl64(v2, 7) + vm_rotl64(v3, 12) +
            vm_rotl64(v4, 18);
        h = vm_xxh64_merge(h, v1);
        h = vm_xxh64_merge(h, v2);
        h = vm_xxh64_merge(h, v3);
        h = vm_xxh64_merge(h, v4);
    } else {
        h = seed + kP64_5;
    }
    h += (uint64_t)len;
    while (p + 8 <= end) {
        h ^= vm_xxh64_round(0, vm_rd64(p));
        h = vm_rotl64(h, 27) * kP64_1 + kP64_4;
        p += 8;
    }
    if (p + 4 <= end) {
        h ^= (uint64_t)vm_rd32(p) * kP64_1;
        h = vm_rotl64(h, 23) * kP64_2 + kP64_3;
        p += 4;
    }
    while (p < end) {
        h ^= (uint64_t)(*p) * kP64_5;
        h = vm_rotl64(h, 11) * kP64_1;
        p++;
    }
    h ^= h >> 33;
    h *= kP64_2;
    h ^= h >> 29;
    h *= kP64_3;
    h ^= h >> 32;
    return h;
}

static inline uint32_t vm_xxh32_round(uint32_t acc, uint32_t in) {
    acc += in * kP32_2;
    acc = vm_rotl32(acc, 13);
    return acc * kP32_1;
}

uint32_t vm_xxh32(const uint8_t* p, int64_t len, uint32_t seed) {
    const uint8_t* end = p + len;
    uint32_t h;
    if (len >= 16) {
        uint32_t v1 = seed + kP32_1 + kP32_2, v2 = seed + kP32_2;
        uint32_t v3 = seed, v4 = seed - kP32_1;
        const uint8_t* limit = end - 16;
        do {
            v1 = vm_xxh32_round(v1, vm_rd32(p));
            v2 = vm_xxh32_round(v2, vm_rd32(p + 4));
            v3 = vm_xxh32_round(v3, vm_rd32(p + 8));
            v4 = vm_xxh32_round(v4, vm_rd32(p + 12));
            p += 16;
        } while (p <= limit);
        h = vm_rotl32(v1, 1) + vm_rotl32(v2, 7) + vm_rotl32(v3, 12) +
            vm_rotl32(v4, 18);
    } else {
        h = seed + kP32_5;
    }
    h += (uint32_t)len;
    while (p + 4 <= end) {
        h += vm_rd32(p) * kP32_3;
        h = vm_rotl32(h, 17) * kP32_4;
        p += 4;
    }
    while (p < end) {
        h += (uint32_t)(*p) * kP32_5;
        h = vm_rotl32(h, 11) * kP32_1;
        p++;
    }
    h ^= h >> 15;
    h *= kP32_2;
    h ^= h >> 13;
    h *= kP32_3;
    h ^= h >> 16;
    return h;
}

}  // extern "C"
