// K1 decode_tiles: nearest-delta2 planes -> resident tile rows.
//
// Replaces victoriametrics_tpu/ops/device_decode.py:decode_tiles (with its
// _reconstruct helper), a jax.jit program of two cumulative sums per plane.
//
// Per row, with a[0] = 0, a[1] = fdelta, a[j] = d2[j-2] (j >= 2):
//   b[j] = a[0] + ... + a[j]          (b[j] = delta between samples j-1, j)
//   x[j] = first + b[0] + ... + b[j]
// in 32-bit two's-complement arithmetic.  The reference wraps in int32;
// signed overflow is undefined in C++, so the sums run in uint32, which
// wraps to the same bits, and in any order (sums mod 2^32 are
// associative).  The headroom columns past a row's count hold zero d2 and
// decode into a linear tail that can overflow: that tail is reproduced bit
// for bit.  ts is TS_PAD past counts[row]; values are
// (double)(int32)x * scale[row], one IEEE multiply (the library is built
// with --fmad=false, and there is nothing to contract here anyway).
//
// Bound: bytes.  A row reads its two d2 planes (1, 2 or 4 B a column
// each) and a few scalars and writes 12 B a column (int32 ts, float64
// value); four adds a column.  Design: one launch decodes both planes.  A
// persistent grid (as many blocks as the occupancy query lets reside)
// walks the rows; a block takes its row in chunks of the plan's width
// (ops/device_decode.k1_plan: the whole row where two blocks of its
// workspace fit an SM, 108 KB at the full width), each chunk in four
// steps:
//  1. stage: the chunk's d2 entries of both planes into shared memory,
//     the 16-byte words that lie wholly inside them by cp.async, an
//     unaligned head and tail (under 16 bytes each) by threads, so no
//     byte outside the entries is read;
//  2. scan: each thread takes a run of odd length (distinct banks) and
//     sums its a and its running b for both planes; two block scans of
//     the pairs (decode.cuh block_scan2) with the carries of the row's
//     earlier chunks give each run's start;
//  3. rebuild: each run's ts and values into shared memory, placed at the
//     output's own offset within a 16-byte word;
//  4. store: each output span's 16-byte aligned body by one bulk copy
//     (cp.async.bulk, drained while the next chunk stages and scans), its
//     unaligned head and tail (at most 3 ts, 1 value) by threads.
// Two block scans a chunk, where the plane-at-a-time kernel made two per
// 256 columns and plane; each byte is read once and written once.

#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"
#include "decode.cuh"

namespace {

// threads a block (512 ran no faster at any width measured and slower at
// the dashboard's, 128 no faster: PERF.md, K1)
constexpr int kK1Threads = 256;

// The chunk workspace in dynamic shared memory, in bytes, for a chunk of
// `chunk` columns (ops/device_decode.k1_smem is the same sum): the ts
// words with 3 of alignment slack, the values with 1, and each plane's
// staged d2 words, 32 bytes over (a partial head and tail word).
__host__ __device__ constexpr long long round16(long long b) {
  return (b + 15) / 16 * 16;
}
__host__ __device__ constexpr long long ts_ws(int chunk) {
  return round16(4LL * (chunk + 3));
}
__host__ __device__ constexpr long long val_ws(int chunk) {
  return round16(8LL * (chunk + 1));
}
__host__ __device__ constexpr long long raw_ws(int chunk, int bytes) {
  return round16(static_cast<long long>(chunk) * bytes + 32);
}

struct K1Args {
  const int32_t *ts_first, *ts_fd, *val_first, *val_fd, *counts;
  const void *ts_d2, *val_d2;
  long long ts_d2w, val_d2w;
  const double* scale;
  int32_t* ts_out;
  double* val_out;
  long long S;
  int n, chunk;
};

// Stage the `bytes` bytes at `src` into `dst` at src's offset within its
// 16-byte word: the words wholly inside [src, src + bytes) by queued
// cp.async copies, the bytes of a partial head and tail word by threads
// (visible after the caller's barrier), none outside the range.  Returns
// that offset.
__device__ __forceinline__ int stage_words(unsigned char* dst,
                                           const void* src, int bytes) {
  if (bytes <= 0) return 0;
  const uintptr_t s = reinterpret_cast<uintptr_t>(src);
  const uintptr_t e = s + bytes;
  const uintptr_t w0 = s & ~static_cast<uintptr_t>(15);
  const uintptr_t b0 = (s + 15) & ~static_cast<uintptr_t>(15);
  const uintptr_t b1 = e & ~static_cast<uintptr_t>(15);
  const uintptr_t h1 = b0 < e ? b0 : e;  // the head's end
  const uintptr_t t0 = b1 > h1 ? b1 : h1;  // the tail's start
  const int first = static_cast<int>((b0 - w0) >> 4);
  const int words = b1 > b0 ? static_cast<int>((b1 - b0) >> 4) : 0;
  for (int w = threadIdx.x; w < words; w += blockDim.x)
    copy16_async(dst + 16 * (first + w),
                 reinterpret_cast<const void*>(b0 + 16 * w));
  const int head = static_cast<int>(h1 - s);
  const int i = threadIdx.x - (blockDim.x - 32);  // the last warp's lanes
  if (i >= 0 && i < head + static_cast<int>(e - t0)) {
    const uintptr_t p = i < head ? s + i : t0 + (i - head);
    dst[p - w0] = *reinterpret_cast<const unsigned char*>(p);
  }
  return static_cast<int>(s - w0);
}

// Output elements [g0, g0 + cols) of `dst` from `src`, which holds element
// g0 at index g0 mod (16 / sizeof(T)): the aligned body by thread 0's bulk
// copy (committed by the caller), the head and tail by threads.  Every
// thread of the block calls it after a barrier that follows the writes
// to `src` and their fence_shared_to_async.
template <typename T>
__device__ __forceinline__ void store_span(T* dst, const T* src,
                                           long long g0, int cols) {
  constexpr int kPer = 16 / sizeof(T);
  const int off = static_cast<int>(g0 % kPer);
  const int head = min((kPer - off) % kPer, cols);
  const int body = (cols - head) / kPer * kPer;
  const int tail = cols - head - body;
  const int tid = threadIdx.x;
  if (tid == 0 && body > 0)
    bulk_store(dst + g0 + head, src + off + head,
               static_cast<unsigned>(body * sizeof(T)));
  if (tid < head) {
    dst[g0 + tid] = src[off + tid];
  } else if (tid < head + tail) {
    const int i = body + tid;  // head + body + (tid - head)
    dst[g0 + i] = src[off + i];
  }
}

template <typename TD, typename VD>
// The 4 of __launch_bounds__ holds the registers at 64 a thread, the
// budget the kernel was measured with (two blocks an SM at full width,
// up to eight at the dashboard's 28 KB).
__global__ void __launch_bounds__(kK1Threads, 4)
decode_tiles(K1Args a) {
  extern __shared__ __align__(16) unsigned char ws[];
  __shared__ uint2 warp_sums[kK1Threads / 32];
  const int C = a.chunk;
  const int n = a.n;
  int32_t* s_ts = reinterpret_cast<int32_t*>(ws);
  double* s_val = reinterpret_cast<double*>(ws + ts_ws(C));
  unsigned char* raw_t = ws + ts_ws(C) + val_ws(C);
  unsigned char* raw_v = raw_t + raw_ws(C, sizeof(TD));
  const int tid = threadIdx.x;
  constexpr int threads = kK1Threads;
  constexpr int warps = kK1Threads / 32;
  for (long long row = blockIdx.x; row < a.S; row += gridDim.x) {
    const int cnt = a.counts[row];
    const double sc = a.scale[row];
    const uint2 fd = make_uint2(static_cast<uint32_t>(a.ts_fd[row]),
                                static_cast<uint32_t>(a.val_fd[row]));
    const TD* tp = static_cast<const TD*>(a.ts_d2) + row * a.ts_d2w;
    const VD* vp = static_cast<const VD*>(a.val_d2) + row * a.val_d2w;
    // b and x at the column before the chunk
    uint2 carry_b = make_uint2(0u, 0u);
    uint2 carry_x = make_uint2(static_cast<uint32_t>(a.ts_first[row]),
                               static_cast<uint32_t>(a.val_first[row]));
    for (int c0 = 0; c0 < n; c0 += C) {
      const int cols = min(C, n - c0);
      // 1. d2[k0, k0 + nk): the entries of columns [max(c0, 2), c0 + cols)
      const int k0 = max(c0 - 2, 0);
      const int nk = c0 + cols - 2 - k0;
      const TD* rt = reinterpret_cast<const TD*>(
          raw_t + stage_words(raw_t, tp + k0,
                              nk * static_cast<int>(sizeof(TD))));
      const VD* rv = reinterpret_cast<const VD*>(
          raw_v + stage_words(raw_v, vp + k0,
                              nk * static_cast<int>(sizeof(VD))));
      commit_async();
      wait_async<0>();
      __syncthreads();
      // column c0 + i's a of both planes
      const auto at = [&](int i) {
        const int j = c0 + i;
        if (j >= 2)
          return make_uint2(
              static_cast<uint32_t>(static_cast<int32_t>(rt[j - 2 - k0])),
              static_cast<uint32_t>(static_cast<int32_t>(rv[j - 2 - k0])));
        return j == 1 ? fd : make_uint2(0u, 0u);
      };
      // 2. this thread's run [i0, i1) of the chunk
      const int L = ((cols + threads - 1) / threads) | 1;
      const int i0 = min(tid * L, cols);
      const int i1 = min(i0 + L, cols);
      uint2 sa = make_uint2(0u, 0u), sb = make_uint2(0u, 0u);
      for (int i = i0; i < i1; ++i) {
        const uint2 v = at(i);
        sa.x += v.x;
        sa.y += v.y;
        sb.x += sa.x;
        sb.y += sa.y;
      }
      // the last chunk's bulk stores must have read s_ts and s_val before
      // step 3 rewrites them: the scans' barriers order this wait first
      if (tid == 0) bulk_wait_read();
      uint2 tot_a, tot_b;
      uint2 ca = block_scan2(sa, warp_sums, warps, &tot_a);
      ca.x += carry_b.x - sa.x;  // b before the run
      ca.y += carry_b.y - sa.y;
      const uint32_t len = static_cast<uint32_t>(i1 - i0);
      const uint2 seg = make_uint2(len * ca.x + sb.x, len * ca.y + sb.y);
      const uint2 cb = block_scan2(seg, warp_sums, warps, &tot_b);
      carry_b.x += tot_a.x;
      carry_b.y += tot_a.y;
      // 3. rebuild the run at the output's offsets within 16-byte words
      const long long g0 = row * n + c0;
      const int ot = static_cast<int>(g0 & 3);
      const int ov = static_cast<int>(g0 & 1);
      uint32_t bt = ca.x, bv = ca.y;
      uint32_t xt = carry_x.x + (cb.x - seg.x);
      uint32_t xv = carry_x.y + (cb.y - seg.y);
      for (int i = i0; i < i1; ++i) {
        const uint2 v = at(i);
        bt += v.x;
        bv += v.y;
        xt += bt;
        xv += bv;
        s_ts[ot + i] = c0 + i < cnt ? static_cast<int32_t>(xt) : kTsPad;
        s_val[ov + i] = static_cast<double>(static_cast<int32_t>(xv)) * sc;
      }
      carry_x.x += tot_b.x;
      carry_x.y += tot_b.y;
      // 4. store
      fence_shared_to_async();
      __syncthreads();
      store_span(a.ts_out, s_ts, g0, cols);
      store_span(a.val_out, s_val, g0, cols);
      if (tid == 0) bulk_commit();
    }
  }
  if (tid == 0) bulk_wait();
}

// `smem` is the caller's size of the chunk workspace (k1_plan's); it
// must be this kernel's own carve-up.
template <typename TD, typename VD>
int launch(const K1Args& a, long long smem, cudaStream_t stream) {
  const auto k = &decode_tiles<TD, VD>;
  if (smem != ts_ws(a.chunk) + val_ws(a.chunk) +
                  raw_ws(a.chunk, sizeof(TD)) + raw_ws(a.chunk, sizeof(VD)))
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, optin = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (smem > optin) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(reinterpret_cast<const void*>(k),
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, reinterpret_cast<const void*>(k), kK1Threads,
      static_cast<size_t>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long resident = static_cast<long long>(sms) *
                             (per_sm > 0 ? per_sm : 1);
  k<<<static_cast<unsigned>(a.S < resident ? a.S : resident), kK1Threads,
      static_cast<size_t>(smem), stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename TD>
int launch_val(const K1Args& a, int val_bytes, long long smem,
               cudaStream_t stream) {
  switch (val_bytes) {
    case 1:
      return launch<TD, int8_t>(a, smem, stream);
    case 2:
      return launch<TD, int16_t>(a, smem, stream);
    case 4:
      return launch<TD, int32_t>(a, smem, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Both planes of S rows -> ts_out int32 [S, n], val_out float64 [S, n]
// (16-byte aligned), over chunks of `chunk` columns with `smem` bytes of
// workspace a block (ops/device_decode.k1_plan).
extern "C" int vm_decode_tiles(const void* ts_first, const void* ts_fd,
                               const void* ts_d2, int ts_d2_bytes,
                               long long ts_d2w, const void* val_first,
                               const void* val_fd, const void* val_d2,
                               int val_d2_bytes, long long val_d2w,
                               const void* scale, const void* counts,
                               long long S, int n, int chunk, long long smem,
                               void* ts_out, void* val_out, void* stream) {
  if (S <= 0 || n <= 0) return 0;
  if (chunk < 1 || (reinterpret_cast<uintptr_t>(ts_out) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(val_out) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  K1Args a;
  a.ts_first = static_cast<const int32_t*>(ts_first);
  a.ts_fd = static_cast<const int32_t*>(ts_fd);
  a.val_first = static_cast<const int32_t*>(val_first);
  a.val_fd = static_cast<const int32_t*>(val_fd);
  a.counts = static_cast<const int32_t*>(counts);
  a.ts_d2 = ts_d2;
  a.val_d2 = val_d2;
  a.ts_d2w = ts_d2w;
  a.val_d2w = val_d2w;
  a.scale = static_cast<const double*>(scale);
  a.ts_out = static_cast<int32_t*>(ts_out);
  a.val_out = static_cast<double*>(val_out);
  a.S = S;
  a.n = n;
  a.chunk = chunk;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (ts_d2_bytes) {
    case 1:
      return launch_val<int8_t>(a, val_d2_bytes, smem, st);
    case 2:
      return launch_val<int16_t>(a, val_d2_bytes, smem, st);
    case 4:
      return launch_val<int32_t>(a, val_d2_bytes, smem, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* vm_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
