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
// wraps to the same bits.  The headroom columns past a row's count hold
// zero d2 and decode into a linear tail that can overflow: that tail is
// reproduced bit for bit.  ts is TS_PAD past counts[row]; values are
// (double)(int32)x * scale[row], one IEEE multiply (the library is built
// with --fmad=false, and there is nothing to contract here anyway).
//
// The row decode itself lives in decode.cuh, which B12 (rollup.cu
// decode_rollup) shares.
//
// Bound: bytes.  A row reads its d2 plane (1, 2 or 4 B per column) plus a
// few scalars and writes 4 B (ts plane) or 8 B (values plane) per column;
// there are two adds per element.  Design: one 256-thread block per row
// and plane walks the row in 256-column chunks; each chunk is a two-level
// inclusive scan (warp shuffles, then the eight warp totals) carried from
// chunk to chunk, so each byte is read once and written once, coalesced.

#include <cuda_runtime.h>
#include <stdint.h>

#include "decode.cuh"

namespace {

// One block per row.  Exactly one of ts_out (timestamp plane, masked to
// TS_PAD past counts) and val_out (value plane, scaled) is non-null.
template <typename D2>
__global__ void __launch_bounds__(kDecodeThreads)
decode_plane(const int32_t* __restrict__ first,
             const int32_t* __restrict__ fdelta,
             const D2* __restrict__ d2, int d2w,
             const int32_t* __restrict__ counts,
             const double* __restrict__ scale,
             int32_t* __restrict__ ts_out, double* __restrict__ val_out,
             int n) {
  __shared__ uint32_t warp_sums[kDecodeWarps];
  const long long row = blockIdx.x;
  const long long o = row * static_cast<long long>(n);
  decode_row(static_cast<uint32_t>(first[row]),
             static_cast<uint32_t>(fdelta[row]),
             d2 + row * static_cast<long long>(d2w), n,
             ts_out != nullptr ? counts[row] : 0,
             val_out != nullptr ? scale[row] : 0.0,
             ts_out != nullptr ? ts_out + o : nullptr,
             val_out != nullptr ? val_out + o : nullptr, warp_sums);
}

template <typename D2>
void launch(const void* first, const void* fdelta, const void* d2, int d2w,
            const void* counts, const void* scale, void* ts_out,
            void* val_out, long long S, int n, cudaStream_t stream) {
  decode_plane<D2><<<static_cast<unsigned>(S), kDecodeThreads, 0, stream>>>(
      static_cast<const int32_t*>(first), static_cast<const int32_t*>(fdelta),
      static_cast<const D2*>(d2), d2w, static_cast<const int32_t*>(counts),
      static_cast<const double*>(scale), static_cast<int32_t*>(ts_out),
      static_cast<double*>(val_out), n);
}

}  // namespace

extern "C" int vm_decode_plane(const void* first, const void* fdelta,
                               const void* d2, int d2_bytes, int d2w,
                               const void* counts, const void* scale,
                               void* ts_out, void* val_out, long long S,
                               int n, void* stream) {
  if (S <= 0 || n <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d2_bytes) {
    case 1:
      launch<int8_t>(first, fdelta, d2, d2w, counts, scale, ts_out, val_out,
                     S, n, st);
      break;
    case 2:
      launch<int16_t>(first, fdelta, d2, d2w, counts, scale, ts_out, val_out,
                      S, n, st);
      break;
    case 4:
      launch<int32_t>(first, fdelta, d2, d2w, counts, scale, ts_out, val_out,
                      S, n, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* vm_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
