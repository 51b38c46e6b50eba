// The nearest-delta2 row decode that K1 (decode.cu) and B12
// (rollup.cu decode_rollup) share, so both rebuild a row bit for bit the
// same way.  See decode.cu for the arithmetic.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDecodeThreads = 256;
constexpr int kDecodeWarps = kDecodeThreads / 32;
constexpr int32_t kTsPad = 2147483647;

// Block-wide inclusive scan of uint32 values (mod 2^32) over a block of
// kDecodeThreads threads.  Every thread of the block must call it; *total
// receives the sum over the block.
__device__ uint32_t block_scan(uint32_t v, uint32_t* warp_sums,
                               uint32_t* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += y;
  }
  if (lane == 31) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    uint32_t w = lane < kDecodeWarps ? warp_sums[lane] : 0u;
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < kDecodeWarps) warp_sums[lane] = w;
  }
  __syncthreads();
  if (warp > 0) v += warp_sums[warp - 1];
  *total = warp_sums[kDecodeWarps - 1];
  __syncthreads();  // warp_sums is rewritten by the next call
  return v;
}

// Decode one row's plane: x[j] = x0 + sum_{k<=j} b[k], b = prefix sums of
// [0, fd, d2...], in uint32.  Exactly one of ts_row (masked to TS_PAD from
// column cnt on) and val_row ((int32)x * sc) is non-null; both address
// the row's n columns.  Every thread of the block must call it.
template <typename D2>
__device__ void decode_row(uint32_t x0, uint32_t fd,
                           const D2* __restrict__ d2row, int n, int cnt,
                           double sc, int32_t* ts_row, double* val_row,
                           uint32_t* warp_sums) {
  uint32_t carry_a = 0u, carry_b = 0u;
  for (int base = 0; base < n; base += kDecodeThreads) {
    const int j = base + threadIdx.x;
    uint32_t a = 0u;
    if (j == 1) {
      a = fd;
    } else if (j >= 2 && j < n) {
      a = static_cast<uint32_t>(static_cast<int32_t>(d2row[j - 2]));
    }
    uint32_t tot;
    const uint32_t b = carry_a + block_scan(a, warp_sums, &tot);
    carry_a += tot;
    const uint32_t x = x0 + carry_b + block_scan(b, warp_sums, &tot);
    carry_b += tot;
    if (j < n) {
      if (ts_row != nullptr) {
        ts_row[j] = j < cnt ? static_cast<int32_t>(x) : kTsPad;
      } else {
        val_row[j] = static_cast<double>(static_cast<int32_t>(x)) * sc;
      }
    }
  }
}

// decode_row with the d2 plane's element size (1, 2 or 4 bytes) chosen at
// run time; the branch is uniform across the block.
__device__ void decode_row_any(int d2_bytes, uint32_t x0, uint32_t fd,
                               const void* d2row, int n, int cnt, double sc,
                               int32_t* ts_row, double* val_row,
                               uint32_t* warp_sums) {
  if (d2_bytes == 1) {
    decode_row(x0, fd, static_cast<const int8_t*>(d2row), n, cnt, sc, ts_row,
               val_row, warp_sums);
  } else if (d2_bytes == 2) {
    decode_row(x0, fd, static_cast<const int16_t*>(d2row), n, cnt, sc,
               ts_row, val_row, warp_sums);
  } else {
    decode_row(x0, fd, static_cast<const int32_t*>(d2row), n, cnt, sc,
               ts_row, val_row, warp_sums);
  }
}

}  // namespace
