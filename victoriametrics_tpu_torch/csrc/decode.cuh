// The nearest-delta2 row decode of K1 (decode.cu decode_tiles) and B12
// (rollup.cu decode_rollup): block_scan2, a block scan of the two
// planes' uint32 sums at once, which both use, and decode_row_pair, B12's
// decode of a whole row from global memory.  See decode.cu for the
// arithmetic.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int32_t kTsPad = 2147483647;

// One row of a delta plane as B12 reads it: the first value, the first
// delta and the row's d2 entries of `bytes` bytes (1, 2 or 4).
struct PlaneRow {
  uint32_t x0, fd;
  const unsigned char* d2;
  int bytes;
  // column j's a: 0, fd, then d2[j - 2] sign-extended (the
  // element size is uniform across the block)
  __device__ __forceinline__ uint32_t a(int j) const {
    if (j < 2) return j == 1 ? fd : 0u;
    const int k = j - 2;
    if (bytes == 1)
      return static_cast<uint32_t>(
          static_cast<int32_t>(reinterpret_cast<const int8_t*>(d2)[k]));
    if (bytes == 2)
      return static_cast<uint32_t>(
          static_cast<int32_t>(reinterpret_cast<const int16_t*>(d2)[k]));
    return static_cast<uint32_t>(reinterpret_cast<const int32_t*>(d2)[k]);
  }
};

// Block-wide inclusive scan of two uint32 values at once (the two
// planes' sums, mod 2^32) over a block of `warps` warps (at most 32;
// warp_sums holds that many).  Every thread of the block must call it;
// *total, when given, receives the sums over the block.
__device__ __forceinline__ uint2 block_scan2(uint2 v, uint2* warp_sums,
                                             int warps,
                                             uint2* total = nullptr) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(0xffffffffu, v.x, o);
    const uint32_t z = __shfl_up_sync(0xffffffffu, v.y, o);
    if (lane >= o) {
      v.x += y;
      v.y += z;
    }
  }
  if (lane == 31) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    uint2 w = lane < warps ? warp_sums[lane] : make_uint2(0u, 0u);
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t y = __shfl_up_sync(0xffffffffu, w.x, o);
      const uint32_t z = __shfl_up_sync(0xffffffffu, w.y, o);
      if (lane >= o) {
        w.x += y;
        w.y += z;
      }
    }
    if (lane < warps) warp_sums[lane] = w;
  }
  __syncthreads();
  if (warp > 0) {
    v.x += warp_sums[warp - 1].x;
    v.y += warp_sums[warp - 1].y;
  }
  if (total != nullptr) *total = warp_sums[warps - 1];
  __syncthreads();  // warp_sums is rewritten by the next call
  return v;
}

// B12's row decode: both planes of one row, the timestamps into ts_row
// (TS_PAD from column cnt on) and the values, (int32)x * sc, into
// val_row, K1's values by thread-contiguous segments over the
// whole block (a multiple of 32 threads, at most 1024): thread p owns
// the columns [p L, p L + L), L the least odd number with blockDim.x L
// >= n (odd, so a warp's shared-memory words fall in distinct banks).
// Pass 1 sums each plane's a and its running b over the segment, both
// planes' loads issued 8 columns at a time; two block scans of the pairs
// give those sums over the earlier segments; pass 2 rebuilds the
// segment's x, reading back the a it stashed in the row (a timestamp
// word; a value's low word: the same thread's words).  Two block scans a
// row.  Every sum is uint32 arithmetic mod 2^32, which is associative,
// so the values are K1's bit for bit.
__device__ void decode_row_pair(const PlaneRow& tp, const PlaneRow& vp,
                                int n, int cnt, double sc, int32_t* ts_row,
                                double* val_row, uint2* warp_sums) {
  constexpr int kBatch = 8;
  const int threads = blockDim.x;
  const int L = ((n + threads - 1) / threads) | 1;
  const int j0 = min(static_cast<int>(threadIdx.x) * L, n);
  const int j1 = min(j0 + L, n);
  uint32_t* tst = reinterpret_cast<uint32_t*>(ts_row);
  uint32_t* vst = reinterpret_cast<uint32_t*>(val_row);  // low words
  uint2 sa = make_uint2(0u, 0u), sb = make_uint2(0u, 0u);
  const auto add = [&](int j, uint32_t at, uint32_t av) {
    tst[j] = at;
    vst[2 * j] = av;
    sa.x += at;
    sa.y += av;
    sb.x += sa.x;
    sb.y += sa.y;
  };
  int j = j0;
  for (; j + kBatch <= j1; j += kBatch) {
    uint32_t at[kBatch], av[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      at[u] = tp.a(j + u);
      av[u] = vp.a(j + u);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) add(j + u, at[u], av[u]);
  }
  for (; j < j1; ++j) add(j, tp.a(j), vp.a(j));
  const int warps = threads >> 5;
  uint2 ca = block_scan2(sa, warp_sums, warps);
  ca.x -= sa.x;
  ca.y -= sa.y;
  // a segment's b summed: each b carries the earlier segments' a
  const uint32_t len = static_cast<uint32_t>(j1 - j0);
  const uint2 seg = make_uint2(len * ca.x + sb.x, len * ca.y + sb.y);
  uint2 cb = block_scan2(seg, warp_sums, warps);
  uint32_t bt = ca.x, bv = ca.y;
  uint32_t xt = tp.x0 + (cb.x - seg.x), xv = vp.x0 + (cb.y - seg.y);
  for (j = j0; j < j1; ++j) {
    bt += tst[j];
    bv += vst[2 * j];
    xt += bt;
    xv += bv;
    ts_row[j] = j < cnt ? static_cast<int32_t>(xt) : kTsPad;
    val_row[j] = static_cast<double>(static_cast<int32_t>(xv)) * sc;
  }
}

}  // namespace
