// The mesh layer's own kernels: B13's cross-shard combine and B15's halo
// compaction and time add-back.
//
// B13 replaces victoriametrics_tpu/parallel/mesh.py:sharded_rollup_aggregate
// (with its memoised form cached_sharded_rollup_aggregate): K2 jitted with
// series-sharded inputs, where GSPMD reduces partial_group_moments across
// the shards (psum / pmin / pmax) and then finalize_group_moments runs.
// Here each shard's K2 group walk writes its moments [M, G, T]
// (rollup.cu rollup_group_moments) into one [D, M, G, T] buffer on the
// first shard's card, and combine_moments folds the D shards for each
// (group, step) IN SHARD ORDER with moments_merge (sums add, extrema keep
// the first of equal values) and finalizes with finalize_moments, the
// operations K2 itself ends with (moments.cuh).  A group's rows are walked
// in ascending order and the shards are consecutive row blocks, so count,
// group, min and max equal the unsharded K2 bit for bit; sum, avg,
// stddev and stdvar differ from it only in how the sums associate.
//
// B15 replaces victoriametrics_tpu/parallel/mesh.py:time_sharded_rollup
// (shard_map over (series, time): a ring halo by lax.ppermute, a stable
// argsort that compacts the valid samples, then rollup_tile_shifted).
// halo_compact, one block per row of a (series, time) shard: the left
// neighbour's last H columns (none for the first time shard, whose ring
// halo the reference masks) and the shard's own C columns, read through
// row strides (views of one tile need no copy), keep their valid samples
// in time order (a block scan of the valid flags gives each sample its
// place: the stable argsort's order), written as ts - shift in wrapping
// int32 arithmetic; past the count the row is TS_PAD / 0.0 and counts[r]
// is the count.  B5 then rolls the compacted tile up with shift 0 on the
// shard's grid.  add_seconds adds shift / 1e3 (one float64 division, as
// the reference's shift.astype(f64) / 1e3) to the time-valued funcs'
// output block in place.
//
// Bound: bytes.  The combine reads D x M x G x T float64 and writes G x T;
// halo_compact reads H + C samples per row (13 B each: ts, value, flag)
// and writes H + C columns (12 B each); add_seconds reads and writes its
// block once.

#include <cuda_runtime.h>
#include <stdint.h>

#include "decode.cuh"
#include "moments.cuh"

namespace {

constexpr int kCombineThreads = 256;

__global__ void __launch_bounds__(kCombineThreads)
combine_moments(const double* __restrict__ moments, int D, int M,
                long long GT, int aggr, double* __restrict__ out) {
  const long long e =
      static_cast<long long>(blockIdx.x) * kCombineThreads + threadIdx.x;
  if (e >= GT) return;
  Moments m = moments_empty();
  for (int d = 0; d < D; ++d) {
    Moments p = moments_empty();
    for (int k = 0; k < M; ++k)
      moment_set(p, aggr, k, moments[(static_cast<long long>(d) * M + k) *
                                         GT + e]);
    moments_merge(m, p);
  }
  out[e] = finalize_moments(m, aggr);
}

__global__ void __launch_bounds__(kDecodeThreads)
halo_compact(const int32_t* __restrict__ ts, long long ts_ld,
             const double* __restrict__ vals, long long vals_ld,
             const bool* __restrict__ valid, long long valid_ld,
             const int32_t* __restrict__ h_ts, long long h_ts_ld,
             const double* __restrict__ h_vals, long long h_vals_ld,
             const bool* __restrict__ h_valid, long long h_valid_ld, int C,
             int H, int32_t shift, int32_t* __restrict__ ts_out,
             double* __restrict__ vals_out, int32_t* __restrict__ counts) {
  __shared__ uint32_t warp_sums[kDecodeWarps];
  const long long r = blockIdx.x;
  const int W = H + C;
  const long long o = r * W;
  uint32_t carry = 0u;
  for (int base = 0; base < W; base += kDecodeThreads) {
    const int j = base + threadIdx.x;
    bool ok = false;
    int32_t t = 0;
    double v = 0.0;
    if (j < H) {
      if (h_valid != nullptr && h_valid[r * h_valid_ld + j]) {
        ok = true;
        t = h_ts[r * h_ts_ld + j];
        v = h_vals[r * h_vals_ld + j];
      }
    } else if (j < W && valid[r * valid_ld + (j - H)]) {
      ok = true;
      t = ts[r * ts_ld + (j - H)];
      v = vals[r * vals_ld + (j - H)];
    }
    uint32_t tot;
    const uint32_t incl = block_scan(ok ? 1u : 0u, warp_sums, &tot);
    if (ok) {
      const long long p = o + carry + incl - 1u;
      ts_out[p] = static_cast<int32_t>(static_cast<uint32_t>(t) -
                                       static_cast<uint32_t>(shift));
      vals_out[p] = v;
    }
    carry += tot;
  }
  for (int p = static_cast<int>(carry) + threadIdx.x; p < W;
       p += kDecodeThreads) {
    ts_out[o + p] = kTsPad;
    vals_out[o + p] = 0.0;
  }
  if (threadIdx.x == 0) counts[r] = static_cast<int32_t>(carry);
}

__global__ void __launch_bounds__(kCombineThreads)
add_seconds(double* __restrict__ out, long long ld, long long R, int cols,
            int32_t shift) {
  const long long e =
      static_cast<long long>(blockIdx.x) * kCombineThreads + threadIdx.x;
  if (e >= R * cols) return;
  const long long r = e / cols;
  const double add = static_cast<double>(shift) / 1e3;  // a true division
  out[r * ld + (e - r * cols)] += add;
}

unsigned blocks_for(long long n) {
  return static_cast<unsigned>((n + kCombineThreads - 1) / kCombineThreads);
}

}  // namespace

// B13's combine: moments [D, M, G*T] (M = moment_count(aggr)) -> out [G*T].
extern "C" int vm_combine_moments(const void* moments, int D, int M,
                                  long long GT, int aggr, void* out,
                                  void* stream) {
  if (GT <= 0) return 0;
  if (D <= 0 || aggr < aSum || aggr > aGroup || M != moment_count(aggr))
    return static_cast<int>(cudaErrorInvalidValue);
  combine_moments<<<blocks_for(GT), kCombineThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(moments), D, M, GT, aggr,
      static_cast<double*>(out));
  return static_cast<int>(cudaGetLastError());
}

// B15's halo compaction of R rows: local columns [R, C] and halo columns
// [R, H] (h_* null: masked), each with its row stride -> ts_out, vals_out
// [R, H + C] and counts [R].
extern "C" int vm_halo_compact(
    const void* ts, long long ts_ld, const void* vals, long long vals_ld,
    const void* valid, long long valid_ld, const void* h_ts,
    long long h_ts_ld, const void* h_vals, long long h_vals_ld,
    const void* h_valid, long long h_valid_ld, long long R, int C, int H,
    int shift, void* ts_out, void* vals_out, void* counts, void* stream) {
  if (R <= 0 || C + H <= 0) return 0;
  if (C < 0 || H < 0) return static_cast<int>(cudaErrorInvalidValue);
  halo_compact<<<static_cast<unsigned>(R), kDecodeThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ts), ts_ld,
      static_cast<const double*>(vals), vals_ld,
      static_cast<const bool*>(valid), valid_ld,
      static_cast<const int32_t*>(h_ts), h_ts_ld,
      static_cast<const double*>(h_vals), h_vals_ld,
      static_cast<const bool*>(h_valid), h_valid_ld, C, H, shift,
      static_cast<int32_t*>(ts_out), static_cast<double*>(vals_out),
      static_cast<int32_t*>(counts));
  return static_cast<int>(cudaGetLastError());
}

// B15's add-back for the time-valued funcs: out[r * ld + c] += shift / 1e3
// over an [R, cols] block, in place.
extern "C" int vm_add_seconds(void* out, long long ld, long long R, int cols,
                              int shift, void* stream) {
  if (R <= 0 || cols <= 0) return 0;
  add_seconds<<<blocks_for(R * cols), kCombineThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<double*>(out), ld, R, cols, shift);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* vm_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
