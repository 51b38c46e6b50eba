// The mesh layer's own kernels: B13's cross-shard combine and B15's halo
// pass.
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
// The shards of one card run as one launch per phase: halo_compact here,
// then rollup.cu's row scan, scratch pass and series pass over the same
// D shards (ShardBlocks).  halo_compact decides per row, on the card,
// whether the row can be read in place (its halo and columns one segment
// of a tile row, every flag valid: the compacted row would be that
// segment) or must be compacted (a gap, or a halo copied from another
// card); only the latter is written.  The passes shift either source's
// timestamps by the shard's grid offset in registers, which is the
// reference's ts - shift in wrapping int32 arithmetic, and the series
// pass adds shift / 1e3 (one float64 division, as the reference's
// shift.astype(f64) / 1e3) to the time-valued funcs' values as it
// stores them.
//
// Bound: bytes.  The combine reads D x M x G x T float64 and writes G x T;
// B15 must read each of a row's H + C samples once (13 B: ts, value,
// flag) and write its [rows, T] block.  halo_compact reads the flags
// (1 B a column) of a row it leaves in place, and reads 13 B and writes
// 12 B a valid sample of a row it compacts.

#include <cuda_runtime.h>
#include <stdint.h>

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

// B15's halo pass over the D (series, time) shards of one card, one warp
// per row: shard d's row reads its halo's H[d] columns (the left
// neighbour's last ones; none for the first time shard) then its C own
// columns, each array through its row stride.  Where the shard's halo and
// columns are one segment of each row of one tile (inplace[d]) and all
// H[d] + C flags of the row are valid, the row is read in place by the
// passes: src[r] = 0, counts[r] = H[d] + C, nothing written.  Any other
// row is compacted: its valid samples in time order (a ballot a 32
// columns gives each its place: the stable argsort's order) into row r
// of cts / cvals (N columns, raw timestamps: the passes shift them),
// src[r] = 1, counts[r] = the valid samples.
constexpr int kHaloFields = 15;  // desc values per shard (parallel/mesh.py)
constexpr int kMaxShards = 16;   // rollup.cu's

struct HaloShard {
  const int32_t* ts;
  const double* vals;
  const bool* valid;
  const int32_t* h_ts;
  const double* h_vals;
  const bool* h_valid;
  long long ts_ld, vals_ld, valid_ld, h_ts_ld, h_vals_ld, h_valid_ld;
  int H, inplace;
};

struct HaloArgs {
  HaloShard sh[kMaxShards];
  long long row0[kMaxShards + 1];
  int D, C, N;
  int32_t* cts;
  double* cvals;
  int32_t* counts;
  int32_t* src;
};

// Whether any byte of x is 0 (a false flag among four).
__device__ __forceinline__ bool has_zero_byte(unsigned x) {
  return ((x - 0x01010101u) & ~x & 0x80808080u) != 0u;
}

__global__ void __launch_bounds__(kCombineThreads)
halo_compact(HaloArgs a) {
  const long long r =
      static_cast<long long>(blockIdx.x) * (kCombineThreads / 32) +
      (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  const unsigned full = 0xffffffffu;
  if (r >= a.row0[a.D]) return;  // uniform across the warp
  int d = 0;
  while (d + 1 < a.D && r >= a.row0[d + 1]) ++d;
  const HaloShard& h = a.sh[d];
  const long long local = r - a.row0[d];
  const int H = h.H, W = h.H + a.C;
  const bool* hv = h.h_valid + local * h.h_valid_ld;
  const bool* lv = h.valid + local * h.valid_ld;
  bool in_place = h.inplace != 0;
  if (in_place) {  // every flag valid?  The segment is one run of W bytes
    const unsigned char* seg =
        reinterpret_cast<const unsigned char*>(H ? hv : lv);
    const int head = static_cast<int>(
        min(static_cast<long long>((16 - (reinterpret_cast<uintptr_t>(seg) &
                                          15)) & 15),
            static_cast<long long>(W)));
    const int nvec = (W - head) / 16;  // 16-byte words after the head
    const int tail = head + 16 * nvec;
    bool ok = true;
    if (lane < head) ok = seg[lane] != 0;
    if (lane < W - tail) ok = ok && seg[tail + lane] != 0;
    const uint4* vec = reinterpret_cast<const uint4*>(seg + head);
    for (int c0 = 0; c0 < nvec; c0 += 128) {  // 4 loads a lane in flight
      uint4 x[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int c = c0 + 32 * k + lane;
        x[k] = c < nvec ? vec[c] : make_uint4(~0u, ~0u, ~0u, ~0u);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k)
        ok = ok && !has_zero_byte(x[k].x) && !has_zero_byte(x[k].y) &&
             !has_zero_byte(x[k].z) && !has_zero_byte(x[k].w);
    }
    in_place = __all_sync(full, ok);
  }
  if (in_place) {
    if (lane == 0) {
      a.counts[r] = W;
      a.src[r] = 0;
    }
    return;
  }
  const int32_t* ht = h.h_ts + local * h.h_ts_ld;
  const double* hx = h.h_vals + local * h.h_vals_ld;
  const int32_t* lt = h.ts + local * h.ts_ld;
  const double* lx = h.vals + local * h.vals_ld;
  int32_t* ct = a.cts + r * a.N;
  double* cx = a.cvals + r * a.N;
  const unsigned below = (1u << lane) - 1u;
  int carry = 0;
  for (int base = 0; base < W; base += 32) {
    const int j = base + lane;
    const bool ok = j < W && (j < H ? hv[j] : lv[j - H]);
    const unsigned m = __ballot_sync(full, ok);
    if (ok) {
      const int p = carry + __popc(m & below);
      ct[p] = j < H ? ht[j] : lt[j - H];
      cx[p] = j < H ? hx[j] : lx[j - H];
    }
    carry += __popc(m);
  }
  if (lane == 0) {
    a.counts[r] = carry;
    a.src[r] = 1;
  }
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

// B15's halo pass over the D shards of one card: `desc` holds
// kHaloFields values per shard (parallel/mesh.py _halo_desc): ts, its row
// stride, vals, its stride, valid, its stride, the halo's three arrays
// and strides (null with H = 0), the rows, H and inplace.  Outputs over
// the concatenation of the shards' rows: counts, src, and the compacted
// rows in cts / cvals [rows, N] (N >= H + C).
extern "C" int vm_halo_compact(int D, const long long* desc, int C, int N,
                               void* cts, void* cvals, void* counts,
                               void* src, void* stream) {
  if (D < 1 || D > kMaxShards || C < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  HaloArgs a{};
  a.D = D;
  a.C = C;
  a.N = N;
  for (int d = 0; d < D; ++d) {
    const long long* f = desc + static_cast<long long>(d) * kHaloFields;
    HaloShard& h = a.sh[d];
    h.ts = reinterpret_cast<const int32_t*>(f[0]);
    h.ts_ld = f[1];
    h.vals = reinterpret_cast<const double*>(f[2]);
    h.vals_ld = f[3];
    h.valid = reinterpret_cast<const bool*>(f[4]);
    h.valid_ld = f[5];
    h.h_ts = reinterpret_cast<const int32_t*>(f[6]);
    h.h_ts_ld = f[7];
    h.h_vals = reinterpret_cast<const double*>(f[8]);
    h.h_vals_ld = f[9];
    h.h_valid = reinterpret_cast<const bool*>(f[10]);
    h.h_valid_ld = f[11];
    h.H = static_cast<int>(f[13]);
    h.inplace = static_cast<int>(f[14]);
    if (f[12] < 0 || f[13] < 0 || f[13] + C > N ||
        (f[13] > 0 && (f[6] == 0 || f[8] == 0 || f[10] == 0)))
      return static_cast<int>(cudaErrorInvalidValue);
    a.row0[d + 1] = a.row0[d] + f[12];
  }
  a.cts = static_cast<int32_t*>(cts);
  a.cvals = static_cast<double*>(cvals);
  a.counts = static_cast<int32_t*>(counts);
  a.src = static_cast<int32_t*>(src);
  const long long R = a.row0[D];
  if (R <= 0 || C + N <= 0) return 0;
  const long long per = kCombineThreads / 32;
  halo_compact<<<static_cast<unsigned>((R + per - 1) / per),
                 kCombineThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* vm_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
