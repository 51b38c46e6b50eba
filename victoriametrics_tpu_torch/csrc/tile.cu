// K3 append_tile and K4 compact_tile: the rolling tile's two maintenance
// passes, both per-row scatter/gather.
//
// K3 replaces victoriametrics_tpu/ops/device_rollup.py:append_tile.  Each
// row's K new samples land after its counts[row] existing ones; positions
// at or past N are dropped, and counts[row] += new_counts[row].  The
// reference donated its buffers to XLA; this kernel writes IN PLACE on the
// resident ts / values / counts tensors.  One warp per row: every lane
// reads counts[row] before the warp synchronises and lane 0 writes the new
// count, so no lane sees a half-updated row.
//
// K4 replaces victoriametrics_tpu/ops/device_rollup.py:compact_tile.  Each
// row drops its samples with ts < cutoff_rel (a sorted row's prefix),
// moves the survivors to the front and rebases them by -delta; the freed
// tail is TS_PAD / 0.0.  Shifting a row left in place is a read-after-
// write hazard between threads, so the kernel writes fresh output tensors
// and the caller drops the old ones, as the reference's donation did.
// One 256-thread block per row: a block reduction counts the dropped
// prefix, then the block copies the row.
//
// Bound: bytes.  K3 reads each row's live new samples (the first
// new_counts[row] of its K columns, 12 B each) and writes the same bytes
// into the tile, plus the counts; K4 reads the survivors (12 B each) and
// the timestamps of the dropped prefix (4 B each) and writes the whole
// [S, N] output tile (12 B per column).  Both are single coalesced passes
// with no arithmetic beyond an int32 rebase.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kAppendThreads = 256;
constexpr int kCompactThreads = 256;
constexpr int32_t kTsPad = 2147483647;

__global__ void __launch_bounds__(kAppendThreads)
append_rows(int32_t* __restrict__ ts, double* __restrict__ vals,
            int32_t* __restrict__ counts, const int32_t* __restrict__ new_ts,
            const double* __restrict__ new_vals,
            const int32_t* __restrict__ new_counts, long long S, int N,
            int K) {
  const long long row =
      static_cast<long long>(blockIdx.x) * (kAppendThreads / 32) +
      (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= S) return;  // uniform across the warp
  const int c = counts[row];
  const int nc = new_counts[row];
  const long long off = row * static_cast<long long>(N);
  const long long noff = row * static_cast<long long>(K);
  for (int k = lane; k < K && k < nc; k += 32) {
    const long long pos = static_cast<long long>(c) + k;
    if (pos >= 0 && pos < N) {
      ts[off + pos] = new_ts[noff + k];
      vals[off + pos] = new_vals[noff + k];
    }
  }
  __syncwarp();
  if (lane == 0) {
    counts[row] = static_cast<int32_t>(static_cast<uint32_t>(c) +
                                       static_cast<uint32_t>(nc));
  }
}

__global__ void __launch_bounds__(kCompactThreads)
compact_rows(const int32_t* __restrict__ ts, const double* __restrict__ vals,
             const int32_t* __restrict__ counts, int32_t* __restrict__ ts_out,
             double* __restrict__ vals_out, int32_t* __restrict__ counts_out,
             int N, int32_t cutoff, int32_t delta) {
  __shared__ int warp_drop[kCompactThreads / 32];
  const long long row = blockIdx.x;
  const long long off = row * static_cast<long long>(N);
  const int c = counts[row];
  const int valid = c < N ? c : N;
  int local = 0;
  for (int i = threadIdx.x; i < valid; i += kCompactThreads) {
    local += ts[off + i] < cutoff ? 1 : 0;
  }
  for (int o = 16; o > 0; o >>= 1) {
    local += __shfl_down_sync(0xffffffffu, local, o);
  }
  if ((threadIdx.x & 31) == 0) warp_drop[threadIdx.x >> 5] = local;
  __syncthreads();
  int drop = 0;
  for (int w = 0; w < kCompactThreads / 32; ++w) drop += warp_drop[w];
  const int nc = c - drop;
  for (int k = threadIdx.x; k < N; k += kCompactThreads) {
    if (k < nc) {
      int src = drop + k;
      src = src < N - 1 ? src : N - 1;
      ts_out[off + k] = static_cast<int32_t>(
          static_cast<uint32_t>(ts[off + src]) -
          static_cast<uint32_t>(delta));
      vals_out[off + k] = vals[off + src];
    } else {
      ts_out[off + k] = kTsPad;
      vals_out[off + k] = 0.0;
    }
  }
  if (threadIdx.x == 0) counts_out[row] = nc;
}

}  // namespace

extern "C" int vm_append_tile(void* ts, void* vals, void* counts,
                              const void* new_ts, const void* new_vals,
                              const void* new_counts, long long S, int N,
                              int K, void* stream) {
  if (S <= 0) return 0;
  const long long per_block = kAppendThreads / 32;
  const unsigned blocks = static_cast<unsigned>((S + per_block - 1) /
                                                per_block);
  append_rows<<<blocks, kAppendThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(ts), static_cast<double*>(vals),
      static_cast<int32_t*>(counts), static_cast<const int32_t*>(new_ts),
      static_cast<const double*>(new_vals),
      static_cast<const int32_t*>(new_counts), S, N, K);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int vm_compact_tile(const void* ts, const void* vals,
                               const void* counts, void* ts_out,
                               void* vals_out, void* counts_out, long long S,
                               int N, int cutoff, int delta, void* stream) {
  if (S <= 0) return 0;
  compact_rows<<<static_cast<unsigned>(S), kCompactThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ts), static_cast<const double*>(vals),
      static_cast<const int32_t*>(counts), static_cast<int32_t*>(ts_out),
      static_cast<double*>(vals_out), static_cast<int32_t*>(counts_out), N,
      cutoff, delta);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* vm_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
