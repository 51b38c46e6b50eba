// K3 append_tile and K4 compact_tile: the rolling tile's two maintenance
// passes, both per-row scatter/gather; B10 fleet_append_tile and B11
// fleet_compact_tile: the same two passes over a fleet bucket's [B, S, N]
// stack of stream tiles.
//
// K3 replaces victoriametrics_tpu/ops/device_rollup.py:append_tile.  Each
// row's first new_counts[row] of its K new samples land after its
// counts[row] existing ones; positions at or past N (or below 0) are
// dropped, and counts[row] += new_counts[row] (uint32 arithmetic).  The
// reference donated its buffers to XLA; this kernel writes IN PLACE on the
// resident ts / values / counts tensors.  A group of G lanes serves a row
// (ops/device_rollup.append_plan: the least power of two >= K / 2, at
// least 4 and at most a warp: 4 lanes for the K of 8 that a refresh's
// one scrape and a fleet interval's four pad to, a warp for the
// resume's 120),
// consecutive groups consecutive rows, so the counts and new_counts
// loads are coalesced and a store instruction writes a run of columns in
// each of 32 / G rows (with a thread a row, it would scatter over 32
// rows: slower, as measured).  A lane loads up to 4 of its
// columns before it stores them; those loads wait on new_counts only, the
// stores' addresses on counts.  A lane never reads a column past
// new_counts[row], and a row with new_counts 0 is untouched.  Every lane
// of a group reads counts[row] before the warp synchronises and the
// group's first lane writes the new count, so no lane sees a
// half-updated row.
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
// B10 replaces victoriametrics_tpu/ops/device_rollup.py:fleet_append_tile
// (jax.vmap of the append over the leading stream axis, donated).  The
// append is independent per row, so B10 is K3's kernel over the B x S rows
// of the stack, in place like K3; streams with nothing staged carry
// new_counts 0 and are untouched.
//
// B11 replaces victoriametrics_tpu/ops/device_rollup.py:fleet_compact_tile:
// K4's compaction with each stream's cutoff and delta read from [B] device
// arrays (block row / S).  Every slot is compacted, as in the reference: a
// slot given cutoff 0 drops its live samples with ts < 0 and keeps the
// rest unchanged.  Fresh output tensors, as K4.
//
// Bound: bytes.  K3 reads each row's live new samples (the first
// new_counts[row] of its K columns, 12 B each) and writes the same bytes
// into the tile, plus the counts (at the shapes served, less time than a
// launch takes); K4 reads the survivors (12 B each) and
// the timestamps of the dropped prefix (4 B each) and writes the whole
// [S, N] output tile (12 B per column).  Both are single coalesced passes
// with no arithmetic beyond an int32 rebase; B10 and B11 move the same
// bytes per row over B x S rows.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kAppendThreads = 256;
constexpr int kCompactThreads = 256;
constexpr int32_t kTsPad = 2147483647;

// the columns a lane loads before it stores
constexpr int kAppendBatch = 4;

template <int G>
__global__ void __launch_bounds__(kAppendThreads)
append_rows(int32_t* __restrict__ ts, double* __restrict__ vals,
            int32_t* __restrict__ counts, const int32_t* __restrict__ new_ts,
            const double* __restrict__ new_vals,
            const int32_t* __restrict__ new_counts, long long S, int N,
            int K) {
  const long long t =
      static_cast<long long>(blockIdx.x) * kAppendThreads + threadIdx.x;
  const long long row = t / G;
  const int lane = static_cast<int>(t % G);
  const bool on = row < S;
  const int nc = on ? new_counts[row] : 0;
  const int c = on ? counts[row] : 0;
  const int m = min(K, nc);  // the live columns
  const long long off = row * static_cast<long long>(N);
  const long long noff = row * static_cast<long long>(K);
  for (int k0 = lane; k0 < m; k0 += kAppendBatch * G) {
    int32_t nt[kAppendBatch];
    double nv[kAppendBatch];
#pragma unroll
    for (int u = 0; u < kAppendBatch; ++u) {
      const int k = k0 + u * G;
      if (k < m) {
        nt[u] = new_ts[noff + k];
        nv[u] = new_vals[noff + k];
      }
    }
#pragma unroll
    for (int u = 0; u < kAppendBatch; ++u) {
      const int k = k0 + u * G;
      const long long pos = static_cast<long long>(c) + k;
      if (k < m && pos >= 0 && pos < N) {
        ts[off + pos] = nt[u];
        vals[off + pos] = nv[u];
      }
    }
  }
  __syncwarp();  // the group's lanes have read counts[row]
  if (on && lane == 0 && nc != 0)
    counts[row] = static_cast<int32_t>(static_cast<uint32_t>(c) +
                                       static_cast<uint32_t>(nc));
}

__global__ void __launch_bounds__(kCompactThreads)
compact_rows(const int32_t* __restrict__ ts, const double* __restrict__ vals,
             const int32_t* __restrict__ counts, int32_t* __restrict__ ts_out,
             double* __restrict__ vals_out, int32_t* __restrict__ counts_out,
             int N, int32_t cutoff, int32_t delta,
             const int32_t* __restrict__ cutoffs,
             const int32_t* __restrict__ deltas, long long rows_per_stream) {
  __shared__ int warp_drop[kCompactThreads / 32];
  const long long row = blockIdx.x;
  if (cutoffs != nullptr) {  // B11: the row's stream's cutoff and delta
    const long long b = row / rows_per_stream;
    cutoff = cutoffs[b];
    delta = deltas[b];
  }
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

template <int G>
void launch_append(void* ts, void* vals, void* counts, const void* new_ts,
                   const void* new_vals, const void* new_counts, long long S,
                   int N, int K, cudaStream_t stream) {
  const long long threads = S * G;
  append_rows<G><<<static_cast<unsigned>((threads + kAppendThreads - 1) /
                                         kAppendThreads),
                   kAppendThreads, 0, stream>>>(
      static_cast<int32_t*>(ts), static_cast<double*>(vals),
      static_cast<int32_t*>(counts), static_cast<const int32_t*>(new_ts),
      static_cast<const double*>(new_vals),
      static_cast<const int32_t*>(new_counts), S, N, K);
}

// `lanes` a row (ops/device_rollup.append_plan): 4, 8, 16 or 32.
int append(void* ts, void* vals, void* counts, const void* new_ts,
           const void* new_vals, const void* new_counts, long long S, int N,
           int K, int lanes, void* stream) {
  if (S <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (lanes) {
    case 4:
      launch_append<4>(ts, vals, counts, new_ts, new_vals, new_counts, S, N,
                       K, st);
      break;
    case 8:
      launch_append<8>(ts, vals, counts, new_ts, new_vals, new_counts, S, N,
                       K, st);
      break;
    case 16:
      launch_append<16>(ts, vals, counts, new_ts, new_vals, new_counts, S, N,
                        K, st);
      break;
    case 32:
      launch_append<32>(ts, vals, counts, new_ts, new_vals, new_counts, S, N,
                        K, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

int compact(const void* ts, const void* vals, const void* counts,
            void* ts_out, void* vals_out, void* counts_out, long long S,
            int N, int cutoff, int delta, const void* cutoffs,
            const void* deltas, long long rows_per_stream, void* stream) {
  if (S <= 0) return 0;
  compact_rows<<<static_cast<unsigned>(S), kCompactThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ts), static_cast<const double*>(vals),
      static_cast<const int32_t*>(counts), static_cast<int32_t*>(ts_out),
      static_cast<double*>(vals_out), static_cast<int32_t*>(counts_out), N,
      cutoff, delta, static_cast<const int32_t*>(cutoffs),
      static_cast<const int32_t*>(deltas), rows_per_stream);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int vm_append_tile(void* ts, void* vals, void* counts,
                              const void* new_ts, const void* new_vals,
                              const void* new_counts, long long S, int N,
                              int K, int lanes, void* stream) {
  return append(ts, vals, counts, new_ts, new_vals, new_counts, S, N, K,
                lanes, stream);
}

// B10: [B, S, N] += [B, S, K], in place.
extern "C" int vm_fleet_append_tile(void* ts, void* vals, void* counts,
                                    const void* new_ts, const void* new_vals,
                                    const void* new_counts, long long B,
                                    long long S, int N, int K, int lanes,
                                    void* stream) {
  return append(ts, vals, counts, new_ts, new_vals, new_counts, B * S, N, K,
                lanes, stream);
}

extern "C" int vm_compact_tile(const void* ts, const void* vals,
                               const void* counts, void* ts_out,
                               void* vals_out, void* counts_out, long long S,
                               int N, int cutoff, int delta, void* stream) {
  return compact(ts, vals, counts, ts_out, vals_out, counts_out, S, N, cutoff,
                 delta, nullptr, nullptr, 1, stream);
}

// B11: each stream of the [B, S, N] stack compacted at its cutoff and
// rebased by its delta ([B] int32 each).
extern "C" int vm_fleet_compact_tile(const void* ts, const void* vals,
                                     const void* counts, void* ts_out,
                                     void* vals_out, void* counts_out,
                                     const void* cutoffs, const void* deltas,
                                     long long B, long long S, int N,
                                     void* stream) {
  if (S <= 0) return 0;
  return compact(ts, vals, counts, ts_out, vals_out, counts_out, B * S, N, 0,
                 0, cutoffs, deltas, S, stream);
}

extern "C" const char* vm_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
