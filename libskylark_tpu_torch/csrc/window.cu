// Row scatter-accumulate and scaled row gather for Hopper (sm_90a).
//
// Replaces libskylark_tpu/sketch/pallas_window.py:
//   scatter_rows        (pallas_window.py:228, _scatter_rows_impl :172, _window_kernel :130)
//   gather_scaled_rows  (pallas_window.py:364, _gather_rows_impl :330, _gather_kernel :312)
//
// scatter_rows:  out[b[h,i], :] += v[h,i] * A[i, :]   (f32 accumulate), optionally
//                out = acc + that, as one IEEE add (bitwise acc + scatter_rows(...)).
// gather_scaled_rows:  out[j, :] = scale * T[idx[j], :]   (bitwise T.index_select * scale).
//
// What bounds them on the H100: bytes.  Both do at most two flops per element
// of A or T they read.
//
// scatter_rows must be deterministic run to run (fused == unfused, planned ==
// eager and kill/resume all rest on it), so it uses no float atomics.  The
// TPU kernel kept one (S_pad, 512) accumulator in VMEM and walked the entries
// in order on one core; Hopper has 227 KB of shared memory per block and 132
// SMs that run blocks in no order, so the output is tiled instead: one block
// owns a (32 segments x 128 columns) f32 tile in shared memory, thread t owns
// column t of it.  The block walks the entries in order (i ascending, hash h
// innermost, as _window_kernel does), stages 1024 bucket ids at a time,
// compacts the entries that land in its segment range into an ordered list in
// shared memory (warp ballots, no atomics), and then every thread adds
// v * A[i, col] for the listed entries in list order.  A is read once in total
// (each row lands in one segment tile per hash); the bucket ids are re-read by
// every segment tile, which L2 serves (4 MB at k = 2^20).  One walk over all k
// entries is a long serial chain for a 4-warp block, so the ordered entry range
// is also cut into `splits` contiguous pieces (grid.z, chosen by the wrapper
// from the shape alone so that the card holds ~8 blocks per SM): each piece
// writes its partial tile to a workspace, and a second kernel adds the pieces
// in split order.  Each (segment, column) sum therefore has one fixed order.  Products and sums use __fmul_rn /
// __fadd_rn so nvcc cannot contract them into FMAs that the fused and unfused
// launches might round differently.  Entries whose bucket lies outside
// [0, num_segments) are dropped, as a segment sum drops them.
//
// gather_scaled_rows is a pure copy with one multiply per element, in T's
// dtype: grid (S rows, column tiles), coalesced along the columns.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SC_THREADS = 128;  // one thread per column of the tile
constexpr int SC_SEGS = 32;      // segment rows per tile
constexpr int SC_ROUNDS = 8;     // staged entries per pass = SC_ROUNDS * SC_THREADS
constexpr int SC_CHUNK = SC_ROUNDS * SC_THREADS;
constexpr int SC_WARPS = SC_THREADS / 32;
constexpr int SC_UNROLL = 8;

__device__ __forceinline__ float to_f32(float a) { return a; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 a) { return __bfloat162float(a); }

template <typename T>
__global__ void __launch_bounds__(SC_THREADS)
scatter_rows_kernel(const T* __restrict__ A, const int* __restrict__ b,
                    const float* __restrict__ v, const float* __restrict__ acc,
                    float* __restrict__ out, int k, int m, int nnz, int num_segments,
                    int split_span) {
  __shared__ float tile[SC_SEGS * SC_THREADS];
  __shared__ int list_seg[SC_CHUNK];
  __shared__ float list_val[SC_CHUNK];
  __shared__ int list_row[SC_CHUNK];
  __shared__ int warp_count[SC_ROUNDS][SC_WARPS];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int seg0 = blockIdx.x * SC_SEGS;
  const int col = blockIdx.y * SC_THREADS + tid;
  const bool live = col < m;
  const unsigned lanes_below = (1u << lane) - 1u;

  for (int r = 0; r < SC_SEGS; ++r) tile[r * SC_THREADS + tid] = 0.0f;

  // This block's share of the entries: split blockIdx.z of the ordered
  // entry range, chunk-aligned (nnz * k < 2^31, checked by the wrapper).
  const int total = k * nnz;
  const int first = blockIdx.z * split_span;
  const int last = min(total, first + split_span);
  for (int base = first; base < last; base += SC_CHUNK) {
    // Stage: which of this chunk's entries land in the tile's segments.
    int seg[SC_ROUNDS];
    unsigned mask[SC_ROUNDS];
#pragma unroll
    for (int r = 0; r < SC_ROUNDS; ++r) {
      const int e = base + r * SC_THREADS + tid;
      seg[r] = -1;
      if (e < last) {
        const int i = e / nnz;
        const int h = e - i * nnz;
        const int t = b[(size_t)h * k + i] - seg0;
        if (t >= 0 && t < SC_SEGS) seg[r] = t;
      }
      mask[r] = __ballot_sync(0xffffffffu, seg[r] >= 0);
      if (lane == 0) warp_count[r][warp] = __popc(mask[r]);
    }
    __syncthreads();
    // Compact into the list in entry order: (round, warp, lane).
    int run = 0;
#pragma unroll
    for (int r = 0; r < SC_ROUNDS; ++r) {
      int before = run;
      for (int w = 0; w < SC_WARPS; ++w) {
        if (w < warp) before += warp_count[r][w];
        run += warp_count[r][w];
      }
      if (seg[r] >= 0) {
        const int e = base + r * SC_THREADS + tid;
        const int i = e / nnz;
        const int h = e - i * nnz;
        const int pos = before + __popc(mask[r] & lanes_below);
        list_seg[pos] = seg[r];
        list_val[pos] = v[(size_t)h * k + i];
        list_row[pos] = i;
      }
    }
    __syncthreads();
    // Accumulate the listed entries in order; loads run ahead of the adds.
    if (live) {
      int t = 0;
      for (; t + SC_UNROLL <= run; t += SC_UNROLL) {
        float a[SC_UNROLL];
#pragma unroll
        for (int u = 0; u < SC_UNROLL; ++u)
          a[u] = to_f32(A[(size_t)list_row[t + u] * m + col]);
#pragma unroll
        for (int u = 0; u < SC_UNROLL; ++u) {
          float* cell = &tile[list_seg[t + u] * SC_THREADS + tid];
          *cell = __fadd_rn(*cell, __fmul_rn(list_val[t + u], a[u]));
        }
      }
      for (; t < run; ++t) {
        const float a = to_f32(A[(size_t)list_row[t] * m + col]);
        float* cell = &tile[list_seg[t] * SC_THREADS + tid];
        *cell = __fadd_rn(*cell, __fmul_rn(list_val[t], a));
      }
    }
    __syncthreads();  // the list and counts are rewritten by the next pass
  }

  if (!live) return;
  // One split: emit (with the acc fold).  Several: write this split's
  // partial tile to its slice of the workspace ``out``.
  float* dst = out + (size_t)blockIdx.z * num_segments * m;
  for (int r = 0; r < SC_SEGS; ++r) {
    const int s = seg0 + r;
    if (s >= num_segments) break;
    const size_t o = (size_t)s * m + col;
    const float p = tile[r * SC_THREADS + tid];
    dst[o] = (acc && gridDim.z == 1) ? __fadd_rn(acc[o], p) : p;
  }
}

// Sums the splits' partial tiles in split order (a fixed order, so the
// result is the same run to run), then folds acc in with one add.
__global__ void reduce_splits_kernel(const float* __restrict__ parts,
                                     const float* __restrict__ acc, float* __restrict__ out,
                                     long long count, int splits) {
  const long long o = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= count) return;
  float sum = parts[o];
  for (int z = 1; z < splits; ++z) sum = __fadd_rn(sum, parts[(size_t)z * count + o]);
  out[o] = acc ? __fadd_rn(acc[o], sum) : sum;
}

constexpr int GA_THREADS = 256;
constexpr int GA_PER_THREAD = 4;
constexpr int GA_COLS = GA_THREADS * GA_PER_THREAD;

__device__ __forceinline__ float scaled(float t, float s) { return __fmul_rn(t, s); }
__device__ __forceinline__ __nv_bfloat16 scaled(__nv_bfloat16 t, float s) {
  // bf16 * bf16 is exact in float32; one rounding gives the bf16 product.
  return __float2bfloat16_rn(__bfloat162float(t) * s);
}
__device__ __forceinline__ float nan_of(float) { return __int_as_float(0x7fc00000); }
__device__ __forceinline__ __nv_bfloat16 nan_of(__nv_bfloat16) {
  return __float2bfloat16_rn(__int_as_float(0x7fc00000));
}

template <typename T>
__global__ void __launch_bounds__(GA_THREADS)
gather_scaled_rows_kernel(const T* __restrict__ src, const int* __restrict__ idx,
                          T* __restrict__ out, int nrows, int m, float scale) {
  const size_t j = blockIdx.x;
  const int r = idx[j];
  // An index outside [0, nrows) would read out of bounds: poison the row.
  const bool ok = (unsigned)r < (unsigned)nrows;
  int c = blockIdx.y * GA_COLS + threadIdx.x;
#pragma unroll
  for (int u = 0; u < GA_PER_THREAD; ++u, c += GA_THREADS) {
    if (c < m) out[j * m + c] = ok ? scaled(src[(size_t)r * m + c], scale) : nan_of(T());
  }
}

template <typename T>
int launch_scatter(const void* A, const void* b, const void* v, const void* acc, void* out,
                   void* parts, int k, int m, int nnz, int num_segments, int splits,
                   void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int chunks = (k * nnz + SC_CHUNK - 1) / SC_CHUNK;
  const int span = ((chunks + splits - 1) / splits) * SC_CHUNK;
  dim3 grid((num_segments + SC_SEGS - 1) / SC_SEGS, (m + SC_THREADS - 1) / SC_THREADS,
            splits);
  scatter_rows_kernel<T><<<grid, SC_THREADS, 0, st>>>(
      (const T*)A, (const int*)b, (const float*)v, (const float*)acc,
      (float*)(splits > 1 ? parts : out), k, m, nnz, num_segments, span);
  int err = (int)cudaGetLastError();
  if (err || splits == 1) return err;
  const long long count = (long long)num_segments * m;
  reduce_splits_kernel<<<(unsigned)((count + 255) / 256), 256, 0, st>>>(
      (const float*)parts, (const float*)acc, (float*)out, count, splits);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_gather(const void* src, const void* idx, void* out, int nrows, int m, int s,
                  float scale, void* stream) {
  dim3 grid(s, (m + GA_COLS - 1) / GA_COLS);
  gather_scaled_rows_kernel<T><<<grid, GA_THREADS, 0, (cudaStream_t)stream>>>(
      (const T*)src, (const int*)idx, (T*)out, nrows, m, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int skylark_scatter_rows_f32(const void* A, const void* b, const void* v, const void* acc,
                             void* out, void* parts, int k, int m, int nnz, int num_segments,
                             int splits, void* stream) {
  return launch_scatter<float>(A, b, v, acc, out, parts, k, m, nnz, num_segments, splits,
                               stream);
}

int skylark_scatter_rows_bf16(const void* A, const void* b, const void* v, const void* acc,
                              void* out, void* parts, int k, int m, int nnz,
                              int num_segments, int splits, void* stream) {
  return launch_scatter<__nv_bfloat16>(A, b, v, acc, out, parts, k, m, nnz, num_segments,
                                       splits, stream);
}

int skylark_gather_scaled_rows_f32(const void* src, const void* idx, void* out, int nrows,
                                   int m, int s, float scale, void* stream) {
  return launch_gather<float>(src, idx, out, nrows, m, s, scale, stream);
}

int skylark_gather_scaled_rows_bf16(const void* src, const void* idx, void* out, int nrows,
                                    int m, int s, float scale, void* stream) {
  return launch_gather<__nv_bfloat16>(src, idx, out, nrows, m, s, scale, stream);
}

}  // extern "C"
