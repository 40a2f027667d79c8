// Flat deterministic segment sum for Hopper (sm_90a).
//
// Replaces libskylark_tpu/sketch/pallas_scatter.py:
//   segment_sum_flat  (pallas_scatter.py:218, _segment_sum_impl :244,
//                      _partition_kernel :109, _accumulate_kernel :147)
//
//   out[t] = sum(vals[keys == t])  for flat int32 keys, f32 accumulation;
//   keys outside [0, T) are dropped, as a segment sum drops them.
//
// What bounds it on the H100: bytes.  Each entry is read once (4 bytes of key,
// 2 or 4 of value) and each slot written once, with one add per entry; at
// 10^7 entries into 1.024e8 slots the 410 MB output dominates.
//
// The result must be identical run to run (the sketches built on it are
// compared bitwise), so no float atomics.  The TPU kernel walked one (V/128,
// 128) VMEM accumulator of 8 MB per partition on one core in grid order;
// Hopper gives a block at most 227 KB of shared memory and runs blocks in no
// order, so the work is a one-digit radix partition followed by one block per
// partition, with every float add in a fixed order:
//
// pass 1a (count_kernel): one warp per chunk of C entries counts the chunk's
//   entries per partition (p = key / V, V = SS_V slots) into column k of a
//   (P, K) table.  Warp peers with the same partition are found with
//   __match_any_sync, so the leader adds the whole group with one integer
//   atomic (a hot partition costs one atomic per 32 entries).  Integer adds
//   commute, so the counts are exact whatever the order.
// between the passes the wrapper takes the exclusive prefix sum of the table,
//   read partition-major, with torch.cumsum (as the TPU kernel's host code does
//   with jnp.cumsum): offs[p][k] is where chunk k's entries of partition p go.
// pass 1b (place_kernel): the same warp walks its chunk again in order, 32
//   entries at a time, and writes each entry at offs[p][k] + its rank among
//   its peers below it; the leader then advances offs[p][k].  The placement
//   is stable, so partition p's entries lie contiguous and in input order.
// pass 2 (accumulate_kernel): one block per partition holds V f32 slots in
//   shared memory and takes its entries in groups of SS_G, in order.  A group
//   is bitonic-sorted on (slot << 11 | position), keys that are unique, so the
//   sort has one result: entries grouped by slot, in input order within a
//   slot.  One thread per run of equal slots sums the run in that order and
//   adds the sum into its slot.  Every slot therefore takes its entries in
//   input order, group by group, whatever the scheduling; summing a run
//   before adding it keeps a hot slot's error near that of a blocked sum
//   (a slot with 5e6 entries adds ~2.4e3 run sums, not 5e6 terms, into its
//   accumulator).  The block writes its V slots once.
//
// Pass 1 costs a second read of the keys and values and a write and read of the
// sorted copies (16 bytes per entry beyond the bound's 8); the (P, K) table is
// kept at or below nnz / 2 ints by the wrapper's choice of C.  A hot slot is
// one long run per group for one thread: right, but slow.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int SS_V = 16384;             // slots per partition (64 KB of f32)
constexpr int SS_G = 2048;              // entries per staged group in pass 2
constexpr int SS_POS_BITS = 11;         // log2(SS_G)
constexpr int SS_THREADS = 512;         // pass-2 block
constexpr int SS_WARPS_1 = 8;           // pass-1 block: one warp per chunk
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float a) { return a; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 a) { return __bfloat162float(a); }
__device__ __forceinline__ float to_f32(__half a) { return __half2float(a); }

// Partition of key, or -1 for a key outside [0, T).
__device__ __forceinline__ int partition_of(int key, int T) {
  return (unsigned)key < (unsigned)T ? key / SS_V : -1;
}

__global__ void __launch_bounds__(SS_WARPS_1 * 32)
count_kernel(const int* __restrict__ keys, long long nnz, int T, int C, int K,
             int* __restrict__ counts) {
  const int lane = threadIdx.x & 31;
  const int k = blockIdx.x * SS_WARPS_1 + (threadIdx.x >> 5);
  if (k >= K) return;  // whole warps leave together
  const long long begin = (long long)k * C;
  const long long end = min(nnz, begin + C);
  // The next group's key is loaded while this group is counted.
  int next = begin + lane < end ? keys[begin + lane] : -1;
  for (long long base = begin; base < end; base += 32) {
    const int p = partition_of(next, T);
    next = base + 32 + lane < end ? keys[base + 32 + lane] : -1;
    const unsigned peers = __match_any_sync(FULL, p);
    if (p >= 0 && lane == __ffs(peers) - 1)
      atomicAdd(&counts[(size_t)p * K + k], __popc(peers));
  }
}

template <typename T_>
__global__ void __launch_bounds__(SS_WARPS_1 * 32)
place_kernel(const int* __restrict__ keys, const T_* __restrict__ vals, long long nnz,
             int T, int C, int K, int* __restrict__ offs, int* __restrict__ skeys,
             float* __restrict__ svals) {
  const int lane = threadIdx.x & 31;
  const int k = blockIdx.x * SS_WARPS_1 + (threadIdx.x >> 5);
  if (k >= K) return;
  const unsigned below = (1u << lane) - 1u;
  const long long begin = (long long)k * C;
  const long long end = min(nnz, begin + C);
  // The next group's entries are loaded while this group is placed.
  int next_key = -1;
  float next_val = 0.0f;
  if (begin + lane < end) {
    next_key = keys[begin + lane];
    next_val = to_f32(vals[begin + lane]);
  }
  for (long long base = begin; base < end; base += 32) {
    const int key = next_key;
    const float val = next_val;
    const long long e = base + 32 + lane;
    next_key = -1;
    if (e < end) {
      next_key = keys[e];
      next_val = to_f32(vals[e]);
    }
    const int p = partition_of(key, T);
    const unsigned peers = __match_any_sync(FULL, p);
    const int leader = __ffs(peers) - 1;
    int* slot = p >= 0 ? &offs[(size_t)p * K + k] : nullptr;
    int at = (p >= 0 && lane == leader) ? *slot : 0;
    at = __shfl_sync(FULL, at, leader);
    if (p >= 0) {
      const int pos = at + __popc(peers & below);
      skeys[pos] = key;
      svals[pos] = val;
      if (lane == leader) *slot = at + __popc(peers);
    }
    // The next group's leader for p may be another lane: order the store.
    __syncwarp();
  }
}

__global__ void __launch_bounds__(SS_THREADS)
accumulate_kernel(const int* __restrict__ skeys, const float* __restrict__ svals,
                  const int* __restrict__ part_start, int T, float* __restrict__ out) {
  extern __shared__ float smem[];
  float* acc = smem;                                     // SS_V slots
  unsigned* comp = (unsigned*)(acc + SS_V);              // SS_G sort keys
  float* gval = (float*)(comp + SS_G);                   // values by position
  float* sval = gval + SS_G;                             // values in sorted order

  const int tid = threadIdx.x;
  const int p = blockIdx.x;
  const int slot0 = p * SS_V;
  for (int s = tid; s < SS_V; s += SS_THREADS) acc[s] = 0.0f;

  const int first = part_start[p];
  const int last = part_start[p + 1];
  for (int g0 = first; g0 < last; g0 += SS_G) {
    const int n = min(SS_G, last - g0);
    int size = 1;
    while (size < n) size <<= 1;
    __syncthreads();  // the previous group's runs are done with comp/sval
    for (int i = tid; i < size; i += SS_THREADS) {
      if (i < n) {
        comp[i] = ((unsigned)(skeys[g0 + i] - slot0) << SS_POS_BITS) | (unsigned)i;
        gval[i] = svals[g0 + i];
      } else {
        comp[i] = 0xffffffffu;  // padding sorts last
      }
    }
    __syncthreads();
    for (int kk = 2; kk <= size; kk <<= 1) {
      for (int j = kk >> 1; j > 0; j >>= 1) {
        for (int t = tid; t < (size >> 1); t += SS_THREADS) {
          const int i = (t / j) * (j << 1) + (t % j);
          const int l = i + j;
          const unsigned a = comp[i], b = comp[l];
          if ((a > b) == ((i & kk) == 0)) {
            comp[i] = b;
            comp[l] = a;
          }
        }
        __syncthreads();
      }
    }
    for (int i = tid; i < n; i += SS_THREADS)
      sval[i] = gval[comp[i] & (SS_G - 1)];
    __syncthreads();
    for (int i = tid; i < n; i += SS_THREADS) {
      const unsigned s = comp[i] >> SS_POS_BITS;
      if (i > 0 && (comp[i - 1] >> SS_POS_BITS) == s) continue;  // not a run start
      float a = sval[i];
      for (int r = i + 1; r < n && (comp[r] >> SS_POS_BITS) == s; ++r) a = __fadd_rn(a, sval[r]);
      acc[s] = __fadd_rn(acc[s], a);
    }
  }
  __syncthreads();
  const int count = min(SS_V, T - slot0);
  for (int s = tid; s < count; s += SS_THREADS) out[(size_t)slot0 + s] = acc[s];
}

constexpr size_t ACC_SMEM = SS_V * sizeof(float) + SS_G * (sizeof(unsigned) + 2 * sizeof(float));

template <typename T_>
int launch_place(const void* keys, const void* vals, long long nnz, int T, int V, int C,
                 int K, void* offs, void* skeys, void* svals, void* stream) {
  if (V != SS_V) return (int)cudaErrorInvalidValue;
  place_kernel<T_><<<(K + SS_WARPS_1 - 1) / SS_WARPS_1, SS_WARPS_1 * 32, 0,
                     (cudaStream_t)stream>>>((const int*)keys, (const T_*)vals, nnz, T, C, K,
                                             (int*)offs, (int*)skeys, (float*)svals);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int skylark_segment_count(const void* keys, long long nnz, int T, int V, int C, int K,
                          void* counts, void* stream) {
  if (V != SS_V) return (int)cudaErrorInvalidValue;
  count_kernel<<<(K + SS_WARPS_1 - 1) / SS_WARPS_1, SS_WARPS_1 * 32, 0,
                 (cudaStream_t)stream>>>((const int*)keys, nnz, T, C, K, (int*)counts);
  return (int)cudaGetLastError();
}

int skylark_segment_place_f32(const void* keys, const void* vals, long long nnz, int T, int V,
                              int C, int K, void* offs, void* skeys, void* svals,
                              void* stream) {
  return launch_place<float>(keys, vals, nnz, T, V, C, K, offs, skeys, svals, stream);
}

int skylark_segment_place_bf16(const void* keys, const void* vals, long long nnz, int T, int V,
                               int C, int K, void* offs, void* skeys, void* svals,
                               void* stream) {
  return launch_place<__nv_bfloat16>(keys, vals, nnz, T, V, C, K, offs, skeys, svals, stream);
}

int skylark_segment_place_f16(const void* keys, const void* vals, long long nnz, int T, int V,
                              int C, int K, void* offs, void* skeys, void* svals,
                              void* stream) {
  return launch_place<__half>(keys, vals, nnz, T, V, C, K, offs, skeys, svals, stream);
}

int skylark_segment_accumulate(const void* skeys, const void* svals, const void* part_start,
                               int T, int V, int P, void* out, void* stream) {
  if (V != SS_V) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      accumulate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)ACC_SMEM);
  if (err != cudaSuccess) return (int)err;
  accumulate_kernel<<<P, SS_THREADS, ACC_SMEM, (cudaStream_t)stream>>>(
      (const int*)skeys, (const float*)svals, (const int*)part_start, T, (float*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
