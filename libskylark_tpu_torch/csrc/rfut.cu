// Fused RFUT kernels for Hopper (sm_90a): one HBM pass for D-multiply + WHT.
//
// Replaces libskylark_tpu/sketch/pallas_fut.py:
//   rfut_rowwise          (pallas_fut.py:192, body _kernel -> _dwht_tile)
//   rfut_rowwise_sampled  (pallas_fut.py:150, body _kernel_sampled)
//
//   out[r, :] = H_NB (d ⊙ pad(x[r, :])) / sqrt(NB)         (natural Sylvester order)
//   out[r, j] = (H_NB (d ⊙ pad(x[r, :])))[idx[j]] / sqrt(S) (sampled variant)
//
// What bounds it on the H100: bytes.  The transform does NB·log2(NB) adds per
// row, about 3 operations per byte moved at NB = 4096 — far below the ~20
// float32 operations per byte at which 67 TFLOP/s would start to limit it at
// 3.35 TB/s.  So the design keeps every intermediate out of device memory:
// one block owns one row, x is read once and out written once, and the row
// never leaves the SM in between.  Each thread holds R = 8 (16, 32 at the
// largest NB) elements in registers and runs log2(R) radix-2 butterfly stages
// there per pass, so the log2(NB) stages take ceil(log2(NB)/log2(R)) passes
// with one trip through shared memory between two of them (4 passes and 3
// trips at NB = 4096) instead of one barrier-separated shared-memory pass per
// stage.  The first pass runs over the top index bits so that the loads of x
// and d are coalesced, and the last over bits >= 3 so that a warp's stores
// cover whole 32-byte sectors.  NB is a template parameter (one instance per
// power of two from 2^9 to 2^15), so the pass schedule and every shared-memory
// index fold at compile time into a per-thread base plus constants.  The row
// buffer is NB + NB/32 floats (padded against bank conflicts), 132 KiB at
// NB = 2^15, above the 48 KB default, hence the MaxDynamicSharedMemorySize
// attribute.  The last pass stores straight to
// device memory; the sampled variant parks it in shared memory and stores
// only the S selected lanes.  bf16 input is multiplied by d in bf16 (as the
// reference does in the input dtype), transformed in float32, and rounded
// once at the store.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float scaled_load(const float* x, const float* d, int i) {
  return __fmul_rn(x[i], d[i]);
}

__device__ __forceinline__ float scaled_load(const __nv_bfloat16* x,
                                             const __nv_bfloat16* d, int i) {
  // The product of two bf16 values is exact in float32, so rounding it to
  // bf16 gives the correctly rounded bf16 product the reference computes.
  float p = __bfloat162float(x[i]) * __bfloat162float(d[i]);
  return __bfloat162float(__float2bfloat16_rn(p));
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ int padded(int i) { return i + (i >> 5); }

__host__ __device__ constexpr int cmin(int a, int b) { return a < b ? a : b; }

// Block geometry for NB = 2^LOG2NB, fixed at compile time so that every index
// below folds to a per-thread base plus constants.  R = 2^LOG2R elements per
// thread: 8 up to NB = 8192 (NB/8 threads), then 16 and 32 so that a block
// never exceeds 1024 threads.  The first pass covers index bits [TOP, LOG2NB),
// then PASSES more cover [0, TOP) from the bottom up, LOG2R bits at a time.
template <int LOG2NB>
struct Geometry {
  static constexpr int LOG2R = LOG2NB <= 13 ? 3 : LOG2NB - 10;
  static constexpr int R = 1 << LOG2R;
  static constexpr int THREADS = 1 << (LOG2NB - LOG2R);
  static constexpr int TOP = LOG2NB - LOG2R;
  static constexpr int PASSES = (TOP + LOG2R - 1) / LOG2R;
  static constexpr int LAST_LO = (PASSES - 1) * LOG2R;
  static constexpr int LAST_W = cmin(LOG2R, TOP - LAST_LO);
};

// Element that register j of thread t holds while the pass over index bits
// [LO, LO + W) runs: the low W bits of j are those bits, the thread id and
// the rest of j fill the other bits from the bottom, so a warp's lanes walk
// consecutive indices wherever LO >= 5.
template <int LOG2NB, int LO, int W>
__device__ __forceinline__ int element(int t, int j) {
  const int jg = j & ((1 << W) - 1);
  const int rest = t | ((j >> W) << (LOG2NB - Geometry<LOG2NB>::LOG2R));
  return (rest & ((1 << LO) - 1)) | (jg << LO) | ((rest >> LO) << (LO + W));
}

// The W butterfly stages of a pass, on the low W bits of the register index.
template <int LOG2R, int W>
__device__ __forceinline__ void butterfly(float (&v)[1 << LOG2R]) {
#pragma unroll
  for (int s = 0; s < W; ++s) {
#pragma unroll
    for (int j = 0; j < (1 << LOG2R); ++j) {
      if (!(j & (1 << s))) {
        const float a = v[j];
        const float b = v[j | (1 << s)];
        v[j] = __fadd_rn(a, b);
        v[j | (1 << s)] = __fsub_rn(a, b);
      }
    }
  }
}

// Passes P .. PASSES: park the previous pass's values in shared memory, take
// the next LOG2R index bits into the registers and butterfly them.  No barrier
// after the loads: the next pass's stores go to the elements this thread
// itself just read, and the barrier before the loads orders the rest.
template <int LOG2NB, int P>
__device__ __forceinline__ void passes(float (&v)[Geometry<LOG2NB>::R], float* buf, int t) {
  using G = Geometry<LOG2NB>;
  if constexpr (P <= G::PASSES) {
    constexpr int PREV_LO = P == 1 ? G::TOP : (P - 2) * G::LOG2R;
    constexpr int LO = (P - 1) * G::LOG2R;
    constexpr int W = cmin(G::LOG2R, G::TOP - LO);
#pragma unroll
    for (int j = 0; j < G::R; ++j)
      buf[padded(element<LOG2NB, PREV_LO, G::LOG2R>(t, j))] = v[j];
    __syncthreads();
#pragma unroll
    for (int j = 0; j < G::R; ++j) v[j] = buf[padded(element<LOG2NB, LO, W>(t, j))];
    butterfly<G::LOG2R, W>(v);
    passes<LOG2NB, P + 1>(v, buf, t);
  }
}

// The un-normalized Walsh-Hadamard transform of d ⊙ pad(x_row) by the block's
// THREADS threads (the stages commute, so any order of bit groups gives the
// transform).  The first pass takes the top LOG2R index bits, so register j of
// thread t holds element t + j·NB/R and a warp's loads of x and d are
// coalesced.  Between two passes the row goes once through shared memory
// (buf, padded one float in 32 against bank conflicts).  Returns with the last
// pass's values in v: register j holds element<LOG2NB, LAST_LO, LAST_W>(t, j).
template <typename T, int LOG2NB>
__device__ __forceinline__ void dwht_row(const T* __restrict__ xrow, const T* __restrict__ d,
                                         float* buf, int n, float (&v)[Geometry<LOG2NB>::R]) {
  using G = Geometry<LOG2NB>;
  const int t = threadIdx.x;
#pragma unroll
  for (int j = 0; j < G::R; ++j) {
    const int i = t + (j << G::TOP);  // == element<LOG2NB, TOP, LOG2R>(t, j)
    v[j] = i < n ? scaled_load(xrow, d, i) : 0.0f;
  }
  butterfly<G::LOG2R, G::LOG2R>(v);
  passes<LOG2NB, 1>(v, buf, t);
}

template <typename T, int LOG2NB>
__global__ void __launch_bounds__(Geometry<LOG2NB>::THREADS)
rfut_rowwise_kernel(const T* __restrict__ x, const T* __restrict__ d, T* __restrict__ out,
                    int n, float scale) {
  using G = Geometry<LOG2NB>;
  extern __shared__ float buf[];
  const size_t row = blockIdx.x;
  float v[G::R];
  dwht_row<T, LOG2NB>(x + row * n, d, buf, n, v);
  T* orow = out + (row << LOG2NB);
#pragma unroll
  for (int j = 0; j < G::R; ++j)
    store(orow + element<LOG2NB, G::LAST_LO, G::LAST_W>(threadIdx.x, j),
          __fmul_rn(v[j], scale));
}

template <typename T, int LOG2NB>
__global__ void __launch_bounds__(Geometry<LOG2NB>::THREADS)
rfut_rowwise_sampled_kernel(const T* __restrict__ x, const T* __restrict__ d,
                            const int* __restrict__ idx, T* __restrict__ out, int n, int s,
                            float scale) {
  using G = Geometry<LOG2NB>;
  extern __shared__ float buf[];
  const size_t row = blockIdx.x;
  float v[G::R];
  dwht_row<T, LOG2NB>(x + row * n, d, buf, n, v);
#pragma unroll
  for (int j = 0; j < G::R; ++j)
    buf[padded(element<LOG2NB, G::LAST_LO, G::LAST_W>(threadIdx.x, j))] = v[j];
  __syncthreads();
  T* orow = out + row * s;
  for (int j = threadIdx.x; j < s; j += G::THREADS) {
    const int r = idx[j];
    // An index outside [0, NB) would read past the row: poison it instead.
    const float val = (unsigned)r < (1u << LOG2NB) ? __fmul_rn(buf[padded(r)], scale)
                                                   : __int_as_float(0x7fc00000);
    store(orow + j, val);
  }
}

template <typename K>
int prepare(K kernel, int nb, size_t* smem) {
  *smem = (size_t)(nb + nb / 32) * sizeof(float);
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)*smem);
}

template <typename T, int LOG2NB>
int launch_rowwise_nb(const void* x, const void* d, void* out, int m, int n,
                      cudaStream_t stream) {
  constexpr int NB = 1 << LOG2NB;
  size_t smem;
  int err = prepare(rfut_rowwise_kernel<T, LOG2NB>, NB, &smem);
  if (err) return err;
  const float scale = (float)(1.0 / sqrt((double)NB));
  rfut_rowwise_kernel<T, LOG2NB><<<m, Geometry<LOG2NB>::THREADS, smem, stream>>>(
      (const T*)x, (const T*)d, (T*)out, n, scale);
  return (int)cudaGetLastError();
}

template <typename T, int LOG2NB>
int launch_sampled_nb(const void* x, const void* d, const int* idx, void* out, int m, int n,
                      int s, cudaStream_t stream) {
  constexpr int NB = 1 << LOG2NB;
  size_t smem;
  int err = prepare(rfut_rowwise_sampled_kernel<T, LOG2NB>, NB, &smem);
  if (err) return err;
  // 1/sqrt(NB) (orthonormal WHT) x sqrt(NB/S) (sample rescale) = 1/sqrt(S).
  const float scale = (float)(1.0 / sqrt((double)s));
  rfut_rowwise_sampled_kernel<T, LOG2NB><<<m, Geometry<LOG2NB>::THREADS, smem, stream>>>(
      (const T*)x, (const T*)d, idx, (T*)out, n, s, scale);
  return (int)cudaGetLastError();
}

// NB is a power of two in [512, 2^15] (checked by the wrapper); anything else
// is refused with cudaErrorInvalidValue.
template <typename T>
int launch_rowwise(const void* x, const void* d, void* out, int m, int n, int nb,
                   void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (nb) {
    case 1 << 9: return launch_rowwise_nb<T, 9>(x, d, out, m, n, st);
    case 1 << 10: return launch_rowwise_nb<T, 10>(x, d, out, m, n, st);
    case 1 << 11: return launch_rowwise_nb<T, 11>(x, d, out, m, n, st);
    case 1 << 12: return launch_rowwise_nb<T, 12>(x, d, out, m, n, st);
    case 1 << 13: return launch_rowwise_nb<T, 13>(x, d, out, m, n, st);
    case 1 << 14: return launch_rowwise_nb<T, 14>(x, d, out, m, n, st);
    case 1 << 15: return launch_rowwise_nb<T, 15>(x, d, out, m, n, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int launch_sampled(const void* x, const void* d, const int* idx, void* out, int m, int n,
                   int nb, int s, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (nb) {
    case 1 << 9: return launch_sampled_nb<T, 9>(x, d, idx, out, m, n, s, st);
    case 1 << 10: return launch_sampled_nb<T, 10>(x, d, idx, out, m, n, s, st);
    case 1 << 11: return launch_sampled_nb<T, 11>(x, d, idx, out, m, n, s, st);
    case 1 << 12: return launch_sampled_nb<T, 12>(x, d, idx, out, m, n, s, st);
    case 1 << 13: return launch_sampled_nb<T, 13>(x, d, idx, out, m, n, s, st);
    case 1 << 14: return launch_sampled_nb<T, 14>(x, d, idx, out, m, n, s, st);
    case 1 << 15: return launch_sampled_nb<T, 15>(x, d, idx, out, m, n, s, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

int skylark_rfut_rowwise_f32(const void* x, const void* d, void* out, int m, int n, int nb,
                             void* stream) {
  return launch_rowwise<float>(x, d, out, m, n, nb, stream);
}

int skylark_rfut_rowwise_bf16(const void* x, const void* d, void* out, int m, int n, int nb,
                              void* stream) {
  return launch_rowwise<__nv_bfloat16>(x, d, out, m, n, nb, stream);
}

int skylark_rfut_rowwise_sampled_f32(const void* x, const void* d, const void* idx, void* out,
                                     int m, int n, int nb, int s, void* stream) {
  return launch_sampled<float>(x, d, (const int*)idx, out, m, n, nb, s, stream);
}

int skylark_rfut_rowwise_sampled_bf16(const void* x, const void* d, const void* idx, void* out,
                                      int m, int n, int nb, int s, void* stream) {
  return launch_sampled<__nv_bfloat16>(x, d, (const int*)idx, out, m, n, nb, s, stream);
}

}  // extern "C"
