// Fused RFUT kernels for Hopper (sm_90a): one HBM pass for D-multiply + WHT.
//
// Replaces libskylark_tpu/sketch/pallas_fut.py:
//   rfut_rowwise          (pallas_fut.py:192, body _kernel -> _dwht_tile)
//   rfut_rowwise_sampled  (pallas_fut.py:150, body _kernel_sampled)
//
//   out[r, :] = H_NB (d ⊙ pad(x[r, :])) / sqrt(NB)         (natural Sylvester order)
//   out[r, j] = (H_NB (d ⊙ pad(x[r, :])))[idx[j]] / sqrt(S) (sampled variant)
//
// What bounds every instance on the H100: bytes.  The transform does
// NB·log2(NB) adds per row, at most ~4 operations per byte moved (NB = 2^15),
// far below the ~20 float32 operations per byte at which 67 TFLOP/s would
// start to limit it at 3.35 TB/s.  So each design keeps every intermediate
// out of device memory (x read once, out written once) and differs in how it
// keeps enough bytes in flight.
//
// NB >= 512, and the sampled variant at every NB: one block owns one row.
// Each thread holds R = 8 (16, 32 at the largest NB) elements in registers
// and runs log2(R) radix-2 butterfly stages there per pass, so the log2(NB)
// stages take ceil(log2(NB)/log2(R)) passes with one trip through shared
// memory between two of them (4 passes and 3 trips at NB = 4096) instead of
// one barrier-separated shared-memory pass per stage.  The first pass runs
// over the top index bits so that the loads of x and d are coalesced, and the
// last over bits >= 3 so that a warp's stores cover whole 32-byte sectors.
// NB is a template parameter (one instance per power of two from 2^7 to
// 2^15), so the pass schedule and every shared-memory index fold at compile
// time into a per-thread base plus constants.  The row buffer is NB + NB/32
// floats (padded against bank conflicts), 132 KiB at NB = 2^15, above the
// 48 KB default, hence the MaxDynamicSharedMemorySize attribute.  The last
// pass stores straight to device memory; the sampled variant parks it in
// shared memory and stores only the S selected lanes.  From 64 threads a
// block up the SM is full of warps and this design runs near its bound.
//
// rfut_rowwise at NB = 128 and 256: one warp owns one row.  A block per row
// would be 16 or 32 threads there: the SM's 32-block limit leaves it a quarter
// full, each block makes one 512-byte load, waits one memory latency and
// retires, and launch, latency and retire, not bytes, set the time.  Here a
// row lives in one warp's registers: lane l holds R = NB/32 elements, in
// chunks of C = 16 bytes' worth (4 f32 at NB = 128, 8 bf16 at NB = 256; 4
// bf16, 8 bytes, at NB = 128), chunk k of lane l being elements
// k·32C + l·C ... + C - 1, so each chunk is one vector load or store and a
// warp's chunk covers a contiguous 512 bytes.  The stages over the register
// bits run in registers, those over the five lane bits as __shfl_xor_sync
// (lower lane a + b, upper lane a - b, one fma by ±1 each): no shared memory,
// no __syncthreads.
// A persistent grid (two blocks per SM, the SM count read once) walks tiles
// of TILE consecutive rows (8 KB of x) with a grid stride.  In each block one
// producer thread keeps the next STAGES = 2 tiles in flight as 1-D bulk
// copies (TMA, cp.async.bulk) into a ring in shared memory, each stage with a
// full and an empty mbarrier: 32 KB in flight per SM.  CONSUMERS = 8 warps
// wait on a stage's full barrier, read their rows with vector loads, release
// the stage, transform, and store from registers.  These constants are the
// fastest of a sweep on the H100 (PERF.md): more bytes in flight
// (deeper rings, more blocks) ran slower, and fewer consumer warps per SM
// left bf16 rows waiting on the transform.  Where a bulk copy cannot be used
// (x not 16-byte aligned, or a row not a whole number of 16-byte units) the
// same kernel, instantiated with BULK = false, reads its rows with guarded
// per-element loads instead; the wrapper (kernels_fut.bulk_copies) decides.
// Each output row is a function of that row of x alone, computed by the same
// operations in the same order on either load path, so results do not depend
// on m, the row's position, the grid or the ring.
//
// bf16 input is multiplied by d in bf16 (as the reference does in the input
// dtype), transformed in float32, and rounded once at the store.

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
__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

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

// ---- NB = 128, 256: a warp per row, fed by a ring of bulk copies ----------

// NB up to 2^WARP_MAX_LOG2NB takes the warp-per-row kernel.  From NB = 512
// the block per row has enough threads to fill the SM, and in f32 it ran
// faster there than this kernel (PERF.md).
constexpr int WARP_MAX_LOG2NB = 8;
constexpr int CONSUMERS = 8;       // consumer warps per block (plus one producer warp)
constexpr int STAGES = 2;          // ring depth per block
constexpr int STAGE_BYTES = 8192;  // x bytes per stage at n = NB (at least one row a warp)
constexpr int BULK_BLOCKS_PER_SM = 2;  // fed by bulk copies: 32 KB in flight per SM

template <typename T, int LOG2NB>
struct WarpGeometry {
  static constexpr int NB = 1 << LOG2NB;
  static constexpr int R = NB / 32;                                 // elements per lane
  static constexpr int C = cmin(R, 16 / (int)sizeof(T));            // elements per chunk
  static constexpr int ROWS = cmax(1, STAGE_BYTES / (CONSUMERS * NB * (int)sizeof(T)));
  static constexpr int TILE = CONSUMERS * ROWS;                     // rows per stage
  static constexpr int THREADS = 32 * (CONSUMERS + 1);
  static constexpr int BARRIERS = 128;                              // bytes before the ring
  static_assert(2 * STAGES * 8 <= BARRIERS, "the barriers must fit before the ring");
  static constexpr size_t SMEM = BARRIERS + (size_t)STAGES * TILE * NB * sizeof(T);
};

// Element of a row that register j of lane l holds.
template <int C>
__device__ __forceinline__ int warp_element(int l, int j) {
  return (j / C) * 32 * C + l * C + (j % C);
}

// A chunk of C elements moves as 2 or 4 32-bit words in one 8- or 16-byte
// access.
__device__ __forceinline__ void load_words(const void* p, uint32_t (&w)[2]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  w[0] = v.x, w[1] = v.y;
}
__device__ __forceinline__ void load_words(const void* p, uint32_t (&w)[4]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
}
__device__ __forceinline__ void store_words(void* p, const uint32_t (&w)[2]) {
  *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
}
__device__ __forceinline__ void store_words(void* p, const uint32_t (&w)[4]) {
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

// Element i of a chunk's words, as float32 (a bf16 is the top half of its
// float32), and the other way, rounding once to T.
__device__ __forceinline__ float unpack(const float*, const uint32_t* w, int i) {
  return __uint_as_float(w[i]);
}
__device__ __forceinline__ float unpack(const __nv_bfloat16*, const uint32_t* w, int i) {
  return __uint_as_float(i & 1 ? w[i >> 1] & 0xffff0000u : w[i >> 1] << 16);
}
__device__ __forceinline__ void pack(float*, uint32_t* w, int i, float v) {
  w[i] = __float_as_uint(v);
}
__device__ __forceinline__ void pack(__nv_bfloat16*, uint32_t* w, int i, float v) {
  const uint32_t b = __bfloat16_as_ushort(__float2bfloat16_rn(v));
  w[i >> 1] = i & 1 ? w[i >> 1] | (b << 16) : b;
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// x·d as scaled_load computes it, both operands already in float32.
__device__ __forceinline__ float scaled(const float*, float x, float d) { return __fmul_rn(x, d); }
__device__ __forceinline__ float scaled(const __nv_bfloat16*, float x, float d) {
  return __bfloat162float(__float2bfloat16_rn(x * d));
}

__device__ __forceinline__ uint32_t shared_address(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(shared_address(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n\t.reg .b64 state;\n\t"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n\t}" ::"r"(shared_address(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   shared_address(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = shared_address(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// 1-D bulk copy of `bytes` (a multiple of 16, both addresses 16-byte aligned)
// from device memory into shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(shared_address(dst)),
      "l"(src), "r"(bytes), "r"(shared_address(bar))
      : "memory");
}

// The un-normalized WHT of the row a warp holds, R = 2^LOG2R elements a lane
// laid out as warp_element says: the register bits first, then the lane bits.
template <int LOG2R>
__device__ __forceinline__ void warp_wht(float (&v)[1 << LOG2R], int lane) {
  butterfly<LOG2R, LOG2R>(v);
#pragma unroll
  for (int mask = 1; mask < 32; mask <<= 1) {
    // fma(±1, v, o) rounds v + o (lower lane) or o - v (upper lane) once,
    // bitwise __fadd_rn(a, b) and __fsub_rn(a, b), in one instruction.
    const float sign = lane & mask ? -1.0f : 1.0f;
#pragma unroll
    for (int j = 0; j < (1 << LOG2R); ++j)
      v[j] = __fmaf_rn(sign, v[j], __shfl_xor_sync(0xffffffffu, v[j], mask));
  }
}

// Warps 0 .. CONSUMERS-1 transform rows; warp CONSUMERS (with BULK) feeds
// them.  Tile t holds rows [t·TILE, t·TILE + TILE); consumer warp w takes
// rows t·TILE + w·ROWS ... + ROWS - 1 of each tile its block walks.
template <typename T, int LOG2NB, bool BULK>
__global__ void __launch_bounds__(WarpGeometry<T, LOG2NB>::THREADS)
rfut_rowwise_warp_kernel(const T* __restrict__ x, const T* __restrict__ d, T* __restrict__ out,
                         int m, int n, float scale) {
  using G = WarpGeometry<T, LOG2NB>;
  constexpr int R = G::R, C = G::C;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + STAGES;
  T* ring = reinterpret_cast<T*>(smem + G::BARRIERS);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tiles = (m + G::TILE - 1) / G::TILE;

  if constexpr (BULK) {
    if (threadIdx.x == 0) {
      for (int s = 0; s < STAGES; ++s) {
        mbar_init(&full[s], 1);
        mbar_init(&empty[s], CONSUMERS);
      }
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    if (warp == CONSUMERS) {
      if (lane == 0) {
        int stage = 0;
        uint32_t phase = 0;
        for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
          mbar_wait(&empty[stage], phase ^ 1);  // passes at once in the first round
          const int rows = min(G::TILE, m - t * G::TILE);
          const uint32_t bytes = (uint32_t)rows * n * sizeof(T);
          mbar_arrive_expect_tx(&full[stage], bytes);
          bulk_load(ring + (size_t)stage * G::TILE * G::NB, x + (size_t)t * G::TILE * n, bytes,
                    &full[stage]);
          if (++stage == STAGES) stage = 0, phase ^= 1;
        }
      }
      return;
    }
  } else if (warp == CONSUMERS) {
    return;
  }

  float dv[R];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int e = warp_element<C>(lane, j);
    dv[j] = e < n ? to_float(d[e]) : 0.0f;
  }
  int stage = 0;
  uint32_t phase = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int first = t * G::TILE + warp * G::ROWS;
    float v[G::ROWS][R];
    if constexpr (BULK) {
      mbar_wait(&full[stage], phase);
      const T* tile = ring + (size_t)stage * G::TILE * G::NB;
#pragma unroll
      for (int r = 0; r < G::ROWS; ++r) {
        if (first + r >= m) break;
        const T* row = tile + (size_t)(warp * G::ROWS + r) * n;
#pragma unroll
        for (int k = 0; k < R / C; ++k) {
          const int e = k * 32 * C + lane * C;
          uint32_t words[C * sizeof(T) / 4] = {};
          if (e < n) load_words(row + e, words);
#pragma unroll
          for (int w = 0; w < C; ++w)
            v[r][k * C + w] = e < n ? scaled(x, unpack(x, words, w), dv[k * C + w]) : 0.0f;
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);
      if (++stage == STAGES) stage = 0, phase ^= 1;
    } else {
#pragma unroll
      for (int r = 0; r < G::ROWS; ++r) {
        if (first + r >= m) break;
        const T* row = x + (size_t)(first + r) * n;
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const int e = warp_element<C>(lane, j);
          v[r][j] = e < n ? scaled(x, to_float(row[e]), dv[j]) : 0.0f;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < G::ROWS; ++r) {
      if (first + r >= m) break;
      warp_wht<LOG2NB - 5>(v[r], lane);
      T* orow = out + ((size_t)(first + r) << LOG2NB);
#pragma unroll
      for (int k = 0; k < R / C; ++k) {
        uint32_t words[C * sizeof(T) / 4];
#pragma unroll
        for (int w = 0; w < C; ++w) pack(out, words, w, __fmul_rn(v[r][k * C + w], scale));
        store_words(orow + k * 32 * C + lane * C, words);
      }
    }
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

int sm_count() {
  static int count[64];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return 132;
  if (!count[dev]) cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev);
  return count[dev];
}

// Blocks of `kernel` that fit on one SM with `smem` bytes of dynamic shared
// memory each.
template <typename K>
int blocks_per_sm(K kernel, int threads, size_t smem) {
  int blocks = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
  return blocks > 0 ? blocks : 1;
}

template <typename T, int LOG2NB, bool BULK>
int launch_warp(const void* x, const void* d, void* out, int m, int n, cudaStream_t stream) {
  using G = WarpGeometry<T, LOG2NB>;
  static_assert(G::SMEM <= 48 * 1024, "the ring must fit the default shared memory");
  const auto kernel = rfut_rowwise_warp_kernel<T, LOG2NB, BULK>;
  const size_t smem = BULK ? G::SMEM : 0;
  // Fed by bulk copies, BULK_BLOCKS_PER_SM blocks per SM; guarded loads
  // keep a few rows per warp in flight, so they take every block the SM
  // holds (one block per SM ran them at half the speed).
  static const int per_sm =
      cmin(BULK ? BULK_BLOCKS_PER_SM : 1 << 20, blocks_per_sm(kernel, G::THREADS, smem));
  const int tiles = (m + G::TILE - 1) / G::TILE;
  const int grid = cmin(tiles, per_sm * sm_count());
  const float scale = (float)(1.0 / sqrt((double)G::NB));
  kernel<<<grid, G::THREADS, smem, stream>>>((const T*)x, (const T*)d, (T*)out, m, n, scale);
  return (int)cudaGetLastError();
}

template <typename T, int LOG2NB>
int launch_rowwise_any(const void* x, const void* d, void* out, int m, int n, int bulk,
                       cudaStream_t stream) {
  if constexpr (LOG2NB <= WARP_MAX_LOG2NB)
    return bulk ? launch_warp<T, LOG2NB, true>(x, d, out, m, n, stream)
                : launch_warp<T, LOG2NB, false>(x, d, out, m, n, stream);
  else
    return launch_rowwise_nb<T, LOG2NB>(x, d, out, m, n, stream);
}

// NB is a power of two in [128, 2^15] (checked by the wrapper); anything else
// is refused with cudaErrorInvalidValue.  `bulk` (read only up to
// NB = 2^WARP_MAX_LOG2NB) says that x is 16-byte aligned and its rows whole
// 16-byte units, so the warp kernel may feed itself with bulk copies.
template <typename T>
int launch_rowwise(const void* x, const void* d, void* out, int m, int n, int nb, int bulk,
                   void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (nb) {
    case 1 << 7: return launch_rowwise_any<T, 7>(x, d, out, m, n, bulk, st);
    case 1 << 8: return launch_rowwise_any<T, 8>(x, d, out, m, n, bulk, st);
    case 1 << 9: return launch_rowwise_any<T, 9>(x, d, out, m, n, bulk, st);
    case 1 << 10: return launch_rowwise_any<T, 10>(x, d, out, m, n, bulk, st);
    case 1 << 11: return launch_rowwise_any<T, 11>(x, d, out, m, n, bulk, st);
    case 1 << 12: return launch_rowwise_any<T, 12>(x, d, out, m, n, bulk, st);
    case 1 << 13: return launch_rowwise_any<T, 13>(x, d, out, m, n, bulk, st);
    case 1 << 14: return launch_rowwise_any<T, 14>(x, d, out, m, n, bulk, st);
    case 1 << 15: return launch_rowwise_any<T, 15>(x, d, out, m, n, bulk, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int launch_sampled(const void* x, const void* d, const int* idx, void* out, int m, int n,
                   int nb, int s, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (nb) {
    case 1 << 7: return launch_sampled_nb<T, 7>(x, d, idx, out, m, n, s, st);
    case 1 << 8: return launch_sampled_nb<T, 8>(x, d, idx, out, m, n, s, st);
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
                             int bulk, void* stream) {
  return launch_rowwise<float>(x, d, out, m, n, nb, bulk, stream);
}

int skylark_rfut_rowwise_bf16(const void* x, const void* d, void* out, int m, int n, int nb,
                              int bulk, void* stream) {
  return launch_rowwise<__nv_bfloat16>(x, d, out, m, n, nb, bulk, stream);
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
