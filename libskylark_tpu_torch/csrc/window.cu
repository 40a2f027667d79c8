// Row scatter-accumulate and scaled row gather for Hopper (sm_90a).
//
// Replaces libskylark_tpu/sketch/pallas_window.py:
//   scatter_rows        (pallas_window.py:228, _scatter_rows_impl :172, _window_kernel :130)
//   gather_scaled_rows  (pallas_window.py:364, _gather_rows_impl :330, _gather_kernel :312)
//
// scatter_rows:  out[t, :] = sum of v[h,i] * A[i, :] over the entries e = i * nnz + h
//                with b[h,i] == t, in ascending e (f32); optionally out = acc + that,
//                as one IEEE add (bitwise acc + scatter_rows(...)).  Buckets outside
//                [0, S) are dropped, as a segment sum drops them.
// gather_scaled_rows:  out[j, :] = scale * T[idx[j], :]   (bitwise T.index_select * scale).
//
// What bounds them on the H100: bytes.  Both do at most two flops per element
// of A or T they read.
//
// scatter_rows must be identical run to run (fused == unfused, planned == eager
// and kill/resume all rest on it), so it uses no float atomics.  The TPU kernel
// walked the entries in order (i ascending, hash h innermost) on one core into
// one (S, 512) VMEM accumulator.  Hopper runs blocks in no order with 227 KB of
// shared memory each, so the work is cut in two passes:
//
// Pass 1, a stable partition of the E = nnz * k entries by bucket: an LSD radix
//   partition in passes of at most 8 bucket bits (two passes for S = 2048, four
//   at most).  Each pass is a count kernel (a block takes a tile of 2048 entries
//   and writes its per-digit counts to column `tile` of a (digits, tiles) table,
//   per-warp histograms by integer shared-memory atomics), an int32 torch.cumsum
//   of the table, and a place kernel (the block ranks its tile stably in shared
//   memory, equal digits found by one warp ballot per digit bit, and writes each
//   digit's run contiguously; csrc/stage.cuh, shared with csrc/scatter.cu's
//   pass 1).  Every pass is stable, so after the last one the entries are in
//   bucket order and, inside a bucket, in entry order.  The first pass reads the bucket ids once and drops
//   those out of range; later passes learn the kept count from the previous
//   table's last prefix, so nothing waits on the host.  The table holds at most
//   256 * ceil(E / 2048) ints whatever S is.  A last kernel finds where each
//   bucket starts (seg_start, a binary search in the sorted buckets) and into how
//   many pieces of at most L entries it is cut.
//
// Pass 2, the walk: a block (m >= 64) or a warp (m < 64) per piece and column
//   range.  A wide-row thread owns 4 consecutive columns (one 16-byte load of an
//   f32 row, 8 of a bf16 one, where m % 4 == 0 and A is aligned; scalar loads
//   otherwise), so a warp reads 512 contiguous bytes of each listed row, and the
//   loads of 8 listed entries are issued before their adds.  A narrow warp loads
//   32 listed values at once and folds them in list order through shuffles,
//   while the next 32 load.  Either way each (bucket, column) sum is kept in a
//   register and adds __fmul_rn(v, a) with __fadd_rn (nvcc may not contract them
//   into FMAs) in list order from +0, with no barrier and no shared tile.  A is
//   read once per hash and the bucket ids not at all.  A bucket of at most L
//   entries is one piece, and its sum is exactly the plain version's in-order
//   sum; acc is folded in with one add at the single write.  A longer (hot)
//   bucket is cut into L-entry pieces, whose partial rows are kept apart (the
//   first in the bucket's output row, the others in a workspace); a fold kernel
//   adds them in piece order, then acc.  The cut depends on the data alone, so
//   the result is still the same run to run.
//
// gather_scaled_rows is a pure copy with one multiply per element, in T's
// dtype: grid (S rows, column tiles), coalesced along the columns.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

#include "stage.cuh"

constexpr int PT_BATCHES = 8;                      // pass-1 block: 8 batches of 32 entries per warp
constexpr int PT_TILE = PT_THREADS * PT_BATCHES;   // 2048 entries per tile
constexpr int PT_DIGITS = 256;                     // digits of a pass, at most
constexpr int WK_THREADS = 128;                    // wide walk: a block per piece ...
constexpr int WK_COLS = 4 * WK_THREADS;            // ... and 512 columns
constexpr int WK_AHEAD = 8;                        // listed rows loaded before their adds
constexpr int NW_WARPS = 4;                        // narrow walk: a warp per piece and column
constexpr int NARROW_M = 64;                       // m below this takes the narrow walk
constexpr int FD_THREADS = 256;

// ---------------------------------------------------------------- pass 1 --

// A pass's input.  The first pass (ents == nullptr) reads the bucket ids b,
// (nnz, k) row-major, in entry order e = i * nnz + h, and drops buckets outside
// [0, S); a later pass reads the previous pass's (keys, ents), *total of them.
struct PassIn {
  const int* keys;
  const int* ents;
  const int* total;
  int E, k, nnz, S;
};

// Entry j of the pass: its bucket (-1 if dropped or past the end) and its e.
__device__ __forceinline__ void load_entry(const PassIn& in, int n, int j, int& key, int& e) {
  key = -1;
  e = 0;
  if (j >= n) return;
  if (in.ents) {
    key = in.keys[j];
    e = in.ents[j];
    return;
  }
  e = j;
  const int i = j / in.nnz, h = j - i * in.nnz;
  const int t = in.keys[(size_t)h * in.k + i];
  if ((unsigned)t < (unsigned)in.S) key = t;
}

__device__ __forceinline__ int digit_of(int key, int shift, int nd) {
  return key < 0 ? -1 : (key >> shift) & (nd - 1);
}

// Block `tile` takes entries [tile * PT_TILE, ...); warp w holds the 256
// consecutive entries from w * 256, batch j of 32 at w * 256 + j * 32.
__device__ __forceinline__ int entry_index(int jj) {
  return (int)blockIdx.x * PT_TILE + (((threadIdx.x >> 5) * PT_BATCHES + jj) << 5) +
         (threadIdx.x & 31);
}

__global__ void __launch_bounds__(PT_THREADS)
count_kernel(PassIn in, int shift, int nd, int tiles, int* __restrict__ counts) {
  __shared__ int hist[PT_WARPS * PT_DIGITS];
  const int tid = threadIdx.x, w = tid >> 5;
  const int n = in.total ? *in.total : in.E;
  int key[PT_BATCHES];
#pragma unroll
  for (int jj = 0; jj < PT_BATCHES; ++jj) {
    int e;
    load_entry(in, n, entry_index(jj), key[jj], e);
  }
  for (int i = tid; i < PT_WARPS * nd; i += PT_THREADS) hist[i] = 0;
  __syncthreads();
#pragma unroll
  for (int jj = 0; jj < PT_BATCHES; ++jj) warp_count(digit_of(key[jj], shift, nd), hist + w * nd);
  __syncthreads();
  for (int d = tid; d < nd; d += PT_THREADS) {
    int s = 0;
    for (int u = 0; u < PT_WARPS; ++u) s += hist[u * nd + d];
    counts[(long long)d * tiles + blockIdx.x] = s;
  }
}

constexpr size_t PLACE_SMEM = sizeof(int) * (2 * PT_TILE + PT_WARPS * PT_DIGITS + (PT_DIGITS + 1) +
                                             PT_DIGITS + (PT_WARPS + 1));

// Places one tile: ranks it stably by digit in shared memory, then writes each
// digit's run from its offset in the prefixed table cum (inclusive cumsum).
__global__ void __launch_bounds__(PT_THREADS, 2)
place_kernel(PassIn in, int shift, int nd, int tiles, const int* __restrict__ cum,
             int* __restrict__ okeys, int* __restrict__ oents) {
  extern __shared__ int smem[];
  int* skey = smem;                          // PT_TILE staged buckets
  int* sent = skey + PT_TILE;                // PT_TILE staged entries
  int* hist = sent + PT_TILE;                // PT_WARPS x PT_DIGITS
  int* start = hist + PT_WARPS * PT_DIGITS;  // PT_DIGITS + 1
  int* gbase = start + PT_DIGITS + 1;        // PT_DIGITS
  int* scratch = gbase + PT_DIGITS;          // PT_WARPS + 1
  const int tid = threadIdx.x, w = tid >> 5;
  const int n = in.total ? *in.total : in.E;
  int key[PT_BATCHES], ent[PT_BATCHES];
#pragma unroll
  for (int jj = 0; jj < PT_BATCHES; ++jj) load_entry(in, n, entry_index(jj), key[jj], ent[jj]);
  const int bits = 32 - __clz(nd - 1);
  for (int i = tid; i < PT_WARPS * nd; i += PT_THREADS) hist[i] = 0;
  __syncthreads();
  int* row = hist + w * nd;
#pragma unroll
  for (int jj = 0; jj < PT_BATCHES; ++jj) warp_count(digit_of(key[jj], shift, nd), row);
  __syncthreads();
  const int total = rank_bases(hist, nd, start, scratch);
  for (int d = tid; d < nd; d += PT_THREADS)
    gbase[d] = excl(cum, (long long)d * tiles + blockIdx.x) - start[d];
#pragma unroll
  for (int jj = 0; jj < PT_BATCHES; ++jj) {
    const int r = warp_rank(digit_of(key[jj], shift, nd), row, bits);
    if (r >= 0) {
      skey[r] = key[jj];
      sent[r] = ent[jj];
    }
  }
  __syncthreads();
  for (int i = tid; i < total; i += PT_THREADS) {
    const int t = skey[i];
    const int dst = gbase[digit_of(t, shift, nd)] + i;
    okeys[dst] = t;
    oents[dst] = sent[i];
  }
}

// The first i in [0, n) with a[i] >= x (a sorted), or n.
__device__ __forceinline__ int lower_bound(const int* a, int n, int x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (a[mid] < x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// seg_start[t] for t in [0, S]: where bucket t starts in the sorted entries;
// pieces[t] for t < S: max(1, ceil(len_t / L)).
__global__ void seg_start_kernel(const int* __restrict__ skeys, const int* __restrict__ total,
                                 int S, int L, int* __restrict__ seg_start,
                                 int* __restrict__ pieces) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t > S) return;
  const int n = *total;
  const int lo = lower_bound(skeys, n, (int)t);
  seg_start[t] = lo;
  if (t < S) {
    const int len = lower_bound(skeys, n, (int)t + 1) - lo;
    pieces[t] = max(1, len / L + (len % L != 0));
  }
}

// ---------------------------------------------------------------- pass 2 --

// A piece: entries [lo, hi) of bucket seg's sorted list, piece p of it.  A
// bucket cut into several pieces keeps piece 0's partial in its output row and
// piece p >= 1's in workspace row `slot`, consecutive for one bucket: the
// number of pieces p >= 1 of the buckets before it, plus p - 1.
struct Piece {
  int seg, lo, hi, p;
  bool whole;
  long long slot;
};

// Piece b of the ordered list of all pieces (piece_cum: inclusive cumsum of
// pieces[t]); false for b past the last piece.
__device__ __forceinline__ bool find_piece(const int* __restrict__ seg_start,
                                           const int* __restrict__ piece_cum, int S, int L,
                                           long long b, Piece& pc) {
  if (b >= piece_cum[S - 1]) return false;
  int lo = 0, hi = S - 1;  // the first t with piece_cum[t] > b
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (piece_cum[mid] > b) hi = mid; else lo = mid + 1;
  }
  const int first = excl(piece_cum, lo);
  const int p = (int)(b - first);
  const int s1 = seg_start[lo + 1];
  pc.seg = lo;
  pc.lo = seg_start[lo] + p * L;
  pc.hi = min(s1, pc.lo + L);
  pc.p = p;
  pc.whole = piece_cum[lo] - first == 1;
  pc.slot = (long long)first - lo + p - 1;
  return true;
}

__device__ __forceinline__ void emit(const Piece& pc, int m, int col, float s,
                                     const float* __restrict__ acc, float* __restrict__ out,
                                     float* __restrict__ parts) {
  const size_t o = (size_t)pc.seg * m + col;
  if (pc.whole) {
    out[o] = acc ? __fadd_rn(acc[o], s) : s;
  } else if (pc.p == 0) {
    out[o] = s;
  } else {
    parts[(size_t)pc.slot * m + col] = s;
  }
}

// Four consecutive columns of a row in one load (16 bytes of f32, 8 of bf16).
__device__ __forceinline__ void unpack(float4 x, float* a) {
  a[0] = x.x;
  a[1] = x.y;
  a[2] = x.z;
  a[3] = x.w;
}
__device__ __forceinline__ void unpack(uint2 x, float* a) {  // bf16 -> f32 is exact
  a[0] = __uint_as_float(x.x << 16);
  a[1] = __uint_as_float(x.x & 0xffff0000u);
  a[2] = __uint_as_float(x.y << 16);
  a[3] = __uint_as_float(x.y & 0xffff0000u);
}
template <typename T> struct Vec4;
template <> struct Vec4<float> { using type = float4; };
template <> struct Vec4<__nv_bfloat16> { using type = uint2; };

template <typename T, bool VEC>
__device__ __forceinline__ void load4(const T* __restrict__ row, int c0, int m, float* a) {
  if (VEC) {
    unpack(*reinterpret_cast<const typename Vec4<T>::type*>(row + c0), a);
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) a[c] = c0 + c < m ? to_f32(row[c0 + c]) : 0.0f;
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(WK_THREADS)
walk_wide_kernel(const T* __restrict__ A, const float* __restrict__ v,
                 const int* __restrict__ sents, const int* __restrict__ seg_start,
                 const int* __restrict__ piece_cum, const float* __restrict__ acc,
                 float* __restrict__ out, float* __restrict__ parts, int k, int m, int nnz,
                 int S, int L) {
  Piece pc;
  if (!find_piece(seg_start, piece_cum, S, L, blockIdx.x, pc)) return;
  const int c0 = blockIdx.y * WK_COLS + 4 * threadIdx.x;
  if (c0 >= m) return;
  float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int j = pc.lo; j < pc.hi; j += WK_AHEAD) {
    float val[WK_AHEAD], a[WK_AHEAD][4];
#pragma unroll
    for (int u = 0; u < WK_AHEAD; ++u) {
      val[u] = 0.0f;
      a[u][0] = a[u][1] = a[u][2] = a[u][3] = 0.0f;
      if (j + u < pc.hi) {
        const int e = sents[j + u];
        const int i = e / nnz, h = e - i * nnz;
        val[u] = v[(size_t)h * k + i];
        load4<T, VEC>(A + (size_t)i * m, c0, m, a[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < WK_AHEAD; ++u) {
      if (j + u < pc.hi) {
#pragma unroll
        for (int c = 0; c < 4; ++c) s[c] = __fadd_rn(s[c], __fmul_rn(val[u], a[u][c]));
      }
    }
  }
#pragma unroll
  for (int c = 0; c < 4; ++c)
    if (c0 + c < m) emit(pc, m, c0 + c, s[c], acc, out, parts);
}

template <typename T>
__global__ void __launch_bounds__(NW_WARPS * 32)
walk_narrow_kernel(const T* __restrict__ A, const float* __restrict__ v,
                   const int* __restrict__ sents, const int* __restrict__ seg_start,
                   const int* __restrict__ piece_cum, const float* __restrict__ acc,
                   float* __restrict__ out, float* __restrict__ parts, int k, int m, int nnz,
                   int S, int L) {
  const int lane = threadIdx.x & 31;
  const long long b = (long long)blockIdx.x * NW_WARPS + (threadIdx.x >> 5);
  const int col = blockIdx.y;
  Piece pc;
  if (!find_piece(seg_start, piece_cum, S, L, b, pc)) return;  // the whole warp
  // This lane's product v * A[i, col] in the batch of 32 listed entries at j.
  auto product = [&](int j) {
    float p = 0.0f;
    if (j + lane < pc.hi) {
      const int e = sents[j + lane];
      const int i = e / nnz, h = e - i * nnz;
      p = __fmul_rn(v[(size_t)h * k + i], to_f32(A[(size_t)i * m + col]));
    }
    return p;
  };
  float s = 0.0f;
  float p = product(pc.lo);
  for (int j = pc.lo; j < pc.hi; j += 32) {
    const float next = product(j + 32);  // the next batch loads while this one is added
    const int n = min(32, pc.hi - j);
#pragma unroll
    for (int q = 0; q < 32; ++q) {
      const float x = __shfl_sync(FULL, p, q);
      if (q < n) s = __fadd_rn(s, x);
    }
    p = next;
  }
  if (lane == 0) emit(pc, m, col, s, acc, out, parts);
}

// A bucket cut into several pieces: its partial rows (piece 0's in out)
// added in piece order, then acc.
__global__ void __launch_bounds__(FD_THREADS)
fold_kernel(const int* __restrict__ piece_cum, const float* __restrict__ acc,
            const float* __restrict__ parts, float* __restrict__ out, int m) {
  const int t = blockIdx.x;
  const int col = blockIdx.y * FD_THREADS + threadIdx.x;
  if (col >= m) return;
  const int first = excl(piece_cum, t);
  const int n = piece_cum[t] - first;
  if (n == 1) return;
  const long long slot = (long long)first - t;  // piece 1's workspace row
  const size_t o = (size_t)t * m + col;
  float s = out[o];
  for (int q = 1; q < n; ++q) s = __fadd_rn(s, parts[(size_t)(slot + q - 1) * m + col]);
  out[o] = acc ? __fadd_rn(acc[o], s) : s;
}

template <typename T>
int launch_walk(const void* A, const void* v, const void* sents, const void* seg_start,
                const void* piece_cum, const void* acc, void* out, void* parts, int k, int m,
                int nnz, int S, int L, int pieces, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const T* a = (const T*)A;
  const float* vv = (const float*)v;
  const int* se = (const int*)sents;
  const int* ss = (const int*)seg_start;
  const int* pcum = (const int*)piece_cum;
  const float* ac = (const float*)acc;
  float* o = (float*)out;
  float* pa = (float*)parts;
  if (m < NARROW_M) {
    dim3 grid((pieces + NW_WARPS - 1) / NW_WARPS, m);
    walk_narrow_kernel<T><<<grid, NW_WARPS * 32, 0, st>>>(a, vv, se, ss, pcum, ac, o, pa, k, m,
                                                          nnz, S, L);
  } else {
    dim3 grid(pieces, (m + WK_COLS - 1) / WK_COLS);
    if (m % 4 == 0 && (uintptr_t)A % (4 * sizeof(T)) == 0)
      walk_wide_kernel<T, true><<<grid, WK_THREADS, 0, st>>>(a, vv, se, ss, pcum, ac, o, pa, k,
                                                             m, nnz, S, L);
    else
      walk_wide_kernel<T, false><<<grid, WK_THREADS, 0, st>>>(a, vv, se, ss, pcum, ac, o, pa,
                                                              k, m, nnz, S, L);
  }
  int err = (int)cudaGetLastError();
  if (err || pieces == S) return err;  // pieces == S: no bucket can be cut
  fold_kernel<<<dim3(S, (m + FD_THREADS - 1) / FD_THREADS), FD_THREADS, 0, st>>>(
      pcum, ac, pa, o, m);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------------ gather --

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
int launch_gather(const void* src, const void* idx, void* out, int nrows, int m, int s,
                  float scale, void* stream) {
  dim3 grid(s, (m + GA_COLS - 1) / GA_COLS);
  gather_scaled_rows_kernel<T><<<grid, GA_THREADS, 0, (cudaStream_t)stream>>>(
      (const T*)src, (const int*)idx, (T*)out, nrows, m, scale);
  return (int)cudaGetLastError();
}

bool bad_digits(int nd) { return nd < 1 || nd > PT_DIGITS || (nd & (nd - 1)); }

}  // namespace

extern "C" {

// Pass 1, one LSD pass, counts: a (nd, tiles) table, digit (key >> shift) & (nd - 1).
int skylark_scatter_count(const void* keys, const void* ents, const void* total, int E, int k,
                          int nnz, int S, int shift, int nd, int tiles, void* counts,
                          void* stream) {
  if (bad_digits(nd)) return (int)cudaErrorInvalidValue;
  PassIn in{(const int*)keys, (const int*)ents, (const int*)total, E, k, nnz, S};
  count_kernel<<<tiles, PT_THREADS, 0, (cudaStream_t)stream>>>(in, shift, nd, tiles,
                                                               (int*)counts);
  return (int)cudaGetLastError();
}

// Pass 1, one LSD pass, placement by the prefixed table cum into okeys/oents.
int skylark_scatter_place(const void* keys, const void* ents, const void* total, int E, int k,
                          int nnz, int S, int shift, int nd, int tiles, const void* cum,
                          void* okeys, void* oents, void* stream) {
  if (bad_digits(nd)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(place_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)PLACE_SMEM);
  if (err != cudaSuccess) return (int)err;
  PassIn in{(const int*)keys, (const int*)ents, (const int*)total, E, k, nnz, S};
  place_kernel<<<tiles, PT_THREADS, PLACE_SMEM, (cudaStream_t)stream>>>(
      in, shift, nd, tiles, (const int*)cum, (int*)okeys, (int*)oents);
  return (int)cudaGetLastError();
}

// Pass 1, last step: seg_start (S + 1) and pieces (S) from the sorted buckets.
int skylark_scatter_seg_start(const void* skeys, const void* total, int S, int L,
                              void* seg_start, void* pieces, void* stream) {
  if (L < 1) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)(((long long)S + 1 + 255) / 256);
  seg_start_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(
      (const int*)skeys, (const int*)total, S, L, (int*)seg_start, (int*)pieces);
  return (int)cudaGetLastError();
}

// Pass 2: the walk over `pieces` (an upper bound on the pieces) and the fold.
int skylark_scatter_walk_f32(const void* A, const void* v, const void* sents,
                             const void* seg_start, const void* piece_cum, const void* acc,
                             void* out, void* parts, int k, int m, int nnz, int S, int L,
                             int pieces, void* stream) {
  return launch_walk<float>(A, v, sents, seg_start, piece_cum, acc, out, parts, k, m, nnz, S, L,
                            pieces, stream);
}

int skylark_scatter_walk_bf16(const void* A, const void* v, const void* sents,
                              const void* seg_start, const void* piece_cum, const void* acc,
                              void* out, void* parts, int k, int m, int nnz, int S, int L,
                              int pieces, void* stream) {
  return launch_walk<__nv_bfloat16>(A, v, sents, seg_start, piece_cum, acc, out, parts, k, m,
                                    nnz, S, L, pieces, stream);
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
