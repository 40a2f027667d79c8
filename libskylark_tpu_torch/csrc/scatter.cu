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
// order, so the work is a stable partition of the entries by slot range
// (p = key >> 14, V = 16384 slots, 64 KB of f32), then one block per
// partition that adds its entries in a fixed order.
//
// Pass 1, the partition, in two levels of the same block-staged kernel pair.
// A one-level partition into P ~ 10^4 ranges scatters every entry (a chunk
// holds 1-2 entries per range), which costs four scattered sector accesses
// for 8 useful bytes; two levels of at most 512 digits each keep every write
// in runs of tens to hundreds of entries.
//   level 1: coarse bucket b = key >> shift (2^shift a multiple of V, at most
//     256 buckets).  count_kernel: a block takes a tile of 8192 entries and
//     writes its per-bucket count to column k of a (buckets, tiles) table
//     (per-warp histograms by integer shared-memory atomics, no global
//     atomics).  torch.cumsum prefixes the table between the kernels.
//     place_kernel: the block loads the tile again, ranks it stably in
//     shared memory (per-warp histograms prefixed in warp order, then each
//     warp ranks its entries in input order, equal digits found by one
//     warp ballot per digit bit) and writes each bucket's run contiguously.
//   level 2: fine digit f = (key >> 14) mod F within each coarse bucket
//     (F = 2^shift / V partitions per bucket), the same kernels on the
//     level-1 output.  Tiles are cut inside each bucket and never cross one,
//     so a flat (tiles, F) table laid out bucket by bucket, digit by digit,
//     tile by tile prefixes to each partition's offsets with one cumsum.
//     The grids are sized by an upper bound on the tile count (nnz / 8192 +
//     buckets); each block finds its tile from the bucket starts, and
//     surplus blocks leave.  The first tile of each bucket writes part_start.
// The result is entries stably ordered by partition, keys out of range
// dropped, with part_start (P + 1); nothing waits on the host.
//
// Pass 2 (accumulate_kernel): one block per partition holds the V f32 slots
//   in shared memory and takes its entries in groups of SS_G, in order.  Each
//   of the 16 warps owns 1024 slots.  A group is ranked stably by owner (the
//   same shared-memory ranking as pass 1), then each warp walks its own
//   entries in input order, 32 at a time: the lowest lane of each set of equal
//   slots (__match_any_sync) adds the set's values in lane order to the
//   slot's running group sum, and the slot's value from before the group is
//   set aside at its first entry and added back when the group ends.  Each
//   slot has one writer, so the walk needs no barrier; every slot adds, per
//   group, the in-order sum of its entries in that group.  That is exactly
//   the order of the earlier bitonic-sorted version of this pass, whose
//   results this one reproduces bit for bit, and it keeps a hot slot's error
//   near that of a blocked sum (a slot with 5e6 entries adds ~2.4e3 group
//   sums, not 5e6 terms, into its accumulator).  The block writes its V
//   slots once.  87 KB of shared memory: two blocks fit on an SM.
//
// Bytes: ~48 per entry over the four pass-1 kernels and pass 2, plus the count
// tables (about 4 * 256 / 8192 bytes per entry) and 4 per slot written.  On
// an H100 the place kernels run at about half the HBM rate and pass 2, paced
// by its per-group barriers and serial walks rather than by bytes, at about
// a third (PERF.md).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

#include "stage.cuh"

constexpr int SS_VBITS = 14;
constexpr int SS_V = 1 << SS_VBITS;               // slots per partition
constexpr int SS_G = 2048;                        // entries per staged group in pass 2
constexpr int PT_BATCHES = 32;                    // pass-1 block: 32 batches of 32 entries per warp
constexpr int PT_TILE = PT_THREADS * PT_BATCHES;  // 8192 entries per tile
constexpr int PT_DIGITS = 512;                    // digits of a level, at most
constexpr int AC_WARPS = 16;                      // pass-2 block
constexpr int AC_THREADS = AC_WARPS * 32;
constexpr int AC_SUB_BITS = 10;                   // warp w owns slots [w << 10, (w + 1) << 10)
constexpr int AC_BATCHES = SS_G / AC_THREADS;     // 4 entries per thread per group
static_assert((SS_V >> AC_SUB_BITS) == AC_WARPS, "one slot range per pass-2 warp");
static_assert(SS_G % AC_THREADS == 0, "whole batches per pass-2 group");
static_assert(AC_WARPS * AC_WARPS <= AC_THREADS, "pass-2 histogram zeroed in one step");

__device__ __forceinline__ float to_f32(__half a) { return __half2float(a); }

// Where coarse bucket b starts in the level-1 output (b = NB: the total).
__device__ __forceinline__ int bucket_start(const int* cum1, int K1, int b) {
  return excl(cum1, (long long)b * K1);
}

// Level digit of a key, or -1 for an entry that is dropped (or absent).
template <bool FINE>
__device__ __forceinline__ int digit_of(int key, int T, int shift, int fmask) {
  if (FINE) return key < 0 ? -1 : (key >> SS_VBITS) & fmask;
  return (unsigned)key < (unsigned)T ? key >> shift : -1;
}

// A pass-1 tile: entries [begin, begin + n) of the level's input; its count of
// digit d sits at col + d * stride of the level's table.
struct Tile {
  long long begin;
  int n;
  long long col;
  int stride;
  int bucket;  // fine level: the coarse bucket ...
  bool first;  // ... and whether this is its first tile
};

// Level 1: tile k is entries [k * PT_TILE, ...), digit d's count at d * K1 + k.
__device__ __forceinline__ Tile coarse_tile(long long nnz, int K1) {
  Tile t;
  t.begin = (long long)blockIdx.x * PT_TILE;
  t.n = (int)min((long long)PT_TILE, nnz - t.begin);
  t.col = blockIdx.x;
  t.stride = K1;
  t.bucket = 0;
  t.first = false;
  return t;
}

// Level 2: coarse bucket b (level-1 output [bucket_start(b), bucket_start(b +
// 1))) is cut into ntiles_b = max(1, ceil(len_b / PT_TILE)) tiles of its own;
// tiles are numbered bucket by bucket from tile_off[b].  The (tiles, F) table
// holds bucket b's counts at [tile_off[b] * F, (tile_off[b] + ntiles_b) * F),
// digit-major: tile t's count of digit f at tile_off[b] * F + f * ntiles_b + t.
// Returns false for a block past the last tile.
__device__ bool fine_tile(const int* cum1, int K1, int NB, int F, int* tile_off, int* scratch,
                          Tile& t) {
  for (int b = threadIdx.x; b < NB; b += PT_THREADS) {
    const int len = bucket_start(cum1, K1, b + 1) - bucket_start(cum1, K1, b);
    tile_off[b] = max(1, (len + PT_TILE - 1) / PT_TILE);
  }
  __syncthreads();
  const int K2 = exclusive_scan(tile_off, NB, scratch);
  const int k = blockIdx.x;
  if (k >= K2) return false;
  int lo = 0, hi = NB - 1;  // the last bucket whose first tile is <= k
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (tile_off[mid] <= k) lo = mid; else hi = mid - 1;
  }
  const int tile0 = tile_off[lo];
  const int ntiles = (lo + 1 < NB ? tile_off[lo + 1] : K2) - tile0;
  const int tk = k - tile0;
  const int end = bucket_start(cum1, K1, lo + 1);
  t.begin = bucket_start(cum1, K1, lo) + (long long)tk * PT_TILE;
  t.n = (int)max(0LL, min((long long)PT_TILE, end - t.begin));
  t.col = (long long)tile0 * F + tk;
  t.stride = ntiles;
  t.bucket = lo;
  t.first = tk == 0;
  return true;
}

template <bool FINE>
__global__ void __launch_bounds__(PT_THREADS)
count_kernel(const int* __restrict__ keys, long long nnz, int T, int shift, int nd, int K1,
             const int* __restrict__ cum1, int NB, int* __restrict__ counts) {
  __shared__ int hist[PT_WARPS * PT_DIGITS];
  __shared__ int tile_off[PT_DIGITS];
  __shared__ int scratch[PT_WARPS + 1];
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  Tile t;
  if (FINE) {
    if (!fine_tile(cum1, K1, NB, nd, tile_off, scratch, t)) {
      // A surplus block zeroes its share of the table's unused tail.
      for (int d = tid; d < nd; d += PT_THREADS) counts[(long long)blockIdx.x * nd + d] = 0;
      return;
    }
  } else {
    t = coarse_tile(nnz, K1);
  }
  int k[PT_BATCHES];
#pragma unroll
  for (int j = 0; j < PT_BATCHES; ++j) {
    const int i = (w * PT_BATCHES + j) * 32 + lane;
    k[j] = i < t.n ? keys[t.begin + i] : -1;
  }
  for (int i = tid; i < PT_WARPS * nd; i += PT_THREADS) hist[i] = 0;
  __syncthreads();
#pragma unroll
  for (int j = 0; j < PT_BATCHES; ++j)
    warp_count(digit_of<FINE>(k[j], T, shift, nd - 1), hist + w * nd);
  __syncthreads();
  for (int d = tid; d < nd; d += PT_THREADS) {
    int s = 0;
    for (int v = 0; v < PT_WARPS; ++v) s += hist[v * nd + d];
    counts[t.col + (long long)d * t.stride] = s;
  }
}

constexpr size_t PLACE_SMEM =
    sizeof(int) * (2 * PT_TILE + PT_WARPS * PT_DIGITS + 3 * PT_DIGITS + 1 + PT_WARPS + 1);

// Places one tile: ranks it stably by digit in shared memory, then writes each
// digit's run to its offset from the prefixed table cum (inclusive cumsum).
template <bool FINE, typename T_>
__global__ void __launch_bounds__(PT_THREADS, 2)
place_kernel(const int* __restrict__ keys, const T_* __restrict__ vals, long long nnz, int T,
             int shift, int nd, int K1, const int* __restrict__ cum1, int NB,
             const int* __restrict__ cum, int P, int* __restrict__ okeys,
             float* __restrict__ ovals, int* __restrict__ part_start) {
  extern __shared__ int smem[];
  int* skey = smem;                                // PT_TILE staged keys
  float* sval = (float*)(skey + PT_TILE);          // PT_TILE staged values
  int* hist = (int*)(sval + PT_TILE);              // PT_WARPS x PT_DIGITS
  int* start = hist + PT_WARPS * PT_DIGITS;        // PT_DIGITS + 1
  int* gbase = start + PT_DIGITS + 1;              // PT_DIGITS
  int* tile_off = gbase + PT_DIGITS;               // PT_DIGITS
  int* scratch = tile_off + PT_DIGITS;             // PT_WARPS + 1
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  Tile t;
  if (FINE) {
    if (!fine_tile(cum1, K1, NB, nd, tile_off, scratch, t)) return;
  } else {
    t = coarse_tile(nnz, K1);
  }
  int k[PT_BATCHES];
  float v[PT_BATCHES];
#pragma unroll
  for (int j = 0; j < PT_BATCHES; ++j) {
    const int i = (w * PT_BATCHES + j) * 32 + lane;
    k[j] = -1;
    v[j] = 0.0f;
    if (i < t.n) {
      k[j] = keys[t.begin + i];
      v[j] = to_f32(vals[t.begin + i]);
    }
  }
  const int bits = 32 - __clz(nd - 1);
  for (int i = tid; i < PT_WARPS * nd; i += PT_THREADS) hist[i] = 0;
  __syncthreads();
  int* row = hist + w * nd;
#pragma unroll
  for (int j = 0; j < PT_BATCHES; ++j)
    warp_count(digit_of<FINE>(k[j], T, shift, nd - 1), row);
  __syncthreads();
  const int total = rank_bases(hist, nd, start, scratch);
  for (int d = tid; d < nd; d += PT_THREADS) {
    const int at = excl(cum, t.col + (long long)d * t.stride);
    gbase[d] = at - start[d];
    if (FINE && t.first && t.bucket * nd + d < P) part_start[t.bucket * nd + d] = at;
  }
  if (FINE && t.first && t.bucket == NB - 1 && tid == 0) part_start[P] = bucket_start(cum1, K1, NB);
#pragma unroll
  for (int j = 0; j < PT_BATCHES; ++j) {
    const int r = warp_rank(digit_of<FINE>(k[j], T, shift, nd - 1), row, bits);
    if (r >= 0) {
      skey[r] = k[j];
      sval[r] = v[j];
    }
  }
  __syncthreads();
  for (int i = tid; i < total; i += PT_THREADS) {
    const int key = skey[i];
    const int dst = gbase[digit_of<FINE>(key, T, shift, nd - 1)] + i;
    okeys[dst] = key;
    ovals[dst] = sval[i];
  }
}

constexpr size_t ACC_SMEM = sizeof(float) * (SS_V + 2 * SS_G)      // acc, gval, saved
                            + sizeof(unsigned) * (SS_V / 32)        // touched
                            + sizeof(int) * (AC_WARPS * AC_WARPS + AC_WARPS + 1)
                            + sizeof(unsigned short) * SS_G;        // gslot

__global__ void __launch_bounds__(AC_THREADS, 2)
accumulate_kernel(const int* __restrict__ skeys, const float* __restrict__ svals,
                  const int* __restrict__ part_start, int T, float* __restrict__ out) {
  extern __shared__ float smem_f[];
  float* acc = smem_f;                                    // SS_V slots
  float* gval = acc + SS_V;                               // group values, by owner
  float* saved = gval + SS_G;                             // a slot's value before the group
  unsigned* touched = (unsigned*)(saved + SS_G);          // slot seen in this group
  int* hist = (int*)(touched + SS_V / 32);                // AC_WARPS x AC_WARPS
  int* start = hist + AC_WARPS * AC_WARPS;                // AC_WARPS + 1
  unsigned short* gslot = (unsigned short*)(start + AC_WARPS + 1);  // group slots, by owner

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int p = blockIdx.x;
  const int slot0 = p * SS_V;
  for (int s = tid; s < SS_V; s += AC_THREADS) acc[s] = 0.0f;
  for (int i = tid; i < SS_V / 32; i += AC_THREADS) touched[i] = 0u;
  if (tid < AC_WARPS * AC_WARPS) hist[tid] = 0;
  int* row = hist + w * AC_WARPS;
  constexpr int OWNER_BITS = SS_VBITS - AC_SUB_BITS;

  const int begin = part_start[p];
  const int end = part_start[p + 1];
  // Warp w stages group entries [w * 128, w * 128 + 128), one batch of 32 per j.
  int s[AC_BATCHES];
  float v[AC_BATCHES];
#pragma unroll
  for (int j = 0; j < AC_BATCHES; ++j) {
    const int e = begin + (w * AC_BATCHES + j) * 32 + lane;
    s[j] = e < end ? skeys[e] - slot0 : -1;
    v[j] = e < end ? svals[e] : 0.0f;
  }
  for (int g0 = begin; g0 < end; g0 += SS_G) {
    __syncthreads();  // the previous group's walks are done with gslot/gval/start
#pragma unroll
    for (int j = 0; j < AC_BATCHES; ++j) warp_count(s[j] >= 0 ? s[j] >> AC_SUB_BITS : -1, row);
    __syncthreads();
    // One warp turns the (warp, owner) counts into rank bases; lane d has owner d.
    if (w == 0) {
      int total = 0;
      if (lane < AC_WARPS)
        for (int u = 0; u < AC_WARPS; ++u) total += hist[u * AC_WARPS + lane];
      int incl = total;
      for (int o = 1; o < AC_WARPS; o <<= 1) {
        const int y = __shfl_up_sync(FULL, incl, o);
        if (lane >= o) incl += y;
      }
      if (lane < AC_WARPS) {
        int run = incl - total;
        start[lane] = run;
        for (int u = 0; u < AC_WARPS; ++u) {
          const int c = hist[u * AC_WARPS + lane];
          hist[u * AC_WARPS + lane] = run;
          run += c;
        }
      }
      if (lane == AC_WARPS - 1) start[AC_WARPS] = incl;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < AC_BATCHES; ++j) {
      const int r = warp_rank(s[j] >= 0 ? s[j] >> AC_SUB_BITS : -1, row, OWNER_BITS);
      if (r >= 0) {
        gslot[r] = (unsigned short)s[j];
        gval[r] = v[j];
      }
    }
    // The next group's entries are loaded while this one is walked.
#pragma unroll
    for (int j = 0; j < AC_BATCHES; ++j) {
      const int e = g0 + SS_G + (w * AC_BATCHES + j) * 32 + lane;
      s[j] = e < end ? skeys[e] - slot0 : -1;
      v[j] = e < end ? svals[e] : 0.0f;
    }
    __syncthreads();
    // Warp w walks its own entries in input order, batch n of 32 at lo + 32 n;
    // bit n of firsts: this lane's entry of batch n is its slot's first.
    const int lo = start[w], hi = start[w + 1];
    unsigned long long firsts = 0;
    for (int b0 = lo, n = 0; b0 < hi; b0 += 32, ++n) {
      const int i = b0 + lane;
      const int slot = i < hi ? (int)gslot[i] : -1;
      const unsigned peers = __match_any_sync(FULL, slot);
      if (slot >= 0 && lane == __ffs(peers) - 1) {
        const unsigned bit = 1u << (slot & 31);
        float a;
        if (touched[slot >> 5] & bit) {
          a = __fadd_rn(acc[slot], gval[i]);
        } else {
          atomicOr(&touched[slot >> 5], bit);
          saved[i] = acc[slot];
          firsts |= 1ull << n;
          a = gval[i];
        }
        for (unsigned m = peers & (peers - 1u); m; m &= m - 1u)
          a = __fadd_rn(a, gval[b0 + __ffs(m) - 1]);
        acc[slot] = a;
      }
      __syncwarp();  // the next batch's leader for this slot may be another lane
    }
    // Each slot's group sum goes onto its value from before the group.
    for (; firsts; firsts &= firsts - 1) {
      const int i = lo + 32 * (__ffsll(firsts) - 1) + lane;
      const int slot = gslot[i];
      acc[slot] = __fadd_rn(saved[i], acc[slot]);
    }
    touched[w * 32 + lane] = 0u;  // this warp's 1024 slots
    if (lane < AC_WARPS) row[lane] = 0;
    __syncwarp();
  }
  __syncthreads();
  const int count = min(SS_V, T - slot0);
  for (int i = tid; i < count; i += AC_THREADS) out[(size_t)slot0 + i] = acc[i];
}

template <bool FINE, typename T_>
int launch_place(int grid, const void* keys, const void* vals, long long nnz, int T, int shift,
                 int nd, int K1, const void* cum1, int NB, const void* cum, int P, void* okeys,
                 void* ovals, void* part_start, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(place_kernel<FINE, T_>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)PLACE_SMEM);
  if (err != cudaSuccess) return (int)err;
  place_kernel<FINE, T_><<<grid, PT_THREADS, PLACE_SMEM, (cudaStream_t)stream>>>(
      (const int*)keys, (const T_*)vals, nnz, T, shift, nd, K1, (const int*)cum1, NB,
      (const int*)cum, P, (int*)okeys, (float*)ovals, (int*)part_start);
  return (int)cudaGetLastError();
}

bool bad_digits(int nd) { return nd < 1 || nd > PT_DIGITS; }

}  // namespace

extern "C" {

// Level 1, counts: a (NB, K1) table, K1 = ceil(nnz / 8192) tiles.
int skylark_segment_count_coarse(const void* keys, long long nnz, int T, int shift, int NB,
                                 int K1, void* counts, void* stream) {
  if (bad_digits(NB) || NB > PT_DIGITS / 2) return (int)cudaErrorInvalidValue;
  count_kernel<false><<<K1, PT_THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)keys, nnz, T, shift, NB, K1, nullptr, NB, (int*)counts);
  return (int)cudaGetLastError();
}

// Level 1, placement by the prefixed table cum1 into keys1/vals1 (f32).
int skylark_segment_place_coarse_f32(const void* keys, const void* vals, long long nnz, int T,
                                     int shift, int NB, int K1, const void* cum1, void* keys1,
                                     void* vals1, void* stream) {
  return launch_place<false, float>(K1, keys, vals, nnz, T, shift, NB, K1, nullptr, NB, cum1, 0,
                                    keys1, vals1, nullptr, stream);
}

int skylark_segment_place_coarse_bf16(const void* keys, const void* vals, long long nnz, int T,
                                      int shift, int NB, int K1, const void* cum1, void* keys1,
                                      void* vals1, void* stream) {
  return launch_place<false, __nv_bfloat16>(K1, keys, vals, nnz, T, shift, NB, K1, nullptr, NB,
                                            cum1, 0, keys1, vals1, nullptr, stream);
}

int skylark_segment_place_coarse_f16(const void* keys, const void* vals, long long nnz, int T,
                                     int shift, int NB, int K1, const void* cum1, void* keys1,
                                     void* vals1, void* stream) {
  return launch_place<false, __half>(K1, keys, vals, nnz, T, shift, NB, K1, nullptr, NB, cum1, 0,
                                     keys1, vals1, nullptr, stream);
}

// Level 2, counts: a (K2, F) table over K2 blocks, K2 an upper bound on the
// fine tiles (surplus blocks zero the tail).
int skylark_segment_count_fine(const void* keys1, int K1, int NB, const void* cum1, int F,
                               int K2, void* counts, void* stream) {
  if (bad_digits(F) || bad_digits(NB)) return (int)cudaErrorInvalidValue;
  count_kernel<true><<<K2, PT_THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)keys1, 0, 0, 0, F, K1, (const int*)cum1, NB, (int*)counts);
  return (int)cudaGetLastError();
}

// Level 2, placement by cum2 into the partitioned keys/vals, and part_start.
int skylark_segment_place_fine(const void* keys1, const void* vals1, int K1, int NB,
                               const void* cum1, int F, int K2, const void* cum2, int P,
                               void* skeys, void* svals, void* part_start, void* stream) {
  if (bad_digits(F) || bad_digits(NB)) return (int)cudaErrorInvalidValue;
  return launch_place<true, float>(K2, keys1, vals1, 0, 0, 0, F, K1, cum1, NB, cum2, P, skeys,
                                   svals, part_start, stream);
}

int skylark_segment_accumulate(const void* skeys, const void* svals, const void* part_start,
                               int T, int V, int P, void* out, void* stream) {
  if (V != SS_V) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      accumulate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)ACC_SMEM);
  if (err != cudaSuccess) return (int)err;
  accumulate_kernel<<<P, AC_THREADS, ACC_SMEM, (cudaStream_t)stream>>>(
      (const int*)skeys, (const float*)svals, (const int*)part_start, T, (float*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
