// Block-staged stable ranking shared by the pass-1 kernels of csrc/scatter.cu
// and csrc/window.cu: a block of PT_WARPS warps counts a tile's digits into
// per-warp shared-memory histograms (integer atomics, exact in any order),
// turns them into rank bases, and ranks each warp's batches of 32 in input
// order, equal digits found by one warp ballot per digit bit.  Each source
// includes it inside its own anonymous namespace.

constexpr unsigned FULL = 0xffffffffu;
constexpr int PT_WARPS = 8;  // pass-1 block
constexpr int PT_THREADS = PT_WARPS * 32;

__device__ __forceinline__ float to_f32(float a) { return a; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 a) { return __bfloat162float(a); }

// Exclusive prefix of an inclusive cumsum: the sum of the entries before i.
__device__ __forceinline__ int excl(const int* cum, long long i) { return i > 0 ? cum[i - 1] : 0; }

// In-place exclusive prefix sum of a[0, n) over a pass-1 block; returns the
// total.  Every thread of the block calls it; it ends with a barrier.
__device__ int exclusive_scan(int* a, int n, int* scratch) {
  constexpr int NW = PT_WARPS;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int per = (n + PT_THREADS - 1) / PT_THREADS;
  const int lo = min(n, tid * per), hi = min(n, lo + per);
  int own = 0;
  for (int i = lo; i < hi; ++i) own += a[i];
  int incl = own;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) scratch[w] = incl;
  __syncthreads();
  if (w == 0) {
    const int t = lane < NW ? scratch[lane] : 0;
    int ti = t;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, ti, o);
      if (lane >= o) ti += y;
    }
    if (lane < NW) scratch[lane] = ti - t;
    if (lane == NW - 1) scratch[NW] = ti;
  }
  __syncthreads();
  int run = scratch[w] + incl - own;
  for (int i = lo; i < hi; ++i) {
    const int x = a[i];
    a[i] = run;
    run += x;
  }
  const int total = scratch[NW];
  __syncthreads();
  return total;
}

// Lanes of this warp holding the same value v in [-1, 2^bits), from one
// ballot per bit (bit `bits` tells -1 apart): for a few bits, cheaper on
// this card than __match_any_sync.
__device__ __forceinline__ unsigned peers_of(int v, int bits) {
  unsigned m = FULL;
  for (int b = 0; b <= bits; ++b) {
    const unsigned bal = __ballot_sync(FULL, (v >> b) & 1);
    m &= ((v >> b) & 1) ? bal : ~bal;
  }
  return m;
}

// One entry per lane into this warp's histogram row (integer shared-memory
// atomics: exact in any order).
__device__ __forceinline__ void warp_count(int d, int* row) {
  if (d >= 0) atomicAdd(&row[d], 1);
}

// One batch's ranks: row[d] is where this warp's next digit-d entry goes.
// Lanes of equal digit take consecutive ranks in lane order; -1 if d < 0.
__device__ __forceinline__ int warp_rank(int d, int* row, int bits) {
  const int lane = threadIdx.x & 31;
  const unsigned peers = peers_of(d, bits);
  const int leader = __ffs(peers) - 1;
  int base = (d >= 0 && lane == leader) ? row[d] : 0;
  base = __shfl_sync(FULL, base, leader);
  int r = -1;
  if (d >= 0) {
    r = base + __popc(peers & ((1u << lane) - 1u));
    if (lane == leader) row[d] = base + __popc(peers);
  }
  __syncwarp();  // the next batch's leader for d may be another lane
  return r;
}

// After every warp of a pass-1 block has counted its batches into its row of
// hist (PT_WARPS rows of nd): start[d] = where digit d begins in the block's
// stable order, start[nd] = the total, and hist[w][d] = where warp w's first
// digit-d entry goes (warps hold consecutive entries: warp order is input order).
__device__ int rank_bases(int* hist, int nd, int* start, int* scratch) {
  for (int d = threadIdx.x; d < nd; d += PT_THREADS) {
    int t = 0;
    for (int w = 0; w < PT_WARPS; ++w) t += hist[w * nd + d];
    start[d] = t;
  }
  __syncthreads();
  const int total = exclusive_scan(start, nd, scratch);
  for (int d = threadIdx.x; d < nd; d += PT_THREADS) {
    int run = start[d];
    for (int w = 0; w < PT_WARPS; ++w) {
      const int c = hist[w * nd + d];
      hist[w * nd + d] = run;
      run += c;
    }
  }
  if (threadIdx.x == 0) start[nd] = total;
  __syncthreads();
  return total;
}
