"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``libskylark_tpu_torch/csrc``, holds
each kernel against its plain PyTorch version at the main paths'
shapes (``rfut_rowwise`` at NB = 128, 256 also on both of its load
paths, misaligned views, row independence and run-to-run, bitwise),
drives the main paths with every launch counter reset just before each
and read just after it, times each kernel beside its bound, its plain
version and a one-call PyTorch equivalent (``rfut_rowwise`` also over
NB = 128 ... 1024 at 2^25 elements), and ends with one JSON line.  The
paths:

- sketch-and-solve least squares at 2^20 x 512 with FJLT and CWT, at
  32768 x 1024 with FJLT, and the FJLT rowwise apply at 131072 x 4096;
- the sparse hash sketch at the JAX package's own benchmark shape: CWT
  and SJLT of a 10^6 x 10^5 sparse COO matrix with 10^7 nonzeros to
  1024 rows, dense and sparse output;
- the in-core adjacency sketch and Nyström eigensolve of a planted-
  partition graph at the scale of SNAP com-LiveJournal (3,997,962
  vertices, 34,681,189 edges), generated from the seed;
- the random-feature kernel machine's predict path: the flagship forward
  step (``libskylark_tpu_torch.flagship``), a 10-class
  ``FeatureMapModel`` per feature map on 131072 x 4096 f32 (the JAX
  package's RFT benchmark shape), the kernel approximation of five maps
  on 1024 rows, and a Gaussian ``KernelModel`` on 8192 training rows and
  32768 test rows;
- randomized NLA in f32 at full width (``nla_path``): Blendenpik at
  2^20 x 512 (FJLT, ``gather_scaled_rows``) and at 32768 x 1024
  (``rfut_rowwise_sampled``), Blendenpik in f64 at cond 1e6, LSRN on a
  rank-deficient 2^20 x 512, the guarded FJLT and CWT sketch-and-solve
  against the same calls under ``SKYLARK_GUARD=0``, the randomized SVD of
  a 2^21 x 1024 rank-100 synthetic matrix (the JAX package's headline SVD
  width), the sparse randomized SVD of the 10^6 x 10^5 COO at k = 6,
  ``cond_est``, and the guard's certificate and a preconditioned LSQR
  solve with their steps replayed as CUDA graphs against eager steps
  (bitwise the same).  Each f32 solve is held against gels in f64 at
  bounds that a control (a sketch-and-solve x, a solve stopped after a
  few steps, a least-squares x of larger norm) is shown to miss;
- the kernel machine's training path (``train_path``): BlockADMM at the
  JAX package's TPU configuration (262144 x 128, two Gaussian maps of
  2048, hinge + l2, P = 4) with regular and Fastfood maps, its seconds
  per iteration graphed and eager (bitwise equal); KRR/RLSC on 131072 x
  4096 with 10 planted classes (Fastfood features, sketched by FJLT and
  CWT, large-scale BCD at s = 8192); exact and faster KRR and the
  nonlinear estimators on 32768 rows.  Each model is held against an f64
  solve of the same problem or the exact solve, and its training
  accuracy against a model of random weights, beside a control that
  misses the bound; ADMM and approximate KRR also against the CPU route
  on a row subset;
- out-of-core streaming (``stream_path``): the fused stream chunk
  (``scatter_rows`` with its ``acc`` fold) against the unfused one at
  8 x 65536 x 2048 -> 1024 (CWT, MMT); the overlapped streamed sketch of
  8 pinned host batches against the serial one and the resident apply,
  and the FJLT rowwise form; streaming sketch-and-solve least squares of
  a 2^22 x 512 A (8 GiB) in 32 pinned batches, killed after batch 17
  and resumed; the north-star streaming KRR at 10^7 x 4096 -> 2048 bf16
  with its check at n = 2^20; the streaming randomized SVD of a rank-100
  2^21 x 1024 matrix in bf16 panels; the graph of the third path
  streamed in edge blocks of 2^22.  Each bitwise pin (fused, overlap,
  resume, streamed graph) and each bound beside a control that misses;
- the remaining sketches and the graph analytics (``sketches_path``):
  FJLT with the DCT on the 2^20 x 512 LS problem (``gather_scaled_rows``
  its epilogue, no WHT kernel) held against scipy's DCT, QJLT least
  squares on the same A with its Omega held against exact digits, the
  kernel machine on the "quasi" (QMC) feature maps at 131072 x 4096 ->
  2048, approximate ASE of the third path's graph held by its
  eigen-residuals, and local clustering around a planted cluster in a
  graph of 10^6 vertices and 10^7 edges;
- mixed-precision refinement (``refine_path``): ``refine_least_squares``
  on bench.py's refine problem (f64 32768 x 768) against the f64 QR
  solve, the refine route with FJLT and CWT on the 2^20 x 512 LS problem
  (its sketch of a bf16 copy of A: the bf16 gather and row scatter)
  beside the sketch and exact routes, the bf16 sampled kernel at 32768 x
  512, the guard's faults on the sketch and refine routes, and
  checkpointed faster KRR killed and resumed, bitwise.  Each refined x is
  held against an f64 solve at 1e-9 beside a control that misses.

It exits non-zero, printing no result, without a CUDA device or without
the package beside it.  It imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
MEM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
F32_OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
LS_RATIO_BOUND = 1.5           # sketched residual / lstsq residual
SPIN_CYCLES = 4_000_000        # ~2 ms of GPU clock: covers a call's host overhead
GATHER_RUN = 32                # back-to-back gather launches per timed run, each its own indices
L2_FLUSH_BYTES = 256 << 20     # read before a cold run: five times the H100's 50 MB L2
LS_REPEATS = 3                 # timed solves per LS configuration (median kept)
HOT_DRAWS = 3                  # draws of scatter_rows' hot-bucket check
SEED = 20261016
# rfut_rowwise at NB = 128, 256 (the warp-per-row kernel): phase 2's row
# counts, and the sweep of phase 4 at 2^25 f32 elements of x per width.
RFUT_NARROW_M = (1, 31, 262_143)
RFUT_SWEEP_NB, RFUT_SWEEP_ELEMS = (128, 256, 512, 1024), 1 << 25
# Sparse hash sketch (the JAX package's bench.py bench_sparse_cwt shape).
SP_ROWS, SP_COLS, SP_NNZ, SP_S = 1_000_000, 100_000, 10_000_000, 1024
# Planted-partition graph at the scale of SNAP com-LiveJournal.
LJ_VERTICES, LJ_EDGES, LJ_BLOCKS, LJ_INTRA = 3_997_962, 34_681_189, 16, 0.8
ASE_K = 16                     # embedding rank; sketch size 2k as streaming_ase sizes it
# Random-feature predict at the JAX package's RFT benchmark shape (bench.py).
ML_ROWS, ML_DIM, ML_S, ML_CLASSES = 131072, 4096, 2048, 10
ML_CHECK_ROWS = 4096           # rows held against the CPU route (maps are row-independent)
ML_REPEATS = 3                 # timed predicts per model (median kept)
KA_ROWS = 1024                 # rows of the kernel-approximation check
KM_TRAIN, KM_TEST, KM_CHECK = 8192, 32768, 1024   # KernelModel rows
# Randomized NLA (phase 3e).  The f32 problems keep cond(A) low enough that
# Blendenpik's 1-norm condest of R stays under f32's retry threshold
# 0.1/sqrt(eps) ~ 290: at n = 1024, s = 4096 a CPU rehearsal read ~370
# for cond 32 (a retry) and ~240 for cond 10, so (b) uses cond 10.
NLA_M, NLA_N = 1 << 20, 512
NLA_SMALL_M, NLA_SMALL_N = 32768, 1024
NLA_RATIO_BOUND = 1.001        # residual / gels residual
# The f32 problems' b = A·x_true + NLA_NOISE·g: x is held against gels in
# f64 at NLA_X_TOL, a bound that controls fail.  A CPU rehearsal at
# 2^16 x 512 read 9e-7 for Blendenpik, 2.9e-2 (residual ratio 1.15) for
# sketch-and-solve and 0.14 for Blendenpik stopped after 5 LSQR steps;
# 4.9e-7 for LSRN, 7.7e-2 for LSRN stopped after 3 steps and 0.41
# (residual ratio 1.0) for a least-squares solution that is not the
# least-norm one.
NLA_NOISE = 0.1
NLA_X_TOL = 1e-4
NLA_F64_TOL = 1e-6             # ||x - x_gels|| / ||x_gels|| at cond 1e6, f64
SVD_M, SVD_N, SVD_R, SVD_NOISE = 1 << 21, 1024, 100, 0.01   # bench.py:768-800, m cut
SVD_K, SVD_PANEL, SVD_CHECK_M = 100, 1 << 17, 1 << 14
SP_SVD_K = 6                   # skylark_svd's default rank (cli/svd.py)
# Training path (phase 3f).  BlockADMM at the JAX package's TPU
# configuration (bench.py bench_admm: 262144 x 128, two Gaussian maps of
# 2048 at sigma 2, hinge + l2, P = 4), its seconds per iteration measured
# as bench.py measures them, (t_N - t_1)/(N - 1) with N = 201, min of 2.
ADMM_M, ADMM_D, ADMM_S, ADMM_P, ADMM_SIGMA, ADMM_ITERS = 262_144, 128, 2048, 4, 2.0, 201
ADMM_CHECK_M, ADMM_CHECK_ITERS = 8192, 5   # rows and iterations held against the CPU route
# KRR/RLSC on the predict phase's X (ML_ROWS x ML_DIM, ML_CLASSES classes
# planted by a Fastfood teacher): approximate (Fastfood, s = ML_S),
# sketched to t = 4s with FJLT and CWT, large-scale at s = 8192 in chunks
# of max_split = 2048 (lam = 16, where the block coordinate descent stops
# at its default tolerance within a few sweeps); exact, faster and the
# nonlinear estimators on the first EXACT_N rows (an n x n Gram of 4 GiB
# f32).
KRR_LAM = 1.0
KRR_LS_S, KRR_LS_SPLIT, KRR_LS_LAM, KRR_LS_ITERS = 8192, 2048, 16.0, 300
KRR_CHECK_ROWS = 4096
EXACT_N, EXACT_LAM = 32768, 0.1
FASTER_TOL = 1e-5                  # CG's relative residual
PCR_RANK, PCR_S, PCR_T = 512, 1024, 8192
# Bounds of the training checks; each printed beside a control that misses it.
TRAIN_W_TOL = 1e-3                 # ||W - W_f64|| / ||W_f64||, same features, f64 solve
TRAIN_CPU_TOL = 1e-4               # card vs the CPU route on a row subset
# Training accuracy on balanced planted classes; a model of random
# weights reads ~1/classes, within ~0.002 over 32768 rows.
ADMM_ACC_MIN, KRR_ACC_MIN, NL_ACC_MIN = 0.9, 0.3, 0.15
# Kernel widths for 4096-dim standard normal rows, set so that k(x, y)
# of two rows is about exp(-1): E||x - y||^2 = 2d, E||x - y||_1 =
# 2d/sqrt(pi), E sum sqrt(|x_i| + |y_i|) = 1.2146 d.
ML_SIGMA = math.sqrt(ML_DIM)
ML_LAPLACE_SIGMA = 2 * ML_DIM / math.sqrt(math.pi)
ML_MATERN_L = math.sqrt(3.0) * math.sqrt(2 * ML_DIM)
ML_BETA = 1.0 / (1.2146 * ML_DIM)
# Streaming (phase 3g).  (a) bench.py:440-484's fused stream chunk and (b)
# bench.py:487-555's overlapped pass: 8 chunks of 65536 x 2048 f32 -> 1024.
ST_CHUNK, ST_N, ST_S, ST_CHUNKS = 65_536, 2048, 1024, 8
ST_REPEATS = 5                     # timed passes (min kept, as bench.py keeps it)
# (c) streaming sketch-and-solve: A 2^22 x 512 f32 (8 GiB) plus b in 32
# pinned host batches, the default sketch (JLT, s = 4n); killed after
# batch 17 (chunk 8 of two batches) and resumed.
LSQ_M, LSQ_N, LSQ_BATCH, LSQ_EVERY, LSQ_KILL_CHUNK = 1 << 22, 512, 131_072, 2, 8
LSQ_NOISE = 1.0
# (d) the north star, bench.py:719-766: 10^7 x 4096 -> 2048 Gaussian
# features (sigma 8), bf16, hot panels of 125000 rows, lam 0.1, 3 sweeps.
NS_N, NS_D, NS_S, NS_BR, NS_SIGMA, NS_LAM, NS_SWEEPS = (
    10_000_000, 4096, 2048, 125_000, 8.0, 0.1, 3)
# Its correctness check: n = 2^20 on the same block_fn, at a lam where W
# depends on it (at lam 0.1 the Gram's eigenvalues, ~n/s = 512, make a 2 lam
# control move W by ~2e-4 only); W against the same sweeps in core (bf16
# state: NS_INCORE_TOL) and against an f64 solve of the same bf16 features
# (NS_W_TOL: the residual update takes delta rounded to bf16, as the JAX
# package's does, so W keeps ~2^-9 of sweep 0's update, 2.8e-3 on the card;
# tests/test_torch_streaming.py::test_streaming_kernel_ridge_bf16_matches_jax
# holds the bf16 path against the JAX package's on the CPU).
NS_CHECK_N, NS_CHECK_LAM, NS_INCORE_TOL, NS_W_TOL = 1 << 20, 50.0, 2e-2, 1e-2
# (e) the streaming randomized SVD: bench.py:768-800's matrix (rank 100,
# 1024 columns, noise 0.01, bf16 panels), m cut from 10^7 to 2^21 as in
# phase 3e (the counter stream makes a 10^7 pass ~14 s; PERF.md).
SSVD_M, SSVD_N, SSVD_R, SSVD_BR, SSVD_NOISE, SSVD_TOL = 1 << 21, 1024, 100, 262_144, 0.01, 1e-2
SSVD_CTL_R = 50                    # the control: a rank-50 matrix's sigma
# (f) the streamed graph: phase 3c's planted graph in edge blocks of 2^22.
GRAPH_BATCH = 1 << 22
# The remaining sketches and the graph analytics (phase 3h).  (a) FJLT with
# the DCT on the LS phase's problem (SK_M x SK_N f32 to SK_S rows): sketch
# columns held against scipy's DCT in f64, and the DCT at N = NB = 2^15,
# where the WHT takes the fused kernels.
SK_M, SK_N, SK_S = 1 << 20, 512, 2048
DCT_CHECK_COLS, DCT_TOL, DCT_KERNEL_N = 8, 1e-5, 1 << 15
# (b) QJLT: Omega entries held against exact digits, and panels of a
# 2^16-column QJLT against its whole realization.
QJLT_CHECK_ENTRIES, QJLT_PANEL_N = 4096, 1 << 16
# (c) kernel approximation of the QMC maps on KA_ROWS rows: (map, S,
# bound) at the JAX tests' bounds (tests/test_feature_maps.py:285-310, 456;
# the Laplacian at phase 3d's LaplacianRFT bound).
QMC_KA = (("GaussianQRFT", 4096, 0.05), ("LaplacianQRFT", 8192, 0.08),
          ("ExpSemigroupQRLT", 4096, 0.1))
# (d) ASE of phase 3c's graph.  Without power iterations its randomized
# eigenvectors are noise: the 15 planted eigenvalues near 15 sit above a
# bulk edge of 2 sqrt(17.35) ~ 8.3, a ratio of 1.8; a CPU rehearsal at
# 250,000 vertices of the same degree read max ||A v - lam v|| / |lam| of
# 61 at q = 0, 0.24 at q = 4 and 0.012 at q = 6.
ASE_ITERS, ASE_RES_BOUND = 8, 0.05
# Local clustering (the JAX locality test, tests/test_graph.py:127-160,
# scaled up): a planted cluster of LC_NC vertices with LC_IN internal and
# LC_OUT external edges per vertex, in a background of LC_EDGES random
# edges on the other vertices, searched from one seed at the test's
# epsilon, recursively (one diffusion from one seed stops at a prefix 2-20 %
# above the planted conductance on such draws: the sweep keeps a few
# background vertices; the recursion restarts from the found set).
LC_N, LC_EDGES, LC_NC, LC_IN, LC_OUT, LC_EPS, LC_COND_TOL = (
    1_000_000, 10_000_000, 1000, 30, 2, 1e-4, 0.1)
# Mixed-precision refinement (phase 3i).  (a) bench.py:1521-1530's refine
# problem at its chip size: f64 A RF_A_M x RF_A_N, b = A x + 1e-3 g, against
# the f64 QR solve (residual ratio within 1 + RF_RATIO_TOL, x within
# RF_X_TOL); (b) the LS phase's problem (NLA_M x NLA_N f32, b = A x + 0.1 g)
# on the refine route with FJLT and CWT (x within RF_X_TOL of an f64 solve
# of the same f32 A) beside the sketch and exact routes; (c) f32 A RF_C_M x
# RF_C_N, where the bf16 sketch takes the sampled kernel at NB = 2^15; (d)
# the guard's faults at (b)'s shape; (e) checkpointed faster KRR at phase
# 3f's shape, preempted after chunk 1 and resumed.
RF_A_M, RF_A_N, RF_A_NOISE = 32_768, 768, 1e-3
RF_C_M, RF_C_N = 32_768, 512
RF_X_TOL, RF_RATIO_TOL = 1e-9, 1e-10


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(ok: bool, msg: str) -> None:
    if not ok:
        fail(msg)


def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median device time of ``fn`` over ``reps`` runs, CUDA events.  A
    spin kernel queued before each start event keeps the card busy while
    the host enqueues ``fn``, so a short kernel is timed without the
    wrapper's host-side overhead."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def time_launches(calls, reps: int = 5, flush: torch.Tensor | None = None,
                  warm: torch.Tensor | None = None) -> float:
    """Device time per launch of ``calls`` run back to back between one
    pair of CUDA events, median over ``reps`` runs.  A spin kernel queued
    before the start event covers the host's enqueue of the whole run.
    With ``flush`` (a CUDA tensor larger than the L2) it is read before
    each run, so that the L2 holds none of the run's inputs; then
    ``warm``, if given, is read, so that the L2 holds it."""
    for fn in calls[:2]:
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.sum()
        if warm is not None:
            warm.sum()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES * (1 + len(calls) // 16))
        start.record()
        for fn in calls:
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / len(calls))
    return statistics.median(times)


def bound(bytes_moved: float, ops: float) -> tuple[float, str]:
    t_bytes = bytes_moved / MEM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(out: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    """(max absolute error, that error over max |ref|)."""
    out, ref = out.float(), ref.float()
    abs_err = float((out - ref).abs().max())
    return abs_err, abs_err / max(float(ref.abs().max()), 1e-30)


def scatter_error_bound(A, b, v, segs: int, piece: int):
    """The exact sums of ``scatter_rows(A, b, v, segs)`` (f64) and a bound
    on its f32 rounding error per output element, for its order of
    operations: each term fl(v·a) rounded, the terms of a bucket added in
    entry order e = i·nnz + h within pieces of at most ``piece`` entries,
    then the pieces in order.  Recursive summation errs by at most u times
    the sum of its partial sums' magnitudes from the second on (Higham,
    Accuracy and Stability of Numerical Algorithms, (4.3)); the partial
    sums are taken exact (f64) and the factor 1.01 covers the second-order
    terms (u·piece < 1e-3).  Also returns the control: the largest
    bucket's first piece left out of its sum, as (row, its sum)."""
    m = A.shape[1]
    x = (v.T.double()[:, :, None] * A.double()[:, None, :]).reshape(-1, m)
    key = b.T.reshape(-1).long()
    keep = (key >= 0) & (key < segs)
    order = torch.sort(key[keep], stable=True)
    key, x = order.values, x[keep][order.indices]
    del order
    counts = torch.bincount(key, minlength=segs)
    pos = torch.arange(key.shape[0], device=x.device) - (torch.cumsum(counts, 0) - counts)[key]

    def partial_sums(vals, head):
        """Running sums of ``vals`` restarting at each row where ``head``."""
        heads = head.nonzero()[:, 0]
        run = vals.cumsum(0)
        base = torch.zeros_like(run[:heads.shape[0]])
        base[1:] = run[heads[1:] - 1]
        return run - base[torch.cumsum(head, 0) - 1], heads

    bound = torch.zeros(segs, m, dtype=torch.float64, device=x.device)
    bound.index_add_(0, key, x.abs())
    T, heads = partial_sums(x, pos % piece == 0)      # within each piece
    exact = torch.zeros_like(bound).index_add_(0, key, x)
    del x
    bucket = key[heads]
    absT = torch.zeros(heads.shape[0], m, dtype=torch.float64, device=T.device)
    bound.index_add_(0, bucket, absT.index_add_(
        0, torch.cumsum(pos % piece == 0, 0) - 1, T.abs()) - T[heads].abs())
    P = T[torch.cat([heads[1:] - 1, heads.new_tensor([key.shape[0] - 1])])]  # piece sums
    del T, absT
    F, fheads = partial_sums(P, pos[heads] == 0)      # the fold, bucket by bucket
    bound.index_add_(0, bucket, F.abs()).index_add_(0, bucket[fheads], -F[fheads].abs())
    row = int(counts.argmax())
    first = int(((bucket == row) & (pos[heads] == 0)).nonzero()[0, 0])
    return exact, bound * (2.0 ** -24 * 1.01), (row, P[first])


def bound_ratio(out, exact, bound) -> float:
    """max |out - exact| / bound over the elements (inf where the bound is
    0 and the error is not)."""
    err = (out.double() - exact).abs()
    return float(torch.where(bound > 0, err / bound.clamp(min=1e-300),
                             torch.where(err > 0, math.inf, 0.0)).max())


def signature(name, args) -> tuple:
    """A kernel launch's signature: its name, each tensor argument's shape
    and dtype, and the other arguments."""
    return (name,) + tuple((tuple(a.shape), a.dtype) if torch.is_tensor(a) else a for a in args)


class Held:
    """Stands in for a kernel's wrapper in its module while a path runs,
    so that the first launch of each signature (kernel, input shapes and
    dtypes, the other arguments) is held against the plain version on
    the same inputs by ``compare(out, *args, **kwargs)``; signatures go
    into ``held``.  The launch counts (the wrapper adds to them by its
    module name) stay the wrapper's own, and the plain runs launch no
    kernel."""

    def __init__(self, kernel, name, compare, held: set):
        self.kernel, self.name, self.compare, self.held = kernel, name, compare, held

    def __getattr__(self, attr):  # the wrapper's other counters, e.g. launches_by_nb
        return getattr(self.kernel, attr)

    @property
    def launches(self):
        return self.kernel.launches

    @launches.setter
    def launches(self, count):
        self.kernel.launches = count

    def __call__(self, *args, **kwargs):
        out = self.kernel(*args, **kwargs)
        sig = signature(self.name, args)
        if sig not in self.held:
            self.held.add(sig)
            self.compare(out, *args, **kwargs)
        return out


def hold(mod, name, compare, held: set):
    """Put a :class:`Held` in place of ``mod.name``; returns the wrapper."""
    kernel = getattr(mod, name)
    setattr(mod, name, Held(kernel, name, compare, held))
    return kernel


def rfut_narrow_check(kf, dev) -> None:
    """Phase 2's check of ``rfut_rowwise`` at NB = 128 and 256 (the warp-
    per-row kernel): f32 and bf16, m in ``RFUT_NARROW_M``, n = NB and
    NB - 3, x contiguous at a 16-byte aligned address and x a view one
    element past it (the bulk-copy and the guarded load paths, as
    ``kf.bulk_copies`` decides).  Each case is held against the plain
    version beside a control that misses (the plain version with d's
    sign flipped at the column of x's largest entry); rows a:b bitwise
    the kernel on rows a:b alone (a and b odd, so not multiples of the
    rows per ring stage), an aligned copy of a misaligned x bitwise the
    view (the two load paths), and two runs bitwise equal."""
    g = torch.Generator(device=dev).manual_seed(SEED + 13)
    cases = 0
    for nb in (128, 256):
        for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
            for n in (nb, nb - 3):
                buf = torch.randn(max(RFUT_NARROW_M) * n + 1, generator=g, device=dev).to(dtype)
                d = torch.where(torch.randn(n, generator=g, device=dev) > 0, 1.0, -1.0).to(dtype)
                rel, ctl = 0.0, math.inf
                for m in RFUT_NARROW_M:
                    for offset in (0, 1):
                        x = buf[offset:offset + m * n].view(m, n)
                        label = (f"rfut_rowwise NB = {nb} {dtype} x ({m}, {n}) "
                                 f"{'aligned' if offset == 0 else 'one element off'}")
                        bulk = offset == 0 and n * x.element_size() % 16 == 0
                        check(kf.bulk_copies(x) == bulk, f"{label}: bulk_copies is not {bulk}")
                        out = kf.rfut_rowwise(x, d, nb)
                        _, r = max_err(out, kf.rfut_rowwise_plain(x, d, nb))
                        d_ctl = d.clone()
                        col = int(x.float().abs().amax(0).argmax())
                        d_ctl[col] = -d_ctl[col]
                        _, c = max_err(out, kf.rfut_rowwise_plain(x, d_ctl, nb))
                        check(r <= tol and c > tol, f"{label}: rel {r}, control {c} (tol {tol})")
                        check(torch.equal(out, kf.rfut_rowwise(x, d, nb)),
                              f"{label}: two runs are not bitwise equal")
                        if offset:
                            check(torch.equal(out, kf.rfut_rowwise(x.clone(), d, nb)),
                                  f"{label}: an aligned copy is not bitwise the view")
                        if m > 1:
                            a, b = 3, m - 2
                            check(torch.equal(out[a:b], kf.rfut_rowwise(x[a:b].contiguous(), d, nb)),
                                  f"{label}: rows {a}:{b} are not bitwise the kernel on them alone")
                        rel, ctl, cases = max(rel, r), min(ctl, c), cases + 1
                print(f"rfut_rowwise NB = {nb} {dtype} n = {n}, m in {RFUT_NARROW_M}, aligned and "
                      f"one element off: worst rel {rel:.3g} (tol {tol:g}), weakest control "
                      f"{ctl:.3g}; rows independent, load paths and runs bitwise")
                del buf
    print(f"rfut_rowwise NB = 128, 256: {cases} cases held")


def rfut_sweep(kf, dev) -> dict:
    """``rfut_rowwise`` on 2^25 f32 elements of x at each NB of
    ``RFUT_SWEEP_NB``: held against its plain version (rel 1e-5), timed
    against its bytes bound.  Returns per NB the max abs error, ms,
    plain ms, bytes and operations."""
    g = torch.Generator(device=dev).manual_seed(SEED + 9)
    res = {}
    for nb in RFUT_SWEEP_NB:
        m = RFUT_SWEEP_ELEMS // nb
        x = torch.randn(m, nb, generator=g, device=dev)
        d = torch.where(torch.randn(nb, generator=g, device=dev) > 0, 1.0, -1.0)
        err, r = max_err(kf.rfut_rowwise(x, d, nb), kf.rfut_rowwise_plain(x, d, nb))
        check(r <= 1e-5, f"rfut_rowwise at NB = {nb} disagrees with its plain version: {r}")
        ms = time_ms(lambda: kf.rfut_rowwise(x, d, nb))
        nbytes, ops = 4 * (2 * m * nb + nb), m * (nb * math.log2(nb) + nb)
        b_ms, _ = bound(nbytes, ops)
        res[nb] = {"err": err, "ms": ms, "bytes": nbytes, "ops": ops,
                   "plain_ms": time_ms(lambda: kf.rfut_rowwise_plain(x, d, nb), reps=3, warmup=1)}
        print(f"rfut_rowwise sweep, x {m} x {nb} f32, NB = {nb}: {ms!r} ms, {b_ms / ms:.3f} of "
              f"its bytes bound {b_ms:.4f} ms; rel {r:.3g} (tol 1e-5)")
        del x
    return res


def host_median(fn, reps: int = ML_REPEATS) -> tuple[float, list[float]]:
    """Median host-clock seconds of ``fn`` ending in a synchronize."""
    runs = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t0)
    return statistics.median(runs), runs


def ml_path(sky, dev, reset_counts, read_counts) -> None:
    """The random-feature kernel machine's predict path on the card, each
    output held against the port's CPU route."""
    from libskylark_tpu_torch.sketch import kernels_fut as kf

    ml = sky.ml
    reset_counts()
    t_path = time.perf_counter()

    # (a) The flagship forward step (__graft_entry__.entry's twin).
    fwd, args = sky.flagship.entry(device=dev)
    fwd_cpu, args_cpu = sky.flagship.entry(device="cpu")
    out = fwd(*args)
    torch.cuda.synchronize()
    _, r = max_err(out.cpu(), fwd_cpu(*args_cpu))
    check(tuple(out.shape) == (256, 10) and bool(torch.isfinite(out).all()),
          "flagship: output not finite of shape (256, 10)")
    check(r <= 1e-5, f"flagship disagrees with the CPU route: rel {r}")
    print(f"flagship GaussianRFT(128 -> 512) on (256, 128), Z @ W (512, 10): vs CPU route rel "
          f"{r:.3g} (tol 1e-5); {time_ms(lambda: fwd(*args), reps=20)!r} ms per step "
          f"(CUDA events, median of 20)")

    # (b) Full-width predict, one 10-class model per feature map.
    g = torch.Generator(device=dev).manual_seed(SEED)
    X = torch.randn(ML_ROWS, ML_DIM, generator=g, device=dev)
    X_abs = X.abs()
    rows_cpu, abs_cpu = X[:ML_CHECK_ROWS].cpu(), X_abs[:ML_CHECK_ROWS].cpu()
    d, s = ML_DIM, ML_S

    def ctx(i):
        return sky.SketchContext(seed=SEED + i)

    models = [
        ("GaussianRFT", [ml.GaussianKernel(d, ML_SIGMA).create_rft(s, "regular", ctx(1))], X),
        ("LaplacianRFT",
         [ml.LaplacianKernel(d, ML_LAPLACE_SIGMA).create_rft(s, "regular", ctx(2))], X),
        ("MaternRFT nu=1.5",
         [ml.MaternKernel(d, 1.5, ML_MATERN_L).create_rft(s, "regular", ctx(3))], X),
        ("FastGaussianRFT", [ml.GaussianKernel(d, ML_SIGMA).create_rft(s, "fast", ctx(4))], X),
        ("ExpSemigroupRLT on |X|",
         [ml.ExpSemigroupKernel(d, ML_BETA).create_rft(s, "regular", ctx(5))], X_abs),
        ("PPT q=3, S=1024",
         [ml.PolynomialKernel(d, 3, 1.0, 1.0 / d).create_rft(1024, "regular", ctx(6))], X),
        ("GaussianRFT + FJLT",
         [ml.GaussianKernel(d, ML_SIGMA).create_rft(s, "regular", ctx(7)),
          ml.LinearKernel(d).create_rft(s, "fast", ctx(8))], X),
    ]
    gemm_bound_s = 2.0 * ML_ROWS * d * s / F32_OPS_PER_S
    print(f"predict: X ({ML_ROWS}, {d}) f32 on the card; W.X GEMM bound of an RFT apply at "
          f"S = {s}: {gemm_bound_s!r} s (2 m d S flop at 67 TFLOP/s f32)")
    for name, maps, Xm in models:
        width = sum(S.getsketchdim() for S in maps)
        W = torch.randn(width, ML_CLASSES, generator=g, device=dev) * 0.01
        model = ml.FeatureMapModel(maps, W, classes=list(range(ML_CLASSES)), device=dev)
        before = {"rfut_rowwise": kf.rfut_rowwise.launches,
                  "rfut_rowwise_sampled": kf.rfut_rowwise_sampled.launches}
        torch.cuda.reset_peak_memory_stats()
        t_first, _ = host_median(lambda: model.predict(Xm), reps=1)
        O = model.predict(Xm)
        secs, runs = host_median(lambda: model.predict(Xm))
        peak = torch.cuda.max_memory_allocated() / 2**30
        check(tuple(O.shape) == (ML_ROWS, ML_CLASSES) and bool(torch.isfinite(O).all()),
              f"predict {name}: output not finite of shape ({ML_ROWS}, {ML_CLASSES})")
        # The CPU route on the first rows, from the model's JSON.
        cpu_model = ml.FeatureMapModel.from_dict(model.to_dict(), W.cpu(), device="cpu")
        Xc = abs_cpu if Xm is X_abs else rows_cpu
        head = O[:ML_CHECK_ROWS].cpu()
        if name == "LaplacianRFT":
            # Cauchy W: held on W.X per row, then the epilogue and Z @ W of
            # the card's W.X on the CPU (tests/test_torch_rft.py).
            S_card, S_cpu = maps[0], cpu_model.maps[0]
            WX = S_card._underlying.apply(Xm[:ML_CHECK_ROWS], "rowwise").cpu()
            WX_ref = S_cpu._underlying.apply(Xc, "rowwise")
            r_wx = float(((WX - WX_ref).abs().amax(1) / WX_ref.abs().amax(1)).max())
            check(r_wx <= 1e-5, f"predict {name}: W.X rows rel {r_wx} vs the CPU route")
            ref = S_cpu._epilogue(WX, sky.sketch.ROWWISE) @ W.cpu()
            what = f"W.X rows vs CPU route rel {r_wx:.3g} (tol 1e-5); outputs vs CPU epilogue"
        else:
            ref = cpu_model.predict(Xc)
            what = "outputs vs CPU route"
        _, r = max_err(head, ref)
        check(r <= 1e-5, f"predict {name}: rows 0-{ML_CHECK_ROWS - 1} rel {r} vs the CPU route")
        labels = model.predict_labels(Xm[:ML_CHECK_ROWS]).cpu()
        agree = float((labels == ref.argmax(1)).double().mean())
        launched = {k: getattr(kf, k).launches - v for k, v in before.items()}
        print(f"predict {name} ({width} features): median {secs!r} s of "
              f"{[round(x, 5) for x in runs]}, {ML_ROWS / secs:.4g} rows/s; first call "
              f"{t_first!r} s; peak {peak:.2f} GiB; rows 0-{ML_CHECK_ROWS - 1}: {what} rel "
              f"{r:.3g} (tol 1e-5), labels agree {agree:.4f}; rfut launches {launched}")
        if "FJLT" in name:
            check(launched["rfut_rowwise_sampled"] > 0,
                  "rfut_rowwise_sampled was not launched on the FJLT model's predict")
        if name == "FastGaussianRFT":
            check(launched["rfut_rowwise"] > 0,
                  "rfut_rowwise was not launched on the Fastfood model's predict")
        del model, O, cpu_model, ref, head, W
        torch.cuda.empty_cache()
    del rows_cpu, abs_cpu

    # (c) Kernel approximation on 1024 rows, at the JAX package's own
    # sizes and bounds (tests/test_feature_maps.py): mean |Z Z^T - K|.
    Xa = X[:KA_ROWS]
    Xp = Xa / math.sqrt(d)  # the polynomial test's x / sqrt(d)
    cases = [
        ("GaussianRFT", ml.GaussianKernel(d, ML_SIGMA), "regular", 4096, Xa, 0.05),
        ("LaplacianRFT", ml.LaplacianKernel(d, ML_LAPLACE_SIGMA), "regular", 8192, Xa, 0.08),
        ("FastGaussianRFT", ml.GaussianKernel(d, ML_SIGMA), "fast", 4096, Xa, 0.06),
        ("ExpSemigroupRLT", ml.ExpSemigroupKernel(d, ML_BETA), "regular", 16384, Xa.abs(), 0.05),
        ("PPT q=2", ml.PolynomialKernel(d, 2, 1.0, 0.5), "regular", 8192, Xp, 0.05),
    ]
    for j, (name, kernel, tag, sa, Xk, bound_) in enumerate(cases):
        Z = kernel.create_rft(sa, tag, ctx(20 + j)).apply(Xk, "rowwise").double()
        K = kernel.gram(Xk.double())
        err = float((Z @ Z.T - K).abs().mean())
        off = float(K[~torch.eye(KA_ROWS, dtype=torch.bool, device=dev)].mean())
        print(f"kernel approximation {name} S={sa} on ({KA_ROWS}, {d}): mean |ZZ^T - K| "
              f"{err:.4g} (bound {bound_}), mean off-diagonal K {off:.4g}")
        check(err <= bound_, f"kernel approximation {name}: {err} above {bound_}")
        del Z, K
    del Xa, Xp, X_abs

    # (d) KernelModel.predict: Gaussian kernel, 8192 training rows.
    Xtr, Xte = X[:KM_TRAIN], X[KM_TRAIN:KM_TRAIN + KM_TEST]
    A = torch.randn(KM_TRAIN, ML_CLASSES, generator=g, device=dev) * 0.01
    km = ml.KernelModel(ml.GaussianKernel(d, ML_SIGMA), Xtr, A, device=dev)
    O = km.predict(Xte)
    secs, runs = host_median(lambda: km.predict(Xte))
    check(tuple(O.shape) == (KM_TEST, ML_CLASSES) and bool(torch.isfinite(O).all()),
          "KernelModel predict: output not finite")
    km_cpu = ml.KernelModel.from_arrays(km.to_dict(), Xtr.cpu().numpy(), A.cpu().numpy(),
                                        device="cpu")
    _, r = max_err(O[:KM_CHECK].cpu(), km_cpu.predict(Xte[:KM_CHECK].cpu()))
    print(f"KernelModel gaussian: {KM_TRAIN} x {d} training rows, {KM_TEST} test rows (Gram "
          f"{KM_TEST * KM_TRAIN * 4 / 2**30:.2f} GiB): median {secs!r} s of "
          f"{[round(x, 5) for x in runs]}, {KM_TEST / secs:.4g} rows/s; rows 0-{KM_CHECK - 1} "
          f"vs CPU route rel {r:.3g} (tol 1e-5)")
    check(r <= 1e-5, f"KernelModel predict disagrees with the CPU route: rel {r}")
    del Xtr, Xte, A, km, O
    torch.cuda.empty_cache()
    read_counts("random-feature predict", t_path, ("rfut_rowwise", "rfut_rowwise_sampled"))

    # (e) Where a predict's time goes (CUDA events, median of 5), after the
    # path's counts are read: a dense RFT split into W's counter
    # realization, the X W^T GEMM, the in-place epilogue and Z W; Fastfood's
    # features by the RFUT-kernel route against the JAX package's streaming
    # form, and the route's parts for one block.
    S0 = models[0][1][0]
    W = torch.randn(s, ML_CLASSES, generator=g, device=dev)
    Wt = S0._underlying.realize(torch.float32, device=dev)
    WX = X @ Wt.T
    t_real = time_ms(lambda: S0._underlying.realize(torch.float32, device=dev), reps=5)
    t_gemm = time_ms(lambda: X @ Wt.T, reps=5)
    t_epi = time_ms(lambda: S0._epilogue(WX.clone(), sky.sketch.ROWWISE), reps=5)
    t_clone = time_ms(lambda: WX.clone(), reps=5)
    t_out = time_ms(lambda: WX @ W, reps=5)
    print(f"predict GaussianRFT split: realize W {t_real!r} ms, X @ W.T {t_gemm!r} ms (bound "
          f"{gemm_bound_s * 1e3!r} ms), epilogue {t_epi - t_clone!r} ms, Z @ W {t_out!r} ms")
    del Wt, WX
    ff = models[3][1][0]
    t_route = time_ms(lambda: ff._features_rowwise(X), reps=5)
    t_stream = time_ms(lambda: ff._features(X.T), reps=5)
    torch.cuda.reset_peak_memory_stats()
    ff._features(X.T)
    peak_stream = torch.cuda.max_memory_allocated() / 2**30
    nb = ff._nb
    Bd = ff._blocks("rademacher", ff._b_base, torch.float32, dev)[0, :d].contiguous()
    perm = ff._perms(dev)[0]
    T = kf.rfut_rowwise(X, Bd, nb)
    t_rfut = time_ms(lambda: kf.rfut_rowwise(X, Bd, nb), reps=5)
    t_perm = time_ms(lambda: T.index_select(1, perm), reps=5)
    print(f"predict FastGaussianRFT features (pre-cos): RFUT-kernel route {t_route!r} ms "
          f"(one rfut_rowwise {t_rfut!r} ms, the permutation's index_select {t_perm!r} ms); "
          f"JAX streaming form {t_stream!r} ms, peak {peak_stream:.2f} GiB")
    del X, T, W
    torch.cuda.empty_cache()


def nla_path(sky, dev, reset_counts, read_counts, A_sp) -> None:
    """Phase 3e: the randomized NLA layer in f32 at full width (and
    Blendenpik in f64), each item with the launch counters reset before
    it and read after it.  Data is made on the card from the seed."""
    linalg = sky.linalg
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    f64 = torch.float64

    def gaussian(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=g, device=dev, dtype=dtype)

    def gels(A, b):
        return torch.linalg.lstsq(A, b[:, None]).solution[:, 0]

    def timed(label, expect, fn, reps=3):
        """Median of ``reps`` host-clock runs of ``fn``, its counts read."""
        reset_counts()
        t0 = time.perf_counter()
        out = []
        secs, runs = host_median(lambda: out.append(fn()), reps=reps)
        counts = read_counts(label, t0, expect)
        return out[-1], secs, runs, counts

    def ls(route, A, b, **kw):
        return linalg.approximate_least_squares(A, b, sky.SketchContext(seed=SEED), route=route,
                                                return_info=True, **kw)

    def gels64(A, b):
        return gels(A.double(), b.double())

    def rel_err(x, x_ref):
        return float(torch.linalg.vector_norm(x.double() - x_ref) /
                     torch.linalg.vector_norm(x_ref))

    def resid64(A, x, b):
        return float(torch.linalg.vector_norm(A.double() @ x.double() - b.double()))

    def solved(label, info, err, ratio, controls):
        """Checks of one f32 solve: converged inside iter_lim, x within
        NLA_X_TOL of the reference and its residual within
        NLA_RATIO_BOUND, while every control misses one of the two."""
        its, flag = int(info["iterations"]), int(info["flag"])
        print(f"{label}: LSQR iterations {its} (flag {flag}), ||x - x*|| / ||x*|| {err:.3g} "
              f"(bound {NLA_X_TOL}), residual / least residual {ratio:.7f} (bound "
              f"{NLA_RATIO_BOUND}); controls: " + "; ".join(
                  f"{name} {e:.3g}, {r:.7f}" for name, (e, r) in controls.items()))
        check(flag == 0 and its < sky.solvers.KrylovParams().iter_lim, f"{label}: {its} iterations, flag {flag}")
        check(err <= NLA_X_TOL and ratio <= NLA_RATIO_BOUND,
              f"{label}: error {err}, residual ratio {ratio}")
        for name, (e, r) in controls.items():
            check(e > NLA_X_TOL or r > NLA_RATIO_BOUND,
                  f"{label}: the control {name} passes the bounds ({e}, {r})")

    def blendenpik_f32(label, m, n, lo, expect):
        A = gaussian(m, n)
        A *= torch.logspace(0, lo, n, device=dev)
        b = A @ gaussian(n) + NLA_NOISE * gaussian(m)
        (x, info), secs, runs, _ = timed(label, expect, lambda: ls("blendenpik", A, b))
        x_ref = gels64(A, b)
        least = resid64(A, x_ref, b)
        short = sky.solvers.faster_least_squares(A, b, sky.SketchContext(seed=SEED), (
            sky.solvers.FasterLeastSquaresParams(krylov=sky.solvers.KrylovParams(iter_lim=5))))[0]
        p = linalg.LeastSquaresParams(sketch_type="FJLT", sketch_size=4 * n)
        ss = ls(None, A, b, params=p)[0]
        controls = {name: (rel_err(y, x_ref), resid64(A, y, b) / least) for name, y in (
            ("sketch-and-solve", ss), ("Blendenpik at 5 LSQR steps", short))}
        print(f"{label}: cond(A) ~ {10 ** -lo:.3g}, condest(R) {info['condest']:.4g}, attempts "
              f"{info['attempts']}, median {secs!r} s of {[round(r, 4) for r in runs]}")
        check(info["attempts"] == 1 and "fallback" not in info,
              f"{label}: {info['attempts']} attempts, recovery {info['recovery']}")
        solved(label, info, rel_err(x, x_ref), resid64(A, x, b) / least, controls)
        return A

    # (a) Blendenpik f32, 2^20 x 512: FJLT at NB = 2^20, gather_scaled_rows.
    m, n = NLA_M, NLA_N
    A_a = blendenpik_f32("NLA (a) Blendenpik f32 2^20 x 512", m, n, -1.5,
                         ("gather_scaled_rows",))

    # (g) cond_est on (a)'s A, against eigvalsh of A^T A in f64.
    r, secs, runs, _ = timed("NLA (g) cond_est", (), lambda: linalg.cond_est(
        A_a, sky.SketchContext(seed=SEED)), reps=1)
    lam = torch.linalg.eigvalsh(A_a.T.double() @ A_a.double())
    exact = float((lam[-1] / lam[0]).sqrt())
    est = float(r.cond)
    print(f"NLA (g) cond_est on (a)'s A: cond {est:.6g} vs exact {exact:.6g} (ratio "
          f"{est / exact:.4f}, bound 1.1), flag {int(r.flag)}, {secs!r} s")
    check(1 / 1.1 <= est / exact <= 1.1, f"cond_est {est} vs exact {exact}")
    del A_a, lam, r

    # (a2) Blendenpik f64 at cond 1e6 (tests/test_solvers.py's case): the
    # port's kernels take f32/bf16, so no kernel runs here.
    A = gaussian(m, n, dtype=f64)
    A *= torch.logspace(0, -6, n, device=dev, dtype=f64)
    b = A @ gaussian(n, dtype=f64)
    (x, info), secs, runs, counts = timed("NLA (a2) Blendenpik f64 2^20 x 512", (),
                                          lambda: ls("blendenpik", A, b))
    x_ref = gels(A, b)
    err = float(torch.linalg.vector_norm(x - x_ref) / torch.linalg.vector_norm(x_ref))
    print(f"NLA (a2) Blendenpik f64 2^20 x 512, cond(A) 1e6: condest(R) {info['condest']:.4g}, "
          f"attempts {info['attempts']}, LSQR iterations {int(info['iterations'])} (flag "
          f"{int(info['flag'])}), ||x - x_gels|| / ||x_gels|| {err:.3g} (bound {NLA_F64_TOL}), "
          f"median {secs!r} s of {[round(r, 4) for r in runs]}")
    check(err <= NLA_F64_TOL, f"Blendenpik f64: error {err} against gels")
    check(not any(counts.values()), f"Blendenpik f64 launched kernels: {counts}")
    del A, b, x, x_ref

    # (b) Blendenpik f32, 32768 x 1024: FJLT at NB = 32768, the sampled kernel.
    blendenpik_f32("NLA (b) Blendenpik f32 32768 x 1024", NLA_SMALL_M, NLA_SMALL_N, -1.0,
                   ("rfut_rowwise_sampled",))

    # (c) LSRN on a rank-deficient A = [G, G[:, :128]], G 2^20 x 384 (JLT,
    # s = 2048), held against the least-norm solution: from gels on G,
    # whose column space is A's, with the repeated columns' share halved.
    q = n // 4
    G = gaussian(m, 3 * q)
    A = torch.cat([G, G[:, :q]], dim=1)
    b = G @ gaussian(3 * q) + NLA_NOISE * gaussian(m)
    label = "NLA (c) LSRN f32 2^20 x 512"
    (x, info), secs, runs, _ = timed(label, (), lambda: ls("lsrn", A, b))
    x_g = gels64(G, b)
    least = resid64(G, x_g, b)
    x_ref = torch.cat([x_g[:q] / 2, x_g[q:], x_g[:q] / 2])
    short = sky.solvers.lsrn_least_squares(A, b, sky.SketchContext(seed=SEED), (
        sky.solvers.FasterLeastSquaresParams(krylov=sky.solvers.KrylovParams(iter_lim=3))))[0]
    basic = torch.cat([x_g, torch.zeros_like(x_g[:q])])
    controls = {name: (rel_err(y, x_ref), resid64(A, y, b) / least) for name, y in (
        ("LSRN at 3 LSQR steps", short), ("a least-squares x of larger norm", basic))}
    print(f"{label} of rank {3 * q}, JLT s = {4 * n}: median {secs!r} s of "
          f"{[round(r, 4) for r in runs]}")
    check(bool(torch.isfinite(x).all()), f"{label}: non-finite x")
    solved(label, info, rel_err(x, x_ref), resid64(A, x, b) / least, controls)
    del G, A, b, x, x_ref, x_g, short, basic

    # (d) Guarded sketch-and-solve (the LS phase's problem), bitwise the
    # SKYLARK_GUARD=0 result of the same call.
    A = gaussian(m, n)
    b = A @ gaussian(n) + gaussian(m)
    reset_counts()
    t0 = time.perf_counter()
    for stype in ("FJLT", "CWT"):
        p = linalg.LeastSquaresParams(sketch_type=stype, sketch_size=4 * n)
        out = {}

        def run(tag):
            out[tag] = ls(None, A, b, params=p)

        g_secs, g_runs = host_median(lambda: run("guarded"), reps=7)
        os.environ["SKYLARK_GUARD"] = "0"
        try:
            u_secs, u_runs = host_median(lambda: run("unguarded"), reps=7)
        finally:
            del os.environ["SKYLARK_GUARD"]
        (xg, ig), (xu, iu) = out["guarded"], out["unguarded"]
        first = ig["recovery"]["attempts"][0]
        print(f"NLA (d) guarded {stype} sketch-and-solve 2^20 x 512, s = {4 * n}: first verdict "
              f"{first['verdict']} (cert cond {first.get('cond', float('nan')):.4g}), x bitwise "
              f"the SKYLARK_GUARD=0 call: {torch.equal(xg, xu)}; guarded median {g_secs!r} s of "
              f"{[round(r, 4) for r in g_runs]}, unguarded {u_secs!r} s of "
              f"{[round(r, 4) for r in u_runs]}, ratio {g_secs / u_secs:.4f}")
        check(first["verdict"] == "OK" and not ig["recovery"]["recovered"],
              f"guarded {stype}: recovery {ig['recovery']}")
        check(not iu["recovery"]["guarded"], f"SKYLARK_GUARD=0 {stype} ran guarded")
        check(torch.equal(xg, xu), f"guarded {stype} is not bitwise the unguarded result")
    read_counts("NLA (d) guarded sketch-and-solve", t0, ("gather_scaled_rows", "scatter_rows"))
    del A, b, out

    # (e) Randomized SVD at the JAX package's headline SVD width (bench.py
    # SVD rows: 10^7 x 1024, rank 100, noise 0.01), m cut to 2^21 to fit
    # in-core; materialized panel by panel from the counter stream.
    t1 = time.perf_counter()
    block = linalg.synthetic_lowrank_blocks(sky.SketchContext(seed=SEED), SVD_M, SVD_N, SVD_R,
                                            noise=SVD_NOISE, device=dev)
    A = torch.empty(SVD_M, SVD_N, device=dev)
    for r0 in range(0, SVD_M, SVD_PANEL):
        A[r0:r0 + SVD_PANEL] = block(r0, SVD_PANEL)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t1
    params = linalg.SVDParams(num_iterations=1)
    ((U, sv, V), info), secs, runs, _ = timed("NLA (e) randomized SVD", (), lambda: (
        linalg.approximate_svd(A, SVD_K, sky.SketchContext(seed=SEED + 1), params,
                               return_info=True)))
    gram = torch.zeros(SVD_N, SVD_N, dtype=f64, device=dev)
    for r0 in range(0, SVD_M, SVD_PANEL):
        P = A[r0:r0 + SVD_PANEL].double()
        gram += P.T @ P
    exact = torch.linalg.eigvalsh(gram).flip(0)[:SVD_K].clamp(min=0).sqrt()
    rel = float(((sv.double() - exact).abs() / exact).max())
    orth = float((U.T @ U - torch.eye(SVD_K, device=dev)).abs().max())
    first = info["recovery"]["attempts"][0]
    print(f"NLA (e) synthetic rank-{SVD_R} {SVD_M} x {SVD_N} f32 (noise {SVD_NOISE}), made in "
          f"{t_gen:.2f} s: approximate_svd k = {SVD_K}, q = 1, s = {2 * SVD_K}: first and last "
          f"sigma {float(sv[0]):.6g}, {float(sv[-1]):.6g}; vs sqrt(eigvalsh(A^T A)) in f64 max rel "
          f"{rel:.3g} (tol 1e-3); max |U^T U - I| {orth:.3g}; certificate {first['verdict']}; "
          f"median {secs!r} s of {[round(r, 4) for r in runs]}")
    check(rel <= 1e-3, f"randomized SVD: singular values rel {rel}")
    check(first["verdict"] == "OK" and len(info["recovery"]["attempts"]) == 1,
          f"randomized SVD: recovery {info['recovery']}")
    del A, U, sv, V, gram, P
    torch.cuda.empty_cache()
    # The card against the port's CPU route at m = 2^14.
    svs = []
    for d in (dev, "cpu"):
        blk = linalg.synthetic_lowrank_blocks(sky.SketchContext(seed=SEED), SVD_CHECK_M, SVD_N,
                                              SVD_R, noise=SVD_NOISE, device=d)
        svs.append(linalg.approximate_svd(blk(0, SVD_CHECK_M), SVD_K,
                                          sky.SketchContext(seed=SEED + 1), params)[1].cpu())
    rel = float(((svs[0] - svs[1]).abs() / svs[1]).max())
    print(f"NLA (e) at m = {SVD_CHECK_M}: singular values on the card vs the CPU route max rel "
          f"{rel:.3g} (tol 1e-4)")
    check(rel <= 1e-4, f"randomized SVD card vs CPU: rel {rel}")

    # (f) Sparse randomized SVD of phase 3b's COO at skylark_svd's default rank.
    ((U, sv, V), info), secs, runs, _ = timed("NLA (f) sparse randomized SVD", (), lambda: (
        linalg.approximate_svd(A_sp, SP_SVD_K, sky.SketchContext(seed=SEED), return_info=True)))
    res = float(torch.linalg.vector_norm(
        torch.sparse.mm(A_sp, V[:, :1])[:, 0] - sv[0] * U[:, 0]))
    orth = float((U.T @ U - torch.eye(SP_SVD_K, device=dev)).abs().max())
    print(f"NLA (f) sparse approximate_svd {tuple(A_sp.shape)}, {A_sp._nnz()} nonzeros, k = "
          f"{SP_SVD_K}: sigma {[round(float(x), 4) for x in sv]}, ||A v0 - s0 u0|| / s0 "
          f"{res / float(sv[0]):.4f} (certify_svd tol 0.5), max |U^T U - I| {orth:.3g} "
          f"(tol 1e-4), certificate {info['recovery']['attempts'][0]['verdict']}; median "
          f"{secs!r} s of {[round(r, 4) for r in runs]}")
    check(res <= 0.5 * float(sv[0]), f"sparse SVD posterior residual {res}")
    check(orth <= 1e-4, f"sparse SVD: |U^T U - I| {orth}")
    del U, sv, V
    torch.cuda.empty_cache()

    # (h) Where the guard's time goes, and what the CUDA-graph steps and
    # the one-read-per-step chunks of the Krylov loops cost or save: the
    # certificate of one FJLT sketch (cond_est on the 2048 x 512 SA) and
    # a Blendenpik-preconditioned LSQR solve at 2^20 x 512, each with its
    # steps replayed as graphs and run eagerly (bitwise the same), and
    # the solve read every step and every 10 steps.
    A = gaussian(m, n)
    b = A @ gaussian(n) + NLA_NOISE * gaussian(m)
    SA = sky.sketch.create_sketch("FJLT", m, 4 * n, sky.SketchContext(seed=SEED)).apply(
        A, "columnwise")
    P = sky.solvers.TriInversePrecond(torch.linalg.qr(SA, mode="r")[1])
    krylov, chunked = sky.solvers.krylov, sky.resilient.chunked
    certs, cert_ms, sols, sol_ms = {}, {}, {}, {}
    for graphs, every in ((True, 1), (False, 1), (True, 10)):
        chunked.CUDA_GRAPHS, krylov.SYNC_EVERY = graphs, every
        try:
            key = f"{'graphs' if graphs else 'eager'}, a read every {every}"
            if every == 1:
                cert_ms[key] = host_median(lambda: certs.__setitem__(
                    key, sky.guard.certify_sketch(SA)), reps=7)[0] * 1e3
            sol_ms[key] = host_median(lambda: sols.__setitem__(
                key, sky.solvers.lsqr(A, b, P)), reps=5)[0] * 1e3
        finally:
            chunked.CUDA_GRAPHS, krylov.SYNC_EVERY = True, 1
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        cert = sky.guard.certify_sketch(SA)
        torch.cuda.synchronize()
    rows = prof.key_averages()
    dev_ms = sum(getattr(e, "self_device_time_total", 0) for e in rows
                 if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    launches = {k: sum(e.count for e in rows if e.key == k)
                for k in ("cudaLaunchKernel", "cudaGraphLaunch")}
    kp = sky.solvers.KrylovParams(iter_lim=10, tolerance=0.0)
    step_ms = host_median(lambda: sky.solvers.lsqr(A, b, P, kp), reps=3)[0] * 1e3 / 10
    its = int(sols["graphs, a read every 1"][1]["iterations"])
    print(f"NLA (h) guard certificate of the FJLT SA (2048, 512), host clock (median of 7): "
          f"{cert_ms!r} ms; graphed: device kernels {dev_ms!r} ms, launches {launches}, cert "
          f"cond {cert.cond:.4g} (flag {cert.flag}); Blendenpik-preconditioned LSQR at 2^20 x "
          f"512, {its} iterations, host clock (median of 5): {sol_ms!r} ms (a read every 10 "
          f"computes {-(-its // 10) * 10 - its} discarded steps); one step {step_ms!r} ms (two "
          f"matvecs' bytes at 3.35 TB/s: {2 * 4 * m * n / MEM_BYTES_PER_S * 1e3!r} ms)")
    first = next(iter(sols.values()))
    for key, (x, info) in sols.items():
        check(torch.equal(x, first[0]) and int(info["iterations"]) == its,
              f"LSQR ({key}) is not bitwise the graphed solve")
    check(all(c == cert for c in certs.values()), f"certificates differ: {certs}")
    del A, SA, b, P, sols
    torch.cuda.empty_cache()


def train_path(sky, dev, reset_counts, read_counts, smi) -> None:
    """Phase 3f: the kernel machine's training path at full width: the
    BlockADMM trainer at bench.py's configuration, the KRR/RLSC
    strategies and the nonlinear estimators, each trained model checked
    against a bound that a control misses.  Every launch of the phase
    counts for the ``train`` path; data is made on the card from the
    seed."""
    from libskylark_tpu_torch.resilient import chunked
    from libskylark_tpu_torch.sketch import kernels_fut as kf

    from libskylark_tpu_torch.sketch import kernels_window as kw

    ml = sky.ml
    f64 = torch.float64
    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    card = f"[{smi}]"
    rfut = kf.rfut_rowwise  # the kernel itself: its launch counter

    # Each kernel the path launches is held against its plain version on
    # the same inputs at the path's own shapes: the first launch of each
    # signature (kernel, input shapes and dtypes, bucket count), beside a
    # control that misses.  The plain runs launch no kernel.
    held = set()

    def rfut_held(out, x, d, nb):
        tol = 1e-5 if x.dtype == torch.float32 else 1e-2
        _, r = max_err(out, kf.rfut_rowwise_plain(x, d, nb))
        d_ctl = d.clone()
        d_ctl[0] = -d_ctl[0]
        _, c = max_err(out, kf.rfut_rowwise_plain(x, d_ctl, nb))
        print(f"train rfut_rowwise x {tuple(x.shape)} {x.dtype}, NB = {nb}: vs its plain version "
              f"rel {r:.3g} (tol {tol:g}); control (the plain version with d[0] negated) {c:.3g}")
        check(r <= tol and c > tol, f"train rfut_rowwise {tuple(x.shape)}: {r}, control {c}")

    def gather_held(out, T, idx, scale):
        ok = torch.equal(out, kw.gather_scaled_rows_plain(T, idx, scale))
        ctl = kw.gather_scaled_rows_plain(T, (idx + 1) % T.shape[0], scale)
        c = float((ctl - out).abs().max())
        print(f"train gather_scaled_rows T {tuple(T.shape)} {T.dtype}, S = {idx.numel()}: bitwise "
              f"its plain version {ok}; control (each row one index over) max abs diff {c:.3g}")
        check(ok and c > 0, f"train gather_scaled_rows {tuple(T.shape)}: bitwise {ok}")

    def scatter_held(out, A, b, v, segs, **kwargs):
        check(not kwargs, f"train scatter_rows called with {sorted(kwargs)}")
        b, v = (b[None], v[None]) if b.ndim == 1 else (b, v)
        exact, err_bound, (row, piece) = scatter_error_bound(A, b, v, segs, kw._L)
        r = bound_ratio(out, exact, err_bound)
        rp = bound_ratio(kw.scatter_rows_plain(A, b, v, segs), exact, err_bound)
        c = bound_ratio(out[row].double() - piece, exact[row], err_bound[row])
        print(f"train scatter_rows A {tuple(A.shape)} {A.dtype} -> {segs}, nnz = {b.shape[0]}: "
              f"max |out - exact| / rounding bound {r:.3g} (must be <= 1; plain version {rp:.3g}); "
              f"control (bucket {row}'s first piece left out) {c:.3g}")
        check(r <= 1.0 and c > 1.0, f"train scatter_rows {tuple(A.shape)}: {r}, control {c}")

    kernels = [(kf, "rfut_rowwise", hold(kf, "rfut_rowwise", rfut_held, held)),
               (kw, "gather_scaled_rows", hold(kw, "gather_scaled_rows", gather_held, held)),
               (kw, "scatter_rows", hold(kw, "scatter_rows", scatter_held, held))]
    reset_counts()
    t_path = time.perf_counter()

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    def clock(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, out

    def rel(a, b):
        a, b = a.double(), b.double()
        return float((a - b).abs().max() / b.abs().max())

    def acc(labels, y):
        return float((labels.cpu() == torch.as_tensor(y).cpu()).double().mean())

    def solve64(Z, T, lam):
        """The ridge normal equations of the same features in f64."""
        Z = Z.double()
        G = Z.T @ Z
        G.diagonal().add_(lam)
        return torch.cholesky_solve(Z.T @ T.double(), torch.linalg.cholesky(G))

    def against64(label, W, Z, T, lam, bound=TRAIN_W_TOL, factor=2.0):
        """W against the f64 solve of the same ridge problem; the control
        (the f64 solve at ``factor`` lam) must miss the bound."""
        W64 = solve64(Z, T, lam)
        err, ctl = rel(W, W64), rel(solve64(Z, T, factor * lam), W64)
        print(f"{label}: ||W - W_f64|| / ||W_f64|| {err:.3g} (bound {bound}); control "
              f"(the f64 solve at {factor:g} lam) {ctl:.3g}")
        check(err <= bound, f"{label}: W off the f64 solve by {err}")
        check(ctl > bound, f"{label}: the {factor:g} lam control passes ({ctl})")

    def accurate(label, model, Xm, y, classes, minimum):
        """Training accuracy against a model of random W on the same maps."""
        a = acc(model.predict_labels(Xm), y)
        ctl_model = ml.FeatureMapModel(model.maps, randn(*model.W.shape), classes=model.classes)
        c = acc(ctl_model.predict_labels(Xm), y)
        print(f"{label}: training accuracy {a:.4f} (bound {minimum}); control (random W on "
              f"the same maps) {c:.4f}; chance {1 / classes:.3f}")
        check(a >= minimum, f"{label}: training accuracy {a}")
        check(c < minimum, f"{label}: the random-W control passes ({c})")

    # (a) BlockADMM, 262144 x 128, two Gaussian maps of 2048, hinge + l2,
    # P = 4; labels planted by a teacher on the regular maps.
    Xa = randn(ADMM_M, ADMM_D)
    kernel = ml.GaussianKernel(ADMM_D, ADMM_SIGMA)

    def admm_maps(tag):
        ctx = sky.SketchContext(seed=41)
        return [kernel.create_rft(ADMM_S, tag, ctx) for _ in range(2)]

    # Split at the teacher's median, so that the classes are balanced and
    # a model unrelated to the labels scores ~0.5.
    score = ml.FeatureMapModel(admm_maps("regular"), randn(2 * ADMM_S, 1)).predict(Xa)[:, 0]
    ya = np.where((score > score.median()).cpu().numpy(), 1.0, -1.0)
    del score

    def admm(tag, iters, X=Xa, y=ya, graphs=True, loss="hinge"):
        chunked.CUDA_GRAPHS = graphs
        try:
            solver = ml.BlockADMMSolver(loss, "l2", admm_maps(tag), ml.ADMMParams(
                maxiter=iters, data_partitions=ADMM_P))
            return solver.train(X, y)
        finally:
            chunked.CUDA_GRAPHS = True

    # The logistic loss's prox reads the device once per chunk of Newton
    # steps, so its steps run eagerly only.
    per_iter, models = {}, {}
    for loss, tag, modes in (("hinge", "regular", (True, False)), ("hinge", "fast", (True, False)),
                             ("logistic", "regular", (False,))):
        rfut0 = rfut.launches
        for graphs in modes:
            t1 = min(clock(lambda: admm(tag, 1, graphs=graphs, loss=loss))[0] for _ in range(2))
            runs = [clock(lambda: admm(tag, ADMM_ITERS, graphs=graphs, loss=loss))
                    for _ in range(2)]
            tN = min(r[0] for r in runs)
            per_iter[loss, tag, graphs] = (tN - t1) / (ADMM_ITERS - 1)
            models[loss, tag, graphs] = runs[-1][1]
        mg, me = models[loss, tag, modes[0]], models[loss, tag, False]
        h = mg.history
        bitwise = torch.equal(mg.W, me.W) and mg.history == me.history
        tm = mg.timers
        graphed = (f"graphed {per_iter[loss, tag, True]!r}, " if True in modes else "")
        print(f"ADMM {tag} maps {ADMM_M} x {ADMM_D} -> 2 x {ADMM_S}, {loss} + l2, P = {ADMM_P}: "
              f"s/iter {graphed}eager {per_iter[loss, tag, False]!r} "
              f"((t_{ADMM_ITERS} - t_1)/{ADMM_ITERS - 1}, min of 2); transform "
              f"{tm.totals['transform']!r} s, factor {tm.totals['factor']!r} s; graphed W and "
              f"objective bitwise the eager ones: {bitwise if True in modes else 'not graphed'}; "
              f"objective {h[0]:.6g} -> {h[1]:.6g} -> {h[-1]:.6g}; rfut_rowwise launches "
              f"{rfut.launches - rfut0} {card}")
        check(bool(torch.isfinite(mg.W).all()), f"ADMM {loss} {tag}: non-finite W")
        check(bitwise, f"ADMM {loss} {tag}: the graphed run is not bitwise the eager one")
        check(h[-1] < h[1] and max(h[2:]) <= h[1],
              f"ADMM {loss} {tag}: objective not below its second iterate: {h[:3]} ... {h[-1]}")
    for loss, graphs in (("hinge", True), ("logistic", False)):
        accurate(f"ADMM {loss} regular, {ADMM_ITERS} iterations", models[loss, "regular", graphs],
                 Xa, ya, 2, ADMM_ACC_MIN)
    # Where an iteration's time goes: its device kernels (profiler, five
    # eager steps) against the bytes of its eight passes over the blocks.
    bytes_ms = 8 * ADMM_M * ADMM_S * 4 / MEM_BYTES_PER_S * 1e3
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for loss in ("hinge", "logistic"):
        run = ml.BlockADMMSolver(loss, "l2", admm_maps("regular"), ml.ADMMParams(
            maxiter=7, data_partitions=ADMM_P))._prepare(Xa, ya)
        st = run.step(run.step(run.state0))
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(5):
                st = run.step(st)
            torch.cuda.synchronize()
        kern = sorted((e for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA),
                      key=lambda e: -e.self_device_time_total)
        dev_ms = sum(e.self_device_time_total for e in kern) / 5e3
        eager_ms = per_iter[loss, "regular", False] * 1e3
        print(f"ADMM {loss} iteration split: device kernels {dev_ms!r} ms per eager iteration "
              f"(bytes bound {bytes_ms!r} ms; eager host clock {eager_ms!r} ms, device idle "
              f"{1 - dev_ms / eager_ms:.3f}); top: " + "; ".join(
                  f"{e.key[:48]} x{e.count // 5} {e.self_device_time_total / 5e3:.3f} ms"
                  for e in kern[:5]) + f" {card}")
        del run, st, prof
    # The card against the port's CPU route on the first rows.
    sub = slice(0, ADMM_CHECK_M)
    for loss in ("hinge", "logistic"):
        card_W = admm("regular", ADMM_CHECK_ITERS, Xa[sub], ya[sub], loss=loss).W
        cpu_W = admm("regular", ADMM_CHECK_ITERS, Xa[sub].cpu(), ya[sub], loss=loss).W
        r = rel(card_W.cpu(), cpu_W)
        print(f"ADMM {loss} regular on rows 0-{ADMM_CHECK_M - 1}, {ADMM_CHECK_ITERS} iterations: "
              f"W vs the CPU route rel {r:.3g} (tol {TRAIN_CPU_TOL})")
        check(r <= TRAIN_CPU_TOL, f"ADMM {loss}: card vs CPU route rel {r}")
    del Xa, models, card_W, cpu_W
    torch.cuda.empty_cache()

    # (b) KRR/RLSC on X (ML_ROWS x ML_DIM) with ML_CLASSES planted classes.
    X = randn(ML_ROWS, ML_DIM)
    kern = ml.GaussianKernel(ML_DIM, ML_SIGMA)

    def ctx():
        return sky.SketchContext(seed=SEED + 50)

    # The teacher's scores centred per class, so that the classes come out
    # near balanced and a model unrelated to the labels scores ~1/10.
    score = ml.FeatureMapModel([kern.create_rft(ML_S, "fast", ctx())],
                               randn(ML_S, ML_CLASSES)).predict(X)
    y = (score - score.mean(0)).argmax(1).cpu().numpy()
    del score
    print(f"planted classes: largest share {np.bincount(y).max() / y.size:.4f} of {ML_ROWS} rows, "
          f"smallest {np.bincount(y, minlength=ML_CLASSES).min() / y.size:.4f}")
    T32 = ml.dummy_coding(y, device=dev)[0]
    fast = ml.KrrParams(use_fast=True)

    def timed_fit(label, fn, reps=3):
        runs = []
        for _ in range(reps):
            secs, model = clock(fn)
            runs.append(secs)
        print(f"{label}: median {statistics.median(runs)!r} s of {[round(x, 4) for x in runs]} "
              f"{card}")
        return model

    m = timed_fit(f"approximate_kernel_rlsc Fastfood s = {ML_S} on ({ML_ROWS}, {ML_DIM})",
                  lambda: ml.approximate_kernel_rlsc(kern, X, y, KRR_LAM, ML_S, ctx(), fast))
    check(m.info["recovery"]["attempts"] == [], f"approximate KRR: {m.info['recovery']}")
    Z = m.maps[0].apply(X, "rowwise")
    against64("approximate_kernel_rlsc", m.W, Z, T32, KRR_LAM)
    accurate("approximate_kernel_rlsc", m, X, y, ML_CLASSES, KRR_ACC_MIN)
    rows = slice(0, KRR_CHECK_ROWS)
    Ws = [ml.approximate_kernel_rlsc(kern, Xs, y[rows], KRR_LAM, ML_S, ctx(), fast).W.cpu()
          for Xs in (X[rows], X[rows].cpu())]
    r = rel(*Ws)
    print(f"approximate_kernel_rlsc on rows 0-{KRR_CHECK_ROWS - 1}: W vs the CPU route rel "
          f"{r:.3g} (tol {TRAIN_CPU_TOL})")
    check(r <= TRAIN_CPU_TOL, f"approximate KRR: card vs CPU route rel {r}")

    for sk_type in ("FJLT", "CWT"):
        p = ml.KrrParams(use_fast=True, fast_sketch=sk_type == "CWT")
        m = timed_fit(f"sketched_approximate_kernel_rlsc {sk_type} t = {4 * ML_S}", lambda: (
            ml.sketched_approximate_kernel_rlsc(kern, X, y, KRR_LAM, ML_S, ctx(), p)))
        c = ctx()
        kern.create_rft(ML_S, "fast", c)
        R = sky.sketch.create_sketch(sk_type, ML_ROWS, 4 * ML_S, c)
        against64(f"sketched {sk_type}", m.W, R.apply(Z, "columnwise"),
                  R.apply(T32, "columnwise"), KRR_LAM)
        accurate(f"sketched {sk_type}", m, X, y, ML_CLASSES, KRR_ACC_MIN)
    del Z, R

    sweeps = []
    p = ml.KrrParams(max_split=KRR_LS_SPLIT, iter_lim=KRR_LS_ITERS)
    p.log = lambda level, msg: sweeps.append(msg)
    m = timed_fit(f"large_scale_kernel_ridge s = {KRR_LS_S}, max_split = {KRR_LS_SPLIT}, lam = "
                  f"{KRR_LS_LAM}", lambda: ml.large_scale_kernel_ridge(
                      kern, X, T32, KRR_LS_LAM, KRR_LS_S, ctx(), p), reps=1)
    print(f"large_scale: {len(m.maps)} chunks, stopped at {sweeps[-1]} (tolerance {p.tolerance})")
    check(len(sweeps) < KRR_LS_ITERS - 1, f"large_scale: no stop in {KRR_LS_ITERS} sweeps")
    m.classes = list(range(ML_CLASSES))
    # The same block coordinate descent in f64 on the same features (the
    # updates of krr.large_scale_kernel_ridge), for as many sweeps.
    n_sweeps = len(sweeps) + 1
    Zc = [S.apply(X, "rowwise").double().T for S in m.maps]  # (s_c, n) per chunk

    def bcd64(lam):
        R, Ws = T32.double(), [torch.zeros(Z.shape[0], ML_CLASSES, dtype=f64, device=dev)
                               for Z in Zc]
        Ls = [torch.linalg.cholesky(Z @ Z.T + lam * torch.eye(Z.shape[0], dtype=f64, device=dev))
              for Z in Zc]
        for _ in range(n_sweeps):
            for c, Z in enumerate(Zc):
                delta = torch.cholesky_solve(Z @ R - lam * Ws[c], Ls[c])
                Ws[c] = Ws[c] + delta
                R = R - Z.T @ delta
        return torch.cat(Ws)

    W64 = bcd64(KRR_LS_LAM)
    err, ctl = rel(m.W, W64), rel(bcd64(2 * KRR_LS_LAM), W64)
    print(f"large_scale: ||W - W_f64|| / ||W_f64|| {err:.3g} (bound {TRAIN_W_TOL}), W_f64 the "
          f"same {n_sweeps} sweeps in f64; control (the f64 sweeps at 2 lam) {ctl:.3g}")
    check(err <= TRAIN_W_TOL and ctl > TRAIN_W_TOL, f"large_scale: {err}, control {ctl}")
    accurate("large_scale", m, X, y, ML_CLASSES, KRR_ACC_MIN)
    del Zc, W64, m
    torch.cuda.empty_cache()

    # (c) Exact and faster KRR, and the nonlinear estimators, on the first
    # EXACT_N rows.
    Xe, ye = X[:EXACT_N].contiguous(), y[:EXACT_N]
    del X
    Te = ml.dummy_coding(ye, device=dev)[0]
    ex = timed_fit(f"kernel_rlsc n = {EXACT_N}", lambda: ml.kernel_rlsc(kern, Xe, ye, EXACT_LAM),
                   reps=2)

    def exact64(lam):
        K = kern.gram(Xe.double())
        K.diagonal().add_(lam)
        return torch.cholesky_solve(Te.double(), torch.linalg.cholesky(K))

    A64 = exact64(EXACT_LAM)
    err, ctl = rel(ex.A, A64), rel(exact64(2 * EXACT_LAM), A64)
    print(f"kernel_rlsc: ||A - A_f64|| / ||A_f64|| {err:.3g} (bound {TRAIN_W_TOL}); control (the "
          f"f64 solve at 2 lam) {ctl:.3g}")
    check(err <= TRAIN_W_TOL and ctl > TRAIN_W_TOL, f"kernel_rlsc: {err}, control {ctl}")
    del A64

    fp = ml.KrrParams(tolerance=FASTER_TOL)
    fk = timed_fit(f"faster_kernel_rlsc n = {EXACT_N}, s = {ML_S}", lambda: (
        ml.faster_kernel_rlsc(kern, Xe, ye, EXACT_LAM, ML_S, ctx(), fp)), reps=2)
    its, flag = int(fk.info["iterations"]), int(fk.info["flag"])
    short = ml.faster_kernel_rlsc(kern, Xe, ye, EXACT_LAM, ML_S, ctx(),
                                  ml.KrrParams(tolerance=FASTER_TOL, iter_lim=2))
    err, ctl = rel(fk.A, ex.A), rel(short.A, ex.A)
    print(f"faster_kernel_rlsc: CG {its} iterations (flag {flag}, iter_lim {fp.iter_lim}); "
          f"||A - A_exact|| / ||A_exact|| {err:.3g} (bound {TRAIN_W_TOL}); control (CG stopped "
          f"at 2 iterations) {ctl:.3g}")
    check(flag == 0 and its < fp.iter_lim, f"faster_kernel_rlsc: {its} iterations, flag {flag}")
    check(err <= TRAIN_W_TOL and ctl > TRAIN_W_TOL, f"faster_kernel_rlsc: {err}, control {ctl}")
    del fk, short

    rls = timed_fit(f"RLS n = {EXACT_N}", lambda: ml.RLS(kern).train(Xe, ye, EXACT_LAM), reps=1)
    check(torch.equal(rls.alpha, ex.A), "RLS is not bitwise kernel_rlsc")
    a = acc(rls.predict(Xe), ye)
    print(f"RLS: alpha bitwise kernel_rlsc's A; training accuracy {a:.4f}")
    del rls, ex
    torch.cuda.empty_cache()
    def pcr64(est, rank):
        """SketchPCR's regression in f64 on its features and its basis:
        the top-rank right singular vectors of their CWT, whitened in f32
        as the estimator does (the CWT on CPU copies, bitwise the card's
        without a launch; its SVD on the card, as the estimator's)."""
        c = ctx()
        kern.create_rft(PCR_S, "regular", c)
        Z = est.rft.apply(Xe, "rowwise")
        SZ = sky.sketch.CWT(EXACT_N, PCR_T, c).apply(Z.cpu(), "columnwise").to(dev)
        _, sig, Vt = torch.linalg.svd(SZ, full_matrices=False)
        whiten = (Vt[:rank].T / torch.clamp(sig[:rank], min=1e-12)).double()
        return whiten @ torch.linalg.lstsq(Z.double() @ whiten, Te.double()).solution

    for name, fn, features in (
            (f"SketchRLS s = {ML_S}", lambda: ml.SketchRLS(kern).train(
                Xe, ye, ctx(), random_features=ML_S, regularization=KRR_LAM),
             lambda est: est.rft.apply(Xe, "rowwise")),
            (f"NystromRLS l = {ML_S}", lambda: ml.NystromRLS(kern).train(
                Xe, ye, ctx(), random_features=ML_S, regularization=KRR_LAM),
             lambda est: kern.gram(Xe, est.SX) @ est.U),
            (f"SketchPCR rank {PCR_RANK}, s = {PCR_S}, CWT t = {PCR_T}", lambda: ml.SketchPCR(
                kern).train(Xe, ye, ctx(), rank=PCR_RANK, s=PCR_S, t=PCR_T), None)):
        est = timed_fit(name, fn, reps=3)
        if features is None:
            W64 = pcr64(est, PCR_RANK)
            err, ctl = rel(est.weights, W64), rel(pcr64(est, PCR_RANK // 2), W64)
            print(f"{name}: ||W - W_f64|| / ||W_f64|| {err:.3g} (bound {TRAIN_W_TOL}), W_f64 "
                  f"the regression in f64 on the same features and basis; control (rank "
                  f"{PCR_RANK // 2}) {ctl:.3g}")
            check(err <= TRAIN_W_TOL and ctl > TRAIN_W_TOL, f"{name}: {err}, control {ctl}")
        else:
            against64(name, est.weights, features(est), Te, KRR_LAM)
        a = acc(est.predict(Xe), ye)
        W = getattr(est, "weights")
        est.weights = randn(*W.shape).to(W.dtype)
        c = acc(est.predict(Xe), ye)
        print(f"{name}: training accuracy {a:.4f} (bound {NL_ACC_MIN}); control (random "
              f"weights) {c:.4f}")
        check(a >= NL_ACC_MIN and c < NL_ACC_MIN, f"{name}: accuracy {a}, control {c}")
    del Xe, Te
    torch.cuda.empty_cache()
    for mod, name, kernel in kernels:
        setattr(mod, name, kernel)
    check({sig[0] for sig in held} == {name for _, name, _ in kernels},
          f"train: kernels held against their plain versions: {sorted(held)}")
    read_counts("train", t_path, ("rfut_rowwise", "gather_scaled_rows", "scatter_rows"))
    # The Fastfood map's rowwise apply at BlockADMM's shape, as a fit's
    # transform phase runs it (two rfut_rowwise launches per block of 128
    # features): an observation, not a check, made after the path's
    # launches are read.
    ff = ml.GaussianKernel(ADMM_D, ADMM_SIGMA).create_rft(ADMM_S, "fast",
                                                          sky.SketchContext(seed=41))
    x = randn(ADMM_M, ADMM_D)
    rfut0 = rfut.launches
    ff_ms = time_ms(lambda: ff.apply(x, "rowwise"), reps=5)
    print(f"Fastfood map rowwise apply {ADMM_M} x {ADMM_D} -> {ADMM_S} f32: {ff_ms!r} ms of device "
          f"time (CUDA events, median of 5); rfut_rowwise launches per apply "
          f"{(rfut.launches - rfut0) / 7:g} {card}")
    del ff, x
    torch.cuda.empty_cache()


def stream_path(sky, dev, reset_counts, read_counts, smi, graph) -> dict:
    """Phase 3g: the out-of-core streaming stack at full width: (a) the
    fused stream chunk against the unfused one, (b) the overlapped
    streamed sketch of pinned host batches against the serial one, (c)
    streaming sketch-and-solve least squares with a kill and a resume,
    (d) the north-star streaming KRR, (e) the streaming randomized SVD,
    (f) the streamed graph sketch and ASE.  Each kernel the path
    launches is held against its plain version first; then every launch
    of (a)-(f) counts for the ``streaming`` path.  Returns the fused
    chunk's inputs for the kernel table."""
    import tempfile

    from libskylark_tpu_torch.resilient import FaultPlan, SimulatedPreemption, chunked
    from libskylark_tpu_torch.sketch import kernels_fut as kf
    from libskylark_tpu_torch.sketch import kernels_scatter as ks
    from libskylark_tpu_torch.sketch import kernels_window as kw
    from libskylark_tpu_torch.streaming import StreamParams
    from libskylark_tpu_torch.streaming.engine import accumulate_slice

    g = torch.Generator(device=dev).manual_seed(SEED + 7)
    f64, bf16 = torch.float64, torch.bfloat16
    card = f"[{smi}]"
    u = 2.0 ** -24

    def clock(fn, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, out

    def rel(a, b):
        a, b = a.double(), b.double()
        return float((a - b).abs().max() / b.abs().max())

    # Each kernel the path launches is held against its plain version on
    # the same inputs at the path's own shapes, the first launch of each
    # signature, beside a control that misses (as phase 3f holds its own).
    held = set()

    def scatter_held(out, A, b, v, segs, acc=None, label="(held)"):
        part, err_bound, (row, piece) = scatter_error_bound(A, b, v, segs, kw._L)
        exact = part if acc is None else acc.double() + part
        if acc is not None:
            err_bound = err_bound + u * 1.01 * exact.abs()  # the fused emit's one add
        r = bound_ratio(out, exact, err_bound)
        plain = kw.scatter_rows_plain(A.cpu(), b.cpu(), v.cpu(), segs,
                                      acc=None if acc is None else acc.cpu())
        rp = bound_ratio(plain.to(dev), exact, err_bound)
        c = bound_ratio(out[row].double() - piece, exact[row], err_bound[row])
        # Where no bucket holds more than _L entries, the kernel sums each
        # in entry order, as its plain version does: bitwise on CPU copies.
        flat = b[(b >= 0) & (b < segs)].long()
        one_piece = int(torch.bincount(flat, minlength=segs).max()) <= kw._L
        same = torch.equal(out.cpu(), plain)
        print(f"stream {label} scatter_rows{'(acc=)' if acc is not None else ''} A "
              f"{tuple(A.shape)} {A.dtype} -> {segs}, nnz = {b.shape[0]}: max |out - exact| / "
              f"rounding bound {r:.3g} (must be <= 1; plain version {rp:.3g}, bitwise equal "
              f"{same}, required {one_piece}); control (bucket {row}'s first piece left out) "
              f"{c:.3g}")
        check(r <= 1.0 and rp <= 1.0 and c > 1.0 and (same or not one_piece),
              f"stream {label} scatter_rows {tuple(A.shape)}: {r}, plain {rp}, bitwise {same}, "
              f"control {c}")
        return float((out.cpu() - plain).abs().max())

    def segsum_held(out, vals, keys, segs):
        ref = ks.segment_sum_flat_plain(vals, keys, segs)
        _, r = max_err(out, ref)
        i = int(vals.abs().argmax())
        ctl = ks.segment_sum_flat_plain(torch.cat([vals[:i], vals[i + 1:]]),
                                        torch.cat([keys[:i], keys[i + 1:]]), segs)
        _, c = max_err(out, ctl)
        print(f"stream (held) segment_sum_flat {vals.shape[0]} -> {segs} {vals.dtype}: vs its "
              f"plain version rel {r:.3g} (tol 1e-5); control (the plain version without entry "
              f"{i}) {c:.3g}")
        check(r <= 1e-5 and c > 1e-5, f"stream segment_sum_flat {vals.shape[0]}: {r}, control {c}")

    def rfut_held(out, x, d, nb, idx):
        _, r = max_err(out, kf.rfut_rowwise_sampled_plain(x, d, nb, idx))
        d_ctl = d.clone()
        d_ctl[0] = -d_ctl[0]
        _, c = max_err(out, kf.rfut_rowwise_sampled_plain(x, d_ctl, nb, idx))
        print(f"stream (held) rfut_rowwise_sampled x {tuple(x.shape)} {x.dtype}, NB = {nb}, S = "
              f"{idx.shape[0]}: vs its plain version rel {r:.3g} (tol 1e-5); control (the plain "
              f"version with d[0] negated) {c:.3g}")
        check(r <= 1e-5 and c > 1e-5, f"stream rfut_rowwise_sampled {tuple(x.shape)}: {r}, "
              f"control {c}")

    # (a) inputs, and each chunk kernel against its plain version (before
    # the counts are reset: these launches do not count).
    m_a = ST_CHUNK * ST_CHUNKS
    X = torch.randn(ST_CHUNK, ST_N, generator=g, device=dev)
    chunk_sketches = {name: sky.sketch.create_sketch(name, m_a, ST_S, sky.SketchContext(seed=61))
                      for name in ("CWT", "MMT")}
    chunk_err = 0.0
    for name, S in chunk_sketches.items():
        acc0 = torch.randn(ST_S, ST_N, generator=g, device=dev)
        b, v = S._slice_hashes(3 * ST_CHUNK, ST_CHUNK, torch.float32, dev)
        out = kw.scatter_rows(X, b, v, ST_S, acc=acc0)
        chunk_err = max(chunk_err, scatter_held(out, X, b, v, ST_S, acc=acc0,
                                                label=f"(a) {name} chunk:"))
        held.add(signature("scatter_rows", (X, b, v, ST_S)))
        del acc0, b, v, out
    torch.cuda.empty_cache()

    # (b) inputs: 8 pinned host batches, made on the card from the seed.
    H = torch.empty(m_a, ST_N, pin_memory=True)
    for i in range(ST_CHUNKS):
        H[i * ST_CHUNK:(i + 1) * ST_CHUNK].copy_(
            torch.randn(ST_CHUNK, ST_N, generator=g, device=dev))
    host_batches = [H[i * ST_CHUNK:(i + 1) * ST_CHUNK] for i in range(ST_CHUNKS)]

    kernels = [(kw, "scatter_rows", hold(kw, "scatter_rows", scatter_held, held)),
               (ks, "segment_sum_flat", hold(ks, "segment_sum_flat", segsum_held, held)),
               (kf, "rfut_rowwise_sampled", hold(kf, "rfut_rowwise_sampled", rfut_held, held))]
    reset_counts()
    t_path = time.perf_counter()

    # (a) the fused stream chunk, bench.py's pass: 8 chunks folded into
    # one (1024, 2048) accumulator, fused against the unfused composite.
    # Warm: the whole (nnz, N) hash arrays a stream's windows are cut
    # from stay memoized from pass to pass, so the pass draws no hash.
    # Cold: each pass ends in finalize_slices, which drops them, so each
    # pass draws them once, as a user's one pass over a sketch does.
    # Drawn: the side above the memo's limit (set to 0 on a second sketch
    # of the same seed), each chunk's windows drawn for the chunk.
    for name, S in chunk_sketches.items():
        def chunk_pass(fused, sketch=S, finalize=False):
            acc = torch.zeros(ST_S, ST_N, device=dev)
            for c in range(ST_CHUNKS):
                acc = accumulate_slice(sketch, acc, X, c * ST_CHUNK, fused=fused)
            return sketch.finalize_slices(acc) if finalize else acc

        outs = {fused: clock(chunk_pass, fused)[1] for fused in (True, False)}
        warm = {fused: min(clock(chunk_pass, fused)[0] for _ in range(ST_REPEATS))
                for fused in (True, False)}
        S.finalize_slices(outs[True])
        cold = min(clock(chunk_pass, True, S, True)[0] for _ in range(ST_REPEATS))
        S_d = sky.sketch.create_sketch(name, m_a, ST_S, sky.SketchContext(seed=61))
        S_d._SLICE_MEMO_LIMIT = 0
        t_d, out_d = clock(chunk_pass, True, S_d)
        drawn = min([t_d] + [clock(chunk_pass, True, S_d)[0] for _ in range(ST_REPEATS - 1)])
        same = torch.equal(outs[True], outs[False])
        same_d = torch.equal(out_d, outs[True])
        print(f"stream (a) {name} fused stream-chunk columnwise {ST_CHUNKS}x{ST_CHUNK}x{ST_N}"
              f"->{ST_S}: warm (hash arrays memoized) fused {m_a / warm[True] / 1e6:.1f} Mrows/s "
              f"({warm[True]!r} s), unfused {m_a / warm[False] / 1e6:.1f} Mrows/s "
              f"({warm[False]!r} s), fused / unfused speed {warm[False] / warm[True]:.3f}; cold "
              f"(each pass draws the whole arrays) fused {m_a / cold / 1e6:.1f} Mrows/s "
              f"({cold!r} s); drawn per chunk (above the memo limit) fused "
              f"{m_a / drawn / 1e6:.1f} Mrows/s ({drawn!r} s); bitwise fused = unfused {same}, "
              f"drawn = memoized {same_d} {card}")
        check(same, f"stream (a) {name}: fused and unfused passes differ")
        check(same_d, f"stream (a) {name}: drawn and memoized hash windows differ")
        check(bool(torch.isfinite(outs[True]).all()), f"stream (a) {name}: non-finite sketch")
        check(not S.__dict__.get("_slice_memo"), f"stream (a) {name}: finalize kept the memo")
    del outs, out_d, S_d

    # (b) the overlapped streamed sketch of the pinned host batches,
    # overlap against serial, and against the exact sum in f64.
    S_b = sky.sketch.CWT(m_a, ST_S, sky.SketchContext(seed=71))

    def stream_pass(overlap, params=None):
        params = params or StreamParams(overlap=overlap)
        return sky.streaming.sketch(lambda start: iter(host_batches[start:]), S_b,
                                    ncols=ST_N, dtype=torch.float32, params=params)

    outs = {ov: clock(stream_pass, ov)[1] for ov in (True, False)}
    times = {ov: min(clock(stream_pass, ov)[0] for _ in range(ST_REPEATS)) for ov in (True, False)}
    params = StreamParams(overlap=True)
    clock(stream_pass, True, params)
    st = params.prefetch_stats
    same = torch.equal(outs[True], outs[False])
    gbs = H.numel() * 4 / times[True] / 1e9
    print(f"stream (b) CWT overlapped stream columnwise {ST_CHUNKS}x{ST_CHUNK}x{ST_N}->{ST_S} "
          f"from pinned host batches: overlap {m_a / times[True] / 1e6:.1f} Mrows/s "
          f"({times[True]!r} s, {gbs:.1f} GB/s host->card), serial "
          f"{m_a / times[False] / 1e6:.1f} Mrows/s ({times[False]!r} s), serial / overlap "
          f"{times[False] / times[True]:.3f}; bitwise equal {same}; prefetch: {st.produced} "
          f"staged, hits {st.hits}, waits {st.waits}, producer {st.producer_seconds:.4f} s, "
          f"consumer waited {st.wait_seconds:.4f} s, hidden fraction {st.hidden():.3f} {card}")
    check(same, "stream (b): overlapped and serial passes differ")
    # The exact sum in f64 (CWT values are ±1, so each term is exact).
    # Any order of summation errs by at most (n_b - 1)·u·Σ|x| in a bucket
    # of n_b terms (Higham (4.3)).
    A_res = H.to(dev)
    bkt = S_b.buckets(0, m_a, device=dev).long()
    val = S_b.values(torch.float32, 0, m_a, device=dev).double()
    n_b = torch.bincount(bkt, minlength=ST_S).double()
    exact = torch.zeros(ST_S, ST_N, dtype=f64, device=dev)
    absum = torch.zeros(ST_S, ST_N, dtype=f64, device=dev)
    for i in range(ST_CHUNKS):
        sl = slice(i * ST_CHUNK, (i + 1) * ST_CHUNK)
        A_d = A_res[sl].double()
        exact.index_add_(0, bkt[sl], val[sl, None] * A_d)
        absum.index_add_(0, bkt[sl], A_d.abs())
    del A_d
    order_bound = 1.01 * u * (n_b - 1).clamp(min=0)[:, None] * absum
    r = bound_ratio(outs[True], exact, order_bound)
    b0 = int(bkt[0])
    ctl = bound_ratio(outs[True][b0], exact[b0] - val[0] * A_res[0].double(), order_bound[b0])
    print(f"stream (b): streamed vs the exact sum (f64) of the resident {H.numel() * 4 >> 30} GiB "
          f"A: max diff / rounding bound of any summation order {r:.3g} (must be <= 1); control "
          f"(row 0 left out of bucket {b0}) {ctl:.3g}")
    check(r <= 1.0 and ctl > 1.0, f"stream (b): streamed vs exact {r}, control {ctl}")
    # The rowwise form of the same batches: FJLT, a sketch per batch.
    S_r = sky.sketch.FJLT(ST_N, ST_S, sky.SketchContext(seed=73))
    t_r, rowwise = clock(lambda: torch.cat(list(sky.streaming.sketch_batches(
        lambda start: iter(host_batches[start:]), S_r))))
    ok = torch.equal(rowwise, S_r.apply(A_res, "rowwise"))
    print(f"stream (b) FJLT({ST_N}, {ST_S}) rowwise sketch_batches of the same batches: "
          f"{t_r!r} s, bitwise S.apply of the resident A {ok}")
    check(ok, "stream (b): rowwise sketch_batches differ from the resident apply")
    del outs, exact, absum, order_bound, A_res, rowwise, bkt, val, H, host_batches
    torch.cuda.empty_cache()

    # (c) streaming sketch-and-solve LS over 32 pinned host batches.
    A_h = torch.empty(LSQ_M, LSQ_N, pin_memory=True)
    b_h = torch.empty(LSQ_M, pin_memory=True)
    x_true = torch.randn(LSQ_N, generator=g, device=dev)
    for r0 in range(0, LSQ_M, LSQ_BATCH):
        Ap = torch.randn(LSQ_BATCH, LSQ_N, generator=g, device=dev)
        A_h[r0:r0 + LSQ_BATCH].copy_(Ap)
        b_h[r0:r0 + LSQ_BATCH].copy_(Ap @ x_true + LSQ_NOISE * torch.randn(
            LSQ_BATCH, generator=g, device=dev))
    nb = LSQ_M // LSQ_BATCH

    def lsq_source(start):
        return ((A_h[i * LSQ_BATCH:(i + 1) * LSQ_BATCH], b_h[i * LSQ_BATCH:(i + 1) * LSQ_BATCH])
                for i in range(start, nb))

    def lsq(params=None, fault_plan=None, s=None):
        return sky.linalg.streaming_least_squares(
            lsq_source, LSQ_M, LSQ_N, sky.SketchContext(seed=SEED),
            sky.linalg.LeastSquaresParams(sketch_size=s), stream_params=params,
            fault_plan=fault_plan)

    secs, (x_hat, info) = clock(lsq)
    with tempfile.TemporaryDirectory() as ck:
        killed = StreamParams(checkpoint_dir=ck, checkpoint_every=LSQ_EVERY)
        t_kill = time.perf_counter()
        try:
            lsq(killed, FaultPlan(preempt_after_chunk=LSQ_KILL_CHUNK))
            fail("stream (c): the fault plan did not kill the pass")
        except SimulatedPreemption:
            pass
        t_kill = time.perf_counter() - t_kill
        steps = sky.utils.CheckpointStore(ck).steps()
        t_res, (x_res, info_res) = clock(lsq, StreamParams(
            checkpoint_dir=ck, checkpoint_every=LSQ_EVERY, resume=True))
    same = torch.equal(x_hat, x_res)
    # The control: a sketch of only n rows (s = n/2 leaves the small
    # problem underdetermined, which the QR solve refuses).
    _, (x_ctl, _) = clock(lsq, None, None, LSQ_N)
    # The exact solve in f64 from the normal equations (cond(A) ~ 1.05).
    G = torch.zeros(LSQ_N, LSQ_N, dtype=f64, device=dev)
    c = torch.zeros(LSQ_N, dtype=f64, device=dev)
    for A_p, b_p in lsq_source(0):
        A_p, b_p = A_p.to(dev).double(), b_p.to(dev).double()
        G += A_p.T @ A_p
        c += A_p.T @ b_p
    x_star = torch.cholesky_solve(c[:, None], torch.linalg.cholesky(G))[:, 0]
    res = {"x*": 0.0, "x": 0.0, "control": 0.0}
    for A_p, b_p in lsq_source(0):
        A_p, b_p = A_p.to(dev).double(), b_p.to(dev).double()
        for key, x in (("x*", x_star), ("x", x_hat), ("control", x_ctl)):
            res[key] += float(torch.linalg.vector_norm(A_p @ x.double() - b_p) ** 2)
    ratio, ratio_ctl = (math.sqrt(res["x"] / res["x*"]), math.sqrt(res["control"] / res["x*"]))
    gb = (A_h.numel() + b_h.numel()) * 4 / 1e9
    print(f"stream (c) streaming_least_squares {LSQ_M} x {LSQ_N} f32 in {nb} pinned batches of "
          f"{LSQ_BATCH}, default sketch (JLT, s = {4 * LSQ_N}): {secs!r} s, {gb / secs:.2f} GB/s "
          f"host->card ({gb:.2f} GB), info {{rows {info['rows']}, batches {info['batches']}, "
          f"seconds {info['seconds']}, certificate "
          f"{info['recovery']['attempts'][0]['verdict']}}}; residual / f64 exact residual "
          f"{ratio:.4f} (bound {LS_RATIO_BOUND}); control (s = n = {LSQ_N}) "
          f"{ratio_ctl:.4g} {card}")
    print(f"stream (c) killed after batch {LSQ_EVERY * (LSQ_KILL_CHUNK + 1) - 1} ({t_kill:.2f} s, "
          f"slots {steps}) and resumed ({t_res:.2f} s): bitwise the uninterrupted x {same}")
    check(info["rows"] == LSQ_M and info["batches"] == nb, f"stream (c): info {info}")
    check(ratio <= LS_RATIO_BOUND and ratio_ctl > LS_RATIO_BOUND,
          f"stream (c): residual ratio {ratio}, control {ratio_ctl}")
    check(same and info_res["rows"] == LSQ_M, "stream (c): the resumed pass differs")
    del A_h, b_h, G, c, x_star
    torch.cuda.empty_cache()

    # (d) the north star: 10^7 x 4096 -> 2048, bf16 features, hot panels.
    X0 = torch.randn(NS_BR, NS_D, generator=g, device=dev).to(bf16)

    def block_fn(start, rows, X0):
        # A per-panel row rotation of one resident panel stands in for IO.
        return torch.roll(X0, start // rows, dims=0)[:rows]

    kernel = sky.ml.GaussianKernel(NS_D, NS_SIGMA)

    def ns_fit(n, lam, params=None, timer=None):
        y = torch.sign(torch.randn(n, generator=torch.Generator(device=dev).manual_seed(SEED),
                                   device=dev))
        return sky.ml.streaming_kernel_ridge(
            kernel, block_fn, (n, NS_D), y, lam, NS_S, sky.SketchContext(seed=72),
            params or sky.ml.KrrParams(max_split=0, iter_lim=NS_SWEEPS, tolerance=0.0),
            block_rows=NS_BR, feature_dtype=bf16, block_args=(X0,), timer=timer), y

    timer = sky.utils.PhaseTimer()
    secs, (model, _) = clock(ns_fit, NS_N, NS_LAM, None, timer)
    per = timer.totals["sweep"] / timer.counts["sweep"]
    resid = model.info["residual"]
    print(f"stream (d) north-star streaming KRR {NS_N}x{NS_D}->{NS_S} bf16 (hot panels of "
          f"{NS_BR}, lam {NS_LAM}, {NS_SWEEPS} sweeps): {per!r} s/sweep (sweep 0 "
          f"{timer.totals['sweep0']!r} s: Gram, factor, ZR and update passes), total "
          f"{secs!r} s; ||R|| after each sweep {resid} (||y|| "
          f"{math.sqrt(NS_N):.4f}) {card}")
    check(bool(torch.isfinite(model.W).all()), "stream (d): W not finite")
    # One feature chunk (max_split = 0): sweep 0 is the ridge solve, and
    # later sweeps refine what the bf16 rounding of its update lost, so
    # the residual falls in sweep 0 and never rises after.
    check(resid[0] < math.sqrt(NS_N) and all(b <= a for a, b in zip(resid, resid[1:])),
          f"stream (d): the residual rose in a sweep: {resid}")
    # Where a sweep's time goes: the device kernels of eight ZR panel steps
    # (profiler, eager), against the sweep's 160 panel steps.
    from libskylark_tpu_torch.ml.krr import _panel_mm
    S0, npan = model.maps[0], 8
    ops = S0.hoistable_operands(bf16, dev)
    Rp = torch.randn(NS_BR, 1, generator=g, device=dev)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for p in range(npan):
            Zp = S0.apply_with_operands(ops, block_fn(p * NS_BR, NS_BR, X0), "rowwise")
            _panel_mm(Zp.T, Rp)
        torch.cuda.synchronize()
    kern = sorted((e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA),
                  key=lambda e: -e.self_device_time_total)
    dev_ms = sum(e.self_device_time_total for e in kern) / (npan * 1e3)
    print(f"stream (d) one ZR panel step ({NS_BR} x {NS_D} -> {NS_S} bf16): device kernels "
          f"{dev_ms!r} ms (x {2 * NS_N // NS_BR} panel steps a sweep = "
          f"{dev_ms * 2 * NS_N / NS_BR / 1e3!r} s); top: " + "; ".join(
              f"{e.key[:48]} x{e.count // npan} {e.self_device_time_total / (npan * 1e3):.3f} ms"
              for e in kern[:6]) + f" {card}")
    del model, prof, Zp, ops, Rp
    torch.cuda.empty_cache()
    # Correctness at n = 2^20: W against the same sweeps in core on the
    # materialized X, and against an f64 solve of the same bf16 features;
    # the graphed passes against eager ones, bitwise.
    n_c = NS_CHECK_N
    check_params = sky.ml.KrrParams(max_split=0, iter_lim=NS_SWEEPS, tolerance=0.0)
    (model, y) = ns_fit(n_c, NS_CHECK_LAM, check_params)
    chunked.CUDA_GRAPHS = False
    try:
        eager, _ = ns_fit(n_c, NS_CHECK_LAM, check_params)
    finally:
        chunked.CUDA_GRAPHS = True
    graphed_same = torch.equal(model.W, eager.W)
    br = max(b for b in range(1, NS_BR + 1) if n_c % b == 0)
    Xc = torch.cat([block_fn(p * br, br, X0) for p in range(n_c // br)])
    incore = {lam: sky.ml.large_scale_kernel_ridge(kernel, Xc, y, lam, NS_S,
                                                   sky.SketchContext(seed=72), check_params).W
              for lam in (NS_CHECK_LAM, 2 * NS_CHECK_LAM)}
    S_c = model.maps[0]
    Gf = torch.zeros(NS_S, NS_S, dtype=f64, device=dev)
    cf = torch.zeros(NS_S, 1, dtype=f64, device=dev)
    for p in range(n_c // br):
        Z = S_c.apply(Xc[p * br:(p + 1) * br], "rowwise").double()
        Gf += Z.T @ Z
        cf += Z.T @ y[p * br:(p + 1) * br, None].double()
    del Xc, Z

    def solve64(lam):
        return torch.cholesky_solve(cf, torch.linalg.cholesky(
            Gf + lam * torch.eye(NS_S, dtype=f64, device=dev)))

    W64 = solve64(NS_CHECK_LAM)
    e_ic, c_ic = rel(model.W, incore[NS_CHECK_LAM]), rel(incore[2 * NS_CHECK_LAM],
                                                         incore[NS_CHECK_LAM])
    e64, c64 = rel(model.W, W64), rel(solve64(2 * NS_CHECK_LAM), W64)
    print(f"stream (d) check at n = {n_c} (panels of {br}), lam {NS_CHECK_LAM}: W vs in-core "
          f"large_scale_kernel_ridge (bf16 state) {e_ic:.3g} (bound {NS_INCORE_TOL}; control "
          f"in core at 2 lam {c_ic:.3g}); vs the f64 solve of the same bf16 features {e64:.3g} "
          f"(bound {NS_W_TOL}; control at 2 lam {c64:.3g}); graphed passes bitwise eager "
          f"{graphed_same}")
    check(e_ic <= NS_INCORE_TOL and c_ic > NS_INCORE_TOL,
          f"stream (d): vs in-core {e_ic}, control {c_ic}")
    check(e64 <= NS_W_TOL and c64 > NS_W_TOL, f"stream (d): vs f64 {e64}, control {c64}")
    check(graphed_same, "stream (d): graphed and eager passes differ")
    del model, eager, incore, Gf, cf, W64, X0
    torch.cuda.empty_cache()

    # (e) the streaming randomized SVD, bf16 panels, one power iteration.
    block = sky.linalg.synthetic_lowrank_blocks(sky.SketchContext(seed=SEED), SSVD_M, SSVD_N,
                                                SSVD_R, noise=SSVD_NOISE, dtype=bf16, device=dev)

    def ssvd(blk):
        return sky.linalg.streaming_approximate_svd(
            blk, (SSVD_M, SSVD_N), SSVD_R, sky.SketchContext(seed=SEED + 1),
            sky.linalg.SVDParams(num_iterations=1), block_rows=SSVD_BR)

    secs, (u_block, sv, V) = clock(ssvd, block)
    passes = 3  # the power sweep, the G/M pass, the whitening pass
    gram = torch.zeros(SSVD_N, SSVD_N, dtype=f64, device=dev)
    for i in range(SSVD_M // SSVD_BR):
        P = block(i * SSVD_BR, SSVD_BR).double()
        gram += P.T @ P
    exact = torch.linalg.eigvalsh(gram).flip(0)[:SSVD_R].clamp(min=0).sqrt()
    err = float(((sv.double() - exact).abs() / exact).max())
    ctl_block = sky.linalg.synthetic_lowrank_blocks(sky.SketchContext(seed=SEED), SSVD_M, SSVD_N,
                                                    SSVD_CTL_R, dtype=bf16, device=dev)
    sv_ctl = ssvd(ctl_block)[1]
    ctl = float(((sv_ctl.double() - exact).abs() / exact).max())
    U0 = u_block(0)
    print(f"stream (e) streaming_approximate_svd {SSVD_M} x {SSVD_N} bf16 (m cut from 10^7), "
          f"rank {SSVD_R}, panels of {SSVD_BR}, q = 1: {secs!r} s = {passes} passes, "
          f"{secs / passes!r} s per pass, {secs / (passes * SSVD_M) * 1e9:.3f} ns per row per "
          f"pass; sigma vs sqrt(eigvalsh(A^T A)) in f64 max rel {err:.3g} (bound {SSVD_TOL}); "
          f"control (a rank-{SSVD_CTL_R} matrix's sigma) {ctl:.3g} {card}")
    check(err <= SSVD_TOL and ctl > SSVD_TOL, f"stream (e): sigma rel {err}, control {ctl}")
    check(tuple(U0.shape) == (SSVD_BR, SSVD_R) and bool(torch.isfinite(U0).all()),
          "stream (e): U panel not finite of shape (block_rows, k)")
    del gram, P, U0
    torch.cuda.empty_cache()

    # (f) the streamed graph: phase 3c's edges in blocks of 2^22.
    lo, hi, SA_ref, lam_ref, S_g = graph
    n_v = S_g.n

    def edge_source(start):
        for e0 in range(start * GRAPH_BATCH, lo.size, GRAPH_BATCH):
            l, h = lo[e0:e0 + GRAPH_BATCH], hi[e0:e0 + GRAPH_BATCH]
            yield {"rows": np.concatenate([l, h]), "cols": np.concatenate([h, l]),
                   "vals": np.ones(2 * l.size, dtype=np.float32)}

    from libskylark_tpu_torch.graph import stream as gs

    secs, SA = clock(lambda: gs.streamed_adjacency_sketch(edge_source, S_g, ncols=n_v,
                                                          dtype=torch.float32))
    same = torch.equal(SA.cpu(), SA_ref)
    secs_ase, (Xe, lam) = clock(lambda: gs.streaming_ase(edge_source, n_v, ASE_K,
                                                         sky.SketchContext(seed=SEED),
                                                         dtype=torch.float32))
    lam_same = torch.equal(lam.cpu(), lam_ref)
    nblk = -(-lo.size // GRAPH_BATCH)
    print(f"stream (f) streamed_adjacency_sketch of {lo.size} edges in {nblk} blocks of "
          f"{GRAPH_BATCH}: {secs!r} s, bitwise the in-core sketch {same}; streaming_ase k = "
          f"{ASE_K}: {secs_ase!r} s, eigenvalues bitwise the in-core route's {lam_same} {card}")
    check(same and lam_same, f"stream (f): streamed graph sketch {same}, eigenvalues {lam_same}")
    check(bool(torch.isfinite(Xe).all()), "stream (f): embedding not finite")
    del SA, Xe
    for mod, name, kernel in kernels:
        setattr(mod, name, kernel)
    counts = read_counts("streaming", t_path,
                         ("scatter_rows", "segment_sum_flat", "rfut_rowwise_sampled"))
    launched = {name for name, count in counts.items() if count}
    check(launched <= {sig[0] for sig in held},
          f"stream: kernels launched {sorted(launched)}, held against their plain versions "
          f"{sorted({sig[0] for sig in held})}")
    torch.cuda.empty_cache()
    return {"X": X, "S": chunk_sketches["CWT"], "err": chunk_err}


def sketches_path(sky, dev, reset_counts, read_counts, smi, graph) -> None:
    """Phase 3h: the remaining sketches and the graph analytics at full
    width: (a) FJLT with the DCT on the LS phase's A and its solve, (b)
    QJLT least squares on the same A, (c) the kernel machine on QMC
    features at the predict phase's shape, (d) approximate ASE of phase
    3c's graph and local clustering around a planted cluster.  The one
    kernel on the path, ``gather_scaled_rows`` (the DCT FJLT's columnwise
    epilogue), is held bitwise against its plain version at each of its
    signatures, and ``rfut_rowwise*`` must not launch: the DCT takes no
    WHT kernel.  Every launch of (a)-(d) counts for the ``sketches``
    path; the WHT control that shows the kernels can launch runs after
    the count is read."""
    from fractions import Fraction

    import scipy.fft
    import scipy.special

    from libskylark_tpu_torch.graph.graph import SimpleGraph
    from libskylark_tpu_torch.sketch import kernels_fut as kf
    from libskylark_tpu_torch.sketch import kernels_window as kw
    from libskylark_tpu_torch.sketch.rft import _epilogue

    ml, lin = sky.ml, sky.linalg
    g = torch.Generator(device=dev).manual_seed(SEED + 11)
    rng = np.random.default_rng(SEED + 11)
    card = f"[{smi}]"
    f32, f64 = torch.float32, torch.float64
    held = set()

    def gather_held(out, T, idx, scale):
        ok = torch.equal(out, kw.gather_scaled_rows_plain(T, idx, scale))
        ctl = kw.gather_scaled_rows_plain(T, (idx + 1) % T.shape[0], scale)
        c = float((ctl - out).abs().max())
        print(f"sketches gather_scaled_rows T {tuple(T.shape)} {T.dtype}, S = {idx.numel()}: "
              f"bitwise its plain version {ok}; control (each row one index over) max abs diff "
              f"{c:.3g}")
        check(ok and c > 0, f"sketches gather_scaled_rows {tuple(T.shape)}: bitwise {ok}")

    gather = hold(kw, "gather_scaled_rows", gather_held, held)
    reset_counts()
    t_path = time.perf_counter()

    def ctx(i=0):
        return sky.SketchContext(seed=SEED + i)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    def timed(label, fn, reps=3):
        secs, runs = host_median(fn, reps)
        print(f"sketches {label}: median {secs!r} s of {[round(x, 4) for x in runs]} {card}")
        return fn()

    def rel(a, b):
        a, b = a.double(), b.double()
        return float((a - b).abs().max() / b.abs().max())

    # (a) FJLT(2^20, 2048, fut="dct") on the LS phase's shape, and its solve.
    m, n, s = SK_M, SK_N, SK_S
    A = randn(m, n)
    b = A @ randn(n) + randn(m)
    x_ls = torch.linalg.lstsq(A, b[:, None]).solution[:, 0]
    res_ls = float(torch.linalg.vector_norm(A @ x_ls - b))
    del x_ls

    def ratio(x):
        return float(torch.linalg.vector_norm(A @ x - b)) / res_ls

    S = sky.sketch.FJLT(m, s, ctx(), fut="dct")
    SA, Sb = timed(f"(a) FJLT(fut='dct') apply to A ({m}, {n}) and b, S = {s}",
                   lambda: (S.apply(A), S.apply(b[:, None])))
    x = timed("(a) the 2048 x 512 solve", lambda: lin.exact_least_squares(SA, Sb)[:, 0])
    Sc = sky.sketch.FJLT(m, n, ctx(1), fut="dct")  # control: a square sketch
    r, r_ctl = ratio(x), ratio(lin.exact_least_squares(Sc.apply(A), Sc.apply(b[:, None]))[:, 0])
    print(f"sketches (a) DCT sketch-and-solve: residual / gels residual {r:.4f} (bound "
          f"{LS_RATIO_BOUND}); control (S = n = {n}) {r_ctl:.4f}")
    check(r <= LS_RATIO_BOUND and r_ctl > LS_RATIO_BOUND, f"(a) residual ratio {r}, control {r_ctl}")
    # DCT_CHECK_COLS columns against scipy's DCT-II in f64 on the host, with
    # the sketch's diagonal and samples; the WHT sketch of the same seed has
    # the same diagonal and samples and must miss.
    cols = np.sort(rng.choice(n, DCT_CHECK_COLS, replace=False))
    A_cols = A[:, cols].double().cpu()
    D = S._rfut.diagonal(f64, device="cpu")
    idx = S.sample_indices("cpu").long()
    want = scipy.fft.dct((D[:, None] * A_cols).numpy(), type=2, norm="ortho", axis=0)
    want = torch.from_numpy(want)[idx] * math.sqrt(m / s)
    err = rel(SA[:, cols].cpu(), want)
    Sw = sky.sketch.FJLT(m, s, ctx(), fut="wht")
    check(torch.equal(Sw._rfut.diagonal(f64, device="cpu"), D)
          and torch.equal(Sw.sample_indices("cpu").long(), idx), "(a) the WHT control draws "
          "another diagonal or other samples")
    err_ctl = rel(Sw.apply(A_cols), want)  # CPU: the plain WHT route
    print(f"sketches (a) {DCT_CHECK_COLS} sketch columns vs scipy.fft.dct(type=2, norm='ortho') "
          f"in f64 rel {err:.3g} (tol {DCT_TOL}); control (the same columns of the WHT FJLT) "
          f"{err_ctl:.3g}")
    check(err <= DCT_TOL and err_ctl > DCT_TOL, f"(a) DCT columns rel {err}, control {err_ctl}")
    # At NB = 2^15 the WHT FJLT takes the fused kernels; the DCT FJLT must not.
    A15 = A[:DCT_KERNEL_N].clone()
    S15 = sky.sketch.FJLT(DCT_KERNEL_N, s, ctx(2), fut="dct")
    before = (kf.rfut_rowwise.launches, kf.rfut_rowwise_sampled.launches)
    SA15 = S15.apply(A15)
    after = (kf.rfut_rowwise.launches, kf.rfut_rowwise_sampled.launches)
    r15 = rel(SA15[:, :64].cpu(), S15.apply(A15[:, :64].cpu()))
    print(f"sketches (a) FJLT(fut='dct') at N = NB = {DCT_KERNEL_N}: rfut launches "
          f"{after[0] - before[0]} + {after[1] - before[1]}; 64 columns vs the CPU route rel "
          f"{r15:.3g} (tol {DCT_TOL})")
    check(after == before and r15 <= DCT_TOL, f"(a) DCT at NB = 2^15: rfut launches "
          f"{after}, {before}; rel {r15}")
    del SA, Sb, Sc, A_cols, want, SA15
    torch.cuda.empty_cache()

    # (b) QJLT least squares on the same A.
    qp = lin.LeastSquaresParams(sketch_type="QJLT", sketch_size=s)
    xq = timed(f"(b) approximate_least_squares QJLT s = {s}",
               lambda: lin.approximate_least_squares(A, b, ctx(), qp))
    Qc = sky.sketch.QJLT(m, n, ctx())  # control: a square sketch
    r, r_ctl = ratio(xq), ratio(lin.exact_least_squares(Qc.apply(A), Qc.apply(b[:, None]))[:, 0])
    print(f"sketches (b) QJLT sketch-and-solve: residual / gels residual {r:.4f} (bound "
          f"{LS_RATIO_BOUND}); control (s = n = {n}) {r_ctl:.4f}")
    check(r <= LS_RATIO_BOUND and r_ctl > LS_RATIO_BOUND, f"(b) residual ratio {r}, control {r_ctl}")
    Q = sky.sketch.QJLT(m, s, ctx())
    primes = sky.core.primes(m)

    def exact_entry(row, col):
        """Omega[row, col] from Python integer digits: the radical inverse
        as an exact fraction rounded once, scipy's ndtri in f64, the scale
        in f64, one cast to f32."""
        p, res = int(primes[col]), (Q.skip + row) * Q.leap + 1
        u, w = Fraction(0), Fraction(1)
        while res:
            w /= p
            u += w * (res % p)
            res //= p
        return np.float32(scipy.special.ndtri(float(u)) * Q.scale)

    rows = rng.choice(s - 1, QJLT_CHECK_ENTRIES // 1024, replace=False)
    worst, worst_ctl = 0.0, math.inf
    for row in rows:
        cs = rng.choice(m, 1024, replace=False)
        line = Q.realize(f32, offset=(int(row), 0), shape=(2, m), device=dev)[:, cs].cpu().numpy()
        ref = np.array([exact_entry(int(row), int(c)) for c in cs])
        ulp = np.spacing(np.abs(ref))
        worst = max(worst, float((np.abs(line[0] - ref) / ulp).max()))
        worst_ctl = min(worst_ctl, float((np.abs(line[1] - ref) / ulp).max()))  # the next row
    print(f"sketches (b) {QJLT_CHECK_ENTRIES} Omega entries vs exact digits + scipy ndtri in f64, "
          f"cast once: worst {worst:.3g} ulp of f32 (bound 2); control (the next row's entries) "
          f"{worst_ctl:.3g} ulp")
    check(worst <= 2 and worst_ctl > 2, f"(b) Omega entries {worst} ulp, control {worst_ctl}")
    Q16 = sky.sketch.QJLT(QJLT_PANEL_N, s, ctx())
    whole = Q16.realize(f32, device=dev)
    pw = QJLT_PANEL_N // 8
    panels = torch.cat([Q16.realize(f32, offset=(0, c0), shape=(s, pw), device=dev)
                        for c0 in range(0, QJLT_PANEL_N, pw)], 1)
    other = sky.sketch.QJLT(QJLT_PANEL_N, s, ctx(), skip=Q16.skip + 1).realize(f32, device=dev)
    same, ctl_same = torch.equal(panels, whole), torch.equal(other, whole)
    print(f"sketches (b) QJLT({QJLT_PANEL_N}, {s}) realized in 8 panels bitwise the whole {same}; "
          f"control (skip + 1) bitwise {ctl_same}")
    check(same and not ctl_same, f"(b) QJLT panels bitwise {same}, control {ctl_same}")
    del whole, panels, other
    # Where the QJLT apply's time goes: realizing Omega's panels, and the
    # panel GEMMs (the apply's own panel width).
    pc = sky.sketch.dense.MAX_REALIZE_ELEMENTS // s
    spans = [(c0, min(pc, m - c0)) for c0 in range(0, m, pc)]
    t_real = time_ms(lambda: [Q.realize(f32, offset=(0, c0), shape=(s, w), device=dev)
                              for c0, w in spans], reps=2, warmup=1)
    W0 = Q.realize(f32, offset=(0, 0), shape=(s, pc), device=dev)
    t_gemm = time_ms(lambda: [W0[:, :w] @ A[c0:c0 + w] for c0, w in spans], reps=3, warmup=1)
    gemm_bound = 2.0 * m * n * s / F32_OPS_PER_S * 1e3
    print(f"sketches (b) QJLT apply to A: realizing Omega ({s} x {m}, {len(spans)} panels) "
          f"{t_real!r} ms, the panel GEMMs {t_gemm!r} ms (flop bound {gemm_bound!r} ms at 67 "
          f"TFLOP/s f32) {card}")
    del W0, b, x, xq
    torch.cuda.empty_cache()

    # (c) The kernel machine on QMC features, phase 3d's and 3f's shapes.
    d = ML_DIM
    X = randn(ML_ROWS, d)
    X_abs = X.abs()
    rows_cpu, abs_cpu = X[:ML_CHECK_ROWS].cpu(), X_abs[:ML_CHECK_ROWS].cpu()
    kernels = {"GaussianQRFT": (ml.GaussianKernel(d, ML_SIGMA), ml.GaussianKernel(d, 2 * ML_SIGMA)),
               "LaplacianQRFT": (ml.LaplacianKernel(d, ML_LAPLACE_SIGMA),
                                 ml.LaplacianKernel(d, 2 * ML_LAPLACE_SIGMA)),
               "ExpSemigroupQRLT": (ml.ExpSemigroupKernel(d, ML_BETA),
                                    ml.ExpSemigroupKernel(d, 2 * ML_BETA))}
    for name, (kernel, _) in kernels.items():
        Xm, Xc = (X_abs, abs_cpu) if name == "ExpSemigroupQRLT" else (X, rows_cpu)
        Sq = kernel.create_rft(ML_S, "quasi", ctx(3))
        check(Sq.sketch_type == name, f"(c) the quasi tag gave {Sq.sketch_type}, not {name}")
        W = randn(ML_S, ML_CLASSES) * 0.01
        model = ml.FeatureMapModel([Sq], W, classes=list(range(ML_CLASSES)), device=dev)
        O = timed(f"(c) predict {name} ({ML_ROWS}, {d}) -> {ML_S} features, 10 classes",
                  lambda: model.predict(Xm))
        check(tuple(O.shape) == (ML_ROWS, ML_CLASSES) and bool(torch.isfinite(O).all()),
              f"(c) predict {name}: output not finite")
        cpu_model = ml.FeatureMapModel.from_dict(model.to_dict(), W.cpu(), device="cpu")
        if name == "LaplacianQRFT":
            # Cauchy W: W within 8 ulp of the CPU route's, W.X per row, then
            # the CPU epilogue of the card's W.X (as phase 3d holds the RFT).
            Wc, sh = Sq.realize(f32, device=dev)
            Wr, sh_r = cpu_model.maps[0].realize(f32, device="cpu")
            ulps = float(((Wc.cpu() - Wr).abs() / torch.from_numpy(
                np.spacing(np.abs(Wr.numpy())))).max())
            WX = (Xm[:ML_CHECK_ROWS] @ Wc.T).cpu()
            WX_ref = Xc @ Wr.T
            r_wx = float(((WX - WX_ref).abs().amax(1) / WX_ref.abs().amax(1)).max())
            check(ulps <= 8 and torch.equal(sh.cpu(), sh_r) and r_wx <= 1e-5,
                  f"(c) {name}: W {ulps} ulp, W.X rows rel {r_wx}")
            ref = _epilogue(WX, sh_r, None, Sq.outscale, False) @ W.cpu()
            what = f"W within {ulps:g} ulp, W.X rows rel {r_wx:.3g}; outputs vs CPU epilogue"
        else:
            ref = cpu_model.predict(Xc)
            what = "outputs vs the CPU route"
        r = rel(O[:ML_CHECK_ROWS].cpu(), ref)
        print(f"sketches (c) {name}: rows 0-{ML_CHECK_ROWS - 1}: {what} rel {r:.3g} (tol 1e-5)")
        check(r <= 1e-5, f"(c) predict {name}: rel {r} vs the CPU route")
        del model, O, cpu_model, ref
    # Kernel approximation on KA_ROWS rows, at the JAX tests' bounds; the
    # control is the same map of twice the bandwidth.
    for name, sa, bound_ in QMC_KA:
        kernel, wide = kernels[name]
        Xk = (X_abs if name == "ExpSemigroupQRLT" else X)[:KA_ROWS]
        K = kernel.gram(Xk.double())
        errs_ = []
        for k_ in (kernel, wide):
            Z = k_.create_rft(sa, "quasi", ctx(4)).apply(Xk, "rowwise").double()
            errs_.append(float((Z @ Z.T - K).abs().mean()))
        print(f"sketches (c) kernel approximation {name} S = {sa} on ({KA_ROWS}, {d}): mean "
              f"|ZZ^T - K| {errs_[0]:.4g} (bound {bound_}); control (twice the bandwidth) "
              f"{errs_[1]:.4g}")
        check(errs_[0] <= bound_ < errs_[1], f"(c) kernel approximation {name}: {errs_}")
        del K, Z

    # Approximate KRR on the Gaussian kernel's "quasi" features.
    class QuasiGaussian(ml.GaussianKernel):
        """The Gaussian kernel whose feature map is its "quasi" map."""

        def create_rft(self, s_, tag, context):
            return super().create_rft(s_, "quasi", context)

    y = (X @ randn(d, ML_CLASSES)).argmax(1).cpu().numpy()
    T32 = ml.dummy_coding(y, device=dev)[0]
    kq = QuasiGaussian(d, ML_SIGMA)
    mq = timed(f"(c) approximate_kernel_ridge on GaussianQRFT features s = {ML_S}, lam = {KRR_LAM}",
               lambda: ml.approximate_kernel_ridge(kq, X, T32, KRR_LAM, ML_S, ctx(5)))
    check(type(mq.maps[0]).__name__ == "GaussianQRFT", "(c) KRR did not train on GaussianQRFT")
    Z = mq.maps[0].apply(X, "rowwise").double()

    def solve64(lam):
        G = Z.T @ Z
        G.diagonal().add_(lam)
        return torch.cholesky_solve(Z.T @ T32.double(), torch.linalg.cholesky(G))

    W64 = solve64(KRR_LAM)
    err, ctl = rel(mq.W, W64), rel(solve64(2 * KRR_LAM), W64)
    print(f"sketches (c) KRR on quasi features: ||W - W_f64|| / ||W_f64|| {err:.3g} (bound "
          f"{TRAIN_W_TOL}); control (the f64 solve at 2 lam) {ctl:.3g}")
    check(err <= TRAIN_W_TOL < ctl, f"(c) KRR W rel {err}, control {ctl}")
    del X, X_abs, Z, T32, mq, W64
    torch.cuda.empty_cache()

    # (d) Approximate ASE of phase 3c's graph, and local clustering.
    lo, hi = graph[0], graph[1]
    n_v = LJ_VERTICES

    def csr_graph(nv, a, c):
        """A SimpleGraph of nv vertices and the deduplicated undirected
        edges (a, c), its CSR built by one sort (the constructor's Python
        edge list would take minutes at this size)."""
        key = np.concatenate([a * nv + c, c * nv + a])
        key.sort()
        G = object.__new__(SimpleGraph)
        G.n, G.vertices, G.index = nv, range(nv), None
        G.indices = key % nv
        G.indptr = np.concatenate([[0], np.cumsum(np.bincount(key // nv, minlength=nv))])
        # What the constructor guarantees: rows sorted and deduplicated
        # (strictly increasing keys), no self-loops, each vertex's degree
        # the same counted as a row and as a column.
        rows = key // nv
        check(bool((np.diff(key) > 0).all()) and bool((rows != G.indices).all())
              and np.array_equal(np.diff(G.indptr), np.bincount(G.indices, minlength=nv)),
              "(d) csr_graph: rows unsorted, duplicated, self-looped or asymmetric")
        return G

    t0 = time.perf_counter()
    G = csr_graph(n_v, lo, hi)
    t_csr = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    Xe, lam = sky.graph.approximate_ase(
        G, ASE_K, ctx(), sky.graph.ASEParams(sparse=True, num_iterations=ASE_ITERS), device=dev)
    torch.cuda.synchronize()
    t_ase = time.perf_counter() - t0
    check(tuple(Xe.shape) == (n_v, ASE_K) and bool(torch.isfinite(Xe).all()),
          "(d) ASE embedding not finite of shape (n, k)")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    A_g = G.adjacency_coo(device=dev, dtype=f32)
    torch.cuda.synchronize()
    t_coo = time.perf_counter() - t0
    V = Xe / lam.abs().sqrt()[None, :]
    t_spmm = time_ms(lambda: torch.sparse.mm(A_g, torch.cat([V, V], 1)), reps=5)

    def residuals(B):
        R = torch.sparse.mm(A_g, B) - B * lam[None, :]
        return R.norm(dim=0) / lam.abs()

    res = residuals(V)
    Qr, _ = torch.linalg.qr(torch.randn(n_v, ASE_K, generator=g, device=dev))
    res_ctl = residuals(Qr)
    print(f"sketches (d) approximate_ase k = {ASE_K}, sparse, q = {ASE_ITERS}, on {n_v} vertices, "
          f"{lo.size} edges: {t_ase!r} s of host clock (CSR by one sort {t_csr:.2f} s) {card}; "
          f"lam {float(lam.abs().max()):.4f} .. {float(lam.abs().min()):.4f}; max ||A v - lam "
          f"v|| / |lam| {float(res.max()):.3g} (bound {ASE_RES_BOUND}); control (a random "
          f"orthonormal basis, the same lam) min {float(res_ctl.min()):.3g}; of its seconds, "
          f"building the COO on the card {t_coo:.3f} s, one COO product by {2 * ASE_K} "
          f"columns {t_spmm!r} ms of device time")
    check(float(res.max()) <= ASE_RES_BOUND < float(res_ctl.min()),
          f"(d) ASE residuals {res.tolist()}, control {res_ctl.tolist()}")
    del G, A_g, Xe, V, Qr
    torch.cuda.empty_cache()
    # A planted cluster [0, LC_NC) (LC_IN internal and LC_OUT external
    # edges per vertex) in a background on the other vertices, from a
    # generator of its own.
    t0 = time.perf_counter()
    rng_c = np.random.default_rng(SEED + 12)
    bu, bv = rng_c.integers(LC_NC, LC_N, LC_EDGES), rng_c.integers(LC_NC, LC_N, LC_EDGES)
    cu = np.repeat(np.arange(LC_NC), LC_IN // 2)
    ou = np.repeat(np.arange(LC_NC), LC_OUT)
    u = np.concatenate([bu, cu, ou])
    v = np.concatenate([bv, rng_c.integers(0, LC_NC, cu.size),
                        rng_c.integers(LC_NC, LC_N, ou.size)])
    a, c = np.minimum(u, v), np.maximum(u, v)
    code = (a * LC_N + c)[a != c]
    code.sort()  # dedupe by a sort and a neighbour compare, as phase 3c does
    code = code[np.concatenate(([True], code[1:] != code[:-1]))]
    Gl = csr_graph(LC_N, code // LC_N, code % LC_N)
    del bu, bv, u, v, a, c, code
    t_made = time.perf_counter() - t0
    deg = Gl.degrees

    def conductance(vs):
        inside = np.zeros(LC_N, bool)
        inside[vs] = True
        vol = int(deg[vs].sum())
        nbrs = np.concatenate([Gl.indices[Gl.indptr[w]:Gl.indptr[w + 1]] for w in vs])
        return int((~inside[nbrs]).sum()) / min(vol, Gl.volume - vol), vol

    planted, vol = conductance(np.arange(LC_NC))
    t0 = time.perf_counter()
    cluster, cond = sky.graph.find_local_cluster(Gl, [0], epsilon=LC_EPS, recursive=True)
    t_lc = time.perf_counter() - t0
    # An observation beside the check: one diffusion from the seed, not
    # recursive, at the same epsilon.
    _, cond_one = sky.graph.find_local_cluster(Gl, [0], epsilon=LC_EPS)
    overlap = len(cluster & set(range(LC_NC))) / len(cluster | set(range(LC_NC)))
    perm = rng.permutation(LC_N)
    random_set = perm[:int(np.searchsorted(np.cumsum(deg[perm]), vol)) + 1]
    ctl, _ = conductance(random_set)
    print(f"sketches (d) find_local_cluster from vertex 0, epsilon {LC_EPS}, recursive: "
          f"{len(cluster)} "
          f"vertices, conductance {cond:.4f} against the planted {LC_NC} vertices' {planted:.4f} "
          f"(within {LC_COND_TOL:.0%}), Jaccard overlap {overlap:.4f}; {t_lc!r} s of host clock "
          f"on {LC_N} vertices, {Gl.volume // 2} edges (made in {t_made:.1f} s); control (a "
          f"random set of the same volume, {random_set.size} vertices) {ctl:.4f}; not recursive "
          f"(observed, not checked): conductance {cond_one:.4f}, "
          f"{abs(cond_one - planted) / planted:.1%} from the planted")
    check(abs(cond - planted) <= LC_COND_TOL * planted < abs(ctl - planted),
          f"(d) local cluster conductance {cond}, planted {planted}, control {ctl}")
    del Gl, deg, perm, random_set

    setattr(kw, "gather_scaled_rows", gather)
    counts = read_counts("sketches", t_path, ("gather_scaled_rows",))
    check(counts["rfut_rowwise"] == counts["rfut_rowwise_sampled"] == 0,
          f"sketches: the WHT kernels launched {counts}")
    check({name for name, count in counts.items() if count} <= {sig[0] for sig in held},
          f"sketches: kernels launched {counts}, held {held}")
    # The control of the zero rfut counts: the WHT FJLT at NB = 2^15 launches them.
    before = kf.rfut_rowwise_sampled.launches
    sky.sketch.FJLT(DCT_KERNEL_N, s, ctx(2)).apply(A15)
    wht_launches = kf.rfut_rowwise_sampled.launches - before
    print(f"sketches: control, FJLT(fut='wht') at NB = {DCT_KERNEL_N}: rfut_rowwise_sampled "
          f"launches {wht_launches}")
    check(wht_launches > 0, "sketches: the WHT control launched no rfut kernel")
    del A15
    # Where the DCT apply's time goes (CUDA events, median of 5), after the
    # count: the whole columnwise apply of A, the diagonal multiply, the DCT
    # and its FFT alone.
    D_card = S._rfut.diagonal(f32, dev)
    t_apply = time_ms(lambda: S.apply(A), reps=5)
    t_diag = time_ms(lambda: A * D_card[:, None], reps=5)
    XD = A * D_card[:, None]
    t_dct = time_ms(lambda: sky.sketch.dct(XD), reps=5)
    t_fft = time_ms(lambda: torch.fft.fft(XD, dim=0), reps=5)
    print(f"sketches (a) FJLT(fut='dct') apply to A ({m}, {n}) f32: {t_apply!r} ms of device "
          f"time = diagonal {t_diag!r} ms + DCT {t_dct!r} ms (its FFT alone {t_fft!r} ms) + the "
          f"gather; bytes bound of one read and one write of A {8 * m * n / MEM_BYTES_PER_S * 1e3!r}"
          f" ms {card}")
    del A, XD, D_card
    torch.cuda.empty_cache()


def refine_path(sky, dev, reset_counts, read_counts, smi) -> set:
    """Phase 3i: mixed-precision refinement and the routes around it at
    full width, items (a)-(e) as the constants above say, each with the
    launch counters reset before it and read after it (paths ``refine
    (a)`` ... ``refine (e)``).  While the phase runs, the first launch
    of each kernel signature is held against its plain version on the
    same inputs beside a control that misses; the phase fails unless the
    bf16 sampled kernel, the f32 one at S = 3072, the bf16 gather and the
    bf16 row scatter were among them.  Returns the signatures held.
    Times are medians of 3 host-clock runs ending in a synchronize,
    after one warm-up."""
    import shutil

    from libskylark_tpu_torch.sketch import kernels_fut as kf
    from libskylark_tpu_torch.sketch import kernels_window as kw
    from libskylark_tpu_torch.solvers import refine as rf

    lin, ml = sky.linalg, sky.ml
    f32, f64, bf16 = torch.float32, torch.float64, torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(SEED + 17)
    card = f"[{smi}]"
    held = set()

    def sampled_held(out, x, d, nb, idx):
        tol = 1e-5 if x.dtype == f32 else 1e-2
        _, r = max_err(out, kf.rfut_rowwise_sampled_plain(x, d, nb, idx))
        _, c = max_err(out, kf.rfut_rowwise_sampled_plain(x, d, nb, (idx + 1) % nb))
        print(f"refine (held) rfut_rowwise_sampled x {tuple(x.shape)} {x.dtype}, NB = {nb}, S = "
              f"{idx.numel()}: vs its plain version rel {r:.3g} (tol {tol:g}); control (each "
              f"sample one lane over) {c:.3g}")
        check(r <= tol and c > tol, f"refine rfut_rowwise_sampled {tuple(x.shape)} {x.dtype}: "
              f"{r}, control {c}")

    def gather_held(out, T, idx, scale):
        ok = torch.equal(out, kw.gather_scaled_rows_plain(T, idx, scale))
        ctl = kw.gather_scaled_rows_plain(T, (idx + 1) % T.shape[0], scale)
        c = float((ctl.float() - out.float()).abs().max())
        print(f"refine (held) gather_scaled_rows T {tuple(T.shape)} {T.dtype}, S = {idx.numel()}: "
              f"bitwise its plain version {ok}; control (each row one index over) max abs diff "
              f"{c:.3g}")
        check(ok and c > 0, f"refine gather_scaled_rows {tuple(T.shape)} {T.dtype}: bitwise {ok}")

    def scatter_held(out, A, b, v, segs, **kwargs):
        check(not kwargs, f"refine scatter_rows called with {sorted(kwargs)}")
        b, v = (b[None], v[None]) if b.ndim == 1 else (b, v)
        exact, err_bound, (row, piece) = scatter_error_bound(A, b, v, segs, kw._L)
        r = bound_ratio(out, exact, err_bound)
        c = bound_ratio(out[row].double() - piece, exact[row], err_bound[row])
        print(f"refine (held) scatter_rows A {tuple(A.shape)} {A.dtype} -> {segs}, nnz = "
              f"{b.shape[0]}: max |out - exact| / rounding bound {r:.3g} (must be <= 1); control "
              f"(bucket {row}'s first piece left out) {c:.3g}")
        check(r <= 1.0 and c > 1.0, f"refine scatter_rows {tuple(A.shape)} {A.dtype}: {r}, "
              f"control {c}")
        del exact, err_bound

    kernels = [(kf, "rfut_rowwise_sampled", hold(kf, "rfut_rowwise_sampled", sampled_held, held)),
               (kw, "gather_scaled_rows", hold(kw, "gather_scaled_rows", gather_held, held)),
               (kw, "scatter_rows", hold(kw, "scatter_rows", scatter_held, held))]

    def randn(*shape, dtype=f32):
        return torch.randn(*shape, generator=g, device=dev, dtype=dtype)

    def ctx(i=0):
        return sky.SketchContext(seed=SEED + i)

    def timed(label, fn):
        """(median seconds of 3 runs, the last run's result), after a
        warm-up that also holds the first launch of each signature."""
        out, runs = fn(), []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            runs.append(time.perf_counter() - t0)
        secs = statistics.median(runs)
        print(f"refine {label}: median {secs!r} s of {[round(x, 4) for x in runs]} {card}")
        return secs, out

    def rel(x, ref):
        return float(torch.linalg.vector_norm(x.double() - ref) / torch.linalg.vector_norm(ref))

    def item(label, expect, body):
        reset_counts()
        t0 = time.perf_counter()
        out = body()
        torch.cuda.synchronize()
        counts = read_counts(f"refine ({label})", t0, expect)
        unheld = {k for k, c in counts.items() if c} - {name for _, name, _ in kernels}
        check(not unheld, f"refine ({label}) launched kernels it does not hold: {unheld}")
        return out

    def f64_qr(A, b):
        """x of the f64 QR solve of (A, b), and A's singular values (R's)."""
        Q, R = torch.linalg.qr(A.double())
        x = torch.linalg.solve_triangular(R, (Q.T @ b.double())[:, None], upper=True)[:, 0]
        return x, torch.linalg.svdvals(R)

    def sweep_split(label, A, b):
        """Where a refine sweep's time goes: device kernels (profiler)
        against the host clock per sweep of the loop on the refine route's
        own factor, and the bytes bound of a sweep's two passes over the
        f64 A.  Runs after its item's launches are read."""
        m, n = A.shape
        A_w, qr_dtype, _ = rf._working_cast(A, A.dtype)
        SA = sky.sketch.FJLT(m, 4 * n, ctx()).apply(A_w).to(qr_dtype)
        R = torch.linalg.qr(SA, mode="r")[1]
        A64, B64 = A.double(), b.double()[:, None]
        kw_loop = dict(sigma_max=float(torch.linalg.svdvals(R)[0]),
                       rtol=float(torch.finfo(f64).eps) ** 0.75, max_iters=100,
                       stagnation_factor=0.9)
        loop_s, _ = host_median(lambda: rf._refine_loop(A64, B64, R, **kw_loop), 3)
        sweeps = rf._refine_loop(A64, B64, R, **kw_loop)[1]["iters"]
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            rf._refine_loop(A64, B64, R, **kw_loop)
            torch.cuda.synchronize()
        dev_ms = sum(e.self_device_time_total for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
        sweep_bound = 2 * 8 * m * n / MEM_BYTES_PER_S * 1e3
        print(f"refine {label} sweep loop ({sweeps} sweeps): host {loop_s * 1e3 / sweeps!r} ms per "
              f"sweep (median of 3 loops), device kernels {dev_ms / sweeps!r} ms per sweep "
              f"(profiler), device idle {1 - dev_ms / (loop_s * 1e3):.3f}; bytes bound of a "
              f"sweep's two passes over the f64 A {sweep_bound!r} ms {card}")

    # (a) bench.py's refine shape: f64 A, rung f32 (the f32 sampled kernel).
    def item_a():
        m, n = RF_A_M, RF_A_N
        A = randn(m, n, dtype=f64)
        b = A @ randn(n, dtype=f64) + RF_A_NOISE * randn(m, dtype=f64)
        t_r, (x, info) = timed(f"(a) refine_least_squares f64 {m} x {n}",
                               lambda: sky.solvers.refine_least_squares(A, b, ctx()))
        t_q, x_qr = timed(f"(a) exact_least_squares(alg='qr') f64 {m} x {n}",
                          lambda: lin.exact_least_squares(A, b, "qr"))
        res = float(torch.linalg.vector_norm(A @ x - b))
        res_qr = float(torch.linalg.vector_norm(A @ x_qr - b))
        x_sk = lin.approximate_least_squares(A, b, ctx())  # control: sketch-and-solve
        ratio, ratio_ctl = res / res_qr, float(torch.linalg.vector_norm(A @ x_sk - b)) / res_qr
        err, err_ctl = rel(x, x_qr), rel(x_sk, x_qr)
        rinfo = info["refine"]
        print(f"refine (a) rung {rinfo['rung']}, {rinfo['iters']} sweeps, halt {rinfo['halt']}, "
              f"certificate cond {info['recovery']['attempts'][0]['cond']:.4g}; "
              f"{t_r!r} s against the f64 QR's {t_q!r} s; residual / QR residual {ratio!r} "
              f"(bound 1 + {RF_RATIO_TOL:g}), ||x - x_qr|| / ||x_qr|| {err:.3g} (bound "
              f"{RF_X_TOL:g}); control (sketch-and-solve) {ratio_ctl:.6g}, {err_ctl:.3g}")
        check(rinfo["rung"] == "f32" and rinfo["halt"] == "converged",
              f"(a) refine rung {rinfo['rung']}, halt {rinfo['halt']}")
        check(ratio <= 1 + RF_RATIO_TOL and ratio_ctl > 1 + RF_RATIO_TOL,
              f"(a) residual ratio {ratio}, control {ratio_ctl}")
        check(err <= RF_X_TOL and err_ctl > RF_X_TOL, f"(a) x error {err}, control {err_ctl}")
        # Guarded attempt 0 uses the caller's context, unguarded a copy of
        # it: the two are bitwise the same.  And the detector raises 115
        # unguarded when the sweeps run out.
        os.environ["SKYLARK_GUARD"] = "0"
        try:
            x_u, _ = sky.solvers.refine_least_squares(A, b, ctx())
            try:
                sky.solvers.refine_least_squares(A, b, ctx(), sky.solvers.RefineParams(max_iters=2))
                code = None
            except sky.utils.RefinementError as e:
                code = e.code
        finally:
            del os.environ["SKYLARK_GUARD"]
        print(f"refine (a) SKYLARK_GUARD=0: bitwise the guarded x {torch.equal(x_u, x)}; "
              f"control RefineParams(max_iters=2) raises code {code}")
        check(torch.equal(x_u, x) and code == 115, f"(a) unguarded: {torch.equal(x_u, x)}, {code}")
        return A, b

    sweep_split("(a)", *item("a", ("rfut_rowwise_sampled",), item_a))
    torch.cuda.empty_cache()

    # (b) The LS phase's problem at full width, f32: rung bf16+f32.
    m, n = NLA_M, NLA_N
    A = randn(m, n)
    b = A @ randn(n) + NLA_NOISE * randn(m)
    x64, sv = f64_qr(A, b)
    cond = float(sv[0] / sv[-1])
    res64 = float(torch.linalg.vector_norm(A.double() @ x64 - b.double()))

    def ratio(x):
        return float(torch.linalg.vector_norm(A.double() @ x.double() - b.double())) / res64

    def item_b():
        runs = {}
        for label, kw_ in (("refine FJLT", dict(route="refine")),
                           ("refine CWT", dict(route="refine", sketch_type="CWT")),
                           ("sketch FJLT", dict(route="sketch")),
                           ("exact", dict(route="exact"))):
            params = lin.LeastSquaresParams(sketch_type=kw_.pop("sketch_type", None))
            runs[label] = timed(f"(b) approximate_least_squares {label} f32 {m} x {n}",
                                lambda: lin.approximate_least_squares(
                                    A, b, ctx(), params, return_info=True, **kw_))
        x_sk = runs["sketch FJLT"][1][0]
        err_sk = rel(x_sk, x64)
        for label in ("refine FJLT", "refine CWT"):
            secs, (x, info) = runs[label]
            ri = info["refine"]
            err = rel(x, x64)
            print(f"refine (b) {label}: rung {ri['rung']}, {ri['iters']} sweeps, halt "
                  f"{ri['halt']}, certificate cond {info['recovery']['attempts'][0]['cond']:.4g} "
                  f"(cond(A) {cond:.4g}); ||x - x_f64|| / ||x_f64|| {err:.3g} (bound "
                  f"{RF_X_TOL:g}; control, the sketch route's x: {err_sk:.3g}); policy "
                  f"{info['policy']}")
            check(ri["rung"] == "bf16+f32" and ri["halt"] == "converged",
                  f"(b) {label}: rung {ri['rung']}, halt {ri['halt']}")
            check(err <= RF_X_TOL and err_sk > RF_X_TOL, f"(b) {label}: {err}, control {err_sk}")
        Sc = sky.sketch.FJLT(m, n, ctx(1))  # control: a square sketch
        r_sk = ratio(x_sk)
        r_ctl = ratio(lin.exact_least_squares(Sc.apply(A), Sc.apply(b[:, None]))[:, 0])
        print(f"refine (b) sketch route: residual / f64 residual {r_sk:.4f} (bound "
              f"{LS_RATIO_BOUND}); control (S = n = {n}) {r_ctl:.4f}")
        check(r_sk <= LS_RATIO_BOUND and r_ctl > LS_RATIO_BOUND, f"(b) sketch ratio {r_sk}, "
              f"control {r_ctl}")
        # The exact route is the f32 SVD solve the JAX package computes: a
        # backward-stable solve errs by about n·eps·(cond + cond^2 ||r|| /
        # (||A|| ||x||)) (first-order perturbation of least squares).
        x_ex = runs["exact"][1][0]
        err_ex = rel(x_ex, x64)
        ex_bound = n * float(torch.finfo(f32).eps) * (
            cond + cond ** 2 * res64 / (float(sv[0]) * float(torch.linalg.vector_norm(x64))))
        print(f"refine (b) exact route (f32 SVD): ||x - x_f64|| / ||x_f64|| {err_ex:.3g} (bound "
              f"n eps32 (cond + cond^2 ||r|| / (||A|| ||x||)) = {ex_bound:.3g}); control (the "
              f"sketch route's x) {err_sk:.3g}")
        check(err_ex <= ex_bound and err_sk > ex_bound, f"(b) exact: {err_ex}, control {err_sk}")
        return runs

    runs_b = item("b", ("gather_scaled_rows", "scatter_rows"), item_b)
    sweep_split("(b)", A, b)
    torch.cuda.empty_cache()

    # (c) f32 A RF_C_M x RF_C_N: the bf16 sketch through the sampled kernel.
    def item_c():
        A = randn(RF_C_M, RF_C_N)
        b = A @ randn(RF_C_N) + NLA_NOISE * randn(RF_C_M)
        xq = f64_qr(A, b)[0]
        secs, (x, info) = timed(f"(c) refine_least_squares f32 {RF_C_M} x {RF_C_N}",
                                lambda: sky.solvers.refine_least_squares(A, b, ctx()))
        x_sk = lin.approximate_least_squares(A, b, ctx())
        err, err_ctl = rel(x, xq), rel(x_sk, xq)
        ri = info["refine"]
        print(f"refine (c) rung {ri['rung']}, {ri['iters']} sweeps, sketch size "
              f"{ri['sketch_size']}; ||x - x_f64|| / ||x_f64|| {err:.3g} (bound {RF_X_TOL:g}); "
              f"control (sketch-and-solve) {err_ctl:.3g}")
        check(ri["rung"] == "bf16+f32" and ri["halt"] == "converged",
              f"(c) rung {ri['rung']}, halt {ri['halt']}")
        check(err <= RF_X_TOL and err_ctl > RF_X_TOL, f"(c) x error {err}, control {err_ctl}")

    item("c", ("rfut_rowwise_sampled",), item_c)

    # (d) The guard's faults at (b)'s shape, on the sketch and refine routes.
    def item_d():
        for route in ("sketch", "refine"):
            for fault in ("nan_at", "bad_sketch_at"):
                x, info = lin.approximate_least_squares(
                    A, b, ctx(), route=route, return_info=True,
                    fault_plan=sky.resilient.FaultPlan(**{fault: 0}))
                verdicts = [(a["action"], a.get("verdict")) for a in info["recovery"]["attempts"]]
                if route == "refine":
                    val, bnd, ok = rel(x, x64), RF_X_TOL, rel(x, x64) <= RF_X_TOL
                else:
                    val, bnd, ok = ratio(x), LS_RATIO_BOUND, ratio(x) <= LS_RATIO_BOUND
                print(f"refine (d) route {route}, FaultPlan({fault}=0): verdicts {verdicts}; "
                      f"{'x error' if route == 'refine' else 'residual ratio'} {val:.4g} (bound "
                      f"{bnd:g})")
                check(verdicts[0] == ("initial", "RESKETCH") and verdicts[-1][1] == "OK"
                      and info["recovery"]["recovered"] and ok,
                      f"(d) {route} {fault}: {verdicts}, {val}")

    item("d", ("gather_scaled_rows",), item_d)
    del A, b, x64, sv, runs_b
    torch.cuda.empty_cache()

    # (e) Checkpointed faster KRR at phase 3f's shape: a run preempted after
    # chunk 1 and resumed is bitwise the uninterrupted checkpointed run.
    def item_e():
        X = randn(EXACT_N, ML_DIM)
        Y = -torch.ones(EXACT_N, ML_CLASSES, device=dev)
        Y[torch.arange(EXACT_N, device=dev), X[:, :ML_CLASSES].argmax(1)] = 1.0
        kern = ml.GaussianKernel(ML_DIM, ML_SIGMA)
        root = HERE / "build" / "refine_checkpoints"
        shutil.rmtree(root, ignore_errors=True)

        def fit(directory=None, resume=False):
            p = ml.KrrParams(tolerance=FASTER_TOL, resume=resume,
                             checkpoint_dir=str(root / directory) if directory else None)
            return ml.faster_kernel_ridge(kern, X, Y, EXACT_LAM, ML_S, ctx(), p)

        t_plain, plain = timed(f"(e) faster_kernel_ridge n = {EXACT_N}, s = {ML_S}, unchecked",
                               fit)
        t_ck, whole = timed(f"(e) faster_kernel_ridge n = {EXACT_N}, s = {ML_S}, checkpointed "
                            f"every {ml.KrrParams().checkpoint_every} iterations",
                            lambda: fit("whole"))
        runner = sky.resilient.ResilientRunner

        class Preempted(runner):
            def __init__(self, solver, params=None, **kw_):
                super().__init__(solver, params, fault_plan=sky.resilient.FaultPlan(
                    preempt_after_chunk=1))

        sky.resilient.ResilientRunner = Preempted
        try:
            t0 = time.perf_counter()
            fit("killed")
            killed = None
        except sky.resilient.SimulatedPreemption as e:
            killed = time.perf_counter() - t0, str(e)
        finally:
            sky.resilient.ResilientRunner = runner
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        resumed = fit("killed", resume=True)
        torch.cuda.synchronize()
        t_res = time.perf_counter() - t0
        its = int(whole.info["iterations"])
        same, same_plain = torch.equal(resumed.A, whole.A), torch.equal(whole.A, plain.A)
        print(f"refine (e) checkpointed faster KRR: {its} CG iterations; killed after chunk 1 "
              f"({killed}), resumed in {t_res!r} s: bitwise the uninterrupted checkpointed run "
              f"{same}; the checkpointed run bitwise the unchecked one {same_plain}; "
              f"{t_ck!r} s checkpointed against {t_plain!r} s unchecked {card}")
        check(killed is not None and its > 2 * ml.KrrParams().checkpoint_every,
              f"(e) preemption {killed}, {its} iterations")
        check(same and same_plain, f"(e) resumed bitwise {same}, unchecked bitwise {same_plain}")
        shutil.rmtree(root, ignore_errors=True)

    item("e", (), item_e)
    torch.cuda.empty_cache()
    for mod, name, kernel in kernels:
        setattr(mod, name, kernel)
    # (kernel, dtype, shape of the operand, sample or bucket count): the
    # sampled kernel's x is the transposed A, NB = 2^15 wide.
    want = {("rfut_rowwise_sampled", bf16, (RF_C_N, RF_C_M), 4 * RF_C_N),
            ("rfut_rowwise_sampled", f32, (RF_A_N, RF_A_M), 4 * RF_A_N),
            ("gather_scaled_rows", bf16, (NLA_M, NLA_N), 4 * NLA_N),
            ("scatter_rows", bf16, (NLA_M, NLA_N), 4 * NLA_N)}
    got = set()
    for sig in held:
        name, (shape, dtype) = sig[0], sig[1]
        count = {"rfut_rowwise_sampled": lambda: sig[4][0][0],
                 "gather_scaled_rows": lambda: sig[2][0][0],
                 "scatter_rows": lambda: sig[4]}.get(name, lambda: None)()
        got.add((name, dtype, shape, count))
    check(want <= got, f"refine: new signatures not held: {sorted(map(str, want - got))}")
    print(f"refine: {len(held)} kernel signatures held against their plain versions, the new "
          f"ones among them: {sorted(map(str, want))}")
    return held


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    sys.path.insert(0, str(HERE))
    import libskylark_tpu_torch as sky
    from libskylark_tpu_torch import _build
    from libskylark_tpu_torch.graph import stream as gs
    from libskylark_tpu_torch.sketch import kernels_fut as kf
    from libskylark_tpu_torch.sketch import kernels_scatter as ks
    from libskylark_tpu_torch.sketch import kernels_window as kw

    check(Path(sky.__file__).resolve().parent.parent == HERE,
          f"imported {sky.__file__}, not the package beside this script")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    rng = np.random.default_rng(SEED)

    def randn(*shape, dtype=torch.float32):
        return torch.from_numpy(
            rng.standard_normal(shape, dtype=np.float32)).to(dev, dtype)

    # -- 1. build --------------------------------------------------------
    build_s = _build.build_all()
    print(f"build: {len(_build.SOURCES)} kernel libraries in {build_s:.1f} s "
          f"({_build.BUILD_DIR})")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}")

    # -- 2. kernels against their plain versions -------------------------
    errs = {}
    x = randn(4096, 4096)
    d = torch.from_numpy(rng.choice([-1.0, 1.0], 4096).astype(np.float32)).to(dev)
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
        xx, dd = x.to(dtype), d.to(dtype)
        a, r = max_err(kf.rfut_rowwise(xx, dd, 4096), kf.rfut_rowwise_plain(xx, dd, 4096))
        print(f"rfut_rowwise (4096, 4096) {dtype}: max abs err {a:.3g}, rel {r:.3g} (tol {tol:g})")
        check(r <= tol, f"rfut_rowwise {dtype} disagrees with its plain version")
        errs.setdefault("rfut_rowwise", a)
    idx = torch.from_numpy(rng.integers(0, 4096, 1024).astype(np.int32)).to(dev)
    out = kf.rfut_rowwise_sampled(x, d, 4096, idx)
    a, r = max_err(out, kf.rfut_rowwise_sampled_plain(x, d, 4096, idx))
    _, r2 = max_err(out, kf.rfut_rowwise(x, d, 4096)[:, idx.long()] * math.sqrt(4096 / 1024))
    print(f"rfut_rowwise_sampled (4096, 4096) S=1024: max abs err {a:.3g}, rel {r:.3g}; "
          f"vs rfut_rowwise[:, idx]*sqrt(NB/S) rel {r2:.3g} (tol 1e-5)")
    check(r <= 1e-5 and r2 <= 1e-5, "rfut_rowwise_sampled disagrees")
    errs["rfut_rowwise_sampled"] = a
    # Each NB is its own kernel instance: check every one, with padding.
    sweep = 0.0
    for log2nb in range(7, 16):
        nb = 1 << log2nb
        xs, ds = randn(5, nb - 3), d.new_ones(nb - 3)
        ids = torch.from_numpy(rng.integers(0, nb, 256).astype(np.int32)).to(dev)
        for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
            xx, dd = xs.to(dtype), ds.to(dtype)
            _, r = max_err(kf.rfut_rowwise(xx, dd, nb), kf.rfut_rowwise_plain(xx, dd, nb))
            _, r2 = max_err(kf.rfut_rowwise_sampled(xx, dd, nb, ids),
                            kf.rfut_rowwise_sampled_plain(xx, dd, nb, ids))
            check(max(r, r2) <= tol, f"rfut at NB={nb} {dtype} disagrees: {r}, {r2}")
            if dtype == torch.float32:
                sweep = max(sweep, r, r2)
    print(f"rfut NB 2^7..2^15, n = NB - 3, f32 and bf16: f32 worst rel {sweep:.3g} (tol 1e-5)")
    # The warp-per-row kernel at NB = 128, 256: both load paths, row
    # independence and run-to-run bitwise.
    rfut_narrow_check(kf, dev)

    T = randn(1 << 20, 512)
    gidx = torch.from_numpy(rng.integers(0, 1 << 20, 2048).astype(np.int32)).to(dev)
    a, _ = max_err(kw.gather_scaled_rows(T, gidx, 0.3125),
                   kw.gather_scaled_rows_plain(T, gidx, 0.3125))
    print(f"gather_scaled_rows T (2^20, 512) S=2048: max abs err {a!r} (must be 0.0)")
    check(a == 0.0, "gather_scaled_rows is not bitwise equal to its plain version")
    errs["gather_scaled_rows"] = a
    # Bitwise its plain version at the main path's shape in bf16, the b
    # vector (m = 1) and m = 5 (a thread per element, the last block
    # part-empty), m = 4100 (five column tiles, the last part-empty), S = 1,
    # S = 1001, repeated rows.
    T_long = randn(4096, 4100)
    rep_idx = torch.from_numpy(rng.integers(0, 8, 2048).astype(np.int32)).to(dev)
    gather_cases = [
        ("T (2^20, 512) bf16, S=2048", T.bfloat16(), gidx),
        ("T (2^20, 1) f32, S=2048", T[:, :1].contiguous(), gidx),
        ("T (2^20, 5) f32, S=2048", T[:, :5].contiguous(), gidx),
        ("T (2^20, 5) bf16, S=2048", T[:, :5].contiguous().bfloat16(), gidx),
        ("T (4096, 4100) f32, S=2048", T_long, gidx % 4096),
        ("T (2^20, 512) f32, S=1", T, gidx[:1].contiguous()),
        ("T (2^20, 512) f32, S=1001", T, gidx[:1001].contiguous()),
        ("T (2^20, 512) f32, 2048 rows from 8", T, rep_idx),
        ("T (2^20, 512) bf16, 2048 rows from 8", T.bfloat16(), rep_idx),
    ]
    for label, T_, idx_ in gather_cases:
        check(torch.equal(kw.gather_scaled_rows(T_, idx_, 0.3125),
                          kw.gather_scaled_rows_plain(T_, idx_, 0.3125)),
              f"gather_scaled_rows {label} is not bitwise its plain version")
    # An index out of range poisons its row with NaN; the other rows stay
    # bitwise (the plain version is given the indices clamped).
    for T_ in (T, T[:, :5].contiguous()):
        bad_idx = gidx.clone()
        bad_idx[::97] = -1
        bad_idx[1::89] = T_.shape[0]
        out = kw.gather_scaled_rows(T_, bad_idx, 0.3125)
        bad = (bad_idx < 0) | (bad_idx >= T_.shape[0])
        check(bool(out[bad].isnan().all()) and torch.equal(
            out[~bad], kw.gather_scaled_rows_plain(T_, bad_idx.clamp(0, T_.shape[0] - 1),
                                                   0.3125)[~bad]),
              "gather_scaled_rows does not poison rows of indices out of range")
    print(f"gather_scaled_rows: bitwise its plain version at {len(gather_cases)} more shapes "
          "(bf16, m = 1, 5, 4100, S = 1, 1001, repeated rows); indices out of range give NaN rows")
    del T_long, rep_idx, gather_cases, T_, idx_, bad_idx, out, bad

    def rows_partition_bitwise(b, segs):
        """kw.scatter_partition bitwise kw.scatter_partition_plain (the kept prefix)."""
        sk, se, ss = kw.scatter_partition(b, segs)
        pk, pe, pss = kw.scatter_partition_plain(b, segs)
        n = int(pss[-1])
        return torch.equal(ss, pss) and torch.equal(sk[:n], pk[:n]) and torch.equal(se[:n], pe[:n])

    def host_bitwise(out, A, b, v, segs):
        """The kernel's result bitwise scatter_rows_plain on CPU copies (an
        index_add_ of the rows in entry order); if the CPU index_add_ is
        not in index order, bitwise a numpy in-order sum instead."""
        Ac, bc, vc = A.cpu(), b.cpu(), v.cpu()
        out = out.cpu()
        if torch.equal(out, kw.scatter_rows_plain(Ac, bc, vc, segs)):
            return "scatter_rows_plain on CPU copies"
        rows = (vc.T[:, :, None] * Ac.float()[:, None, :]).reshape(-1, A.shape[1]).numpy()
        ref = np.zeros((segs, A.shape[1]), np.float32)
        np.add.at(ref, bc.T.reshape(-1).numpy(), rows)  # unbuffered, in index order
        check(np.array_equal(out.numpy(), ref), "scatter_rows is bitwise neither the CPU "
              "plain version nor a numpy in-order sum")
        return "a numpy in-order sum (the CPU index_add_ is not in index order)"

    # scatter_rows at the LS path's shapes (A 2^20 x 512, the b vector
    # 2^20 x 1, 2048 buckets) and SJLT's nnz = 4 at k = 2^18, cut so that
    # the host's 4 * 2^18 rows of 512 f32 (2 GiB) fit.
    worst = 0.0
    for nnz, k_, cols in ((1, 1 << 20, 512), (1, 1 << 20, 1), (4, 1 << 18, 512)):
        A = T[:k_, :cols].contiguous()
        b = torch.from_numpy(rng.integers(0, 2048, (nnz, k_)).astype(np.int32)).to(dev)
        v = randn(nnz, k_)
        out = kw.scatter_rows(A, b, v, 2048)
        a, r = max_err(out, kw.scatter_rows_plain(A, b, v, 2048))
        worst = max(worst, a)
        what = host_bitwise(out, A, b, v, 2048)
        print(f"scatter_rows A ({k_}, {cols}) -> 2048, nnz={nnz}: bitwise {what}; vs plain "
              f"on the card max abs err {a:.3g}, rel {r:.3g} (tol 1e-5)")
        check(r <= 1e-5, f"scatter_rows nnz={nnz} m={cols} disagrees with its plain version")
        check(torch.equal(out, kw.scatter_rows(A, b, v, 2048)),
              f"scatter_rows nnz={nnz} m={cols} differs run to run")
        acc = randn(2048, cols)
        check(torch.equal(kw.scatter_rows(A, b, v, 2048, acc=acc), acc + out),
              f"scatter_rows nnz={nnz} m={cols} acc fold is not bitwise acc + scatter_rows")
        check(rows_partition_bitwise(b, 2048),
              f"scatter_partition nnz={nnz} is not bitwise scatter_partition_plain")
        if nnz == 1:
            # 1 % of the buckets moved out of range on both sides: bitwise
            # the result of the kept entries alone.
            bad = torch.from_numpy(rng.choice(k_, k_ // 100, replace=False)).to(dev)
            b_bad = b.clone()
            b_bad[0, bad] = torch.where(bad % 2 == 0, -1 - bad % 1000, 2048 + bad % 1000).int()
            keep = (b_bad[0] >= 0) & (b_bad[0] < 2048)
            out_bad = kw.scatter_rows(A, b_bad, v, 2048)
            check(torch.equal(out_bad, kw.scatter_rows(A[keep].contiguous(), b_bad[:, keep],
                                                       v[:, keep], 2048)),
                  f"scatter_rows m={cols} does not drop buckets out of range")
            # The plain version drops them too: bitwise on CPU copies.
            check(torch.equal(out_bad.cpu(), kw.scatter_rows_plain(A.cpu(), b_bad.cpu(),
                                                                   v.cpu(), 2048)),
                  f"scatter_rows m={cols} with buckets out of range is not bitwise its "
                  "plain version on CPU copies")
            check(rows_partition_bitwise(b_bad, 2048), "scatter_partition with buckets out "
                  "of range is not bitwise scatter_partition_plain")
            # A hot bucket with half the entries, cut into pieces of kw._L,
            # on HOT_DRAWS draws: held to the rounding-error bound of the
            # kernel's order of additions, which a sum with one piece left
            # out misses.
            for draw in range(HOT_DRAWS):
                b_hot = b.clone()
                b_hot[0, torch.from_numpy(rng.choice(k_, k_ // 2, replace=False)).to(dev)] = 7
                v_hot = randn(nnz, k_)
                hot = kw.scatter_rows(A, b_hot, v_hot, 2048)
                exact, err_bound, (row, piece) = scatter_error_bound(A, b_hot, v_hot, 2048, kw._L)
                r_hot = bound_ratio(hot, exact, err_bound)
                r_plain = bound_ratio(kw.scatter_rows_plain(A, b_hot, v_hot, 2048), exact,
                                      err_bound)
                r_ctl = float((piece.abs() / err_bound[row]).max())
                print(f"scatter_rows A ({k_}, {cols}), {k_ // 2} entries in one bucket, draw "
                      f"{draw}: max |out - exact| / rounding bound {r_hot:.3g} (must be <= 1; "
                      f"plain version, whose atomics add in no fixed order, {r_plain:.3g}); "
                      f"control (bucket {row}'s first piece left out) {r_ctl:.3g}")
                check(r_hot <= 1.0, f"scatter_rows hot bucket m={cols} draw {draw}: error "
                      f"{r_hot} times its rounding bound")
                check(r_ctl > 1.0, f"scatter_rows hot bucket m={cols}: the control passes")
                if draw == 0:
                    check(torch.equal(hot, kw.scatter_rows(A, b_hot, v_hot, 2048)),
                          f"scatter_rows hot bucket m={cols} differs run to run")
                    check(torch.equal(kw.scatter_rows(A, b_hot, v_hot, 2048, acc=acc),
                                      acc + hot),
                          f"scatter_rows hot bucket m={cols} acc fold is not bitwise")
                del exact, err_bound, piece
            print("scatter_rows: 1 % of buckets out of range: bitwise the kept entries' result "
                  "and the plain version on CPU copies")
            del b_bad, keep, out_bad, b_hot, v_hot, hot
    print("scatter_rows: bitwise run to run, acc fold bitwise acc + out, scatter_partition "
          "bitwise scatter_partition_plain")
    errs["scatter_rows"] = worst
    del T, A, b, v, out, acc
    torch.cuda.synchronize()

    def partition_bitwise(vals, keys, segs):
        """ks.partition bitwise ks.partition_plain (the kept prefix)."""
        sk, sv, ps = ks.partition(vals, keys, segs)
        pk, pv, pps = ks.partition_plain(vals, keys, segs)
        n = int(pps[-1])
        return (torch.equal(ps, pps) and torch.equal(sk[:n], pk[:n])
                and torch.equal(sv[:n].view(torch.int32), pv[:n].view(torch.int32)))

    # segment_sum_flat at the sparse sketch's shape: random, adversarial
    # (partition edges, one hot slot with half the entries) and small keys.
    nnz, tt = SP_NNZ, SP_S * SP_COLS
    pv = ks._V
    edges = np.array([0, pv - 1, pv, 2 * pv - 1, tt - 1], np.int32)
    adversarial = np.concatenate([np.repeat(edges, 1000), np.full(nnz // 2, pv + 7, np.int32),
                                  rng.integers(0, tt, nnz - 5000 - nnz // 2).astype(np.int32)])
    rng.shuffle(adversarial)
    cases = [("random", rng.integers(0, tt, nnz).astype(np.int32), tt),
             ("adversarial", adversarial, tt),
             ("small", rng.integers(0, 37, 100).astype(np.int32), 37)]
    worst = 0.0
    for label, keys_np, segs in cases:
        keys = torch.from_numpy(keys_np).to(dev)
        n_ = keys.shape[0]
        for dtype in (torch.float32, torch.bfloat16):
            vals = randn(n_).to(dtype)
            out = ks.segment_sum_flat(vals, keys, segs)
            plain = ks.segment_sum_flat_plain(vals, keys, segs)
            tol = 1e-5
            if label == "adversarial":
                # A slot with 5e6 entries: an f32 sum of them is off by
                # ~sqrt(n)*eps in any order, so the kernel and its plain
                # version are each held against the f64 sum; a bf16
                # result may round to the neighbouring bf16 value.
                tol = 1e-5 if dtype == torch.float32 else torch.finfo(dtype).eps
                ref = torch.zeros(segs, dtype=torch.float64, device=dev).index_add_(
                    0, keys, vals.double())
                _, r_plain = max_err(plain, ref)
                print(f"segment_sum_flat {label} {dtype}: plain version vs f64 sum rel "
                      f"{r_plain:.3g}")
            else:
                ref = plain
            a, r = max_err(out, ref)
            check(r <= tol, f"segment_sum_flat {label} {dtype} disagrees: rel {r}")
            check(torch.equal(out, ks.segment_sum_flat(vals, keys, segs)),
                  f"segment_sum_flat {label} {dtype} differs run to run")
            dyadic = torch.from_numpy(
                rng.choice([-1.0, -0.5, 0.5, 1.0], n_).astype(np.float32)).to(dev, dtype)
            check(torch.equal(ks.segment_sum_flat(dyadic, keys, segs),
                              ks.segment_sum_flat_plain(dyadic, keys, segs)),
                  f"segment_sum_flat {label} {dtype} not bitwise on dyadic values")
            check(partition_bitwise(vals, keys, segs),
                  f"partition {label} {dtype} is not bitwise partition_plain")
            if tol == 1e-5:
                worst = max(worst, a)
            print(f"segment_sum_flat {label} {n_} -> {segs} {dtype}: max abs err {a:.3g}, "
                  f"rel {r:.3g} vs {'f64 sum' if ref is not plain else 'plain'} (tol {tol:g}); "
                  "bitwise run to run and on dyadic values; partition bitwise partition_plain")
    errs["segment_sum_flat"] = worst
    # Keys out of range are dropped: 1 % of the random keys moved outside
    # [0, T) on both sides give bitwise the sum of the entries kept.
    keys_np = cases[0][1].copy()
    bad = rng.choice(nnz, nnz // 100, replace=False)
    keys_np[bad] = np.where(np.arange(bad.size) % 2 == 0, -1 - bad % 1000, tt + bad % 1000)
    keys = torch.from_numpy(keys_np).to(dev)
    keep = (keys >= 0) & (keys < tt)
    vals = randn(nnz)
    check(partition_bitwise(vals, keys, tt), "partition with keys out of range is not "
          "bitwise partition_plain")
    out = ks.segment_sum_flat(vals, keys, tt)
    check(torch.equal(out, ks.segment_sum_flat(vals[keep], keys[keep], tt)),
          "segment_sum_flat does not drop keys out of range")
    # The plain version drops them too.  On the card it adds by float
    # atomics in no fixed order, so the two are held bitwise on dyadic
    # values, whose sums are exact in any order.
    dyadic = torch.from_numpy(rng.choice([-1.0, -0.5, 0.5, 1.0], nnz).astype(np.float32)).to(dev)
    check(torch.equal(ks.segment_sum_flat(dyadic, keys, tt),
                      ks.segment_sum_flat_plain(dyadic, keys, tt)),
          "segment_sum_flat with keys out of range is not bitwise its plain version")
    print(f"segment_sum_flat/partition with {bad.size} keys out of range: partition bitwise "
          "partition_plain, sum bitwise the sum of the kept entries and, on dyadic values, "
          "the plain version")
    del keys, vals, keep, out, plain, ref, dyadic, adversarial, cases, keys_np
    torch.cuda.synchronize()

    # -- 3. main path ----------------------------------------------------
    wrappers = {
        "rfut_rowwise": kf.rfut_rowwise,
        "rfut_rowwise_sampled": kf.rfut_rowwise_sampled,
        "gather_scaled_rows": kw.gather_scaled_rows,
        "scatter_rows": kw.scatter_rows,
        "segment_sum_flat": ks.segment_sum_flat,
    }
    launches = dict.fromkeys(wrappers, 0)
    path_launches = {}
    rfut_by_nb = {}  # path -> rfut_rowwise's launches by NB

    def reset_counts():
        for w in wrappers.values():
            w.launches = 0
        wrappers["rfut_rowwise"].launches_by_nb = {}

    def read_counts(path, t0, expect):
        counts = {name: w.launches for name, w in wrappers.items()}
        print(f"{path} path: {time.perf_counter() - t0:.1f} s, launches {counts}")
        for name in expect:
            check(counts[name] > 0, f"kernel {name} was not launched on the {path} path")
        for name, count in counts.items():
            launches[name] += count
        path_launches[path] = counts
        rfut_by_nb[path] = dict(wrappers["rfut_rowwise"].launches_by_nb)
        if rfut_by_nb[path]:
            print(f"{path} path: rfut_rowwise launches by NB {rfut_by_nb[path]}")
        return counts

    reset_counts()
    t_main = time.perf_counter()

    def ls_check(label, A, b, x_ref_res, **kw_):
        runs = []
        for _ in range(LS_REPEATS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            x_hat = sky.linalg.approximate_least_squares(
                A, b, sky.SketchContext(seed=SEED), sky.linalg.LeastSquaresParams(**kw_))
            torch.cuda.synchronize()
            runs.append(time.perf_counter() - t0)
        secs = statistics.median(runs)
        check(tuple(x_hat.shape) == (A.shape[1],) and bool(torch.isfinite(x_hat).all()),
              f"{label}: solution not finite of shape ({A.shape[1]},)")
        res = float(torch.linalg.vector_norm(A @ x_hat - b))
        ratio = res / x_ref_res
        print(f"LS {label}: residual {res:.6g}, lstsq {x_ref_res:.6g}, ratio {ratio:.4f} "
              f"(bound {LS_RATIO_BOUND}), median {secs!r} s of {[round(r, 4) for r in runs]}")
        check(ratio <= LS_RATIO_BOUND, f"{label}: residual ratio {ratio} above bound")

    def lstsq_residual(A, b):
        x_ls = torch.linalg.lstsq(A, b[:, None]).solution[:, 0]
        return float(torch.linalg.vector_norm(A @ x_ls - b))

    m, n = 1 << 20, 512
    A = randn(m, n)
    b = A @ randn(n) + randn(m)
    ref = lstsq_residual(A, b)
    ls_check("FJLT 2^20 x 512, s=2048", A, b, ref, sketch_size=2048)
    ls_check("CWT 2^20 x 512, s=2048", A, b, ref, sketch_type="CWT", sketch_size=2048)
    del A, b
    A = randn(32768, 1024)
    b = A @ randn(1024) + randn(32768)
    ls_check("FJLT 32768 x 1024, s=4096", A, b, lstsq_residual(A, b), sketch_size=4096)
    del A, b
    A = randn(131072, 4096)
    for s in (1024, 1000):
        S = sky.sketch.FJLT(4096, s, sky.SketchContext(seed=SEED))
        out = S.apply(A, "rowwise")
        torch.cuda.synchronize()
        check(tuple(out.shape) == (131072, s) and bool(torch.isfinite(out).all()),
              f"FJLT rowwise S={s}: bad output")
        rows = A[:256].cpu()
        _, r = max_err(out[:256].cpu(), S.apply(rows, "rowwise"))
        norm_ratio = float(out.norm() / A.norm())
        print(f"FJLT(4096, {s}) rowwise on (131072, 4096): rows 0-255 vs CPU plain "
              f"path rel err {r:.3g} (tol 1e-5), ||SA||/||A|| = {norm_ratio:.4f}")
        check(r <= 1e-5, f"FJLT rowwise S={s} disagrees with the CPU plain path")
        check(0.9 < norm_ratio < 1.1, f"FJLT rowwise S={s}: norm ratio {norm_ratio}")
    del out
    read_counts("least-squares", t_main,
                ("rfut_rowwise", "rfut_rowwise_sampled", "gather_scaled_rows", "scatter_rows"))

    # -- 3b. sparse hash sketch (bench.py bench_sparse_cwt's shape) ------
    t0 = time.perf_counter()
    sp_idx = np.stack([rng.integers(0, SP_ROWS, SP_NNZ), rng.integers(0, SP_COLS, SP_NNZ)], 1)
    sp_data = rng.standard_normal(SP_NNZ, dtype=np.float32)
    shape = (SP_ROWS, SP_COLS)
    A_cpu = sky.utils.coo_from_bcoo_arrays(sp_data, sp_idx, shape, device="cpu")
    A_sp = sky.utils.coo_from_bcoo_arrays(sp_data, sp_idx, shape, device=dev)
    a_norm2 = float(A_sp.coalesce()._values().double().square().sum())
    del sp_idx, sp_data
    print(f"sparse A {shape}, {SP_NNZ} nonzeros (uncoalesced COO), made in "
          f"{time.perf_counter() - t0:.1f} s")
    reset_counts()
    t0 = time.perf_counter()
    sketches = {"CWT": sky.sketch.CWT(SP_ROWS, SP_S, sky.SketchContext(seed=SEED)),
                "SJLT": sky.sketch.SJLT(SP_ROWS, SP_S, sky.SketchContext(seed=SEED), nnz=4)}
    dense_out = {}
    for name, S in sketches.items():
        runs = []
        for _ in range(3):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = S.apply(A_sp, "columnwise", dense_output=True)
            torch.cuda.synchronize()
            runs.append(time.perf_counter() - t1)
        check(tuple(out.shape) == (SP_S, SP_COLS) and bool(torch.isfinite(out).all()),
              f"{name} sparse sketch: bad output")
        ref = S.apply(A_cpu, "columnwise", dense_output=True)  # CPU: plain segment sum
        _, r = max_err(out.cpu(), ref)
        ratio = float(out.double().square().sum()) / a_norm2
        print(f"{name}({SP_ROWS}, {SP_S}) sparse -> dense {tuple(out.shape)}: vs plain rel err "
              f"{r:.3g} (tol 1e-5), ||SA||^2/||A||^2 = {ratio:.4f} (1 +- 0.05), median "
              f"{statistics.median(runs)!r} s of {[round(x, 4) for x in runs]}")
        check(r <= 1e-5, f"{name} sparse sketch disagrees with the plain route")
        check(abs(ratio - 1.0) <= 0.05, f"{name} sparse sketch norm ratio {ratio}")
        dense_out[name] = out
    del out, ref
    S = sketches["CWT"]
    sp_out = S.apply(A_sp, "columnwise")
    check(sp_out.layout == torch.sparse_coo, "CWT sparse output is not sparse COO")
    _, r = max_err(sp_out.to_dense(), dense_out["CWT"])
    print(f"CWT sparse -> sparse: {sp_out._nnz()} stored entries, to_dense vs dense output "
          f"rel err {r:.3g} (tol 1e-5)")
    check(r <= 1e-5, "CWT sparse output disagrees with the dense output")
    read_counts("sparse sketch", t0, ("segment_sum_flat",))
    # The segment sum the CWT apply launched, kept for the times below.
    rows_sp, cols_sp = A_sp._indices()
    sp_keys = (S.buckets(device=dev).long()[rows_sp] * SP_COLS + cols_sp).int()
    sp_vals = A_sp._values() * S.values(device=dev)[rows_sp]
    del A_cpu, sp_out, dense_out, rows_sp, cols_sp, sketches, S

    # -- 3c. adjacency sketch + Nyström ASE, com-LiveJournal scale -------
    t0 = time.perf_counter()
    n = LJ_VERTICES
    n_in = int(LJ_EDGES * LJ_INTRA)
    blk = rng.integers(0, LJ_BLOCKS, n_in)
    per = n // LJ_BLOCKS  # block b holds the vertices congruent to b mod 16
    u = np.concatenate([rng.integers(0, per, n_in) * LJ_BLOCKS + blk,
                        rng.integers(0, n, LJ_EDGES - n_in)])
    v = np.concatenate([rng.integers(0, per, n_in) * LJ_BLOCKS + blk,
                        rng.integers(0, n, LJ_EDGES - n_in)])
    lo, hi = np.minimum(u, v), np.maximum(u, v)
    # Drop self-loops; dedupe (lo, hi) as one int64 by a sort and a
    # neighbour compare (numpy 2.3's np.unique is far slower than the
    # sort on these 35M codes).
    code = (lo * n + hi)[lo != hi]
    code.sort()
    code = code[np.concatenate(([True], code[1:] != code[:-1]))]
    lo, hi = code // n, code % n
    del blk, u, v, code
    t_made = time.perf_counter() - t0
    g_idx = torch.from_numpy(np.stack([np.concatenate([lo, hi]), np.concatenate([hi, lo])]))
    A_cpu = torch.sparse_coo_tensor(g_idx, torch.ones(g_idx.shape[1]), (n, n),
                                    check_invariants=False)
    A_g = A_cpu.to(dev)
    torch.cuda.synchronize()
    print(f"graph: {n} vertices, {lo.size} edges, {g_idx.shape[1]} stored entries, drawn and "
          f"deduplicated in {t_made:.1f} s, on the card after {time.perf_counter() - t0:.1f} s")
    del g_idx
    S_g = sky.sketch.SJLT(n, 2 * ASE_K, sky.SketchContext(seed=SEED))
    reset_counts()
    t0 = time.perf_counter()
    sk_runs, eig_runs = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        SA = gs.incore_adjacency_sketch(A_g, S_g, dtype=torch.float32)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        V, lam = gs.ase_from_sketch(SA, S_g, ASE_K)
        torch.cuda.synchronize()
        sk_runs.append(t2 - t1)
        eig_runs.append(time.perf_counter() - t2)
    read_counts("graph", t0, ("segment_sum_flat",))
    SA_ref = gs.incore_adjacency_sketch(A_cpu, S_g)  # CPU: plain segment sum
    g_err, _ = max_err(SA.cpu(), SA_ref)
    check(torch.equal(SA.cpu(), SA_ref), "adjacency sketch is not bitwise the plain route")
    X = V * lam.abs().sqrt()[None, :]
    check(tuple(X.shape) == (n, ASE_K) and bool(torch.isfinite(X).all()),
          "ASE embedding not finite of shape (n, k)")
    _, lam_cpu = gs.ase_from_sketch(SA.cpu(), S_g, ASE_K)
    lam_err = float((lam.cpu().sort().values - lam_cpu.sort().values).abs().max()
                    / lam_cpu.abs().max())
    print(f"adjacency sketch SJLT({n}, {2 * ASE_K}): SA {tuple(SA.shape)} bitwise equal to "
          f"the plain route; median {statistics.median(sk_runs)!r} s of "
          f"{[round(x, 4) for x in sk_runs]}")
    print(f"ASE k={ASE_K}: top |lam| {float(lam.abs().max()):.4f}, lam vs CPU eigensolve rel "
          f"{lam_err:.3g} (tol 1e-4), median {statistics.median(eig_runs)!r} s of "
          f"{[round(x, 4) for x in eig_runs]}")
    check(lam_err <= 1e-4, f"ASE eigenvalues differ from the CPU eigensolve: {lam_err}")
    rows_g, cols_g = A_g._indices()
    g_keys = (S_g.buckets(0, n, device=dev).long()[rows_g] * n + cols_g).int()
    g_vals = A_g._values() * S_g.values(torch.float32, 0, n, device=dev)[rows_g]
    graph = (lo, hi, SA_ref, lam.cpu(), S_g)  # phase 3g streams the same edges
    del A_cpu, A_g, SA, V, X, rows_g, cols_g
    torch.cuda.synchronize()

    # -- 3d. random-feature kernel machine: flagship and full-width predict
    ml_path(sky, dev, reset_counts, read_counts)

    # -- 3e. randomized NLA, f32 at full width (A_sp: phase 3b's COO) ------
    nla_path(sky, dev, reset_counts, read_counts, A_sp)
    del A_sp

    # -- 3f. the kernel machine's training path, at full width ------------
    train_path(sky, dev, reset_counts, read_counts, smi)

    # -- 3g. out-of-core streaming, at full width -------------------------
    chunk = stream_path(sky, dev, reset_counts, read_counts, smi, graph)

    # -- 3h. the remaining sketches and the graph analytics ----------------
    sketches_path(sky, dev, reset_counts, read_counts, smi, graph)
    del graph

    # -- 3i. mixed-precision refinement and the routes around it ----------
    refine_held = refine_path(sky, dev, reset_counts, read_counts, smi)

    # -- 4. times at main-path shapes ------------------------------------
    kernels = []

    def row(name, source, replaces, ms, plain_ms, bytes_moved, ops, library_ms,
            path_count=None, err=None, shape=None, split=None):
        b_ms, by = bound(bytes_moved, ops)
        by_path = {p: c[name] for p, c in path_launches.items() if c[name]}
        # Phase 3i's items, and their sum under "refine", on every row.
        by_path["refine"] = sum(c[name] for p, c in path_launches.items()
                                if p.startswith("refine ("))
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name] if path_count is None else path_count,
            "launches_by_path": by_path,
            # The signatures phase 3i held against the plain version.
            "refine_held": sorted(str(sig[1:]).replace("torch.", "")
                                  for sig in refine_held if sig[0] == name),
            "max_abs_err": errs[name] if err is None else err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by,
            "library_ms": library_ms, **({"shape": shape} if shape else {}), **(split or {}),
        })
        print(f"time {name}{f' {shape}' if shape else ''}: {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {b_ms:.4f} ms ({by}), library {library_ms}")

    def at_nb(nb):
        """rfut_rowwise's launches at width ``nb``, by path."""
        return {p: c[nb] for p, c in rfut_by_nb.items() if c.get(nb)}

    rm, rn = 131072, 4096
    d = torch.from_numpy(rng.choice([-1.0, 1.0], rn).astype(np.float32)).to(dev)
    wht_ops = rm * (rn * math.log2(rn) + rn)
    row("rfut_rowwise", "libskylark_tpu_torch/csrc/rfut.cu",
        "libskylark_tpu/sketch/pallas_fut.py:192",
        time_ms(lambda: kf.rfut_rowwise(A, d, rn)),
        time_ms(lambda: kf.rfut_rowwise_plain(A, d, rn), reps=3, warmup=1),
        4 * (rm * rn + rn + rm * rn), wht_ops, None, split={"launches_at_nb": at_nb(rn)})
    # The warp-per-row widths: NB = 128 at BlockADMM's Fastfood shape (two
    # launches per block of 128 features on the train path) and NB = 256 on
    # the same 2^25 elements, from the sweep over NB, on draws of their own.
    # ``launches`` counts the launches at that width; where no path runs
    # the width, the kernel's launches on all paths, as the NB = 4096 row.
    sweep = rfut_sweep(kf, dev)
    for nb in (128, 256):
        w = sweep[nb]
        row("rfut_rowwise", "libskylark_tpu_torch/csrc/rfut.cu",
            "libskylark_tpu/sketch/pallas_fut.py:192", w["ms"], w["plain_ms"], w["bytes"],
            w["ops"], None, path_count=sum(at_nb(nb).values()) or None, err=w["err"],
            shape=f"x {RFUT_SWEEP_ELEMS // nb} x {nb} f32, NB = {nb}"
                  + (" (Fastfood in BlockADMM)" if nb == ADMM_D else ""),
            split={"launches_at_nb": at_nb(nb)})
    sidx = torch.from_numpy(rng.integers(0, rn, 1024).astype(np.int32)).to(dev)
    row("rfut_rowwise_sampled", "libskylark_tpu_torch/csrc/rfut.cu",
        "libskylark_tpu/sketch/pallas_fut.py:150",
        time_ms(lambda: kf.rfut_rowwise_sampled(A, d, rn, sidx)),
        time_ms(lambda: kf.rfut_rowwise_sampled_plain(A, d, rn, sidx), reps=3, warmup=1),
        4 * (rm * rn + rn + rm * 1024) + 4 * 1024, wht_ops, None)
    del A
    T = randn(1 << 20, 512)
    # gather_scaled_rows as the FJLT LS path meets it.  A: the WHT has just
    # written all 2 GiB of T, so the rows come in cold, and the sampler has
    # just written the indices, so they are warm: a run of GATHER_RUN
    # launches, each with its own 2048 indices, after an L2 flush and a read
    # of the indices.  b (m = 1): the b WHT has just written those 4 MB, so
    # all warm.  Both rows carry the path's launch count (one A and one b
    # gather per solve).
    idx_all = torch.from_numpy(
        rng.integers(0, 1 << 20, (GATHER_RUN, 2048)).astype(np.int32)).to(dev)
    run_idx = list(idx_all)
    flush = torch.zeros(L2_FLUSH_BYTES // 4, device=dev)
    scale = torch.tensor(0.3125, device=dev)
    uniq = statistics.mean(int(torch.unique(i).numel()) for i in run_idx)
    for cols, fl in ((512, flush), (1, None)):
        Tg = T if cols == 512 else T[:, :1].contiguous()

        def per_launch(fn):
            return time_launches([lambda i=i: fn(Tg, i) for i in run_idx], flush=fl,
                                 warm=idx_all)

        row("gather_scaled_rows", "libskylark_tpu_torch/csrc/window.cu",
            "libskylark_tpu/sketch/pallas_window.py:364",
            per_launch(lambda t, i: kw.gather_scaled_rows(t, i, 0.3125)),
            per_launch(lambda t, i: kw.gather_scaled_rows_plain(t, i, 0.3125)),
            4 * (uniq * cols + 2048 * cols) + 4 * 2048, 2048 * cols,
            per_launch(lambda t, i: torch.index_select(t, 0, i) * scale),
            path_count=path_launches["least-squares"]["gather_scaled_rows"],
            shape=f"T 2^20 x {cols} f32, S = 2048, rows {'cold' if fl is not None else 'warm'}"
                  f", per launch of {GATHER_RUN}")
    del idx_all, run_idx, flush, Tg
    # scatter_rows at the CWT LS path's two shapes, A and the b vector; the
    # path's launch count (one A and one b apply per solve) is on both rows.
    b = torch.from_numpy(rng.integers(0, 2048, (1, 1 << 20)).astype(np.int32)).to(dev)
    v = torch.from_numpy(rng.choice([-1.0, 1.0], (1, 1 << 20)).astype(np.float32)).to(dev)
    b_flat = b[0].long()
    p1 = time_ms(lambda: kw.scatter_partition(b, 2048))
    for cols in (512, 1):
        A = T if cols == 512 else T[:, :1].contiguous()
        vA = v[0][:, None] * A
        lib_out = torch.zeros(2048, cols, device=dev)
        ms = time_ms(lambda: kw.scatter_rows(A, b, v, 2048))
        row("scatter_rows", "libskylark_tpu_torch/csrc/window.cu",
            "libskylark_tpu/sketch/pallas_window.py:228", ms,
            time_ms(lambda: kw.scatter_rows_plain(A, b, v, 2048), reps=3, warmup=1),
            4 * ((1 << 20) * cols + 2 * (1 << 20) + 2048 * cols), 2 * (1 << 20) * cols,
            time_ms(lambda: lib_out.index_add_(0, b_flat, vA)),
            path_count=path_launches["least-squares"]["scatter_rows"],
            shape=f"A 2^20 x {cols} f32 -> 2048, nnz = 1",
            split={"pass1_ms": p1, "pass2_ms": ms - p1})
        print(f"scatter_rows (2^20, {cols}): total {ms:.4f} ms = pass 1 {p1:.4f} ms + pass 2 "
              f"{ms - p1:.4f} ms")
        del vA, lib_out
    del T, A
    # scatter_rows with its acc fold at the stream chunk's shape (phase 3g
    # (a)): one launch per chunk of the fused fold, at its launch count.
    Xc = chunk["X"]
    b, v = chunk["S"]._slice_hashes(0, ST_CHUNK, torch.float32, dev)
    acc_c = randn(ST_S, ST_N)
    vX = v[0][:, None] * Xc
    lib_acc = acc_c.clone()
    p1 = time_ms(lambda: kw.scatter_partition(b, ST_S))
    ms = time_ms(lambda: kw.scatter_rows(Xc, b, v, ST_S, acc=acc_c))
    row("scatter_rows", "libskylark_tpu_torch/csrc/window.cu",
        "libskylark_tpu/sketch/pallas_window.py:228", ms,
        time_ms(lambda: kw.scatter_rows_plain(Xc, b, v, ST_S, acc=acc_c), reps=3, warmup=1),
        4 * (ST_CHUNK * ST_N + 2 * ST_CHUNK + 2 * ST_S * ST_N), 2 * ST_CHUNK * ST_N + ST_S * ST_N,
        time_ms(lambda: lib_acc.index_add_(0, b[0].long(), vX)),
        path_count=path_launches["streaming"]["scatter_rows"], err=chunk["err"],
        shape=f"A {ST_CHUNK} x {ST_N} f32 -> {ST_S}, nnz = 1, acc folded (stream chunk)",
        split={"pass1_ms": p1, "pass2_ms": ms - p1})
    print(f"scatter_rows (acc, {ST_CHUNK} x {ST_N}): total {ms:.4f} ms = pass 1 {p1:.4f} ms + "
          f"pass 2 {ms - p1:.4f} ms")
    del chunk, Xc, b, v, acc_c, vX, lib_acc

    for path, keys, vals, segs, err in (
            ("sparse sketch", sp_keys, sp_vals, SP_S * SP_COLS, errs["segment_sum_flat"]),
            ("graph", g_keys, g_vals, 2 * ASE_K * LJ_VERTICES, g_err)):
        nnz = keys.shape[0]
        check(partition_bitwise(vals, keys, segs),
              f"partition at the {path} path's shape is not bitwise partition_plain")
        lib_out = torch.zeros(segs, device=dev)
        ms = time_ms(lambda: ks.segment_sum_flat(vals, keys, segs), reps=5)
        # Pass 1 alone, and each of its levels alone (level 2 on level 1's
        # output); pass 2 is the total less pass 1.
        plan = ks._plan(nnz, segs)
        p1 = time_ms(lambda: ks.partition(vals, keys, segs), reps=5)
        l1 = time_ms(lambda: ks._level1(vals, keys, segs, plan), reps=5)
        lvl1 = ks._level1(vals, keys, segs, plan)
        l2 = time_ms(lambda: ks._level2(*lvl1, plan), reps=5)
        del lvl1
        split = {"pass1_ms": p1, "level1_ms": l1, "level2_ms": l2, "pass2_ms": ms - p1}
        row("segment_sum_flat", "libskylark_tpu_torch/csrc/scatter.cu",
            "libskylark_tpu/sketch/pallas_scatter.py:218", ms,
            time_ms(lambda: ks.segment_sum_flat_plain(vals, keys, segs), reps=5),
            8 * nnz + 4 * segs, nnz,
            time_ms(lambda: lib_out.zero_().index_add_(0, keys, vals), reps=5),
            path_count=path_launches[path]["segment_sum_flat"], err=err,
            shape=f"{nnz} -> {segs} f32 ({path})", split=split)
        print(f"segment_sum_flat ({path}): total {ms:.4f} ms = pass 1 {p1:.4f} ms (level 1 "
              f"{l1:.4f} ms, level 2 {l2:.4f} ms) + pass 2 {ms - p1:.4f} ms; partition bitwise "
              "partition_plain")
        del lib_out

    print(json.dumps({"kernels": kernels}))
    print(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
