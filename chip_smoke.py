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
  a 2^21 x 512 A (4 GiB) in 32 pinned batches, killed after batch 17
  and resumed; the north-star streaming KRR at 10^7 x 4096 -> 2048 bf16
  with its check at n = 2^20; the streaming randomized SVD of a rank-100
  2^20 x 1024 matrix in bf16 panels; the graph of the third path
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
  held against an f64 solve at 1e-9 beside a control that misses;
- the learned policy (``policy_path``), each item against a fresh profile
  store: the 2^20 x 512 LS problem walked up the store's ladder (the
  sketch shrinking 2048 -> 1536 -> 1152 -> 1024, bf16-first, then
  fp8-first) with FJLT and CWT, and the same at 32768 x 768 (where a
  learned S = 1728 takes ``rfut_rowwise`` at NB = 2^15), each rung timed
  beside the f32 solve at the same S; the fp8 and bf16 escalation drills
  and the e4m3 rounding on the card; the learned exact, Blendenpik and
  refine routes; approximate KRR bf16-first at 131072 x 4096 -> 2048 and
  streaming LS's throughput record.  Each solve is held to its route's
  bound beside a control that misses;
- the plans layer (``plans_path``): the LS solves at 2^20 x 512 (FJLT,
  CWT) and 32768 x 768 (FJLT) through captured CUDA graphs against the
  same calls with ``SKYLARK_NO_PLANS=1``, bitwise, replayed in another
  order, eager / cold / warm seconds; the stream chunk through
  ``plans.accumulate_slice`` (windows gathered from the memoized hash
  arrays, and drawn inside the graph) bitwise eager and pass to pass; a
  ragged stream that captures once per rung of the bucket ladder; the
  warm start from a fresh profile store; one capture of every
  registered transform and rowwise bucketed batches, bitwise eager;
- the command-line drivers (``cli_path``), run in process through
  ``main(argv)`` on files written from the seed at the widths of
  YearPredictionMSD (linear: Blendenpik with ``--cond-est``, sketch-and-
  solve, ``--stream``; svd), mnist (krr and ml on Fastfood features, the
  saved model's streamed predict) and SNAP com-Youtube (graph_se streamed
  and in core, community), each against an f64 reference beside a
  control that misses, the reads through the port's native parser, the
  host seconds split into read, copy to the card and solve;
- the telemetry layer and the randomized Gauss-Seidel solvers
  (``telemetry_path``): bench.py's telemetry acceptance run (streaming
  least squares of a rank-deficient 262144 x 512 A with an injected
  fault, JLT and CWT) held to the JAX package's ledger assertions;
  telemetry off against on, bitwise, with equal launch counts, on the
  kernel paths (the LS solves, a sparse SJLT stream, approximate KRR,
  Blendenpik, LSRN), each priced in host seconds; the drivers'
  ``--telemetry`` flags; ``randomized_block_gauss_seidel`` and
  ``asy_fcg`` on a 16384 x 16384 SPD A of condition 100, each X held
  against an f64 solve by the a-posteriori bound ||B - A X|| / lambda_min
  beside controls that miss it; and a ``utils.profiling`` trace;
- the serving layer (``serve_path``): the port's server holding the LS
  cell's 2^20 x 512 A under FJLT and CWT, a 32768 x 768 A under FJLT and
  under CWT with reserved rows, a 10-class Fastfood model and the
  com-Youtube-scale graph on the card; bench.py's serving drive (16
  clients, 256 requests) serial and coalesced; coalesced ≡ serial and
  routed ≡ serial bitwise beside a control that misses, plans captured
  mid-traffic by three workers; a cache hit with no launch; live row
  appends and edge folds against fresh registrations; a journaled
  registry recovered bitwise; HTTP, ``/metrics``, ``cli.top`` and
  ``cli.serve`` over stdio;
- the elastic multi-process path (``elastic_path``): at world 1 on NCCL
  in this process, ``distributed_sketch_least_squares`` of the streaming
  LS problem (2^21 x 512 in batches of 65536, s = 2048, JLT and CWT)
  and the ``DistributedBlockADMMTrainer`` at the training path's shape,
  each bitwise its single-process route; worlds of 2 ranks on the one
  card over gloo, each rank a ``chip_smoke.py --elastic-rank`` process:
  the LS problem uninterrupted, a rank SIGKILLed after its first commit
  and the world resumed (bitwise), exact data shrunk 2 -> 1 and grown
  1 -> 2 (bitwise the uninterrupted run at the new size), a straggler
  past a 2 s collective deadline (exit 110 naming it), the trainer
  killed after an ADMM chunk and resumed (bitwise), and the third
  path's graph in edge blocks against its in-core sketch; every rank
  holds the kernels it launches against their plain versions;
- the explicit sharded schedules (``mesh_path``) on meshes of 1, 2 and 4
  slots of the one card and a (2, 2) grid: FJLT rowwise at 131072 x
  4096, CWT and FJLT on a 2^20 x 32 block, JLT columnwise at 2^20 x 512,
  the sparse schedules (dense and sparse output, the capacity at
  ``suggest_sparse_out_capacity``'s count and one less) on the 10^6 x
  10^5 COO, the chained adjacency sketch of the third path's graph in
  core against the streamed chain, and the streaming randomized SVD of
  a rank-100 2^20 x 1024 matrix with its panels split over the slots;
  a mesh of one bitwise the unsharded call, more slots bitwise or
  within an f32 bound, each beside a control.  Slots on one card run in
  turn: the seconds are a schedule's overhead, never a speed-up;
- the sharded-input routes (``shard_path``) on meshes of 1, 2 and 4
  slots of the one card: ``solve_regression`` on a row-sharded A at the
  LS cell and at 32768 x 768 (accelerated, sketched with FJLT and CWT,
  exact), the randomized SVD, approximate KRR and BlockADMM at the
  training widths, the drivers' ``--shard`` (a mesh of one on one card,
  bitwise the run without it), ``dryrun_multichip(4)``, the serve
  programs forced over 2 and 4 entries of the card (every probe verdict
  printed, every answer bitwise the serial one) and a die-under-load
  drill on replicas sharing the card.  A mesh of one bitwise the
  unsharded call, more slots within a bound per route beside a control.

It exits non-zero, printing no result, without a CUDA device or without
the package beside it.  It imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from contextlib import contextmanager
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
# (c) streaming sketch-and-solve: A 2^21 x 512 f32 (4 GiB; 2^22 until phase
# 3m came, cut to keep the script's time) plus b in 32
# pinned host batches, the default sketch (JLT, s = 4n); killed after
# batch 17 (chunk 8 of two batches) and resumed.
LSQ_M, LSQ_N, LSQ_BATCH, LSQ_EVERY, LSQ_KILL_CHUNK = 1 << 21, 512, 65_536, 2, 8
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
# 1024 columns, noise 0.01, bf16 panels), m cut from 10^7 to 2^20 (the
# counter stream makes a 10^7 pass ~14 s; PERF.md): 2^21, as in phase 3e,
# until phase 3m came, then halved to keep the script's time.
SSVD_M, SSVD_N, SSVD_R, SSVD_BR, SSVD_NOISE, SSVD_TOL = 1 << 20, 1024, 100, 262_144, 0.01, 1e-2
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
# The learned policy (phase 3j), each item against a fresh profile store
# under build/: (a) the LS phase's problem (NLA_M x NLA_N f32) walked up
# the store's ladder with FJLT (three f32 runs at S = 4n, bf16 at 1536,
# 1152 and 1024, then fp8 at 1024) and its rungs timed at S = 2n; (b)
# bench.py:1521-1530's refine shape in f32 (PL_B_M x PL_B_N, Gaussian),
# walked and timed the same way; (c) CWT at (a)'s shape; (d) the fp8 and
# bf16 escalation drills at (a)'s shape (one entry of A set to PL_BAD; a
# rank-collapsed sketch), and round_to_e4m3 on the card; (e) the learned
# exact, Blendenpik and refine routes at (b)'s shape; (f) approximate KRR
# at phase 3f's shape bf16-first, and streaming LS of a PL_STREAM_M x NLA_N
# A in PL_STREAM_BATCHES batches.
PL_B_M, PL_B_N = 32_768, 768
PL_BAD_ROW, PL_BAD = 12_345, 1000.0
PL_STREAM_M, PL_STREAM_BATCHES = 1 << 21, 8
# The bf16 rung of approximate KRR: W (which the rung rounds to bf16)
# against the f64 solve of the same bf16 features, max-norm relative;
# twice bf16's unit roundoff 2^-8 (tests/test_torch_policy_store.py holds
# the JAX package's rung to the same bound).
PL_KRR_W_TOL = 2.0 ** -7
# The plans layer (phase 3k).  (a) least squares planned against eager
# (SKYLARK_NO_PLANS=1), guard on: the LS cell (NLA_M x NLA_N f32, FJLT and
# CWT, S = PK_S_LS) and bench.py:1521-1530's shape (PL_B_M x PL_B_N f32,
# FJLT, the default S = 4n); (b) phase 3g (a)'s stream chunk through
# plans.accumulate_slice, and a ragged stream of PK_RAGGED rows of ST_N
# columns; (c) the warm start; (d) one capture of every registered
# transform at PK_N -> PK_SK, both dims, PK_COLS columns, f32 and bf16.
PK_S_LS, PK_REPEATS = 2048, 3
PK_PLAN_BYTES = 16 << 30            # the cache's byte bound in 3k (a)-(c): the LS cell's A fits
PK_WARM_N = 1 << 26                 # a CWT past the hash memo's limit: drawn, captured steps
PK_RAGGED = (9000, 65_536, 23_000, 41_000, 12_000, 30_000, 50_000, 17_000)
PK_N, PK_SK, PK_COLS = 300, 40, (5, 20)
PK_ROWWISE_K = (5, 20, 33, 48, 9000)   # rowwise batches, bucketed against the eager ragged apply
PK_PARAMS = {"NURST": {"probs": np.linspace(1.0, 2.0, PK_N)}, "SJLT": {"nnz": 2}}
# The command-line drivers (phase 3l), run in process through main(argv)
# on files written from the seed into CLI_DIR (build/cli_data/, ignored by
# git), once per seed and shape.  The widths are those of public data sets
# the reference's drivers are run on, and no row is cut: YearPredictionMSD's
# training split (LIBSVM collection, 463,715 x 90, dense; its first
# CLI_LS_TOP columns scaled up, b = A x + g) for linear and svd; mnist's
# training and test splits (LIBSVM collection, 60,000 and 10,000 x 784, 10
# classes, written dense) for krr and ml; SNAP com-Youtube's 1,134,890
# vertices and 2,987,624 edges for graph_se and community (CLI_BLOCKS
# planted communities of CLI_BLOCK_V vertices, CLI_BLOCK_IN internal and
# CLI_BLOCK_OUT external edges per member, in a background on the rest:
# phase 3h's planted cluster, whose conductance the local clustering finds
# at LC_EPS; at 2000 vertices and 40 edges it stops after 17 vertices).
# Accuracy: test accuracy >= CLI_ACC_BOUND (PERF.md 2's training bound).
CLI_DIR = HERE / "build" / "cli_data"
CLI_LS_M, CLI_LS_N, CLI_LS_TOP, CLI_LS_BATCH = 463_715, 90, 10, 65_536
CLI_MN_M, CLI_MN_T, CLI_MN_D, CLI_MN_K, CLI_MN_NOISE = 60_000, 10_000, 784, 10, 0.5
CLI_MN_S, CLI_MN_SIGMA, CLI_MN_LAM = 4096, 20.0, 0.01
CLI_ML_ITERS, CLI_ML_LAM = 20, 0.01
CLI_YT_V, CLI_YT_E = 1_134_890, 2_987_624
CLI_BLOCKS, CLI_BLOCK_V, CLI_BLOCK_IN, CLI_BLOCK_OUT = 8, 1000, 30, 2
CLI_ASE_K, CLI_ACC_BOUND = 8, 0.9
# The telemetry layer and the randomized Gauss-Seidel solvers (phase 3m).
# (a) bench.py's bench_telemetry (bench.py:2011-2016): streaming LS of a
# TM_M x TM_N f32 A in batches of TM_BATCH, here rank-deficient with a
# FaultPlan(bad_sketch_at=1) (tests/test_telemetry.py's acceptance run);
# (b) telemetry off against on, TM_REPEATS runs each, on (a) and the kernel
# paths, among them a sparse SJLT stream of phase 3b's TM_SP_M rows and
# TM_SP_NNZ nonzeros over TM_N columns in TM_SP_BATCHES COO batches.
TM_DIR = HERE / "build" / "telemetry"
TM_M, TM_N, TM_BATCH, TM_REPEATS = 262_144, 512, 32_768, 3
TM_SP_M, TM_SP_NNZ, TM_SP_BATCHES = 1_000_000, 10_000_000, 8
# (c) The JAX drivers' ledgers, as (kind, name) with the plans layer's
# events left out, on phase 3l's flags: tests/test_torch_cli.py holds the
# JAX package's drivers to these on small files of the same shape.
CLI_LEDGERS = {
    "linear": [("guard", "initial"), ("run_summary", "blendenpik")],
    "linear sketched": [("guard", "initial"), ("run_summary", "sketch_and_solve_ls")],
    "krr": [("run_summary", "approximate_krr")],
    "ml": [],
}
# (d) GS on an SPD A = I + U diag(mu) U^T (U orthonormal GS_N x GS_R from
# the seed, mu log-spaced so that the eigenvalues run from 1 to GS_COND):
# the JAX defaults (block GS_BLOCK, GS_SWEEPS sweeps; asy_fcg at
# KrylovParams() with 2 inner sweeps), GS_RHS right-hand sides; the
# schedule held card against CPU at GS_CHECK_N.
GS_N, GS_R, GS_COND, GS_BLOCK, GS_SWEEPS, GS_RHS, GS_CHECK_N = (
    16_384, 256, 100.0, 64, 10, (1, 16), 2048)


# The serving layer (phase 3n), the port's server on the card at full
# width.  The registry: the LS cell (SV_M x SV_N f32, phase 1's shape)
# under FJLT ("ls") and CWT ("ls_cwt") at the JAX default s = SV_S, one A
# shared; SV_RF_M x SV_RF_N (phase 3i's shape) under FJLT at SV_RF_S
# ("ls_rf") and under CWT with SV_UP_ROWS rows of reserved capacity
# ("ls_up": the FJLT has no columnwise slice rule, so live appends take a
# hash sketch); a 10-class FeatureMapModel on Fastfood features ML_DIM ->
# ML_S ("mdl", phase 3f's shapes); phase 3l's com-Youtube-scale graph at
# k = CLI_ASE_K ("g"), SV_EDGES random edges folded into it live.
# bench.py:1048-1130's drive: SV_CLIENTS client threads, SV_REQUESTS
# requests over SV_RHS distinct inputs, serial (max_coalesce 1) and
# coalesced (SV_COALESCE); coalesced ≡ serial at SV_RUNGS requests.  A
# live append is held to a fresh registration of the merged A: S·A and R
# within SV_UPDATE_TOL of their largest entry (sums in another order), x
# within SV_X_TOL.
SV_DIR = HERE / "build" / "serve"
SV_M, SV_N, SV_S = 1 << 20, 512, 2048
SV_RF_M, SV_RF_N, SV_RF_S, SV_UP_ROWS, SV_EDGES = 32_768, 768, 3072, 64, 64
SV_CLIENTS, SV_REQUESTS, SV_COALESCE, SV_RHS = 16, 256, 32, 8
SV_RUNGS = (1, 8, 9, 17, 32)
SV_UPDATE_TOL, SV_X_TOL = 1e-5, 1e-4
EL_DIR = HERE / "build" / "elastic"
EL_M, EL_N, EL_BATCH, EL_S = 1 << 21, 512, 65_536, 2048   # phase 3g's streaming LS shape
EL_EVERY, EL_KILL_CHUNK = 4, 0     # batches per checkpoint; rank 1 dies after its first commit
EL_DEADLINE_S, EL_SLOW_S = 2.0, 60.0
EL_ADMM_ITERS, EL_ADMM_BATCH = 41, 65_536   # s/iter = (t_41 - t_1) / 40
EL_STAGE_TIMEOUT_S = 420           # each spawned stage of worlds
EL_W_ULPS = 16                     # world 2's W from world 1's: u an iteration, relative
# Phase 3p: the explicit sharded schedules on meshes of 1, 2 and 4 slots
# of the one card (and a (2, 2) grid): FJLT rowwise at phase 3a's shape,
# CWT and FJLT on a 2^20 x 32 right-hand-side block, JLT columnwise at the
# LS cell's 2^20 x 512 -> 2048, the sparse schedules on phase 3b's COO
# (rowwise on 2^18 rows: the unsharded dense output's limit), the chained
# graph sketch (S1 = CWT(n -> 64): the streamed chain's dense S1·A is
# 64 x 3,997,962 f32, ~1 GiB), and phase 3g's streaming SVD shape in f32.
# A reordered f32 sum is held within MESH_TOL of the largest entry (the
# kernels' f32 tolerance against their plain versions).
MESH_RW_M, MESH_RW_N, MESH_RW_S, MESH_RW_S2 = 131_072, 4096, 1024, 1000
MESH_B_N, MESH_B_K, MESH_B_S = 1 << 20, 32, 2048
MESH_JLT_N, MESH_JLT_M, MESH_JLT_S = 1 << 20, 512, 2048
MESH_RW_ROWS = 1 << 18
MESH_CHAIN_S1, MESH_CHAIN_S2 = 64, 32
MESH_TOL = 1e-5
# Phase 3q: the sharded-input routes (parallel.routes) on meshes of 1, 2
# and 4 slots of the one card.  (a) solve_regression at the LS cell and at
# bench.py's refine width, b = A x + SH_NOISE g; (b) the randomized SVD at
# phase 3e's width 1024 and rank (depth cut from 2^21 to 2^19), approximate
# KRR at phase 3f's width 4096 -> 2048 (depth cut to 32768) and BlockADMM
# at phase 3f's configuration (SH_ADMM_ITERS iterations); (e) the serve
# programs on a 32768 x 768 system and a 768-wide feature-map model.  A
# mesh of one is held bitwise; 2 and 4 slots within SH_TOL of the one
# slot's result (max |diff| / max |ref|), each beside a control that
# misses: another sketch's x for the sketch route, the sketch-and-solve x
# for the routes that solve exactly (LSQR to eps32, the QR), sigma one
# index over, another seed's maps.
SH_LS = ((1 << 20, 512), (32_768, 768))
SH_SLOTS = (1, 2, 4)
SH_NOISE = 0.1
SH_TOL = {"sketched": 1e-4, "accelerated": 1e-4, "exact": 1e-5, "svd": 1e-4,
          "krr": TRAIN_W_TOL, "admm": TRAIN_W_TOL}
SH_SVD_M, SH_SVD_N, SH_SVD_R = 1 << 19, 1024, 100
SH_KRR_M = 32_768
SH_ADMM_ITERS = 5
SH_SV_M, SH_SV_N, SH_SV_D, SH_SV_REQ = 32_768, 768, 768, 32
# The matmul routes (phase 3r): (a) FJLT's subsampled-Hadamard GEMM at
# phase 3p (a)'s rowwise shape (MM_RW_M x MM_RW_N -> MM_RW_S) and
# columnwise at the policy phase's 32768 x 768 (MM_CW_*), and S swept over
# MM_SWEEP_S at both; (b) Fastfood's hoisted W at phase 3f's 4096 -> 2048
# on serving's predict block (MM_FF_PREDICT rows) and a streaming-KRR panel
# (the driver's default block_rows, MM_FF_PANEL); (c) PPT at the predict
# shape to MM_PPT_S, q = 3; (e) ridge on phase 3e's LS cell at a lam that
# moves x by ~20 % (A^T A ~ m I), and the DCT FJLT at phase 3h's SK_S.
MM_RW_M, MM_RW_N, MM_RW_S = 131_072, 4096, 1024
MM_CW_M, MM_CW_N, MM_CW_S = 32_768, 768, 1024
MM_SWEEP_S = (256, 512, 768, 1024)
MM_FF_PREDICT, MM_FF_PANEL = 8, 262_144
MM_PPT_S = 1024
MM_RIDGE_LAM = float(1 << 18)
# Phase 3j (f)'s approximate-KRR rungs, in seconds, printed again by 3r (d).
KRR_RUNG_SECS: dict = {}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(ok: bool, msg: str) -> None:
    if not ok:
        fail(msg)


@contextmanager
def forced_env(**knobs):
    """Env knobs set for the duration (a route forced on), put back after."""
    saved = {k: os.environ.get(k) for k in knobs}
    os.environ.update(knobs)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v


def no_plans():
    """The port's plans off (``SKYLARK_NO_PLANS=1``) for the duration: the
    eager path a planned result is held against."""
    return forced_env(SKYLARK_NO_PLANS="1")


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


def device_ms(fn) -> float:
    """Device time of one call of ``fn`` after a warm-up call: the sum of
    its CUDA kernels' self times in the profiler, in ms."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3


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
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    m = timed_fit(f"large_scale_kernel_ridge s = {KRR_LS_S}, max_split = {KRR_LS_SPLIT}, lam = "
                  f"{KRR_LS_LAM}", lambda: ml.large_scale_kernel_ridge(
                      kern, X, T32, KRR_LS_LAM, KRR_LS_S, ctx(), p), reps=1)
    print(f"large_scale: {len(m.maps)} chunks, stopped at {sweeps[-1]} (tolerance {p.tolerance})")
    # Memory-bounded: the peak above what was resident before is a few
    # chunks' Z, not all of them, with the plans' buffers under their bound.
    peak = torch.cuda.max_memory_allocated() - resident
    z_bytes = X.shape[0] * (KRR_LS_SPLIT // 2) * 4
    st = sky.plans.stats()
    print(f"large_scale: peak memory above the resident {peak / 2**30:.3f} GiB = "
          f"{peak / z_bytes:.2f} chunks' Z of {z_bytes / 2**30:.3f} GiB ({len(m.maps)} chunks); "
          f"plans hold {st['bytes']} bytes (bound {st['max_bytes']}), bypasses "
          f"{st['bypasses']} {card}")
    check(peak < len(m.maps) * z_bytes and st["bytes"] <= st["max_bytes"],
          f"large_scale: peak {peak} bytes, plans {st}")
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
    # of the same seed), each chunk's windows drawn for the chunk.  The
    # default path: memoized windows step eagerly, drawn ones through a
    # captured plan (phase 3k (b)); the drawn pass also runs with the
    # plans off.
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
        with no_plans():
            drawn_e = min(clock(chunk_pass, True, S_d)[0] for _ in range(ST_REPEATS))
        same = torch.equal(outs[True], outs[False])
        same_d = torch.equal(out_d, outs[True])
        print(f"stream (a) {name} fused stream-chunk columnwise {ST_CHUNKS}x{ST_CHUNK}x{ST_N}"
              f"->{ST_S}: warm (hash arrays memoized) fused {m_a / warm[True] / 1e6:.1f} Mrows/s "
              f"({warm[True]!r} s), unfused {m_a / warm[False] / 1e6:.1f} Mrows/s "
              f"({warm[False]!r} s), fused / unfused speed {warm[False] / warm[True]:.3f}; cold "
              f"(each pass draws the whole arrays) fused {m_a / cold / 1e6:.1f} Mrows/s "
              f"({cold!r} s); drawn per chunk (above the memo limit) fused, planned "
              f"{m_a / drawn / 1e6:.1f} Mrows/s ({drawn!r} s; the first pass {t_d!r} s), eager "
              f"(plans off) {m_a / drawn_e / 1e6:.1f} ({drawn_e!r} s); bitwise fused = unfused "
              f"{same}, "
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
    # the residual falls in sweep 0 and never rises after by more than one
    # f32 rounding of ||R|| (its f32 entries are updated in place, and a
    # converged residual moves by their rounding either way).
    check(resid[0] < math.sqrt(NS_N) and all(b <= a * (1 + 2.0 ** -24)
                                             for a, b in zip(resid, resid[1:])),
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
    # (b)'s rowwise FJLT(2048 -> 1024) takes the subsampled-Hadamard GEMM.
    counts = read_counts("streaming", t_path, ("scatter_rows", "segment_sum_flat"))
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


def hold_kernels(label, kf, kw, names, held: set) -> list:
    """Put a :class:`Held` in place of each of the rfut, gather and row
    scatter wrappers in ``names``, each comparing the first launch of a
    signature with its plain version on the same inputs beside a control
    that misses (printed under ``label``).  Returns (module, name,
    wrapper) triples to restore."""
    f32 = torch.float32

    def rfut_rowwise(out, x, d, nb):
        tol = 1e-5 if x.dtype == f32 else 1e-2
        _, r = max_err(out, kf.rfut_rowwise_plain(x, d, nb))
        d_ctl = d.clone()
        d_ctl[1::2] = -d_ctl[1::2]
        _, c = max_err(out, kf.rfut_rowwise_plain(x, d_ctl, nb))
        print(f"{label} (held) rfut_rowwise x {tuple(x.shape)} {x.dtype}, NB = {nb}: vs its plain "
              f"version rel {r:.3g} (tol {tol:g}); control (the plain version with every other "
              f"entry of d negated) {c:.3g}")
        check(r <= tol and c > tol, f"{label} rfut_rowwise {tuple(x.shape)} {x.dtype}: {r}, "
              f"control {c}")

    def rfut_rowwise_sampled(out, x, d, nb, idx):
        tol = 1e-5 if x.dtype == f32 else 1e-2
        _, r = max_err(out, kf.rfut_rowwise_sampled_plain(x, d, nb, idx))
        _, c = max_err(out, kf.rfut_rowwise_sampled_plain(x, d, nb, (idx + 1) % nb))
        print(f"{label} (held) rfut_rowwise_sampled x {tuple(x.shape)} {x.dtype}, NB = {nb}, S = "
              f"{idx.numel()}: vs its plain version rel {r:.3g} (tol {tol:g}); control (each "
              f"sample one lane over) {c:.3g}")
        check(r <= tol and c > tol, f"{label} rfut_rowwise_sampled {tuple(x.shape)} {x.dtype}: "
              f"{r}, control {c}")

    def gather_scaled_rows(out, T, idx, scale):
        # NaN rows count as equal where both have them (the fp8 drill's
        # e4m3 copy of A has a NaN column).
        ref = kw.gather_scaled_rows_plain(T, idx, scale)
        ok = bool(((out == ref) | (out.isnan() & ref.isnan())).all())
        ctl = kw.gather_scaled_rows_plain(T, (idx + 1) % T.shape[0], scale)
        c = float((ctl.float() - out.float()).abs().nan_to_num(0.0).max())
        print(f"{label} (held) gather_scaled_rows T {tuple(T.shape)} {T.dtype}, S = "
              f"{idx.numel()}: bitwise its plain version {ok}; control (each row one index over) "
              f"max abs diff {c:.3g}")
        check(ok and c > 0, f"{label} gather_scaled_rows {tuple(T.shape)} {T.dtype}: bitwise {ok}")

    def scatter_rows(out, A, b, v, segs, **kwargs):
        check(not kwargs, f"{label} scatter_rows called with {sorted(kwargs)}")
        b, v = (b[None], v[None]) if b.ndim == 1 else (b, v)
        exact, err_bound, (row, piece) = scatter_error_bound(A, b, v, segs, kw._L)
        r = bound_ratio(out, exact, err_bound)
        c = bound_ratio(out[row].double() - piece, exact[row], err_bound[row])
        print(f"{label} (held) scatter_rows A {tuple(A.shape)} {A.dtype} -> {segs}, nnz = "
              f"{b.shape[0]}: max |out - exact| / rounding bound {r:.3g} (must be <= 1); control "
              f"(bucket {row}'s first piece left out) {c:.3g}")
        check(r <= 1.0 and c > 1.0, f"{label} scatter_rows {tuple(A.shape)} {A.dtype}: {r}, "
              f"control {c}")
        del exact, err_bound

    compare = {"rfut_rowwise": rfut_rowwise, "rfut_rowwise_sampled": rfut_rowwise_sampled,
               "gather_scaled_rows": gather_scaled_rows, "scatter_rows": scatter_rows}
    mods = {"rfut_rowwise": kf, "rfut_rowwise_sampled": kf, "gather_scaled_rows": kw,
            "scatter_rows": kw}
    return [(mods[n], n, hold(mods[n], n, compare[n], held)) for n in names]


def held_signatures(held: set) -> set:
    """(kernel, dtype, shape of the operand, sample count or NB or bucket
    count) of each held signature: the sampled kernel's S, the
    transform's NB, the gather's S, the row scatter's bucket count."""
    got = set()
    for sig in held:
        name, (shape, dtype) = sig[0], sig[1]
        count = {"rfut_rowwise_sampled": lambda: sig[4][0][0],
                 "rfut_rowwise": lambda: sig[3],
                 "gather_scaled_rows": lambda: sig[2][0][0],
                 "scatter_rows": lambda: sig[4]}.get(name, lambda: None)()
        got.add((name, dtype, shape, count))
    return got


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

    kernels = hold_kernels("refine", kf, kw, ("rfut_rowwise_sampled", "gather_scaled_rows",
                                              "scatter_rows"), held)

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
    got = held_signatures(held)
    check(want <= got, f"refine: new signatures not held: {sorted(map(str, want - got))}")
    print(f"refine: {len(held)} kernel signatures held against their plain versions, the new "
          f"ones among them: {sorted(map(str, want))}")
    return held


def learned_sizes(m: int, n: int) -> list:
    """The sketch sizes a healthy, comfortably conditioned key learns
    after its three default runs: each a quarter under the last certified
    size, down to the floor min(2n, m) (the JAX package's decision)."""
    sizes, s = [], min(4 * n, m)
    for _ in range(3):
        s = max(min(2 * n, m), (s * 3) // 4)
        sizes.append(s)
    return sizes


def policy_path(sky, dev, reset_counts, read_counts, smi) -> set:
    """Phase 3j: the learned policy at full width, items (a)-(f) as the
    constants above say, each against a fresh profile store under
    ``build/`` and with the launch counters reset before it and read
    after it (paths ``policy (a)`` ... ``policy (f)``).  While the phase
    runs, the first launch of each kernel signature is held against its
    plain version beside a control that misses; the phase fails if an
    item launches a kernel it does not hold, or unless the bf16 sampled
    kernel, bf16 ``rfut_rowwise`` at NB = 2^15, the bf16 gather and the
    bf16 row scatter were held at learned sketch sizes.  Returns the
    signatures held.  Times are medians of 3 host-clock runs ending in a
    synchronize, in turns with the other rungs after a warm-up of each,
    with the store frozen (read, not written)."""
    import shutil
    from contextlib import contextmanager

    from libskylark_tpu_torch import policy as pol
    from libskylark_tpu_torch.core.precision import round_to_e4m3
    from libskylark_tpu_torch.sketch import kernels_fut as kf
    from libskylark_tpu_torch.sketch import kernels_window as kw

    lin, ml = sky.linalg, sky.ml
    f32, bf16 = torch.float32, torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(SEED + 19)
    card = f"[{smi}]"
    held = set()
    names = ("rfut_rowwise", "rfut_rowwise_sampled", "gather_scaled_rows", "scatter_rows")
    kernels = hold_kernels("policy", kf, kw, names, held)
    root = HERE / "build" / "policy_stores"
    shutil.rmtree(root, ignore_errors=True)
    # The walks assume the default knobs (backend "gpu" passes both rungs'
    # gates); a caller's SKYLARK_POLICY* and SKYLARK_GUARD* settings are
    # put back at the end.
    saved_env = {k: os.environ.pop(k) for k in list(os.environ)
                 if k.startswith(("SKYLARK_POLICY", "SKYLARK_GUARD"))}
    fp8_name = "float8_e4m3fn"
    backend = "gpu" if dev.type == "cuda" else "cpu"  # what the store keys a CUDA card by

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    def ctx(i=0):
        return sky.SketchContext(seed=SEED + i)

    def fresh_store(label):
        directory = root / label
        shutil.rmtree(directory, ignore_errors=True)
        pol.configure(directory)
        pol.reset()
        pol.invalidate_cache()
        return directory

    def seed_store(label, key, observations):
        """A fresh store holding ``key``'s entry folded from
        ``observations`` (one run each)."""
        directory = fresh_store(label)
        st = pol.ProfileStore(str(directory))
        for obs in observations:
            st.fold(key, obs, now=time.time())
        st.save(now=time.time())
        return directory

    def entry(key):
        pol.invalidate_cache()
        return (pol.load_entries() or {}).get("entries", {}).get(key)

    @contextmanager
    def frozen(**env):
        """Decisions read the store but no run writes it; ``env`` sets
        knobs for the duration."""
        observe, flush = pol.observe, pol.flush
        pol.observe = lambda *a, **k: None
        pol.flush = lambda *a, **k: None
        os.environ.update(env)
        try:
            yield
        finally:
            pol.observe, pol.flush = observe, flush
            for k in env:
                del os.environ[k]

    def in_turns(label, rungs):
        """``rungs`` maps a name to (knobs, fn): each is run once with the
        store frozen (a warm-up), then three times in turns with the
        others, so that drift falls on every rung alike.  Returns the
        median host-clock seconds (ending in a synchronize) and the
        warm-up's result, by name."""
        first = {}
        for name, (env, fn) in rungs.items():
            with frozen(**env):
                first[name] = fn()
        clocks = {name: [] for name in rungs}
        for _ in range(3):
            for name, (env, fn) in rungs.items():
                with frozen(**env):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    fn()
                    torch.cuda.synchronize()
                    clocks[name].append(time.perf_counter() - t0)
        secs = {name: statistics.median(c) for name, c in clocks.items()}
        for name, c in clocks.items():
            print(f"policy {label} {name}: median {secs[name]!r} s of {[round(x, 4) for x in c]} "
                  f"(in turns) {card}")
        return secs, first

    def item(label, expect, body):
        reset_counts()
        t0 = time.perf_counter()
        out = body()
        torch.cuda.synchronize()
        counts = read_counts(f"policy ({label})", t0, expect)
        unheld = {k for k, c in counts.items() if c} - set(names)
        check(not unheld, f"policy ({label}) launched kernels it does not hold: {unheld}")
        return out

    def rounded(A, name):
        """The matrix a rung sketches: A, A in bf16, A rounded to e4m3."""
        return {"f32": lambda: A, "bf16": lambda: A.to(bf16).float(),
                "fp8": lambda: round_to_e4m3(A).float()}[name]()

    class Problem:
        """f32 Gaussian A, b = A x + noise g, and the f64 gels residual of
        the problem each rung sketches (A, or A rounded to its type)."""

        def __init__(self, m, n, noise):
            self.A = randn(m, n)
            self.b = self.A @ randn(n) + noise * randn(m)
            self._res = {}

        def res(self, name="f32"):
            if name not in self._res:
                self._res[name] = gels_res(rounded(self.A, name), self.b)
            return self._res[name]

    def gels_res(A, b):
        x = torch.linalg.lstsq(A.double(), b.double()[:, None]).solution[:, 0]
        return float(torch.linalg.vector_norm(A.double() @ x - b.double()))

    def ratio(A, b, x, res):
        return float(torch.linalg.vector_norm(A.double() @ x.double() - b.double())) / res

    def ratio_control(A, b, res):
        S = sky.sketch.FJLT(A.shape[0], A.shape[1], ctx(1))  # a square sketch misses the bound
        return ratio(A, b, lin.exact_least_squares(S.apply(A), S.apply(b[:, None]))[:, 0], res)

    def rung(p):
        return {None: "f32", "bfloat16": "bf16", fp8_name: "fp8"}[p.get("compute_dtype")]

    def walk(label, P, expect, params=None):
        """Solve ``len(expect)`` times against the item's store, printing
        each decision; each step's (sketch size, rung) is checked against
        ``expect`` where it is given.  Each step's residual ratio is held
        to LS_RATIO_BOUND against the gels solve of the problem its rung
        sketched, and the f32 and bf16 rungs' also against A's (the fp8
        rung's is printed: e4m3's rounding of A acts as added noise of
        about 2.5 % of each row's product, which a sketch-and-solve at
        S = 2n does not average out).  Returns the steps reached."""
        reached = []
        A, b = P.A, P.b
        for step, want in enumerate(expect):
            x, info = lin.approximate_least_squares(A, b, ctx(), params, return_info=True)
            p = info["policy"]
            name = rung(p)
            r = ratio(A, b, x, P.res())
            r_own = ratio(rounded(A, name), b, x, P.res(name))
            reached.append((p["sketch_size"], name))
            attempts = [(a["action"], a.get("verdict")) for a in info["recovery"]["attempts"]]
            print(f"policy ({label}) step {step}: S = {p['sketch_size']}, rung {name}, source "
                  f"{p['source']}; residual / f64 gels residual of the {name} problem "
                  f"{r_own:.4f}, of A {r:.4f} (bound {LS_RATIO_BOUND}); attempts {attempts}; "
                  f"reasons {p.get('reasons', [])}")
            check(r_own <= LS_RATIO_BOUND and (name == "fp8" or r <= LS_RATIO_BOUND)
                  and not p.get("escalated"), f"policy ({label}) step {step}: ratio {r_own}, "
                  f"of A {r}, {p}")
            check(want is None or reached[-1] == want,
                  f"policy ({label}) step {step}: reached {reached[-1]}, expected {want}")
        return reached

    def rungs_timed(label, P, s, default_s):
        """The rungs at sketch size ``s`` with the store frozen: f32 (size
        pinned, bf16 off), bf16 (fp8 off), fp8; and the default f32 run
        (the layer off).  Then each rung's device time split into its
        cast pass, the sketch of A and b, and the rest (profiler)."""
        A, b = P.A, P.b
        m = A.shape[0]
        runs = {"f32": (dict(SKYLARK_POLICY_BF16="0"), lin.LeastSquaresParams(sketch_size=s)),
                "bf16": (dict(SKYLARK_POLICY_FP8="0"), None),
                "fp8": ({}, None),
                "default": (dict(SKYLARK_POLICY="0"), None)}
        casts = {"f32": lambda: A, "bf16": lambda: A.to(bf16),
                 "fp8": lambda: round_to_e4m3(A).to(bf16)}
        secs, infos = in_turns(f"({label}) rung", {
            name: (env, lambda params=params: lin.approximate_least_squares(
                A, b, ctx(), params, return_info=True)[1])
            for name, (env, params) in runs.items()})
        for name, info in infos.items():
            p = info["policy"]
            want = (default_s if name == "default" else s, "f32" if name == "default" else name)
            check((p["sketch_size"], rung(p)) == want and not p.get("escalated"),
                  f"policy ({label}) timed {name}: {p}")
        cast_by = {}
        for name, (env, params) in runs.items():
            with frozen(**env):
                prof_ms = device_ms(lambda: lin.approximate_least_squares(A, b, ctx(), params))
            # The cast by CUDA events: late in this script's process the
            # profiler drops the cast's kernels, alone and inside the solve
            # alike, so the device total takes the profiler's sum with its
            # reading of the cast replaced by the events'.
            narrow = name in ("bf16", "fp8")
            cast_prof = device_ms(casts[name]) if narrow else 0.0
            cast_ms = time_ms(casts[name], reps=5) if narrow else 0.0
            dev_ms = prof_ms - cast_prof + cast_ms
            A_in = casts["f32" if name == "default" else name]()
            s_run = default_s if name == "default" else s
            sk_ms = device_ms(lambda: (lambda S: (S.apply(A_in), S.apply(b[:, None])))(
                sky.sketch.FJLT(m, s_run, ctx())))
            SA = sky.sketch.FJLT(m, s_run, ctx()).apply(A_in).float()
            cert_s, _ = host_median(lambda: sky.guard.certify_sketch(SA), 3)
            del A_in, SA
            cast_by[name] = cast_ms
            print(f"policy ({label}) {name} rung at S = {s_run}: host {secs[name]!r} s, of which "
                  f"the certificate alone {cert_s!r} s (host clock); device {dev_ms!r} ms = cast "
                  f"{cast_ms!r} ms (CUDA events) + sketch of A and b {sk_ms!r} ms (profiler) + "
                  f"rest {dev_ms - cast_ms - sk_ms!r} ms (the profiler's sum over the solve "
                  f"{prof_ms!r} ms, over the cast alone {cast_prof!r} ms) {card}")
        elems = A.numel()
        cast_bound = 6 * elems / MEM_BYTES_PER_S * 1e3
        print(f"policy ({label}) cast passes: bytes bound of reading A in f32 and writing it in "
              f"bf16 {cast_bound!r} ms; bf16 cast {cast_by['bf16']!r} ms, e4m3 round and "
              f"bf16 lift {cast_by['fp8']!r} ms {card}")

    # -- (a) the LS cell's problem, FJLT, walked up the ladder ------------
    m, n = NLA_M, NLA_N
    Pa = Problem(m, n, 1.0)  # b = A x + g, as the LS phase's
    A, b = Pa.A, Pa.b
    key_a = pol.profile_key("ls", backend, "float32", m, n)
    sizes_a = learned_sizes(m, n)
    walk_a = ([(min(4 * n, m), "f32")] * 3 + [(s, "bf16") for s in sizes_a]
              + [(sizes_a[-1], "fp8")])

    def item_a():
        fresh_store("a")
        r_ctl = ratio_control(A, b, Pa.res())
        print(f"policy (a) control: residual ratio of an S = n sketch {r_ctl:.4f} (must exceed "
              f"{LS_RATIO_BOUND})")
        check(r_ctl > LS_RATIO_BOUND, f"policy (a) control ratio {r_ctl}")
        walk("a", Pa, walk_a)
        e = entry(key_a)
        print(f"policy (a) store entry after the walk: {e}")
        rungs_timed("a", Pa, sizes_a[-1], min(4 * n, m))

    item("a", ("gather_scaled_rows",), item_a)
    cond_a = entry(key_a)["cond"]["max"]

    # -- (c) CWT at (a)'s shape: bf16-first --------------------------------
    def item_c():
        fresh_store("c")
        walk("c", Pa, [(min(4 * n, m), "f32")] * 3 + [(sizes_a[0], "bf16")],
             lin.LeastSquaresParams(sketch_type="CWT"))

    item("c", ("scatter_rows",), item_c)

    # -- (d) escalation drills at (a)'s shape ------------------------------
    def healthy(s, **kw_):
        return dict(ok0=True, resketches=0, fallback=False, cond=cond_a, sketch_size=s,
                    route="sketch", sketch_type="FJLT", default_size=min(4 * n, m), **kw_)

    def item_d():
        # fp8 rung: (a)'s walk folded into a fresh store; one entry of A
        # at PL_BAD makes its e4m3 copy NaN, the certificate fails, the
        # solve escalates to A, and the store retires the rung.
        seed_store("d-fp8", key_a, [healthy(min(4 * n, m))] * 3 + [
            healthy(s, bf16="ok") for s in sizes_a])
        A_bad = A.clone()
        A_bad[PL_BAD_ROW, 0] = PL_BAD
        res_bad = gels_res(A_bad, b)
        x, info = lin.approximate_least_squares(A_bad, b, ctx(), return_info=True)
        p, e = info["policy"], entry(key_a)
        nxt = pol.consult("ls", m=m, n=n, dtype=f32, device=dev).to_dict()
        r = ratio(A_bad, b, x, res_bad)
        print(f"policy (d) fp8 drill (A[{PL_BAD_ROW}, 0] = {PL_BAD}): decision {p}; attempts "
              f"{[(a['action'], a.get('verdict')) for a in info['recovery']['attempts']]}; store "
              f"fp8 {e.get('fp8')}, escalations {e.get('escalations')}; next decision "
              f"{nxt.get('compute_dtype')} at S = {nxt['sketch_size']}; residual ratio {r:.4f} "
              f"(bound {LS_RATIO_BOUND})")
        check(p.get("compute_dtype") == fp8_name and p.get("escalated")
              and e["fp8"]["fail"] == 1 and nxt.get("compute_dtype") == "bfloat16"
              and r <= LS_RATIO_BOUND, f"policy (d) fp8 drill: {p}, {e}, {nxt}, {r}")
        del A_bad
        # bf16 rung: a rank-collapsed sketch at attempt 0 escalates.
        seed_store("d-bf16", key_a, [healthy(min(4 * n, m))] * 3)
        x, info = lin.approximate_least_squares(
            A, b, ctx(), return_info=True, fault_plan=sky.resilient.FaultPlan(bad_sketch_at=0))
        p, e = info["policy"], entry(key_a)
        nxt = pol.consult("ls", m=m, n=n, dtype=f32, device=dev).to_dict()
        r = ratio(A, b, x, Pa.res())
        print(f"policy (d) bf16 drill (FaultPlan(bad_sketch_at=0)): decision {p}; store bf16 "
              f"{e.get('bf16')}; next decision {nxt}; residual ratio {r:.4f}")
        check(p.get("compute_dtype") == "bfloat16" and p.get("escalated")
              and e["bf16"]["fail"] == 1 and "compute_dtype" not in nxt
              and r <= LS_RATIO_BOUND, f"policy (d) bf16 drill: {p}, {e}, {nxt}, {r}")
        # round_to_e4m3 on the card: bitwise its CPU result, NaN past 464.
        special = torch.tensor([448.0, 464.0, 464.01, 479.99, 480.0, 1e9, math.inf, -math.inf,
                                math.nan, -480.0, -0.0, 2.0 ** -9, 2.0 ** -10], device=dev)
        v = torch.cat([special, randn(1 << 20) * torch.exp2(
            torch.randint(-12, 9, (1 << 20,), generator=g, device=dev).float())])
        code = round_to_e4m3(v).view(torch.uint8)
        same = torch.equal(code.cpu(), round_to_e4m3(v.cpu()).view(torch.uint8))
        raw = v[:13].to(torch.float8_e4m3fn).view(torch.uint8)
        nan_codes = code[2:10].tolist()
        print(f"policy (d) round_to_e4m3 on the card: bitwise its CPU result on {v.numel()} "
              f"values {same}; codes of {special.tolist()}: {[hex(c) for c in code[:13].tolist()]}; "
              f"(observed) torch's raw CUDA cast: {[hex(c) for c in raw.tolist()]}")
        check(same and all(c in (0x7F, 0xFF) for c in nan_codes)
              and code[:2].tolist() == [0x7E, 0x7E], f"policy (d) round_to_e4m3: {same}, "
              f"{code[:13].tolist()}")

    item("d", ("gather_scaled_rows",), item_d)
    del A, b, Pa
    torch.cuda.empty_cache()

    # -- (b) bench.py's refine shape in f32, FJLT --------------------------
    mb, nb_ = PL_B_M, PL_B_N
    Pb = Problem(mb, nb_, 1.0)
    key_b = pol.profile_key("ls", backend, "float32", mb, nb_)
    sizes_b = learned_sizes(mb, nb_)

    def item_b():
        fresh_store("b")
        reached = walk("b", Pb, [(min(4 * nb_, mb), "f32")] * 3 + [None] * 4)
        print(f"policy (b) walk reached {reached} (the JAX decision on crafted views predicts "
              f"S = {sizes_b})")
        if (sizes_b[1], "bf16") not in reached:
            print(f"policy (b) the walk did not reach S = {sizes_b[1]}: a bf16-first solve with "
                  f"that sketch_size pinned holds its signature")
            x, info = lin.approximate_least_squares(
                Pb.A, Pb.b, ctx(), lin.LeastSquaresParams(sketch_size=sizes_b[1]),
                return_info=True)
            check(rung(info["policy"]) == "bf16", f"policy (b) pinned S: {info['policy']}")
        rungs_timed("b", Pb, sizes_b[-1], min(4 * nb_, mb))

    item("b", ("rfut_rowwise_sampled", "rfut_rowwise"), item_b)

    # -- (e) learned reroutes at (b)'s shape -------------------------------
    def item_e():
        # b at the NLA phases' noise, where their bounds were set.
        Ab = Pb.A
        bb = Ab @ randn(nb_) + NLA_NOISE * randn(mb)
        Q, R = torch.linalg.qr(Ab.double())
        x64 = torch.linalg.solve_triangular(R, (Q.T @ bb.double())[:, None], upper=True)[:, 0]
        sv = torch.linalg.svdvals(R)
        del Q, R
        cond = float(sv[0] / sv[-1])
        r64 = float(torch.linalg.vector_norm(Ab.double() @ x64 - bb.double()))
        with frozen(SKYLARK_POLICY="0"):
            x_sk = lin.approximate_least_squares(Ab, bb, ctx())  # control: the sketch route
        err_sk = rel2(x_sk, x64)
        svd_bound = nb_ * float(torch.finfo(f32).eps) * (
            cond + cond ** 2 * r64 / (float(sv[0]) * float(torch.linalg.vector_norm(x64))))
        base = dict(route="sketch", sketch_type="FJLT", default_size=min(4 * nb_, mb))
        cases = (("exact", dict(ok0=False, fallback=True, **base), svd_bound),
                 ("blendenpik", dict(ok0=False, resketches=1, **base), NLA_X_TOL),
                 ("refine", dict(ok0=True, cond=cond_a, route="refine", sketch_type="FJLT",
                                 refine={"converged": True, "iters": 46, "rung": "bf16+f32"}),
                  RF_X_TOL))
        for route, obs, bound_x in cases:
            seed_store(f"e-{route}", key_b, [obs] * 3)
            x, info = lin.approximate_least_squares(Ab, bb, ctx(), return_info=True)
            err = rel2(x, x64)
            p = info["policy"]
            print(f"policy (e) learned {route}: decision {p}; ||x - x_qr|| / ||x_qr|| {err:.3g} "
                  f"(bound {bound_x:.3g}; control, the sketch route's x: {err_sk:.3g})")
            check(p["route"] == route and p["source"] == "profile", f"policy (e) {route}: {p}")
            check(err <= bound_x < err_sk, f"policy (e) {route}: {err}, control {err_sk}")

    def rel2(x, ref):
        return float(torch.linalg.vector_norm(x.double() - ref) / torch.linalg.vector_norm(ref))

    item("e", ("rfut_rowwise_sampled",), item_e)
    del Pb
    torch.cuda.empty_cache()

    # -- (f) approximate KRR bf16-first; streaming LS ----------------------
    def item_f():
        X = randn(ML_ROWS, ML_DIM)
        Y = -torch.ones(ML_ROWS, ML_CLASSES, device=dev)
        Y[torch.arange(ML_ROWS, device=dev), X[:, :ML_CLASSES].argmax(1)] = 1.0
        kern = ml.GaussianKernel(ML_DIM, ML_SIGMA)
        fast = ml.KrrParams(use_fast=True)
        fresh_store("f-krr")

        def fit(lam=KRR_LAM):
            return ml.approximate_kernel_ridge(kern, X, Y, lam, ML_S, ctx(), fast)

        for step in range(3):
            m32 = fit()
            check("compute_dtype" not in m32.info["policy"], f"policy (f) KRR step {step}")
        mbf = fit()
        p = mbf.info["policy"]
        print(f"policy (f) approximate KRR after 3 runs: decision {p}")
        check(p.get("compute_dtype") == "bfloat16" and not p.get("escalated"),
              f"policy (f) KRR decision {p}")
        secs, models = in_turns(
            f"(f) approximate_kernel_ridge Fastfood {ML_ROWS} x {ML_DIM} -> {ML_S}",
            {"f32": (dict(SKYLARK_POLICY_BF16="0"), fit), "bf16": ({}, fit)})
        (t32, m32), (tbf, mbf) = ((secs[k], models[k]) for k in ("f32", "bf16"))
        KRR_RUNG_SECS.update(f32=t32, bf16=tbf)
        check(rung(m32.info["policy"]) == "f32" and rung(mbf.info["policy"]) == "bf16",
              f"policy (f) KRR timed rungs: {m32.info['policy']}, {mbf.info['policy']}")
        Z = mbf.maps[0].apply(X, "rowwise")

        def w64(Zf, lam):
            Zd = Zf.double()
            G = Zd.T @ Zd
            G.diagonal().add_(lam)
            return torch.linalg.solve(G, Zd.T @ Y.double())

        def relmax(W, ref):
            return float((W.double() - ref).abs().max() / ref.abs().max())

        Zb = Z.to(bf16)
        r32 = relmax(m32.W, w64(Z, KRR_LAM))
        rbf = relmax(mbf.W, w64(Zb, KRR_LAM))
        ctl = relmax(mbf.W, w64(Zb, 2 * KRR_LAM))
        cost = relmax(mbf.W, w64(Z, KRR_LAM))
        print(f"policy (f) KRR W vs the f64 solve of its own features: f32 rung {r32:.3g} (bound "
              f"{TRAIN_W_TOL:g}), bf16 rung {rbf:.3g} against the bf16 features (bound "
              f"{PL_KRR_W_TOL:g}; control, the f64 solve at 2 lambda: {ctl:.3g}); the bf16 rung "
              f"against the f32 features' f64 solve (observed) {cost:.3g}; {tbf!r} s against "
              f"{t32!r} s {card}")
        check(r32 <= TRAIN_W_TOL and rbf <= PL_KRR_W_TOL < ctl,
              f"policy (f) KRR: f32 {r32}, bf16 {rbf}, control {ctl}")
        del X, Y, Z, Zb, m32, mbf
        torch.cuda.empty_cache()

        # Streaming LS in PL_STREAM_BATCHES batches on the card; the f64
        # reference by the normal equations, accumulated per batch.
        fresh_store("f-stream")
        rows = PL_STREAM_M // PL_STREAM_BATCHES
        xt = randn(NLA_N)
        batches = []
        for _ in range(PL_STREAM_BATCHES):
            Ai = randn(rows, NLA_N)
            batches.append((Ai, Ai @ xt + NLA_NOISE * randn(rows)))
        G = sum(Ai.double().T @ Ai.double() for Ai, _ in batches)
        h = sum(Ai.double().T @ bi.double() for Ai, bi in batches)
        x64 = torch.linalg.solve(G, h)

        def res_of(x):
            return math.sqrt(sum(float(torch.linalg.vector_norm(
                Ai.double() @ x.double() - bi.double())) ** 2 for Ai, bi in batches))

        x, info = lin.streaming_least_squares(batches, PL_STREAM_M, NLA_N, ctx())
        e = entry(pol.profile_key("ls_stream", backend, "float32", PL_STREAM_M, NLA_N))
        r = res_of(x) / res_of(x64)
        print(f"policy (f) streaming LS {PL_STREAM_M} x {NLA_N} in {PL_STREAM_BATCHES} batches: "
              f"{info['seconds']!r} s; residual / f64 residual {r:.4f} (bound {LS_RATIO_BOUND}); "
              f"store throughput {e and e.get('throughput')} {card}")
        check(e is not None and e["throughput"]["batches"] == PL_STREAM_BATCHES
              and e["throughput"]["rows_per_s"] > 0 and r <= LS_RATIO_BOUND,
              f"policy (f) streaming: {e}, ratio {r}")

    item("f", ("rfut_rowwise",), item_f)
    torch.cuda.empty_cache()
    for mod, name, kernel in kernels:
        setattr(mod, name, kernel)
    pol.configure(None)
    pol.reset()
    pol.invalidate_cache()
    os.environ.update(saved_env)
    shutil.rmtree(root, ignore_errors=True)
    # The sampled kernel takes S % 128 == 0, rfut_rowwise the other sizes.
    want = {("rfut_rowwise_sampled", bf16, (PL_B_N, PL_B_M), s) if s % 128 == 0
            else ("rfut_rowwise", bf16, (PL_B_N, PL_B_M), PL_B_M) for s in sizes_b}
    want |= {("gather_scaled_rows", bf16, (NLA_M, NLA_N), s) for s in sizes_a}
    want.add(("scatter_rows", bf16, (NLA_M, NLA_N), sizes_a[0]))
    check(want <= held_signatures(held),
          f"policy: signatures not held: {sorted(map(str, want - held_signatures(held)))}")
    print(f"policy: {len(held)} kernel signatures held against their plain versions, the "
          f"learned ones among them: {sorted(map(str, want))}")
    return held


def plans_path(sky, dev, reset_counts, read_counts, smi) -> set:
    """Phase 3k: the plans layer at full width, items (a)-(d) as the
    constants above say, with the launch counters reset before the phase
    and read after it (path ``plans``).  Every planned result is held
    bitwise against the same call with the plans off, beside a control
    that misses.  While the phase runs, the first launch of each kernel
    signature is held against its plain version beside a control (in the
    eager runs or a plan's eager warm-up, never inside a capture); the
    phase fails if it launches a kernel it does not hold.  Returns the
    signatures held.  Host seconds are medians of PK_REPEATS in turns."""
    import shutil

    from libskylark_tpu_torch import plans
    from libskylark_tpu_torch import policy as pol
    from libskylark_tpu_torch.sketch import _launch
    from libskylark_tpu_torch.sketch import kernels_fut as kf
    from libskylark_tpu_torch.sketch import kernels_window as kw

    lin = sky.linalg
    f32, bf16, f64 = torch.float32, torch.bfloat16, torch.float64
    g = torch.Generator(device=dev).manual_seed(SEED + 23)
    card = f"[{smi}]"
    u = 2.0 ** -24
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def clock(fn, *args):
        sync()
        t0 = time.perf_counter()
        out = fn(*args)
        sync()
        return time.perf_counter() - t0, out

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    def ctx(i=0):
        return sky.SketchContext(seed=SEED + i)

    held = set()

    def scatter_held(out, A, b, v, segs, acc=None):
        b, v = (b[None], v[None]) if b.ndim == 1 else (b, v)
        part, err_bound, (row, piece) = scatter_error_bound(A, b, v, segs, kw._L)
        exact = part if acc is None else acc.double() + part
        if acc is not None:
            err_bound = err_bound + u * 1.01 * exact.abs()  # the fused emit's one add
        r = bound_ratio(out, exact, err_bound)
        c = bound_ratio(out[row].double() - piece, exact[row], err_bound[row])
        print(f"plans (held) scatter_rows{'(acc=)' if acc is not None else ''} A "
              f"{tuple(A.shape)} {A.dtype} -> {segs}, nnz = {b.shape[0]}: max |out - exact| / "
              f"rounding bound {r:.3g} (must be <= 1); control (bucket {row}'s first piece left "
              f"out) {c:.3g}")
        check(r <= 1.0 and c > 1.0, f"plans scatter_rows {tuple(A.shape)}: {r}, control {c}")
        del part, exact, err_bound

    kernels = hold_kernels("plans", kf, kw, ("rfut_rowwise", "rfut_rowwise_sampled",
                                             "gather_scaled_rows"), held)
    kernels.append((kw, "scatter_rows", hold(kw, "scatter_rows", scatter_held, held)))
    root = HERE / "build" / "plan_stores"
    saved_env = {k: os.environ.pop(k) for k in list(os.environ)
                 if k.startswith(("SKYLARK_POLICY", "SKYLARK_GUARD", "SKYLARK_PLAN",
                                  "SKYLARK_NO_PLANS", "SKYLARK_NO_FUSED"))}
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    plans.clear()
    reset_counts()
    t_path = time.perf_counter()
    default_bytes = plans.PLAN_CACHE.max_bytes
    try:
        # (a) least squares, planned against eager, guard on.  The LS
        # cell's A (2 GiB) is over the cache's default byte bound, so the
        # default path applies it eagerly (shown first); the phase raises
        # the bound to hold those plans against eager too.
        P1 = randn(NLA_M, NLA_N)
        P1 = (P1, P1 @ randn(NLA_N) + NLA_NOISE * randn(NLA_M))
        before = plans.stats()
        plans.apply(sky.sketch.create_sketch("FJLT", NLA_M, PK_S_LS, ctx()), P1[0], "columnwise")
        after = plans.stats()
        over = after["bypasses"] == before["bypasses"] + 1 and after["misses"] == 0
        print(f"plans (a): at the default byte bound {default_bytes} the FJLT apply of the LS "
              f"cell's A ({P1[0].numel() * 4} bytes) is a bypass {over}; the bound raised to "
              f"{PK_PLAN_BYTES} for (a)-(c)")
        check(over, f"plans (a): the default bound did not bypass: {before} -> {after}")
        plans.PLAN_CACHE.set_max_bytes(PK_PLAN_BYTES)
        P2 = randn(PL_B_M, PL_B_N)
        P2 = (P2, P2 @ randn(PL_B_N) + NLA_NOISE * randn(PL_B_M))
        configs = (("FJLT 2^20 x 512, S = 2048", P1, "FJLT", PK_S_LS),
                   ("CWT 2^20 x 512, S = 2048", P1, "CWT", PK_S_LS),
                   ("FJLT 32768 x 768, S = 3072", P2, "FJLT", 4 * PL_B_N))
        eager = {}
        for label, (A, b), stype, s in configs:
            prm = lin.LeastSquaresParams(sketch_type=stype, sketch_size=s)
            S = sky.sketch.create_sketch(stype, A.shape[0], s, ctx())

            def solve(A=A, b=b, prm=prm):
                return lin.approximate_least_squares(A, b, ctx(), prm)

            with no_plans():
                x_e, SA_e = solve(), S.apply(A, "columnwise")
            x_p, SA_p = solve(), plans.apply(S, A, "columnwise")
            same = torch.equal(x_p, x_e) and torch.equal(SA_p, SA_e)
            S_ctl = sky.sketch.create_sketch(stype, A.shape[0], s, ctx(1))
            ctl = torch.equal(plans.apply(S_ctl, A, "columnwise"), SA_e)
            before = _launch.launch_counts()
            SA_w = plans.apply(S, A, "columnwise")
            replay = {f"{k[1]}": v for k, v in
                      _launch.launch_delta(before, _launch.launch_counts()).items()
                      if k[2] is None}
            check(torch.equal(SA_w, SA_e), f"plans (a) {label}: a replay differs from eager")
            runs = {"eager": [], "cold": [], "warm": []}
            for _ in range(PK_REPEATS):
                with no_plans():
                    runs["eager"].append(clock(solve)[0])
                plans.clear()
                runs["cold"].append(clock(solve)[0])
                runs["warm"].append(clock(solve)[0])
            med = {k: statistics.median(v) for k, v in runs.items()}
            if cuda:  # device kernel time of one solve (profiler), eager and warm
                with no_plans():
                    dev_e = device_ms(solve)
                dev_w = device_ms(solve)
                print(f"plans (a) {label}: device kernels of one solve (profiler) eager "
                      f"{dev_e:.2f} ms, planned warm {dev_w:.2f} ms; device idle against "
                      f"the median host s {1 - dev_e / 1e3 / med['eager']:.2f} / "
                      f"{1 - dev_w / 1e3 / med['warm']:.2f} {card}")
            res = float(torch.linalg.vector_norm(A @ x_p - b))
            print(f"plans (a) {label}, guard on: planned x and S.A bitwise eager {same}; control "
                  f"(a plan of seed + 1) equal {ctl}; one warm planned apply of A replays the "
                  f"launches {replay}; host s, median of {PK_REPEATS} in turns: eager "
                  f"{med['eager']!r}, planned cold (warm-up + capture) {med['cold']!r}, planned "
                  f"warm (replay) {med['warm']!r}; of {runs}; ||A x - b|| {res:.6g} "
                  f"{card}")
            check(same and not ctl, f"plans (a) {label}: planned vs eager {same}, control {ctl}")
            eager[label] = (solve, x_e)
        # The plans replayed in another order than they were captured (the
        # FJLT and CWT plans of the LS cell share its static buffers).
        for label, (solve, x_e) in reversed(list(eager.items())):
            check(torch.equal(solve(), x_e), f"plans (a) {label}: a replay in reverse order "
                  "differs from eager")
        st = plans.stats()
        print(f"plans (a): the three solves replayed in reverse order, bitwise eager; plan stats "
              f"{st}; peak memory {torch.cuda.max_memory_allocated(dev) / 2**30 if cuda else 0:.2f}"
              f" GiB {card}")
        S_fjlt, A_fjlt = sky.sketch.create_sketch("FJLT", NLA_M, PK_S_LS, ctx()), P1[0]
        solve_fjlt = eager[configs[0][0]][0]
        del eager, P2, x_e, x_p, SA_e, SA_p, SA_w

        # (b) the stream chunk through plans.accumulate_slice.  Windows cut
        # from the memoized arrays step eagerly (a bypass each: not
        # launch-bound); windows drawn per step (the memo's limit 0 on the
        # sketch) replay one captured graph, the start on the card.
        m_a = ST_CHUNK * ST_CHUNKS
        X = randn(ST_CHUNK, ST_N)

        def chunk_pass(sketch):
            acc = torch.zeros(ST_S, ST_N, device=dev)
            for c in range(ST_CHUNKS):
                acc = plans.accumulate_slice(sketch, acc, X, c * ST_CHUNK, fused=True)
            return acc

        def drawn(name, seed=61):
            S_ = sky.sketch.create_sketch(name, m_a, ST_S, sky.SketchContext(seed=seed))
            S_._SLICE_MEMO_LIMIT = 0
            return S_

        for name in ("CWT", "MMT"):
            S = sky.sketch.create_sketch(name, m_a, ST_S, sky.SketchContext(seed=61))
            S_d = drawn(name)
            with no_plans():
                ref = chunk_pass(S)
                drawn_e = min(clock(chunk_pass, S_d)[0] for _ in range(ST_REPEATS))
            before = plans.stats()
            memo = chunk_pass(S)
            bypassed = plans.stats()["bypasses"] - before["bypasses"]
            runs_m = {"default": [], "off": []}  # in turns: the bypass against plans off
            for _ in range(ST_REPEATS):
                with no_plans():
                    runs_m["off"].append(clock(chunk_pass, S)[0])
                runs_m["default"].append(clock(chunk_pass, S)[0])
            warm_m, warm_e = min(runs_m["default"]), min(runs_m["off"])
            S.finalize_slices(ref)
            before = plans.stats()
            p1, p2 = chunk_pass(S_d), chunk_pass(S_d)
            st = plans.stats()
            t_pd = min(clock(chunk_pass, S_d)[0] for _ in range(ST_REPEATS))
            ctl = torch.equal(chunk_pass(drawn(name, 62)), ref)
            same_m, same = torch.equal(memo, ref), torch.equal(p1, ref)
            same_pp = torch.equal(p1, p2)
            captured = (st["misses"] == before["misses"] + 1
                        and st["bypasses"] == before["bypasses"])
            print(f"plans (b) {name} stream chunk {ST_CHUNKS}x{ST_CHUNK}x{ST_N}->{ST_S} through "
                  f"plans.accumulate_slice: memoized windows (the default, {bypassed} bypasses) "
                  f"{m_a / warm_m / 1e6:.1f} Mrows/s ({warm_m!r} s, min of {ST_REPEATS}), with the "
                  f"plans off in turns {m_a / warm_e / 1e6:.1f} ({warm_e!r} s); drawn "
                  f"windows planned (one capture {captured}) {m_a / t_pd / 1e6:.1f} ({t_pd!r} s), "
                  f"eager {m_a / drawn_e / 1e6:.1f} ({drawn_e!r} s); PR 10's eager warm / drawn "
                  f"202.3 / 144.1 and 14.9 / 9.3 (CWT / MMT); bitwise eager: memoized {same_m}, "
                  f"drawn planned {same}, pass to pass {same_pp}; control (seed 62) equal {ctl} "
                  f"{card}")
            check(same_m and bypassed == ST_CHUNKS and same and same_pp and captured and not ctl,
                  f"plans (b) {name}: memoized {same_m} ({bypassed} bypasses), drawn {same}, "
                  f"pass to pass {same_pp}, captured {captured}, control {ctl}")
            if cuda:
                # Device time of one step: planned drawn (copy-in, replay,
                # copy out) beside the block's copy into a buffer alone and
                # the eager steps, drawn and memoized.
                acc = torch.zeros(ST_S, ST_N, device=dev)
                buf = torch.empty_like(X)
                step_ms = time_ms(lambda: plans.accumulate_slice(S_d, acc, X, 0))
                copy_ms = time_ms(lambda: buf.copy_(X))
                with no_plans():
                    drawn_ms = time_ms(lambda: plans.accumulate_slice(S_d, acc, X, 0))
                    memo_ms = time_ms(lambda: plans.accumulate_slice(S, acc, X, 0))
                print(f"plans (b) {name} one chunk, device ms (CUDA events, median of 10): "
                      f"planned drawn step {step_ms:.4f}, of which the block's copy-in alone "
                      f"{copy_ms:.4f}; eager drawn step {drawn_ms:.4f}; eager memoized step "
                      f"{memo_ms:.4f} {card}")
                del acc, buf
            S.finalize_slices(ref)
            del ref, memo, p1, p2, S_d
        # A ragged stream: one capture per rung of the ladder, hits after.
        n_r = sum(PK_RAGGED)
        S_r = sky.sketch.CWT(n_r, ST_S, sky.SketchContext(seed=67))
        S_r._SLICE_MEMO_LIMIT = 0  # drawn windows: the captured step
        Xr = randn(n_r, ST_N)
        rungs = {plans.bucket_for(k) for k in PK_RAGGED}

        def ragged_pass():
            acc, row = torch.zeros(ST_S, ST_N, device=dev), 0
            for k in PK_RAGGED:
                acc = plans.accumulate_slice(S_r, acc, Xr[row:row + k], row)
                row += k
            return acc

        plans.clear()
        r1 = ragged_pass()
        st1 = plans.stats()
        r2 = ragged_pass()
        st2 = plans.stats()
        ok1 = st1["traces"] == st1["misses"] == len(rungs) and st1["bypasses"] == 0
        ok2 = (st2["traces"] == st1["traces"] and st2["misses"] == st1["misses"]
               and st2["hits"] >= st1["hits"] + len(PK_RAGGED))
        # Against the exact f64 sum (CWT values are +-1, each term exact):
        # any order of summation errs by at most (n_b - 1) u sum|x| in a
        # bucket of n_b terms.
        bkt = S_r.buckets(0, n_r, device=dev).long()
        val = S_r.values(f32, 0, n_r, device=dev).double()
        exact = torch.zeros(ST_S, ST_N, dtype=f64, device=dev)
        absum = torch.zeros(ST_S, ST_N, dtype=f64, device=dev)
        for lo in range(0, n_r, ST_CHUNK):
            Xd = Xr[lo:lo + ST_CHUNK].double()
            exact.index_add_(0, bkt[lo:lo + ST_CHUNK], val[lo:lo + ST_CHUNK, None] * Xd)
            absum.index_add_(0, bkt[lo:lo + ST_CHUNK], Xd.abs())
        n_b = torch.bincount(bkt, minlength=ST_S).double()
        order_bound = 1.01 * u * (n_b - 1).clamp(min=0)[:, None] * absum
        r = bound_ratio(r1, exact, order_bound)
        b0 = int(bkt[0])
        c = bound_ratio(r1[b0], exact[b0] - val[0] * Xr[0].double(), order_bound[b0])
        print(f"plans (b) ragged stream of {len(PK_RAGGED)} batches {PK_RAGGED} x {ST_N} -> "
              f"{ST_S} (CWT): rungs {sorted(rungs)}; pass 1 traces {st1['traces']}, misses "
              f"{st1['misses']}, bypasses {st1['bypasses']}; pass 2 traces {st2['traces']}, hits "
              f"{st2['hits'] - st1['hits']}; bitwise pass to pass {torch.equal(r1, r2)}; vs the "
              f"exact f64 sum: max diff / rounding bound of any order {r:.3g} (must be <= 1); "
              f"control (row 0 left out of bucket {b0}) {c:.3g}")
        check(ok1 and ok2 and torch.equal(r1, r2) and r <= 1.0 and c > 1.0,
              f"plans (b) ragged stream: {st1}, {st2}, ratio {r}, control {c}")
        del Xr, r1, r2, bkt, val, exact, absum, n_b, order_bound

        # (c) the warm start: the hot plans of (a) and (b) flushed to a fresh
        # store, the plan cache cleared, then replayed.
        shutil.rmtree(root, ignore_errors=True)
        pol.configure(root)
        pol.reset()
        pol.invalidate_cache()
        plans.clear()
        solve_fjlt()  # flushes at its end
        S_c = sky.sketch.create_sketch("CWT", PK_WARM_N, ST_S, sky.SketchContext(seed=61))
        acc = torch.zeros(ST_S, ST_N, device=dev)
        for i in range(ST_CHUNKS):
            acc = plans.accumulate_slice(S_c, acc, X, i * ST_CHUNK)
        pol.flush()
        st = plans.stats()
        pol.invalidate_cache()
        view = pol.load_entries()
        meta = view["meta"]
        kinds = sorted({rec["plan"] for rec in view["plans"]})
        check(meta.get("plan_compiles") == st["compiles"]
              and meta.get("plan_compile_seconds") == st["compile_seconds"],
              f"plans (c): store meta {meta} is not plans.stats() {st}")
        plans.clear()
        t_cold, _ = clock(plans.apply, S_fjlt, A_fjlt, "columnwise")
        ctl_miss = plans.stats()["misses"] == 1
        plans.clear()
        summary = pol.warm_start(device=dev)
        before = plans.stats()
        t_warm, _ = clock(plans.apply, S_fjlt, A_fjlt, "columnwise")
        after = plans.stats()
        hit = after["hits"] == before["hits"] + 1 and after["misses"] == before["misses"]
        print(f"plans (c) warm start: {len(view['plans'])} hot plans in the store ({kinds}), meta "
              f"{meta}; warm_start {summary}; first FJLT apply of A after it a hit {hit}, "
              f"{t_warm!r} s, against {t_cold!r} s cold (control: a miss without the warm start "
              f"{ctl_miss}) {card}")
        check(summary["plans_replayed"] > 0 and hit and ctl_miss and "slice" in kinds
              and "apply" in kinds, f"plans (c): {summary}, hit {hit}, control {ctl_miss}")
        del X, acc, S_c, A_fjlt, P1

        # (d) one capture of every registered transform, bitwise eager, at
        # the default byte bound.
        plans.clear()
        plans.PLAN_CACHE.set_max_bytes(default_bytes)
        captured, refused = 0, []
        for stype in sorted(sky.sketch.sketch_registry()):
            S = sky.sketch.create_sketch(stype, PK_N, PK_SK, ctx(29), **PK_PARAMS.get(stype, {}))
            for dim in ("columnwise", "rowwise"):
                for cols in PK_COLS:
                    for dtype in (f32, bf16):
                        shape = (PK_N, cols) if dim == "columnwise" else (cols, PK_N)
                        A = randn(*shape).to(dtype)
                        try:
                            with no_plans():
                                e = S.apply(A, dim)
                        except (NotImplementedError, RuntimeError) as err:
                            refused.append(f"{stype} {dim} {dtype}: {err}"[:120])
                            continue
                        p1, p2 = plans.apply(S, A, dim), plans.apply(S, A, dim)
                        check(torch.equal(p1, e) and torch.equal(p2, e),
                              f"plans (d) {stype} {dim} {tuple(A.shape)} {dtype}: planned "
                              "differs from eager")
                        captured += 1
        # Rowwise bucketed: the real rows of a bucket-padded batch against
        # the eager ragged apply.  Row-independent kernels (FJLT's rfut,
        # the hash scatter) must be bitwise at every size; a GEMM (JLT, the
        # RFT's W·X, CWT's one-hot route, the FJLT where its gate takes the
        # subsampled-Hadamard GEMM) sees another M, and cuBLAS may
        # pick another algorithm there: bitwise through 48 rows (the JAX
        # package's pin), and above within the rounding bound of the two
        # GEMMs' dot products (2 gamma_K |X| |W|^T, K = N, carried through
        # the RFT's cos epilogue), with the plain GEMM of the same rows at
        # both M printed as the cause.
        rowwise, worst = [], 0.0
        gk = PK_N * u / (1 - PK_N * u)
        for stype in ("JLT", "CWT", "GaussianRFT", "FJLT"):
            S = sky.sketch.create_sketch(stype, PK_N, PK_SK, ctx(31))
            for k in PK_ROWWISE_K:
                X = randn(k, PK_N)
                with no_plans():
                    e = S.apply(X, "rowwise")
                Z = plans.apply_rowwise_bucketed(S, X)
                kb = plans.bucket_for(k, S.batch_size_gates)
                row = (stype, k, kb, torch.equal(Z, e))
                if not row[-1]:
                    gemm = stype in ("JLT", "GaussianRFT") or (
                        stype == "FJLT" and S._gemm_wins(X.dtype))
                    check(gemm and k > 48,
                          f"plans (d): rowwise bucketed {stype} at {k} rows: not bitwise")
                    W = S.hoistable_operands(X.dtype, dev)
                    if stype == "FJLT":  # (N, S) of ±1, scaled by 1/sqrt(S) after the sum
                        W = W.double().T / math.sqrt(S.s)
                    mag = X.double().abs() @ W.double().abs().T
                    bnd = 2 * gk * mag
                    if stype == "GaussianRFT":  # outscale cos(W·X + shift)
                        bnd = S.outscale * (bnd + 2 * u * (mag + 2 * math.pi) + 4 * u)
                    r = bound_ratio(Z, e.double(), bnd)
                    c = bound_ratio(Z.roll(1, 0), e.double(), bnd)
                    Xp = plans.pad_rows(X, kb)
                    row += (f"max diff / rounding bound {r:.3g}, control (rows shifted by one) "
                            f"{c:.3g}", f"plain X @ W.T at M = {k} and {kb} bitwise "
                            f"{torch.equal((Xp @ W.T)[:k], X @ W.T)}")
                    check(r <= 1.0 and c > 1.0, f"plans (d): rowwise bucketed {stype} at {k} "
                          f"rows: {row}")
                    worst = max(worst, r)
                rowwise.append(row)
        print(f"plans (d): rowwise bucketed, (transform, rows, bucket, bitwise the eager ragged "
              f"apply[, its rounding bound, the cause]): {rowwise}; worst ratio to the bound "
              f"{worst:.3g} {card}")
        captured += len(PK_ROWWISE_K) * 4
        st = plans.stats()
        print(f"plans (d): {captured} captures ({st['traces']} plans) of the "
              f"{len(sky.sketch.sketch_registry())} registered transforms ({PK_N} -> {PK_SK}, "
              f"both dims, {PK_COLS} columns, f32 and "
              f"bf16), each bitwise eager on its first and second call; eager refused "
              f"{len(refused)}: {sorted(set(r.split(':')[0] for r in refused))}; plan stats {st}")
        check(0 < st["traces"] <= captured and st["bypasses"] == 0,
              f"plans (d): {captured} captures, {st}")
        peak = torch.cuda.max_memory_allocated(dev) / 2**30 if cuda else 0.0
        print(f"plans: phase 3k peak memory allocated {peak:.2f} GiB {card}")
    finally:
        plans.PLAN_CACHE.set_max_bytes(default_bytes)
        for mod, name, kernel in kernels:
            setattr(mod, name, kernel)
        pol.configure(None)
        os.environ.update(saved_env)
        shutil.rmtree(root, ignore_errors=True)
    counts = read_counts("plans", t_path, ("rfut_rowwise_sampled", "gather_scaled_rows",
                                            "scatter_rows"))
    names = {sig[0] for sig in held}
    for name, count in counts.items():
        check(count == 0 or name in names, f"plans launched {name} without holding it")
    plans.clear()
    if cuda:
        torch.cuda.empty_cache()
    return held


# -- phase 3l: the command-line drivers on files read from disk --------------

_POW10 = 10 ** np.arange(19, dtype=np.int64)


def decimal_fields(q: np.ndarray, int_digits: int, frac_digits: int, signed: bool) -> np.ndarray:
    """uint8 (..., width): each ``q / 10**frac_digits`` written at a fixed
    width, ``[+-]I..I.F..F`` with leading zeros (which both the native
    parser's strtod and Python's float read), made with array arithmetic,
    no per-value formatting."""
    nd = int_digits + frac_digits
    a = np.abs(q)
    check(bool((a < _POW10[nd]).all()), f"decimal_fields: a value needs more than {nd} digits")
    digits = (a[..., None] // _POW10[nd - 1::-1][:nd]) % 10  # most significant first
    width = int(signed) + nd + (1 if frac_digits else 0)
    out = np.empty(q.shape + (width,), np.uint8)
    o = 0
    if signed:
        out[..., 0] = np.where(q < 0, ord("-"), ord("+"))
        o = 1
    out[..., o:o + int_digits] = digits[..., :int_digits] + ord("0")
    if frac_digits:
        out[..., o + int_digits] = ord(".")
        out[..., o + int_digits + 1:] = digits[..., int_digits:] + ord("0")
    return out


def write_dense_libsvm(f, y_fields: np.ndarray, x_fields, rows: int, block: int = 4096) -> None:
    """Write a dense LIBSVM file: row i is ``y_fields[i]`` then `` j:``
    and ``x_fields(lo, hi)[i - lo, j - 1]`` for every column j, in blocks
    of ``block`` rows, each block one array concatenation."""
    prefixes = None
    for lo in range(0, rows, block):
        hi = min(lo + block, rows)
        xf = x_fields(lo, hi)
        n, d, _ = xf.shape
        if prefixes is None:
            prefixes = [np.frombuffer(f" {j + 1}:".encode(), np.uint8) for j in range(d)]
        parts = [y_fields[lo:hi]]
        for j in range(d):
            parts += [np.broadcast_to(prefixes[j], (n, prefixes[j].size)), xf[:, j]]
        parts.append(np.full((n, 1), ord("\n"), np.uint8))
        f.write(np.concatenate(parts, axis=1).tobytes())


def int_lines(cols: list) -> bytes:
    """The rows of non-negative int64 columns as decimal text, space
    separated and newline ended, made with array arithmetic."""
    lens = [np.searchsorted(_POW10[1:], c, side="right") + 1 for c in cols]
    width = sum(lens) + len(cols)
    ends = np.cumsum(width)
    pos = ends - width
    buf = np.empty(int(ends[-1]), np.uint8)
    for i, (c, n) in enumerate(zip(cols, lens)):
        for p in range(int(n.max())):
            m = n > p
            buf[pos[m] + n[m] - 1 - p] = ord("0") + (c[m] // _POW10[p]) % 10
        pos = pos + n
        buf[pos] = ord(" ") if i < len(cols) - 1 else ord("\n")
        pos = pos + 1
    return buf.tobytes()


def cli_file(name: str, make) -> Path:
    """``CLI_DIR/name``, written by ``make(f)`` unless it exists (through a
    temporary name and ``os.replace``, so a cut run leaves no half file)."""
    path = CLI_DIR / name
    if not path.exists():
        CLI_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        with open(tmp, "wb") as f:
            make(f)
        os.replace(tmp, path)
        print(f"cli: wrote {path.name}, {path.stat().st_size / 1e6:.1f} MB, in "
              f"{time.perf_counter() - t0:.1f} s")
    return path


def cli_ls_data(seed: int):
    """YearPredictionMSD's shape (CLI_LS_M x CLI_LS_N, dense): A with its
    first CLI_LS_TOP columns scaled up (a spectrum the rank-k SVD can
    separate), b = A x + g, both at 6 decimals: the integer arrays
    ``(A_q, b_q)`` of the values times 10^6, and the file."""
    rng = np.random.default_rng(seed)
    scale = np.ones(CLI_LS_N)
    scale[:CLI_LS_TOP] = 8.0 * (1.0 - 0.05 * np.arange(CLI_LS_TOP))
    A_q = np.rint(rng.standard_normal((CLI_LS_M, CLI_LS_N)) * scale * 1e6).astype(np.int64)
    b_q = np.rint((A_q @ rng.standard_normal(CLI_LS_N)) + 1e6 * rng.standard_normal(CLI_LS_M))
    b_q = b_q.astype(np.int64)
    path = cli_file(f"year-{seed}-{CLI_LS_M}x{CLI_LS_N}.svm", lambda f: write_dense_libsvm(
        f, decimal_fields(b_q, 3, 6, True),
        lambda lo, hi: decimal_fields(A_q[lo:hi], 3, 6, True), CLI_LS_M))
    return A_q, b_q, path


def cli_mnist_data(seed: int):
    """mnist's shape: CLI_MN_K classes planted as class templates in
    [0.1, 0.9]^CLI_MN_D plus noise, clipped to [0, 1), values at 6
    decimals, labels 0-9; train CLI_MN_M and test CLI_MN_T rows, written
    dense.  Returns ``((X_q, y), path)`` for each split."""
    rng = np.random.default_rng(seed + 1)
    templates = rng.uniform(0.1, 0.9, (CLI_MN_K, CLI_MN_D))
    splits = []
    for name, m in (("train", CLI_MN_M), ("test", CLI_MN_T)):
        y = rng.integers(0, CLI_MN_K, m)
        X = templates[y] + CLI_MN_NOISE * rng.standard_normal((m, CLI_MN_D))
        X_q = np.rint(np.clip(X, 0.0, 0.999999) * 1e6).astype(np.int64)
        path = cli_file(f"mnist-{seed}-{name}-{m}x{CLI_MN_D}.svm", lambda f: write_dense_libsvm(
            f, decimal_fields(y, 1, 0, False),
            lambda lo, hi: decimal_fields(X_q[lo:hi], 1, 6, False), m))
        splits.append(((X_q, y), path))
    return splits


def cli_graph_data(seed: int):
    """An arc list at SNAP com-Youtube's scale (CLI_YT_V vertices,
    CLI_YT_E edges): CLI_BLOCKS planted communities of CLI_BLOCK_V
    vertices (ids below CLI_BLOCKS * CLI_BLOCK_V; CLI_BLOCK_IN internal
    and CLI_BLOCK_OUT external edges per member), and a background on the
    other vertices (a path through all of them, so every vertex is named,
    and random pairs), deduplicated, shuffled, each edge in a random
    direction.  Vertex names are the ids in decimal.  Returns ``(u, v,
    path)``."""
    rng = np.random.default_rng(seed + 2)
    n, nb = CLI_YT_V, CLI_BLOCKS * CLI_BLOCK_V
    blk = np.repeat(np.arange(CLI_BLOCKS), CLI_BLOCK_V * CLI_BLOCK_IN // 2)
    u_in = blk * CLI_BLOCK_V + rng.integers(0, CLI_BLOCK_V, blk.size)
    v_in = blk * CLI_BLOCK_V + rng.integers(0, CLI_BLOCK_V, blk.size)
    u_out = np.repeat(np.arange(nb), CLI_BLOCK_OUT)
    v_out = rng.integers(nb, n, u_out.size)
    walk = nb + rng.permutation(n - nb)

    def unique_edges(u, v):
        """Canonical codes lo * n + hi of the distinct non-loop edges, in
        the order of their first occurrence."""
        lo, hi = np.minimum(u, v), np.maximum(u, v)
        code = (lo * n + hi)[lo != hi]
        _, first = np.unique(code, return_index=True)
        return code[np.sort(first)]

    planted = unique_edges(np.concatenate([u_in, u_out, walk[:-1]]),
                           np.concatenate([v_in, v_out, walk[1:]]))
    n_bg = int(1.02 * (CLI_YT_E - planted.size)) + 16
    bg = unique_edges(rng.integers(nb, n, n_bg), rng.integers(nb, n, n_bg))
    # The planted edges first, all kept; background edges up to the count.
    code = unique_edges(np.concatenate([planted // n, bg // n]),
                        np.concatenate([planted % n, bg % n]))[:CLI_YT_E]
    check(code.size == CLI_YT_E, f"cli graph: {code.size} unique edges, not {CLI_YT_E}")
    code = code[rng.permutation(code.size)]
    lo, hi = code // n, code % n
    flip = rng.random(code.size) < 0.5
    u, v = np.where(flip, hi, lo), np.where(flip, lo, hi)
    path = cli_file(f"youtube-{seed}-{n}v-{CLI_YT_E}e.txt",
                    lambda f: f.write(b"# planted-partition graph at com-Youtube's scale\n"
                                      + int_lines([u, v])))
    return u, v, path


def _rss_sampler():
    """A thread sampling the process's resident set (``/proc/self/statm``)
    every 20 ms; ``stop()`` returns the peak in GiB, or None where the
    file is not there."""
    import threading

    statm = Path("/proc/self/statm")
    if not statm.exists():
        return lambda: None
    page = os.sysconf("SC_PAGE_SIZE")
    peak = [0]
    done = threading.Event()

    def run():
        while not done.wait(0.02):
            peak[0] = max(peak[0], int(statm.read_text().split()[1]) * page)

    thread = threading.Thread(target=run, daemon=True)
    thread.start()

    def stop():
        done.set()
        thread.join()
        return peak[0] / 2**30

    return stop


def cli_path(sky, dev, reset_counts, read_counts, smi) -> set:
    """Phase 3l: the reference's command-line drivers, run in process
    through each one's ``main(argv)`` on the card, on files written from
    the seed (``cli_ls_data``, ``cli_mnist_data``, ``cli_graph_data``):
    ``linear`` three times (Blendenpik with ``--cond-est``, ``--solver
    sketched``, ``--stream``), ``svd``, ``krr`` and ``ml`` (Fastfood
    maps), ``graph_se`` (``--streamed``, and in core with power
    iterations), ``community`` and ``convert2hdf5``.  Each driver runs
    with the launch counters and the native parser's counters reset
    before it and read after it (path ``cli (<driver>)``); its host
    seconds are split into the read (the native parse inside it), the
    copy to the card and the rest, beside its peak memory.  Each result
    is held to its bound in PERF.md §2 beside a control that misses, and
    the first launch of each kernel signature against its plain version.
    Returns the signatures held and the LIBSVM files (``ls``, ``train``,
    ``test``), which phase 3m reads again."""
    import contextlib
    import io as io_

    from libskylark_tpu_torch import native
    from libskylark_tpu_torch.cli import common as cli_common
    from libskylark_tpu_torch.graph import stream as gs
    from libskylark_tpu_torch.sketch import kernels_fut as kf
    from libskylark_tpu_torch.sketch import kernels_scatter as ks
    from libskylark_tpu_torch.sketch import kernels_window as kw

    card = f"[{smi}]"
    check(native.available(), "cli: the native C core did not build (g++)")
    print(f"cli: native library {native.library_path()} {card}")
    out_dir = CLI_DIR / "out"
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    A_q, b_q, ls_file = cli_ls_data(SEED)
    (mn_train, train_file), (mn_test, test_file) = cli_mnist_data(SEED)
    gu, gv, graph_file = cli_graph_data(SEED)
    print(f"cli: data from the seed in {time.perf_counter() - t0:.1f} s: {ls_file.name}, "
          f"{train_file.name}, {test_file.name}, {graph_file.name} (no rows cut)")

    held = set()

    def segsum_held(out, vals, keys, segs):
        ref = ks.segment_sum_flat_plain(vals, keys, segs)
        _, r = max_err(out, ref)
        i = int(vals.abs().argmax())
        ctl = ks.segment_sum_flat_plain(torch.cat([vals[:i], vals[i + 1:]]),
                                        torch.cat([keys[:i], keys[i + 1:]]), segs)
        _, c = max_err(out, ctl)
        print(f"cli (held) segment_sum_flat {vals.shape[0]} -> {segs} {vals.dtype}: vs its plain "
              f"version rel {r:.3g} (tol 1e-5); control (the plain version without entry {i}) "
              f"{c:.3g}")
        check(r <= 1e-5 and c > 1e-5, f"cli segment_sum_flat {vals.shape[0]}: {r}, control {c}")

    restore = hold_kernels("cli", kf, kw, ("rfut_rowwise", "rfut_rowwise_sampled",
                                           "gather_scaled_rows", "scatter_rows"), held)
    restore.append((ks, "segment_sum_flat", hold(ks, "segment_sum_flat", segsum_held, held)))

    # Host seconds of the drivers' reads and copies, from stand-ins for
    # the functions they call (looked up at call time, as the drivers
    # import them inside main).
    spent = {}

    def timed(mod, name, key, sync=False):
        fn = getattr(mod, name)

        def stand_in(*args, **kwargs):
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            if sync:
                torch.cuda.synchronize()
            spent[key] = spent.get(key, 0.0) + time.perf_counter() - t
            return out

        setattr(mod, name, stand_in)
        return mod, name, fn

    restore += [timed(sky.io, "read_libsvm", "read"), timed(sky.graph, "read_arc_list", "read"),
                timed(sky.io, "scan_libsvm_dims", "scan"),
                timed(cli_common, "to_device", "copy", sync=True)]
    totals, by_kernel = {}, {}

    def drive(label, name, argv, expect, file_mb, libsvm=True):
        from importlib import import_module

        main_fn = import_module(f"libskylark_tpu_torch.cli.{name}").main
        spent.clear()
        reset_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        stop_rss = _rss_sampler()
        buf = io_.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = main_fn([str(a) for a in argv])
        torch.cuda.synchronize()
        total = time.perf_counter() - t
        host_peak = stop_rss()
        out = buf.getvalue()
        for line in out.splitlines():
            print(f"cli ({label}) | {line}")
        check(rc == 0, f"cli ({label}): exit code {rc}")
        counts = read_counts(f"cli ({label})", t, expect)
        if libsvm:
            check(native.parse_libsvm_bytes.calls > 0,
                  f"cli ({label}): the LIBSVM reads did not go through the native parser")
        for name, count in counts.items():
            by_kernel[name] = by_kernel.get(name, 0) + count
        calls, nbytes, nsec = (native.parse_libsvm_bytes.calls, native.parse_libsvm_bytes.bytes,
                               native.parse_libsvm_bytes.seconds)
        read, scan, copy = (spent.get(k, 0.0) for k in ("read", "scan", "copy"))
        native_s = (f"native parser {calls} calls, {nbytes / 1e6:.1f} MB in {nsec:.3f} s "
                    f"({nbytes / 1e6 / nsec:.1f} MB/s)" if calls else "native parser not called")
        read_s = (f"read {read:.3f} s ({file_mb / read:.1f} MB/s of {file_mb:.1f} MB)" if read
                  else f"read inside the stream ({file_mb:.1f} MB)")
        if scan:
            read_s += f" + the shape scan {scan:.3f} s ({file_mb / scan:.1f} MB/s)"
        print(f"cli ({label}): {total:.3f} s of host clock = {read_s}; {native_s}; copy to the "
              f"card {copy:.3f} s; solve and the rest {total - read - scan - copy:.3f} s; "
              f"peak memory on the card {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB, "
              f"host resident {host_peak if host_peak is None else round(host_peak, 2)} GiB "
              f"{card}")
        totals[label] = {"seconds": total, "read": read, "scan": scan, "copy": copy,
                         "native_calls": calls}
        return out, counts

    def mb(path):
        return path.stat().st_size / 1e6

    def number(pattern, out):
        found = re.search(pattern, out)
        check(found is not None, f"cli: no {pattern!r} in the driver's output")
        return float(found.group(1))

    # (a) linear: Blendenpik (the default) with --cond-est, sketch-and-solve,
    # and the streamed sketch-and-solve, each against an f64 lstsq.
    A64, b64 = A_q / 1e6, b_q / 1e6
    x_ref, *_ = np.linalg.lstsq(A64, b64, rcond=None)
    r_ref = float(np.linalg.norm(A64 @ x_ref - b64))

    def solution(path):
        x = np.load(path).astype(np.float64)
        return x, float(np.linalg.norm(A64 @ x - b64)) / r_ref, \
            float(np.abs(x - x_ref).max() / np.abs(x_ref).max())

    out, _ = drive("linear", "linear", [ls_file, "--cond-est", "--solution", out_dir / "x_acc.npy"],
                   ("gather_scaled_rows", "scatter_rows"), mb(ls_file))
    x_acc, ratio_acc, err_acc = solution(out_dir / "x_acc.npy")
    cond = number(r"Cond-est: cond ([0-9.e+-]+),", out)
    A_dev = torch.from_numpy(A64.astype(np.float32)).to(dev)
    s_ce = 4 * CLI_LS_N
    SA = sky.sketch.CWT(CLI_LS_M, s_ce, sky.SketchContext(seed=38734)).apply(A_dev)
    cond_exact = float(np.linalg.cond(SA.double().cpu().numpy()))
    SA_ctl = SA.double().clone()
    SA_ctl[:, 0] *= 100.0
    cond_ctl = float(np.linalg.cond(SA_ctl.cpu().numpy()))
    print(f"cli (linear): Blendenpik x vs the f64 lstsq max rel {err_acc:.3g} (bound "
          f"{NLA_X_TOL}), residual ratio {ratio_acc!r} (bound {NLA_RATIO_BOUND}); --cond-est "
          f"{cond:.6g} against cond(S·A) {cond_exact:.6g} of the same CWT sketch (within 1.1x); "
          f"control (column 0 of S·A scaled by 100) {cond_ctl:.6g}")
    check(err_acc <= NLA_X_TOL and ratio_acc <= NLA_RATIO_BOUND,
          f"cli (linear): x rel {err_acc}, ratio {ratio_acc}")
    check(max(cond / cond_exact, cond_exact / cond) <= 1.1 < cond_ctl / cond,
          f"cli (linear): cond-est {cond}, exact {cond_exact}, control {cond_ctl}")
    del SA, SA_ctl

    drive("linear sketched", "linear", [ls_file, "--solver", "sketched", "--solution",
                                        out_dir / "x_sk.npy"], ("gather_scaled_rows",), mb(ls_file))
    x_sk, ratio_sk, err_sk = solution(out_dir / "x_sk.npy")
    S_n = sky.sketch.FJLT(CLI_LS_M, CLI_LS_N, sky.SketchContext(seed=38734))
    b_dev = torch.from_numpy(b64.astype(np.float32)).to(dev)
    x_ctl = torch.linalg.lstsq(S_n.apply(A_dev), S_n.apply(b_dev[:, None])).solution[:, 0]
    ratio_ctl = float(np.linalg.norm(A64 @ x_ctl.double().cpu().numpy() - b64)) / r_ref
    print(f"cli (linear sketched): residual ratio {ratio_sk!r} (bound {LS_RATIO_BOUND}); control "
          f"(FJLT at s = n) {ratio_ctl:.4g}; the Blendenpik bound on x (control for it) missed "
          f"by this x: {err_sk:.3g}")
    check(ratio_sk <= LS_RATIO_BOUND < ratio_ctl and err_sk > NLA_X_TOL,
          f"cli (linear sketched): ratio {ratio_sk}, control {ratio_ctl}, x rel {err_sk}")

    drive("linear stream", "linear", [ls_file, "--stream", "--batch-rows", CLI_LS_BATCH,
                                      "--solution", out_dir / "x_st.npy"], (), mb(ls_file))
    x_st, ratio_st, _ = solution(out_dir / "x_st.npy")

    def whole_file(seed):
        S = sky.sketch.JLT(CLI_LS_M, 4 * CLI_LS_N, sky.SketchContext(seed=seed))
        return sky.linalg.exact_least_squares(S.apply(A_dev), S.apply(b_dev[:, None]))[:, 0]

    x_whole = whole_file(38734).double().cpu().numpy()
    x_other = whole_file(38735).double().cpu().numpy()
    d_st = float(np.abs(x_st - x_whole).max() / np.abs(x_whole).max())
    d_ctl = float(np.abs(x_other - x_whole).max() / np.abs(x_whole).max())
    print(f"cli (linear stream): residual ratio {ratio_st!r} (bound {LS_RATIO_BOUND}); x vs the "
          f"whole-file solve with the stream's sketch (JLT, s = 4n) max rel {d_st:.3g} (tol 1e-5, "
          f"the streaming tests' f32 bound); control (the same at seed + 1) {d_ctl:.3g}; "
          f"Blendenpik x vs this x {float(np.abs(x_acc - x_st).max() / np.abs(x_st).max()):.3g} "
          f"(different sketches: not checked)")
    check(ratio_st <= LS_RATIO_BOUND and d_st <= 1e-5 < d_ctl,
          f"cli (linear stream): ratio {ratio_st}, vs whole file {d_st}, control {d_ctl}")
    del A_dev, b_dev, x_ctl

    # (b) svd, rank CLI_LS_TOP, two power iterations, on the same file.
    drive("svd", "svd", [ls_file, "-k", CLI_LS_TOP, "-i", 2, "--prefix", out_dir / "year"], (),
          mb(ls_file))
    s_got = np.load(out_dir / "year.S.npy").astype(np.float64)
    s_ref = np.sqrt(np.linalg.eigvalsh(A64.T @ A64)[::-1][:CLI_LS_TOP])
    Q = np.linalg.qr(np.random.default_rng(SEED).standard_normal((CLI_LS_N, CLI_LS_TOP)))[0]
    s_ctl = np.linalg.svd(A64 @ Q, compute_uv=False)
    e_svd = float(np.abs(s_got - s_ref).max() / s_ref[0])
    e_ctl = float(np.abs(s_ctl - s_ref).max() / s_ref[0])
    print(f"cli (svd): sigma vs sqrt(eigvalsh(A^T A)) f64 max rel {e_svd:.3g} (bound 1e-3); "
          f"control (A on a random {CLI_LS_TOP}-dim basis) {e_ctl:.3g}")
    check(e_svd <= 1e-3 < e_ctl, f"cli (svd): {e_svd}, control {e_ctl}")
    del A64, b64, A_q, b_q

    # (c) krr (approximate RLSC on Fastfood features) and ml (BlockADMM on
    # Fastfood maps) on the mnist-shaped files: test accuracy, a control of
    # random coefficients, and the saved model reloaded on the card and on
    # the CPU.
    (Xt_q, yt), files_mb = mn_test, mb(train_file) + mb(test_file)
    Xt = torch.from_numpy((Xt_q / 1e6).astype(np.float32)).to(dev)
    del mn_train

    def model_checks(label, out, model_file):
        acc = number(r"Test accuracy: ([0-9.]+)%", out) / 100
        model = sky.ml.load_model(str(model_file))
        pred = model.predict_labels(Xt).cpu().numpy()
        acc_reload = float((pred == yt).mean())
        W = model.W
        model.W = torch.randn(W.shape, generator=torch.Generator(dev).manual_seed(SEED),
                              device=dev, dtype=W.dtype)
        acc_ctl = float((model.predict_labels(Xt).cpu().numpy() == yt).mean())
        model.W = W
        rows = Xt[:ML_CHECK_ROWS]
        on_cpu = sky.ml.load_model(str(model_file), device="cpu").predict(rows.cpu())
        _, e_cpu = max_err(model.predict(rows).cpu(), on_cpu)
        print(f"cli ({label}): test accuracy {acc:.4f} (bound {CLI_ACC_BOUND}); the model file "
              f"reloaded predicts {acc_reload:.4f}; control (random coefficients) {acc_ctl:.4f}; "
              f"card vs the CPU route on {ML_CHECK_ROWS} rows rel {e_cpu:.3g} (tol "
              f"{TRAIN_CPU_TOL})")
        check(acc >= CLI_ACC_BOUND > acc_ctl and abs(acc_reload - acc) < 1e-4
              and e_cpu <= TRAIN_CPU_TOL,
              f"cli ({label}): acc {acc}, reloaded {acc_reload}, control {acc_ctl}, cpu {e_cpu}")

    out, _ = drive("krr", "krr", ["--trainfile", train_file, "--testfile", test_file,
                                  "--modelfile", out_dir / "krr.json", "-a", 2, "--use-fast",
                                  "-f", CLI_MN_S, "--sigma", CLI_MN_SIGMA, "--lambda", CLI_MN_LAM],
                   ("rfut_rowwise",), files_mb)
    model_checks("krr", out, out_dir / "krr.json")
    out, _ = drive("ml", "ml", ["--trainfile", train_file, "--testfile", test_file, "--modelfile",
                                out_dir / "ml.json", "--usefast", "-g", CLI_MN_SIGMA, "-f", CLI_MN_S,
                                "-n", 4, "-i", CLI_ML_ITERS, "-l", "hinge", "--lambda", CLI_ML_LAM],
                   ("rfut_rowwise",), files_mb)
    model_checks("ml", out, out_dir / "ml.json")
    acc_train_run = number(r"Test accuracy: ([0-9.]+)%", out)
    out, _ = drive("ml predict", "ml", ["--testfile", test_file, "--modelfile", out_dir / "ml.json",
                                        "--outputfile", out_dir / "ml.pred", "--batch", 4096],
                   ("rfut_rowwise",), mb(test_file))
    acc_stream = number(r"Test accuracy: ([0-9.]+)%", out)
    n_pred = len((out_dir / "ml.pred").read_text().splitlines())
    print(f"cli (ml predict): the saved model's streamed predict {acc_stream}% on {n_pred} rows, "
          f"the training run's {acc_train_run}%")
    check(acc_stream == acc_train_run and n_pred == CLI_MN_T,
          f"cli (ml predict): {acc_stream} vs {acc_train_run}, {n_pred} predictions")
    del Xt

    # (d) graph_se, streamed (the adjacency sketch folded in edge blocks)
    # and in core with power iterations, and community, on the arc list.
    n = CLI_YT_V
    flat = np.stack([gu, gv], axis=1).ravel()
    names, first = np.unique(flat, return_index=True)
    ids = np.empty(n, np.int64)
    ids[names[np.argsort(first)]] = np.arange(names.size)  # read_arc_list's interning
    check(names.size == n, f"cli graph: {names.size} vertices named, not {n}")
    r, c = ids[gu], ids[gv]
    g_idx = torch.from_numpy(np.stack([np.concatenate([r, c]), np.concatenate([c, r])]))
    A_cpu = torch.sparse_coo_tensor(g_idx, torch.ones(g_idx.shape[1]), (n, n),
                                    check_invariants=False)
    out, _ = drive("graph_se streamed", "graph_se",
                   [graph_file, "--streamed", "-k", CLI_ASE_K, "--batch-edges", 1 << 20,
                    "--prefix", out_dir / "yt_streamed"], ("segment_sum_flat",), mb(graph_file),
                   libsvm=False)

    def eigenvalues(out):
        found = re.search(r"eigenvalues: \[([^\]]*)\]", out)
        check(found is not None, "cli graph_se: no eigenvalues printed")
        return np.array([float(v) for v in found.group(1).split()])

    lam = eigenvalues(out)

    def lam_cpu(seed):
        S = sky.sketch.SJLT(n, 2 * CLI_ASE_K, sky.SketchContext(seed=seed))
        _, lam_ = gs.ase_from_sketch(gs.incore_adjacency_sketch(A_cpu, S), S, CLI_ASE_K)
        return np.sort(lam_.numpy().astype(np.float64))

    ref, other = lam_cpu(38734), lam_cpu(38735)
    e_lam = float(np.abs(np.sort(lam) - ref).max() / np.abs(ref).max())
    e_ctl = float(np.abs(other - ref).max() / np.abs(ref).max())
    print(f"cli (graph_se streamed): eigenvalues vs the CPU eigensolve of the plain in-core sketch "
          f"rel {e_lam:.3g} (tol 1e-4, phase 3c's); control (the sketch at seed + 1) {e_ctl:.3g}")
    check(e_lam <= 1e-4 < e_ctl, f"cli (graph_se streamed): {e_lam}, control {e_ctl}")

    out, _ = drive("graph_se", "graph_se", [graph_file, "--sparse", "-i", ASE_ITERS, "-k",
                                            CLI_ASE_K, "--prefix", out_dir / "yt"], (),
                   mb(graph_file), libsvm=False)
    lam = torch.from_numpy(eigenvalues(out)).to(dev, torch.float32)
    X = torch.from_numpy(np.load(out_dir / "yt.X.npy")).to(dev)
    V = X / lam.abs().sqrt()[None, :]
    A_g = A_cpu.float().to(dev)

    def residuals(B):
        return (torch.sparse.mm(A_g, B) - B * lam[None, :]).norm(dim=0) / lam.abs()

    res = residuals(V)
    g = torch.Generator(dev).manual_seed(SEED)
    res_ctl = residuals(torch.linalg.qr(torch.randn(n, CLI_ASE_K, generator=g, device=dev))[0])
    print(f"cli (graph_se): in core, sparse, q = {ASE_ITERS}: max ||A v - lam v|| / |lam| "
          f"{float(res.max()):.3g} (bound {ASE_RES_BOUND}); control (a random orthonormal basis) "
          f"min {float(res_ctl.min()):.3g}")
    check(float(res.max()) <= ASE_RES_BOUND < float(res_ctl.min()),
          f"cli (graph_se): residuals {res.tolist()}, control {res_ctl.tolist()}")
    del A_g, X, V, A_cpu, g_idx

    deg = np.bincount(np.concatenate([gu, gv]), minlength=n)
    vol_all = int(deg.sum())

    def conductance(members):
        inside = np.zeros(n, bool)
        inside[members] = True
        cut = int((inside[gu] != inside[gv]).sum())
        vol = int(deg[members].sum())
        return cut / min(vol, vol_all - vol), vol

    planted, vol = conductance(np.arange(CLI_BLOCK_V))
    out, _ = drive("community", "community", [graph_file, "--seed", 0, "--recursive",
                                              "--epsilon", LC_EPS], (), mb(graph_file),
                   libsvm=False)
    cond_found = number(r"Conductance: ([0-9.]+)", out)
    members = np.array(out.split("Cluster:")[1].split(), np.int64)
    perm = np.random.default_rng(SEED).permutation(n)
    random_set = perm[:int(np.searchsorted(np.cumsum(deg[perm]), vol)) + 1]
    ctl, _ = conductance(random_set)
    overlap = len(set(members.tolist()) & set(range(CLI_BLOCK_V))) / len(
        set(members.tolist()) | set(range(CLI_BLOCK_V)))
    print(f"cli (community): from vertex 0, recursive, epsilon {LC_EPS}: {members.size} vertices, "
          f"conductance {cond_found:.6f} against the planted block's {planted:.6f} (within "
          f"{LC_COND_TOL:.0%}), Jaccard overlap {overlap:.4f}; control (a random set of the same "
          f"volume) {ctl:.4f}")
    check(abs(cond_found - planted) <= LC_COND_TOL * planted < abs(ctl - planted),
          f"cli (community): {cond_found}, planted {planted}, control {ctl}")

    # (e) convert2hdf5: HDF5 needs h5py, which a machine may lack.
    try:
        import h5py  # noqa: F401
    except ImportError:
        from libskylark_tpu_torch.cli.convert2hdf5 import main as convert

        try:
            convert([str(test_file), str(out_dir / "test.h5")])
            fail("cli (convert2hdf5): ran without h5py")
        except ImportError as e:
            print(f"cli (convert2hdf5): not run here: {e}")
    else:
        drive("convert2hdf5", "convert2hdf5", [test_file, out_dir / "test.h5"], (), mb(test_file))
        Xh, yh = sky.io.read_hdf5(out_dir / "test.h5")
        check(np.array_equal(yh, yt) and np.array_equal(Xh, Xt_q / 1e6),
              "cli (convert2hdf5): the HDF5 file does not hold the test split")

    for mod, name, fn in restore:
        setattr(mod, name, fn)
    print(f"cli: launches over the drivers {by_kernel}; host seconds "
          f"{ {k: round(v['seconds'], 3) for k, v in totals.items()} } {card}")
    for name in ("gather_scaled_rows", "scatter_rows", "rfut_rowwise", "segment_sum_flat"):
        check(by_kernel.get(name, 0) > 0, f"cli: {name} was not launched by the drivers")
    check({name for name, count in by_kernel.items() if count} <= {sig[0] for sig in held},
          f"cli: kernels launched {by_kernel}, held {held}")
    return held, {"ls": ls_file, "train": train_file, "test": test_file}


def _ledger_events(directory: Path) -> list:
    """Every event of the ledgers under ``directory``, in ``seq`` order."""
    events = []
    for path in sorted(directory.glob("ledger-*.jsonl")):
        with open(path, encoding="utf-8") as fh:
            events += [json.loads(line) for line in fh]
    return sorted(events, key=lambda e: e["seq"])


def _port_spans() -> set:
    """The spans only the port opens (``telemetry.SPANS`` but the JAX
    package's streaming and training ones): a planned run opens some an
    eager one does not (``plans.replay``), and the JAX drivers none."""
    from libskylark_tpu_torch.telemetry import SPANS

    return set(SPANS) - {"stream.chunk", "train.stream", "train.factor", "train.iterate"}


def _kinds(events) -> list:
    """A ledger's (kind, name) sequence without the plans layer's events
    (kind ``plan``) and the port's own spans: the part an eager run, a
    planned one and the JAX driver share."""
    port = _port_spans()
    return [(e["kind"], e["name"]) for e in events
            if e["kind"] != "plan" and e["name"] not in port]


def _last_but_port_spans(events) -> dict:
    """A ledger's last event but the port's own spans (``ls.solve``
    closes after the run_summary it encloses)."""
    port = _port_spans()
    return [e for e in events if e["name"] not in port][-1]


def _comparable(counters: dict) -> dict:
    """Telemetry counters without the plans layer's and the port's own
    spans', the timing ones (and the producer thread's hit/wait split) by
    name only."""
    port = _port_spans()
    return {k: (None if "seconds" in k or k in ("prefetch.hits", "prefetch.waits",
                                                "prefetch.produced") else v)
            for k, v in counters.items()
            if not k.startswith("plans.")
            and not (k.startswith("span.") and k[5:].rsplit(".", 1)[0] in port)}


def _bitwise(a, b) -> bool:
    """``a`` and ``b`` (tensors, numbers, nests of dicts and lists) equal
    bitwise, wall-clock ``seconds`` aside."""
    if isinstance(a, dict):
        return (isinstance(b, dict) and set(a) - {"seconds"} == set(b) - {"seconds"}
                and all(_bitwise(a[k], b[k]) for k in a if k != "seconds"))
    if isinstance(a, (list, tuple)):
        return (isinstance(b, (list, tuple)) and len(a) == len(b)
                and all(_bitwise(x, y) for x, y in zip(a, b)))
    if torch.is_tensor(a):
        return torch.is_tensor(b) and a.dtype == b.dtype and torch.equal(a, b)
    return a == b or (a != a and b != b)


def telemetry_path(sky, dev, reset_counts, read_counts, smi, cli_files) -> set:
    """Phase 3m: the telemetry layer and the randomized Gauss-Seidel
    solvers on the card.

    (a) bench.py's ``bench_telemetry`` acceptance run (TM_M x TM_N f32 in
    batches of TM_BATCH; rank-deficient A, ``FaultPlan(bad_sketch_at=1)``,
    guard on) with the default JLT and with CWT, its ledger held to
    ``tests/test_telemetry.py:185-230``; (b) telemetry off against on,
    bitwise, with equal launch counts, on the kernel paths, its host
    seconds off and on, and each call's telemetry counters planned against
    eager; (c) the drivers' ``--telemetry-dir`` and ``--telemetry`` on
    phase 3l's files (``cli_files``); (d) ``randomized_block_gauss_seidel``
    and ``asy_fcg`` at GS_N, an SPD A of condition number GS_COND; (e)
    ``utils.profiling.trace`` around two (b) solves.  Every first launch
    of a kernel signature is held against its plain version.  Returns the
    signatures held."""
    import contextlib
    import io as io_
    import shutil

    from libskylark_tpu_torch import telemetry
    from libskylark_tpu_torch.sketch import kernels_fut as kf
    from libskylark_tpu_torch.sketch import kernels_scatter as ks
    from libskylark_tpu_torch.sketch import kernels_window as kw
    from libskylark_tpu_torch.solvers import gauss_seidel as gs_mod

    card = f"[{smi}]"
    knob = os.environ.get("SKYLARK_TELEMETRY")
    check(not telemetry.enabled(), f"telemetry: SKYLARK_TELEMETRY={knob!r} before phase 3m")
    check(sky.guard.enabled(), "telemetry: the guard is off")
    shutil.rmtree(TM_DIR, ignore_errors=True)
    g = torch.Generator(device=dev).manual_seed(SEED + 18)
    held = set()
    u = 2.0 ** -24

    def scatter_held(out, A, b, v, segs, acc=None):
        b, v = (b[None], v[None]) if b.ndim == 1 else (b, v)
        part, err_bound, (row, piece) = scatter_error_bound(A, b, v, segs, kw._L)
        exact = part if acc is None else acc.double() + part
        if acc is not None:
            err_bound = err_bound + u * 1.01 * exact.abs()  # the fused emit's one add
        r = bound_ratio(out, exact, err_bound)
        c = bound_ratio(out[row].double() - piece, exact[row], err_bound[row])
        print(f"telemetry (held) scatter_rows{'(acc=)' if acc is not None else ''} A "
              f"{tuple(A.shape)} {A.dtype} -> {segs}, nnz = {b.shape[0]}: max |out - exact| / "
              f"rounding bound {r:.3g} (must be <= 1); control (bucket {row}'s first piece left "
              f"out) {c:.3g}")
        check(r <= 1.0 and c > 1.0, f"telemetry scatter_rows {tuple(A.shape)}: {r}, control {c}")

    def segsum_held(out, vals, keys, segs):
        _, r = max_err(out, ks.segment_sum_flat_plain(vals, keys, segs))
        i = int(vals.abs().argmax())
        _, c = max_err(out, ks.segment_sum_flat_plain(torch.cat([vals[:i], vals[i + 1:]]),
                                                      torch.cat([keys[:i], keys[i + 1:]]), segs))
        print(f"telemetry (held) segment_sum_flat {vals.shape[0]} -> {segs} {vals.dtype}: vs its "
              f"plain version rel {r:.3g} (tol 1e-5); control (the plain version without entry "
              f"{i}) {c:.3g}")
        check(r <= 1e-5 and c > 1e-5, f"telemetry segment_sum_flat {vals.shape[0]}: {r}, "
              f"control {c}")

    restore = hold_kernels("telemetry", kf, kw, ("rfut_rowwise", "rfut_rowwise_sampled",
                                                 "gather_scaled_rows"), held)
    restore.append((kw, "scatter_rows", hold(kw, "scatter_rows", scatter_held, held)))
    restore.append((ks, "segment_sum_flat", hold(ks, "segment_sum_flat", segsum_held, held)))

    @contextmanager
    def telemetry_on(label):
        """Telemetry on for the body, its ledger under TM_DIR/label (closed
        after), the registry zeroed before; the knob put back after."""
        os.environ["SKYLARK_TELEMETRY"] = "1"
        telemetry.configure(TM_DIR / label)
        telemetry.reset()
        try:
            yield TM_DIR / label
        finally:
            telemetry.close()
            telemetry.configure(None)
            os.environ.pop("SKYLARK_TELEMETRY")

    try:
        # -- (a) the JAX package's acceptance run, bench_telemetry's size -------
        A = torch.randn(TM_M, TM_N, generator=g, device=dev)
        A[:, -1] = A[:, 0]  # rank-deficient: the certificate says RESKETCH
        b = torch.randn(TM_M, generator=g, device=dev)
        A_h, b_h = A.cpu().pin_memory(), b.cpu().pin_memory()
        del A, b

        def factory(start):
            for i in range(start, TM_M // TM_BATCH):
                yield A_h[i * TM_BATCH:(i + 1) * TM_BATCH], b_h[i * TM_BATCH:(i + 1) * TM_BATCH]

        def stream_ls(stype):
            return sky.linalg.streaming_least_squares(
                factory, TM_M, TM_N, sky.SketchContext(seed=SEED + 18),
                sky.linalg.LeastSquaresParams(sketch_type=stype),
                fault_plan=sky.resilient.FaultPlan(bad_sketch_at=1))

        for stype, expect in ((None, ()), ("CWT", ("scatter_rows",))):
            label = f"(a) {stype or 'JLT'}"
            reset_counts()
            t0 = time.perf_counter()
            with telemetry_on(f"a-{stype or 'JLT'}") as where:
                x, info = stream_ls(stype)
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
                plan_stats = sky.plans.stats()
                snap = telemetry.snapshot()
            read_counts(f"telemetry {label}", t0, expect)
            events = _ledger_events(where)
            kinds = set(_kinds(events))
            chunk_ends = [e for e in events if (e["kind"], e["name"]) == ("span_end", "stream.chunk")]
            replays = [e for e in events if (e["kind"], e["name"]) == ("guard", "replay")]
            initial = [e for e in events if (e["kind"], e["name"]) == ("guard", "initial")]
            summaries = [e for e in events if e["kind"] == "run_summary"]
            payload = summaries[-1]["attrs"] if summaries else {"info": {}, "snapshot": {}}
            snapshot = payload["snapshot"]
            checks = {
                "stream.chunk spans, each with rows": (
                    ("span_start", "stream.chunk") in kinds and bool(chunk_ends)
                    and all("rows" in e["attrs"] for e in chunk_ends)
                    and sum(e["attrs"]["rows"] for e in chunk_ends) == TM_M),
                "one replay": len(replays) == 1,
                "initial RESKETCH, then a fallback": (
                    bool(initial) and initial[-1]["attrs"]["verdict"] == "RESKETCH"
                    and ("guard", "fallback") in kinds),
                "one run_summary, the last seq": (
                    len(summaries) == 1 and summaries[0]["name"] == "streaming_lsq"
                    and summaries[0]["seq"] == _last_but_port_spans(events)["seq"]),
                "its info is the returned info": (
                    set(payload["info"]) == set(info)
                    and payload["info"].get("recovery") == info["recovery"]
                    and payload["info"].get("rows") == TM_M),
                "snapshot.plans == plans.stats()": snapshot.get("plans") == plan_stats,
                "guard.replay = stream.replays = 1": (
                    snapshot.get("guard", {}).get("replay") == 1
                    and snapshot.get("counters", {}).get("stream.replays") == 1),
            }
            check(tuple(x.shape) == (TM_N,) and bool(torch.isfinite(x).all()),
                  f"telemetry {label}: x not finite of shape ({TM_N},)")
            print(f"telemetry {label} streaming LS {TM_M} x {TM_N} in {TM_M // TM_BATCH} batches: "
                  f"{len(events)} ledger events in {secs:.3f} s; ledger checks {checks}; "
                  f"plan_cache_hit_rate {snap['plan_cache_hit_rate']}, prefetch_overlap "
                  f"{snap['prefetch_overlap']}, overlap_efficiency {snap['overlap_efficiency']} "
                  f"{card}")
            check(all(checks.values()), f"telemetry {label}: ledger checks {checks}")

        # -- (b) telemetry off against on, bitwise, on the kernel paths -----------
        def lsq(A, b, **kw_):
            return lambda: sky.linalg.approximate_least_squares(
                A, b, sky.SketchContext(seed=SEED), sky.linalg.LeastSquaresParams(**kw_),
                return_info=True)

        def compare_off_on(label, fn, expect, warm=True):
            outs, secs, counts, planned = {}, {}, {}, None
            if warm:  # a plan's first call runs its body once more, eagerly
                fn()
            telemetry.reset()
            for mode in ("off", "on"):
                reset_counts()
                t0 = time.perf_counter()
                ctx = telemetry_on(f"b-{label}") if mode == "on" else contextlib.nullcontext()
                runs = []
                with ctx:
                    # The registry zeroed before each run: it ends with the
                    # last run's counters.
                    secs[mode] = host_median(
                        lambda: (mode == "on" and telemetry.reset(), runs.append(fn())),
                        reps=TM_REPEATS)
                    if mode == "on":
                        planned = _comparable(telemetry.REGISTRY.snapshot()["counters"])
                counts[mode] = read_counts(f"telemetry (b) {label} {mode}", t0, expect)
                outs[mode] = runs[-1]
                check(mode == "on" or telemetry.REGISTRY.snapshot()["counters"] == {},
                      f"telemetry (b) {label}: the off runs counted")
            with telemetry_on(f"b-{label}-eager"), no_plans():
                fn()
                eager = _comparable(telemetry.REGISTRY.snapshot()["counters"])
            same = _bitwise(outs["off"], outs["on"])
            print(f"telemetry (b) {label}: off ≡ on bitwise {same}; launches off {counts['off']}, "
                  f"on {counts['on']}; host s median of {TM_REPEATS} off {secs['off'][0]!r} "
                  f"({[round(r, 4) for r in secs['off'][1]]}), on {secs['on'][0]!r} "
                  f"({[round(r, 4) for r in secs['on'][1]]}), on/off "
                  f"{secs['on'][0] / secs['off'][0]:.4f}; counters planned ≡ eager "
                  f"{planned == eager} ({len(planned)} counters) {card}")
            check(same and counts["off"] == counts["on"] and planned == eager,
                  f"telemetry (b) {label}: bitwise {same}, launches {counts}, counters planned "
                  f"{planned} eager {eager}")
            return secs

        # (a)'s runs warmed the streams up (their steps are not planned).
        overhead = {}
        for stype, expect in ((None, ()), ("CWT", ("scatter_rows",))):
            overhead[f"stream {stype or 'JLT'}"] = compare_off_on(
                f"stream {stype or 'JLT'}", lambda: stream_ls(stype), expect, warm=False)
        del A_h, b_h
        A = torch.randn(NLA_M, NLA_N, generator=g, device=dev)
        b = A @ torch.randn(NLA_N, generator=g, device=dev) + torch.randn(NLA_M, generator=g,
                                                                          device=dev)
        overhead["LS FJLT"] = compare_off_on(
            "LS FJLT 2^20 x 512", lsq(A, b, sketch_size=2048), ("gather_scaled_rows",))
        overhead["LS CWT"] = compare_off_on(
            "LS CWT 2^20 x 512", lsq(A, b, sketch_type="CWT", sketch_size=2048),
            ("scatter_rows",))
        del A, b
        A = torch.randn(PL_B_M, PL_B_N, generator=g, device=dev)
        b = A @ torch.randn(PL_B_N, generator=g, device=dev) + torch.randn(PL_B_M, generator=g,
                                                                           device=dev)
        small_ls = lsq(A, b, sketch_size=3072)
        overhead["LS FJLT small"] = compare_off_on(
            "LS FJLT 32768 x 768", small_ls, ("rfut_rowwise_sampled",))

        # -- (e) utils.profiling around two (b) solves: the planned FJLT solve
        # above, and the same A streamed in 8 batches with CWT.
        trace_dir = TM_DIR / "trace"
        with telemetry_on("e"):
            with sky.utils.profiling.trace(str(trace_dir)):
                small_ls()
                sky.linalg.streaming_least_squares(
                    lambda start: ((A[i * 4096:(i + 1) * 4096], b[i * 4096:(i + 1) * 4096])
                                   for i in range(start, PL_B_M // 4096)), PL_B_M, PL_B_N,
                    sky.SketchContext(seed=SEED), sky.linalg.LeastSquaresParams(sketch_type="CWT"))
                torch.cuda.synchronize()
        (trace_file,) = list(trace_dir.glob("trace-*.json"))
        trace_events = json.loads(trace_file.read_text())["traceEvents"]
        names = sorted({e.get("name") for e in trace_events} & {"sketch.apply", "stream.chunk"})
        kernels_n = sum(1 for e in trace_events if e.get("cat") == "kernel")
        print(f"telemetry (e) profiling.trace: {trace_file.name} "
              f"{trace_file.stat().st_size / 1e6:.1f} MB, annotate regions found {names}, "
              f"{kernels_n} CUDA kernel events {card}")
        # (A CPU rehearsal's trace holds no CUDA kernel.)
        check(names == ["sketch.apply", "stream.chunk"] and (kernels_n > 0 or dev.type == "cpu"),
              f"telemetry (e): regions {names}, kernel events {kernels_n}")
        del A, b
        # The sparse SJLT stream: phase 3b's rows and nonzeros, TM_N columns,
        # COO batches staged on the card.
        rows_b, nnz_b = TM_SP_M // TM_SP_BATCHES, TM_SP_NNZ // TM_SP_BATCHES
        sp_batches = []
        for _ in range(TM_SP_BATCHES):
            idx = torch.stack([
                torch.randint(0, rows_b, (nnz_b,), generator=g, device=dev),
                torch.randint(0, TM_N, (nnz_b,), generator=g, device=dev)])
            sp_batches.append((
                torch.sparse_coo_tensor(idx, torch.randn(nnz_b, generator=g, device=dev),
                                        (rows_b, TM_N), check_invariants=False),
                torch.randn(rows_b, generator=g, device=dev)))

        def sparse_stream():
            # The batches already lie on the card: no staging thread.
            return sky.linalg.streaming_least_squares(
                lambda start: iter(sp_batches[start:]), TM_SP_M, TM_N,
                sky.SketchContext(seed=SEED + 19),
                sky.linalg.LeastSquaresParams(sketch_type="SJLT"), sparse=True,
                stream_params=sky.streaming.StreamParams(prefetch=0, placer=None))

        overhead["sparse SJLT stream"] = compare_off_on(
            "sparse SJLT stream 10^6 x 512, 10^7 nnz", sparse_stream, ("segment_sum_flat",))
        del sp_batches
        # Approximate KRR on Fastfood features at phase 3f's shape.
        X = torch.randn(ML_ROWS, ML_DIM, generator=g, device=dev)
        Y = torch.sign(torch.randn(ML_ROWS, generator=g, device=dev))

        def krr():
            model = sky.ml.approximate_kernel_ridge(
                sky.ml.GaussianKernel(ML_DIM, ML_SIGMA), X, Y, KRR_LAM, ML_S,
                sky.SketchContext(seed=SEED), sky.ml.KrrParams(use_fast=True))
            return model.W, model.info

        overhead["KRR Fastfood"] = compare_off_on(
            f"approximate KRR Fastfood {ML_ROWS} x {ML_DIM} -> {ML_S}", krr, ("rfut_rowwise",))
        del X, Y
        # Blendenpik and LSRN on phase 3e's problems: (a)'s column-scaled
        # Gaussian A, (c)'s rank-deficient [G, G[:, :128]].
        A = torch.randn(NLA_M, NLA_N, generator=g, device=dev)
        A *= torch.logspace(0, -1.5, NLA_N, device=dev)
        b = A @ torch.randn(NLA_N, generator=g, device=dev) + NLA_NOISE * torch.randn(
            NLA_M, generator=g, device=dev)
        overhead["Blendenpik"] = compare_off_on(
            "Blendenpik f32 2^20 x 512", lambda: sky.solvers.faster_least_squares(
                A, b, sky.SketchContext(seed=SEED)), ("gather_scaled_rows",))
        q = NLA_N // 4
        G = torch.randn(NLA_M, 3 * q, generator=g, device=dev)
        A = torch.cat([G, G[:, :q]], dim=1)
        b = G @ torch.randn(3 * q, generator=g, device=dev) + NLA_NOISE * torch.randn(
            NLA_M, generator=g, device=dev)
        del G
        overhead["LSRN"] = compare_off_on(  # its one sketch is of A, over the plans' bound
            "LSRN f32 2^20 x 512", lambda: sky.solvers.lsrn_least_squares(
                A, b, sky.SketchContext(seed=SEED)), (), warm=False)
        del A, b
        print("telemetry (b) host seconds off / on (median of "
              f"{TM_REPEATS}): " + "; ".join(f"{k} {v['off'][0]:.4f} / {v['on'][0]:.4f}"
                                             for k, v in overhead.items()) + f" {card}")

        # -- (c) the drivers' telemetry flags on phase 3l's files -------------------
        ls_file, train_file, test_file = cli_files["ls"], cli_files["train"], cli_files["test"]
        out_dir = TM_DIR / "cli"
        drivers = {
            "linear": (["linear", ls_file, "--cond-est", "--solution", out_dir / "x.npy"],
                       ("gather_scaled_rows", "scatter_rows")),
            "linear sketched": (["linear", ls_file, "--solver", "sketched", "--solution",
                                 out_dir / "x_sk.npy"], ("gather_scaled_rows",)),
            "svd": (["svd", ls_file, "-k", CLI_LS_TOP, "-i", 2, "--prefix", out_dir / "y"], ()),
            "krr": (["krr", "--trainfile", train_file, "--testfile", test_file, "--modelfile",
                     out_dir / "krr.json", "-a", 2, "--use-fast", "-f", CLI_MN_S, "--sigma",
                     CLI_MN_SIGMA, "--lambda", CLI_MN_LAM], ("rfut_rowwise",)),
            "ml": (["ml", "--trainfile", train_file, "--testfile", test_file, "--modelfile",
                    out_dir / "ml.json", "--usefast", "-g", CLI_MN_SIGMA, "-f", CLI_MN_S, "-n", 4,
                    "-i", CLI_ML_ITERS, "-l", "hinge", "--lambda", CLI_ML_LAM], ("rfut_rowwise",)),
        }
        out_dir.mkdir(parents=True, exist_ok=True)
        for label, (argv, expect) in drivers.items():
            from importlib import import_module

            where = TM_DIR / "cli" / label.replace(" ", "_")
            flags = ["--telemetry-dir", where] if label != "svd" else ["--telemetry"]
            main_fn = import_module(f"libskylark_tpu_torch.cli.{argv[0]}").main
            telemetry.reset()
            reset_counts()
            buf = io_.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = main_fn([str(a) for a in argv[1:] + flags])
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            read_counts(f"telemetry (c) {label}", t0, expect)
            out = buf.getvalue()
            for line in out.splitlines():
                print(f"telemetry (c) ({label}) | {line}")
            events = _ledger_events(where)
            ledger = _kinds(events)
            policy_counters = telemetry.snapshot()["policy"]
            checks = {
                "rc 0": rc == 0,
                "SKYLARK_TELEMETRY put back": os.environ.get("SKYLARK_TELEMETRY") == knob,
                "ledger closed": telemetry.ledger_path() is None,
                "the summary line": "telemetry: plan-cache hit rate" in out,
                "the policy line": ("policy: {" in out) == bool(policy_counters),
            }
            if label != "svd":
                summaries = [e for e in events if e["kind"] == "run_summary"]
                checks.update({
                    "the JAX driver's events": ledger == CLI_LEDGERS[label],
                    "the ledger line": (f"telemetry ledger -> " in out) == bool(events),
                    "run_summary last": (not summaries or summaries[-1]["seq"]
                                         == _last_but_port_spans(events)["seq"]),
                })
            print(f"telemetry (c) {label}: {secs:.3f} s, ledger {ledger}, policy counters "
                  f"{policy_counters}; checks {checks} {card}")
            check(all(checks.values()), f"telemetry (c) {label}: {checks}")

        # -- (d) the randomized Gauss-Seidel solvers at full width ------------------
        f64 = torch.float64
        # A = I + U diag(mu) U^T, U (GS_N, GS_R) orthonormal: eigenvalues 1
        # (GS_N - GS_R of them) and 1 + mu = 1 ... GS_COND, cond(A) = GS_COND.
        U = torch.linalg.qr(torch.randn(GS_N, GS_R, generator=g, device=dev, dtype=f64))[0]
        mu = torch.logspace(0, math.log10(GS_COND), GS_R, device=dev, dtype=f64) - 1.0
        A64 = (U * mu) @ U.T
        A64.diagonal().add_(1.0)
        orth = float((U.T @ U - torch.eye(GS_R, device=dev, dtype=f64)).abs().max())
        del U
        A = A64.float()
        lam_min = 1.0
        print(f"telemetry (d) A {GS_N} x {GS_N} f32 ({A.numel() * 4 / 2**30:.2f} GiB), SPD, "
              f"eigenvalues 1 and 1 + mu in [1, {GS_COND:g}]: cond {GS_COND:g} (U's "
              f"orthonormality max |U^T U - I| {orth:.3g}) {card}")
        check(orth < 1e-12, f"telemetry (d): U not orthonormal ({orth})")
        # The schedule on the card against the CPU route's, bitwise.
        nb_check = gs_mod.gs_num_blocks(GS_CHECK_N, GS_BLOCK)
        sched = gs_mod.gs_schedule(SEED, 7, GS_SWEEPS, nb_check, device=dev).cpu()
        sched_cpu = gs_mod.gs_schedule(SEED, 7, GS_SWEEPS, nb_check, device="cpu")
        Ac = A[:GS_CHECK_N, :GS_CHECK_N]
        Bc = torch.randn(GS_CHECK_N, 2, generator=g, device=dev)
        Xc = sky.solvers.randomized_block_gauss_seidel(Ac, Bc, sky.SketchContext(seed=SEED))[0]
        Xc_cpu = sky.solvers.randomized_block_gauss_seidel(
            Ac.cpu(), Bc.cpu(), sky.SketchContext(seed=SEED))[0]
        _, xc_rel = max_err(Xc.cpu(), Xc_cpu)
        print(f"telemetry (d) schedule at n = {GS_CHECK_N} ({GS_SWEEPS} x {nb_check}): card ≡ CPU "
              f"bitwise {torch.equal(sched, sched_cpu)}; X card vs CPU rel {xc_rel:.3g} (tol 1e-5)")
        check(torch.equal(sched, sched_cpu) and xc_rel <= 1e-5,
              f"telemetry (d): schedule bitwise {torch.equal(sched, sched_cpu)}, X {xc_rel}")
        del Ac, Bc, Xc, Xc_cpu

        def held_to_solve(label, X, B, B64, X_ref, controls):
            """X against the f64 solve X_ref: ‖X − X*‖ ≤ ‖B − A X‖ / λ_min per
            column (the run's own residual, in f64, and A's condition),
            while every control misses the same bound."""
            def rel(Y):
                R = B64 - A64 @ Y.double()
                err = torch.linalg.vector_norm(Y.double() - X_ref, dim=0)
                bnd = torch.linalg.vector_norm(B64 - A64 @ X.double(), dim=0) / lam_min
                return float((err / bnd).max()), float((err / torch.linalg.vector_norm(
                    X_ref, dim=0)).max()), float((torch.linalg.vector_norm(R, dim=0)
                                                 / torch.linalg.vector_norm(B64, dim=0)).max())
            ratio, err, res = rel(X)
            ctl = {name: rel(Y)[0] for name, Y in controls.items()}
            print(f"telemetry (d) {label}: ||X - X*|| / (||B - A X|| / lambda_min) {ratio:.4f} "
                  f"(must be <= 1), ||X - X*|| / ||X*|| {err:.3g}, ||B - A X|| / ||B|| {res:.3g}; "
                  f"controls (the same bound) " + ", ".join(f"{k} {v:.3g}" for k, v in ctl.items()))
            check(ratio <= 1.0 and all(v > 1.0 for v in ctl.values()),
                  f"telemetry (d) {label}: {ratio}, controls {ctl}")

        for k in GS_RHS:
            B = torch.randn(GS_N, k, generator=g, device=dev)
            B64 = B.double()
            X_ref = torch.linalg.solve(A64, B64)
            def solve(sweeps, B=B):
                return sky.solvers.randomized_block_gauss_seidel(
                    A, B, sky.SketchContext(seed=SEED), block_size=GS_BLOCK, sweeps=sweeps)
            reset_counts()
            t0 = time.perf_counter()
            (t_full, runs_full) = host_median(lambda: solve(GS_SWEEPS), reps=TM_REPEATS)
            (t_zero, _) = host_median(lambda: solve(0), reps=TM_REPEATS)
            read_counts(f"telemetry (d) GS k={k}", t0, ())
            X, info = solve(GS_SWEEPS)
            per_sweep = (t_full - t_zero) / GS_SWEEPS
            sweep_bytes = 4 * GS_N * GS_N + 2 * 4 * GS_N * k  # A read once, X and B
            acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts) as prof:
                solve(1)
                torch.cuda.synchronize()
            one = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
            with torch.profiler.profile(activities=acts) as prof:
                solve(0)
                torch.cuda.synchronize()
            zero = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
            dev_ms = (sum(e.device_time_total for e in one)
                      - sum(e.device_time_total for e in zero)) / 1e3
            print(f"telemetry (d) GS k={k}: {GS_SWEEPS} sweeps median {t_full!r} s "
                  f"({[round(r, 4) for r in runs_full]}), 0 sweeps {t_zero!r} s; "
                  f"{per_sweep * 1e3:.3f} ms per sweep of host clock, {dev_ms:.3f} ms of device "
                  f"kernels per sweep, bytes bound {sweep_bytes / MEM_BYTES_PER_S * 1e3:.3f} ms, "
                  f"{len(one) - len(zero)} device launches per sweep "
                  f"({(len(one) - len(zero)) / gs_mod.gs_num_blocks(GS_N, GS_BLOCK):.1f} per "
                  f"block) {card}")
            held_to_solve(f"GS k={k}, {GS_SWEEPS} sweeps", X, B, B64, X_ref, {
                "0 sweeps": solve(0)[0], "1 sweep": solve(1)[0]})
            resid_rel = float((info["resid"].double() - torch.linalg.vector_norm(
                B64 - A64 @ X.double(), dim=0)).abs().max() / torch.linalg.vector_norm(B64))
            check(resid_rel <= 1e-5, f"telemetry (d) GS k={k}: info['resid'] off by {resid_rel}")
            # asy_fcg at KrylovParams() defaults, 2 inner sweeps.
            reset_counts()
            t0 = time.perf_counter()
            torch.cuda.synchronize()
            Xa, ia = sky.solvers.asy_fcg(A, B, sky.SketchContext(seed=SEED), inner_sweeps=2,
                                         block_size=GS_BLOCK)
            torch.cuda.synchronize()
            t_fcg = time.perf_counter() - t0
            read_counts(f"telemetry (d) asy_fcg k={k}", t0, ())
            short = sky.solvers.asy_fcg(A, B, sky.SketchContext(seed=SEED),
                                        sky.solvers.KrylovParams(iter_lim=2), inner_sweeps=2,
                                        block_size=GS_BLOCK)[0]
            print(f"telemetry (d) asy_fcg k={k}: {int(ia['iterations'])} iterations (flag "
                  f"{int(ia['flag'])}) in {t_fcg:.3f} s {card}")
            held_to_solve(f"asy_fcg k={k}", Xa, B, B64, X_ref, {
                "2 iterations": short, "GS at 10 sweeps": X})
            del B, B64, X_ref, X, Xa, short
        del A, A64
    finally:
        for mod, name, fn in restore:
            setattr(mod, name, fn)
        telemetry.close()
        telemetry.configure(None)
        telemetry.reset()
        if knob is None:
            os.environ.pop("SKYLARK_TELEMETRY", None)
        else:
            os.environ["SKYLARK_TELEMETRY"] = knob
    return held


def serve_path(sky, dev, reset_counts, read_counts, smi) -> set:
    """Phase 3n: the serving layer on the card, through the servers a
    user starts.  (a) The registry (``ls``, ``ls_cwt``, ``ls_rf``,
    ``ls_up``, ``mdl``, ``g``: SV_* above) and the server's prime;
    (b) bench.py's drive, serial and coalesced, for each LS system and
    ``predict``, with the copy-in cost per batch; (c) coalesced ≡ serial
    bitwise at SV_RUNGS requests, 2 replicas behind a ``Router`` ≡ 1
    worker serial, each beside a control that misses (one input entry
    moved), and three workers capturing the plans mid-traffic after
    ``plans.clear()``; (d) a cache hit launches nothing; (e) live
    updates (row append into ``ls_up`` against a fresh registration, an
    edge batch folded into ``g`` bitwise a fresh registration, the
    structured refusal of an append past ``ls_rf``'s rows); (f) a journaled registry recovered
    bitwise; (g) HTTP (``serve_http`` + ``Client``, ``/metrics``,
    ``cli.top --once``) and ``cli.serve`` over stdio.  Every first launch
    of a kernel signature is held against its plain version.  Returns
    the signatures held."""
    import concurrent.futures as cf
    import contextlib
    import io as io_
    import shutil
    import threading
    import urllib.request

    from libskylark_tpu_torch import serve, telemetry
    from libskylark_tpu_torch.cli import serve as cli_serve
    from libskylark_tpu_torch.cli import top as cli_top
    from libskylark_tpu_torch.serve import batcher
    from libskylark_tpu_torch.serve.registry import GraphSystem
    from libskylark_tpu_torch.sketch import kernels_fut as kf
    from libskylark_tpu_torch.sketch import kernels_scatter as ks
    from libskylark_tpu_torch.sketch import kernels_window as kw

    card = f"[{smi}]"
    check(not telemetry.enabled(), "serve: telemetry is on before phase 3n")
    shutil.rmtree(SV_DIR, ignore_errors=True)
    SV_DIR.mkdir(parents=True)
    g = torch.Generator(device=dev).manual_seed(SEED + 19)
    held = set()

    def segsum_held(out, vals, keys, segs):
        _, r = max_err(out, ks.segment_sum_flat_plain(vals, keys, segs))
        i = int(vals.abs().argmax())
        _, c = max_err(out, ks.segment_sum_flat_plain(torch.cat([vals[:i], vals[i + 1:]]),
                                                      torch.cat([keys[:i], keys[i + 1:]]), segs))
        print(f"serve (held) segment_sum_flat {vals.shape[0]} -> {segs} {vals.dtype}: vs its "
              f"plain version rel {r:.3g} (tol 1e-5); control (the plain version without entry "
              f"{i}) {c:.3g}")
        check(r <= 1e-5 and c > 1e-5, f"serve segment_sum_flat {vals.shape[0]}: {r}, control {c}")

    restore = hold_kernels("serve", kf, kw, ("rfut_rowwise", "rfut_rowwise_sampled",
                                             "gather_scaled_rows", "scatter_rows"), held)
    restore.append((ks, "segment_sum_flat", hold(ks, "segment_sum_flat", segsum_held, held)))
    launched = {}

    def count(path, t0, expect):
        counts = read_counts(path, t0, expect)
        for name, n in counts.items():
            launched[name] = launched.get(name, 0) + n
        return counts

    def server(registry=None, **kw_):
        """A server on the card (cache off unless asked: the drive and the
        pins measure dispatches, not dictionary lookups), sharing
        ``registry`` when given."""
        kw_.setdefault("warm_start", False)
        kw_.setdefault("cache", False)
        kw_.setdefault("max_queue", 4 * SV_REQUESTS)
        kw_.setdefault("prime", False)
        srv_ = serve.Server(serve.ServeParams(**kw_), seed=SEED, device=dev)
        if registry is not None:
            srv_.registry = registry
        return srv_

    def ctx(k):
        return sky.SketchContext(seed=SEED + k)

    # -- (a) the registry and the prime --------------------------------------
    reset_counts()
    t0 = time.perf_counter()
    A = torch.randn((SV_M, SV_N), generator=g, device=dev)
    A_rf = torch.randn((SV_RF_M, SV_RF_N), generator=g, device=dev)
    srv = server(max_coalesce=SV_COALESCE)
    reg = srv.registry
    check(reg.device == dev, f"serve: the registry is on {reg.device}")
    t_reg = {}
    for name, A_, kw_ in (
            ("ls", A, {"context": ctx(1), "sketch_size": SV_S}),
            ("ls_cwt", A, {"context": ctx(2), "sketch_type": "CWT", "sketch_size": SV_S}),
            ("ls_rf", A_rf, {"context": ctx(3), "sketch_size": SV_RF_S}),
            ("ls_up", A_rf, {"context": ctx(4), "sketch_type": "CWT", "sketch_size": SV_RF_S,
                             "capacity": SV_RF_M + SV_UP_ROWS})):
        t1 = time.perf_counter()
        reg.register_system(name, A_, **kw_)
        torch.cuda.synchronize()
        t_reg[name] = time.perf_counter() - t1
    check(reg.get_system("ls").A.data_ptr() == A.data_ptr(), "serve: A was copied")
    kern = sky.ml.GaussianKernel(ML_DIM, ML_SIGMA)
    model = sky.ml.FeatureMapModel([kern.create_rft(ML_S, "fast", ctx(5))],
                                   torch.randn((ML_S, ML_CLASSES), generator=g, device=dev),
                                   scale_maps=True, classes=list(range(ML_CLASSES)))
    reg.register_model("mdl", model)
    t1 = time.perf_counter()
    gu, gv, _ = cli_graph_data(SEED)
    G = sky.graph.SimpleGraph(zip(gu.tolist(), gv.tolist()))
    t_graph = time.perf_counter() - t1
    del gu, gv
    t1 = time.perf_counter()
    reg.register_graph("g", G, k=CLI_ASE_K, context=ctx(6))
    t_reg["g"] = time.perf_counter() - t1

    # Inputs from the seed: 32 right-hand sides per system (b = A x + e,
    # on the host in f64 as a client sends them) and 32 predict rows.
    def rhs(A_):
        m, n = A_.shape
        return [(A_ @ torch.randn(n, generator=g, device=dev)
                 + torch.randn(m, generator=g, device=dev)).double().cpu().numpy()
                for _ in range(max(SV_RUNGS))]

    b_big = rhs(A)
    bs = {"ls": b_big, "ls_cwt": b_big, "ls_rf": rhs(A_rf)}
    bs["ls_up"] = bs["ls_rf"]
    xs = list(torch.randn((max(SV_RUNGS), ML_DIM), generator=g, device=dev).cpu().numpy())
    keys = ("ls", "ls_cwt", "ls_rf", "predict")
    expect = {"ls": ("gather_scaled_rows",), "ls_cwt": ("scatter_rows",),
              "ls_rf": ("rfut_rowwise_sampled",), "predict": ()}  # predict: the hoisted W

    def req(key, i, x=None):
        if key == "predict":
            return serve.make_request("predict", model="mdl", dtype="float32",
                                      x=xs[i] if x is None else x)
        return serve.make_request("ls_solve", system=key, b=bs[key][i] if x is None else x)

    # One request of each key first, so that each kernel signature of the
    # served path is held on real inputs (the prime's are zeros), then
    # the prime of every lane rung before the traffic.
    srv.start()
    for key in keys + ("ls_up",):
        r = srv.call(req(key, 0))
        check(r["ok"], f"serve first {key}: {r.get('error')}")
    t1 = time.perf_counter()
    srv.prime()
    t_prime = time.perf_counter() - t1
    count("serve (register)", t0, ("gather_scaled_rows", "scatter_rows",
                                   "rfut_rowwise_sampled", "segment_sum_flat"))
    print(f"serve: registered {sorted(reg.describe()['systems'])}, mdl, g ({G.n} vertices, "
          f"{G.volume // 2} edges, built from phase 3l's arc list in {t_graph:.1f} s) in "
          f"{ {k: round(v, 3) for k, v in t_reg.items()} } s; primed {srv.primed} in "
          f"{t_prime:.2f} s {card}")
    print(f"serve: memory after registration: allocated "
          f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB (A {A.numel() * 4 / 2**30:.2f} "
          f"GiB shared by ls and ls_cwt, ls_rf/ls_up's A {A_rf.numel() * 4 / 2**20:.0f} MiB "
          f"shared), reserved {torch.cuda.memory_reserved(dev) / 2**30:.2f} GiB {card}")

    # -- (b) bench.py's drive: SV_CLIENTS threads, SV_REQUESTS requests ------
    srv_s = server(reg, max_coalesce=1, prime=True).start()
    drives = {}

    def drive(srv_, key):
        sizes = []

        def one(i):
            t1 = time.perf_counter()
            r = srv_.call(req(key, i % SV_RHS))
            ms = (time.perf_counter() - t1) * 1e3
            check(r["ok"], f"serve drive {key}: {r.get('error')}")
            sizes.append(r["trace"]["batch_size"])
            return ms

        with cf.ThreadPoolExecutor(max_workers=SV_CLIENTS) as pool:
            list(pool.map(one, range(SV_CLIENTS)))  # warm every rung first
            sizes.clear()
            t1 = time.perf_counter()
            lat = sorted(pool.map(one, range(SV_REQUESTS)))
        wall = time.perf_counter() - t1
        return {"qps": SV_REQUESTS / wall, "p50_ms": lat[len(lat) // 2],
                "p99_ms": lat[min(len(lat) - 1, int(len(lat) * 0.99))],
                "mean_batch": statistics.mean(sizes)}

    for key in keys:
        for mode, srv_ in (("serial", srv_s), ("coalesced", srv)):
            reset_counts()
            t0 = time.perf_counter()
            drives[(key, mode)] = d = drive(srv_, key)
            count(f"serve (drive {key} {mode})", t0, expect[key])
            print(f"serve drive {key} {mode} (max_coalesce "
                  f"{1 if mode == 'serial' else SV_COALESCE}): QPS {d['qps']!r}, p50 "
                  f"{d['p50_ms']!r} ms, p99 {d['p99_ms']!r} ms, mean batch {d['mean_batch']!r} "
                  f"{card}")
    # The copy-in cost of one batch at the 2^20-row systems, as the LS
    # executor pays it: the host stack of the k right-hand sides into
    # pinned f32 memory, then the staging copy (the copy stream), median
    # of 5 each.
    for k in (1, SV_COALESCE):
        host, stage = [], []
        for _ in range(5):
            t1 = time.perf_counter()
            Bt = batcher._host_block(b_big[:k], torch.float32, dev)
            t2 = time.perf_counter()
            batcher._stage(Bt, dev)
            torch.cuda.synchronize()
            host.append(t2 - t1)
            stage.append(time.perf_counter() - t2)
        mb = Bt.numel() * 4 / 1e6
        print(f"serve copy-in per batch of {k} at m = 2^20: host stack into pinned f32 "
              f"{statistics.median(host) * 1e3!r} ms, staging {statistics.median(stage) * 1e3!r} "
              f"ms for {mb:.1f} MB ({mb / 1e3 / statistics.median(stage)!r} GB/s) {card}")
    del Bt

    # -- (c) coalesced ≡ serial, routed ≡ serial, mid-traffic captures -------
    reset_counts()
    t0 = time.perf_counter()
    serial = {key: [srv_s.call(req(key, i)) for i in range(max(SV_RUNGS))] for key in keys}
    for key in keys:
        check(all(r["ok"] and r["trace"]["batch_size"] == 1 for r in serial[key]),
              f"serve serial {key}: {[r.get('error') for r in serial[key]][:2]}")
        serial[key] = [r["result"] for r in serial[key]]

    def alone_then(srv_, reqs):
        """Every request queued before the worker starts: one batch."""
        futs = [srv_.submit(r) for r in reqs]
        srv_.start()
        out = [f.result(timeout=300) for f in futs]
        srv_.stop()
        return out

    for key in keys:
        for n in SV_RUNGS:
            out = alone_then(server(reg, max_coalesce=SV_COALESCE), [req(key, i) for i in range(n)])
            check(all(r["ok"] for r in out), f"serve coalesced {key} x {n}: "
                  f"{[r.get('error') for r in out if not r['ok']][:1]}")
            check({r["trace"]["batch_size"] for r in out} == {n}
                  and {r["trace"]["bucket"] for r in out} == {batcher._lane_bucket(n)},
                  f"serve coalesced {key} x {n}: batches {[r['trace'] for r in out][:1]}")
            same = all(np.array_equal(r["result"], serial[key][i]) for i, r in enumerate(out))
            check(same, f"serve {key}: {n} coalesced requests are not bitwise the serial ones")
        # The control: request 0 with its first entry moved by 1 (the
        # entries are O(1) to O(sqrt(n))), coalesced with the others at
        # the widest rung, must change its answer and only its answer.
        x0 = (bs[key][0] if key != "predict" else xs[0]).copy()
        x0[0] += 1.0
        out = alone_then(server(reg, max_coalesce=SV_COALESCE),
                         [req(key, 0, x0)] + [req(key, i) for i in range(1, max(SV_RUNGS))])
        ctl_diff = float(np.abs(np.asarray(out[0]["result"], np.float64)
                                - np.asarray(serial[key][0], np.float64)).max())
        check(out[0]["ok"] and ctl_diff > 0 and all(
            np.array_equal(r["result"], serial[key][i]) for i, r in enumerate(out) if i),
              f"serve {key}: the control does not miss ({ctl_diff})")
        print(f"serve coalesced ≡ serial {key}: bitwise at {SV_RUNGS} requests (buckets "
              f"{[batcher._lane_bucket(n) for n in SV_RUNGS]}); control (request 0's first entry "
              f"+ 1) max abs diff {ctl_diff:.3g}, its {max(SV_RUNGS) - 1} batch-mates bitwise "
              f"{card}")
    # Without the blocks: the LS solve's Qᵀ·S·B at the widest rung in one
    # GEMM, against the base rung's columns (printed, not held).
    sysm = reg.get_system("ls")
    SB = torch.cat([sky.plans.apply(sysm.S, torch.from_numpy(np.stack(b_big[j:j + 8], 1)).to(
        dev, torch.float32), "columnwise") for j in range(0, SV_COALESCE, 8)], dim=1)
    whole = sysm.Qt @ SB
    blocks = torch.cat([sysm.Qt @ SB[:, j:j + 8] for j in range(0, SV_COALESCE, 8)], dim=1)
    print(f"serve: Q^T S B at {SV_COALESCE} columns in one GEMM vs in blocks of 8: "
          f"{int((whole != blocks).any(0).sum())} of {SV_COALESCE} columns differ, max abs "
          f"{float((whole - blocks).abs().max()):.3g} {card}")
    del SB, whole, blocks
    router = serve.Router()
    reps = [server(reg, max_coalesce=SV_COALESCE).start() for _ in range(2)]
    for i, r_ in enumerate(reps):
        router.join(f"replica-{i}", server=r_)
    for key in keys:
        if key == "ls_rf":  # the other keys place on the other replica
            router.drain("replica-0")
        futs = [router.submit(req(key, i)) for i in range(max(SV_RUNGS))]
        out = [f.result(timeout=300) for f in futs]
        check(all(r["ok"] and np.array_equal(r["result"], serial[key][i])
                  for i, r in enumerate(out)),
              f"serve: routed {key} is not bitwise the serial answers")
        print(f"serve routed ≡ serial {key}: {max(SV_RUNGS)} requests over replicas "
              f"{sorted({r['trace']['replica'] for r in out})}, batches "
              f"{sorted({r['trace']['batch_size'] for r in out})}, bitwise {card}")
    router.stop()
    for r_ in reps:
        r_.stop()
    # Mid-traffic captures: every plan dropped, then three workers on the
    # one card and SV_CLIENTS clients; each plan is captured by whichever
    # worker meets it first while the others launch.  A capture another
    # thread invalidated would come back as an error envelope.
    sky.plans.clear()
    traces0 = sky.plans.stats()["traces"]
    s3 = server(reg, max_coalesce=8, workers=3).start()
    mixed = [(key, i) for i in range(max(SV_RUNGS)) for key in ("ls_rf", "predict", "ls_cwt")]
    with cf.ThreadPoolExecutor(max_workers=SV_CLIENTS) as pool:
        out = list(pool.map(lambda ki: s3.call(req(*ki)), mixed))
    s3.stop()
    errors = [r["error"] for r in out if not r["ok"]]
    mism = [ki for ki, r in zip(mixed, out) if r["ok"]
            and not np.array_equal(r["result"], serial[ki[0]][ki[1]])]
    print(f"serve mid-traffic captures: 3 workers, {len(mixed)} requests, "
          f"{sky.plans.stats()['traces'] - traces0} captures, {len(errors)} error envelopes "
          f"{errors[:2]}, {len(mism)} answers not bitwise serial {card}")
    check(not mism, f"serve mid-traffic captures: {mism[:4]} differ from serial")
    check(not errors, f"serve mid-traffic captures: requests failed {errors[:2]}")
    count("serve (pins)", t0, ("gather_scaled_rows", "scatter_rows",
                                     "rfut_rowwise_sampled"))
    srv_s.stop()

    # -- (d) a cache hit launches nothing --------------------------------------
    s4 = server(cache=True)
    s4.registry.register_system("ls_rf", A_rf, context=ctx(3), sketch_size=SV_RF_S)
    s4.start()
    first = s4.call(req("ls_rf", 0))
    reset_counts()
    t0 = time.perf_counter()
    hit = s4.call(req("ls_rf", 0))
    counts = count("serve (cache hit)", t0, ())
    s4.stop()
    check(hit["ok"] and hit["trace"].get("cache_hit") and not any(counts.values())
          and np.array_equal(hit["result"], first["result"]),
          f"serve: the cache hit launched {counts} ({hit['trace']})")
    print(f"serve cache: a repeated ls_rf request is a hit with no launch {counts} {card}")

    # -- (e) live updates ------------------------------------------------------
    reset_counts()
    t0 = time.perf_counter()
    rows = torch.randn((SV_UP_ROWS, SV_RF_N), generator=g, device=dev)
    old = reg.get_system("ls_up")
    up = srv.call(op="update", system="ls_up", append=rows.double().cpu().numpy(), idem_key="up")
    check(up["ok"] and up["result"]["kind"] == "row_append"
          and up["result"]["rows"] == SV_UP_ROWS, f"serve update ls_up: {up}")
    again = srv.call(op="update", system="ls_up", append=rows.double().cpu().numpy(),
                     idem_key="up")
    check(again["ok"] and again["result"] == up["result"] and reg.get_system("ls_up").m
          == SV_RF_M + SV_UP_ROWS, "serve: a replayed idempotency key applied twice")
    new = reg.get_system("ls_up")
    fresh_reg = serve.Registry(device=dev)
    fresh = fresh_reg.register_system(
        "ls_up", torch.cat([A_rf, rows]), context=ctx(4), sketch=old.S,
        capacity=SV_RF_M + SV_UP_ROWS)
    d_sa = float((new.SA - fresh.SA).abs().max() / fresh.SA.abs().max())
    d_r = float((new.R - fresh.R).abs().max() / fresh.R.abs().max())
    b_up = np.concatenate([bs["ls_rf"][0], np.ones(SV_UP_ROWS)])
    x_live = srv.call(op="ls_solve", system="ls_up", b=b_up)["result"]
    s5 = server(fresh_reg).start()
    x_fresh = s5.call(op="ls_solve", system="ls_up", b=b_up)["result"]
    s5.stop()
    d_x = float(np.abs(x_live - x_fresh).max() / np.abs(x_fresh).max())
    print(f"serve update: {SV_UP_ROWS} rows appended to ls_up (epoch {up['result']['epoch']}); "
          f"vs a fresh registration of the merged A: S·A max rel {d_sa:.3g}, R {d_r:.3g} (tol "
          f"{SV_UPDATE_TOL:g}), x max rel {d_x:.3g} (tol {SV_X_TOL:g}); the replayed idempotency "
          f"key returned the first receipt {card}")
    check(d_sa <= SV_UPDATE_TOL and d_r <= SV_UPDATE_TOL and d_x <= SV_X_TOL,
          f"serve update: the live append is off a fresh registration ({d_sa}, {d_r}, {d_x})")
    refused = srv.call(op="update", system="ls_rf", append=rows[:1].double().cpu().numpy())
    check(not refused["ok"] and refused["error"]["code"] == 102,
          f"serve: an append past ls_rf's rows did not refuse with code 102: {refused}")
    erng = np.random.default_rng(SEED + 19)
    edges = erng.integers(0, CLI_YT_V, (SV_EDGES, 2)).tolist()
    fold = srv.call(op="update", graph="g", edges=edges)
    check(fold["ok"] and fold["result"]["kind"] == "graph_fold", f"serve fold: {fold}")
    g_new = reg.get_graph("g")
    g_fresh = GraphSystem("g", g_new.G, k=CLI_ASE_K, context=ctx(6), device=dev)
    check(torch.equal(g_new._sa, g_fresh._sa) and np.array_equal(g_new.X, g_fresh.X),
          "serve fold: the folded graph is not bitwise a fresh registration of the merged graph")
    seeds = [int(v) for v in np.flatnonzero(g_new.G.degrees > 0)[:2]]
    ppr = srv.call(op="ppr", graph="g", seeds=seeds)
    emb = srv.call(op="ase_embed", graph="g", ids=[0, 1, CLI_YT_V - 1])
    check(ppr["ok"] and emb["ok"] and np.array_equal(emb["result"], g_new.X[[0, 1, CLI_YT_V - 1]]),
          f"serve graph queries: {ppr.get('error')} {emb.get('error')}")
    count("serve (update)", t0, ("scatter_rows", "segment_sum_flat"))
    print(f"serve update: {fold['result']['edges']} new edges folded into g (volume "
          f"{fold['result']['volume']}), SA and X bitwise a fresh registration of the merged "
          f"graph; ppr around {seeds}: {len(ppr['result']['cluster'])} vertices, conductance "
          f"{ppr['result']['conductance']:.4f}; ls_rf (no reserved rows) refused an append with "
          f"code 102 {card}")
    del fresh, fresh_reg, g_fresh

    # -- (f) a journaled registry recovered bitwise --------------------------
    reset_counts()
    t0 = time.perf_counter()
    state = SV_DIR / "state"
    sj = server(state_dir=str(state), journal_compact_every=3, max_coalesce=SV_COALESCE)
    sj.registry.register_system("ls_up", A_rf, context=ctx(4), sketch_type="CWT",
                                sketch_size=SV_RF_S, capacity=SV_RF_M + SV_UP_ROWS)
    sj.registry.register_model("mdl", sky.ml.FeatureMapModel(
        model.maps, model.W, scale_maps=True, classes=model.classes))
    sj.start()
    host_rows = rows.double().cpu().numpy()
    for upd in ({"append": host_rows[:8], "idem_key": "a"}, {"drop": [3, 5], "idem_key": "b"},
                {"append": host_rows[8:16]}):
        r = sj.call(op="update", system="ls_up", **upd)
        check(r["ok"], f"serve journal update: {r}")
    b_j = np.concatenate([bs["ls_rf"][1], np.ones(16)])
    live = [sj.call(op="ls_solve", system="ls_up", b=b_j), sj.call(req("predict", 1))]
    sj.stop()
    sj.registry.journal.close()
    t1 = time.perf_counter()
    rec = serve.Registry.recover(str(state), device=dev)
    t_rec = time.perf_counter() - t1
    a, b_ = sj.registry.get_system("ls_up"), rec.get_system("ls_up")
    same = (rec.epoch == sj.registry.epoch and rec.epoch_log == sj.registry.epoch_log
            and rec._idem == sj.registry._idem and a.retired == b_.retired
            and all(torch.equal(getattr(a, f), getattr(b_, f)) for f in ("A", "SA", "Qt", "R"))
            and torch.equal(rec.get_model("mdl").W, model.W))
    s6 = server(rec).start()
    back = [s6.call(op="ls_solve", system="ls_up", b=b_j), s6.call(req("predict", 1))]
    s6.stop()
    rec.journal.close()
    check(same and all(r["ok"] for r in live + back) and all(
        np.array_equal(x["result"], y["result"]) for x, y in zip(live, back)),
          "serve: the recovered registry is not bitwise the journaled one")
    files = sorted(p.name for p in state.iterdir())
    count("serve (recover)", t0, ("scatter_rows",))
    print(f"serve journal: 2 registrations + 3 updates under {state.relative_to(HERE)} "
          f"({files}); recovered in {t_rec:.2f} s at epoch {rec.epoch}: arrays, epoch log and "
          f"idempotency window bitwise, ls_solve and predict answers bitwise {card}")

    # -- (g) HTTP loopback, /metrics, cli.top, cli.serve over stdio ----------
    reset_counts()
    t0 = time.perf_counter()
    os.environ["SKYLARK_TELEMETRY"] = "1"
    telemetry.reset()
    httpd = serve.serve_http(srv)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        client = serve.Client(url=url, timeout=120)
        many = client.call_many([req("ls_rf", i) for i in range(16)])
        client.close()
        metrics = urllib.request.urlopen(url + "/metrics", timeout=60).read().decode()
        frame = io_.StringIO()
        with contextlib.redirect_stdout(frame):
            top_rc = cli_top.main(["--url", url, "--once"])
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(10)
        os.environ.pop("SKYLARK_TELEMETRY", None)
        telemetry.reset()
    check(all(r["ok"] and np.array_equal(np.asarray(r["result"], np.float32), serial["ls_rf"][i])
              for i, r in enumerate(many)),
          "serve http: the batched POST's answers are not the in-process ones")
    names = sorted(set(re.findall(r"^(skylark_serve_[a-z_]+)", metrics, re.M)))
    check("skylark_serve_requests" in " ".join(names), f"serve /metrics: {names}")
    check(top_rc == 0 and f"serve {url}" in frame.getvalue() and "requests" in frame.getvalue(),
          f"serve: cli.top --once gave {top_rc}: {frame.getvalue()[:300]}")
    print(f"serve http: 16 ls_rf requests in one POST through Client, bitwise the in-process "
          f"answers; /metrics names {names[:8]}...; cli.top --once:")
    print("\n".join("    " + ln for ln in frame.getvalue().splitlines()))
    npy = SV_DIR / "ls_rf.npy"
    np.save(npy, A_rf.cpu().numpy())
    line = serve.encode(serve.make_request("ls_solve", id="stdio", system="sys",
                                           b=bs["ls_rf"][2]))
    out_buf, err_buf = io_.StringIO(), io_.StringIO()
    stdin = sys.stdin
    sys.stdin = io_.StringIO(line + "\n")
    try:
        with contextlib.redirect_stdout(out_buf), contextlib.redirect_stderr(err_buf):
            rc = cli_serve.main(["--system", f"sys={npy}", "--seed", str(SEED), "--sketch-size",
                                 str(SV_RF_S), "--max-coalesce", "8"])
    finally:
        sys.stdin = stdin
    resp = json.loads(out_buf.getvalue().strip().splitlines()[-1])
    s7 = server()
    s7.registry.register_system("sys", A_rf, context=sky.SketchContext(seed=SEED + 1),
                                sketch_size=SV_RF_S)
    s7.start()
    ref = s7.call(op="ls_solve", system="sys", b=bs["ls_rf"][2])
    s7.stop()
    check(rc == 0 and resp["ok"] and resp["id"] == "stdio"
          and np.array_equal(np.asarray(resp["result"], np.float32), ref["result"]),
          f"serve: cli.serve over stdio answered {rc} {str(resp)[:300]}")
    count("serve (http and stdio)", t0, ("rfut_rowwise_sampled",))
    print(f"serve stdio: cli.serve --system sys={npy.relative_to(HERE)} answered "
          f"{resp['id']!r} bitwise the in-process answer; stderr "
          f"{err_buf.getvalue().strip().splitlines()[-1]!r} {card}")
    srv.stop()

    for mod, name, fn in restore:
        setattr(mod, name, fn)
    check({name for name, n in launched.items() if n} <= {sig[0] for sig in held},
          f"serve: kernels launched {launched}, held {sorted({sig[0] for sig in held})}")
    # The Fastfood model's predict blocks take its hoisted W (a GEMM), so
    # the server launches no rfut_rowwise.
    for name in ("gather_scaled_rows", "scatter_rows", "rfut_rowwise_sampled",
                 "segment_sum_flat"):
        check(launched.get(name, 0) > 0, f"serve: {name} was not launched through the server")
    return held


def elastic_holds(label: str, held: set) -> list:
    """Put :class:`Held` stand-ins on the elastic path's three kernels:
    ``scatter_rows`` (the CWT stream fold, with ``acc``), ``rfut_rowwise``
    (the trainer's Fastfood blocks at NB = 128) and ``segment_sum_flat``
    (the partitioned graph stream): the first launch of each signature is
    held against its plain version beside a control that misses.
    Returns ``(module, name, kernel)`` triples to put back."""
    from libskylark_tpu_torch.sketch import kernels_fut as kf
    from libskylark_tpu_torch.sketch import kernels_scatter as ks
    from libskylark_tpu_torch.sketch import kernels_window as kw

    u = 2.0 ** -24

    def rfut_held(out, x, d, nb):
        tol = 1e-5 if x.dtype == torch.float32 else 1e-2
        _, r = max_err(out, kf.rfut_rowwise_plain(x, d, nb))
        d_ctl = d.clone()
        d_ctl[0] = -d_ctl[0]
        _, c = max_err(out, kf.rfut_rowwise_plain(x, d_ctl, nb))
        print(f"{label} (held) rfut_rowwise x {tuple(x.shape)} {x.dtype}, NB = {nb}: vs its "
              f"plain version rel {r:.3g} (tol {tol:g}); control (the plain version with d[0] "
              f"negated) {c:.3g}", flush=True)
        check(r <= tol and c > tol, f"{label} rfut_rowwise {tuple(x.shape)}: {r}, control {c}")

    def scatter_held(out, A, b, v, segs, acc=None):
        b, v = (b[None], v[None]) if b.ndim == 1 else (b, v)
        part, err_bound, _ = scatter_error_bound(A, b, v, segs, kw._L)
        exact = part if acc is None else acc.double() + part
        if acc is not None:
            err_bound = err_bound + u * 1.01 * exact.abs()  # the fused emit's one add
        r = bound_ratio(out, exact, err_bound)
        # The control leaves out the largest term (integer data can sum a
        # whole piece to 0, so a piece is no control there).
        k = int((v[0].abs() * A.abs().amax(1)).argmax())
        row = int(b[0, k])
        ctl = exact[row] - v[0, k].double() * A[k].double()
        c = bound_ratio(out[row], ctl, err_bound[row])
        print(f"{label} (held) scatter_rows{'(acc=)' if acc is not None else ''} A "
              f"{tuple(A.shape)} {A.dtype} -> {segs}, nnz = {b.shape[0]}: max |out - exact| / "
              f"rounding bound {r:.3g} (must be <= 1); control (entry {k}, the largest term, "
              f"left out of bucket {row}) {c:.3g}", flush=True)
        check(r <= 1.0 and c > 1.0, f"{label} scatter_rows {tuple(A.shape)}: {r}, control {c}")

    def segsum_held(out, vals, keys, segs):
        ref = ks.segment_sum_flat_plain(vals, keys, segs)
        _, r = max_err(out, ref)
        i = int(vals.abs().argmax())
        ctl = ks.segment_sum_flat_plain(torch.cat([vals[:i], vals[i + 1:]]),
                                        torch.cat([keys[:i], keys[i + 1:]]), segs)
        _, c = max_err(out, ctl)
        print(f"{label} (held) segment_sum_flat {vals.shape[0]} -> {segs} {vals.dtype}: vs its "
              f"plain version rel {r:.3g} (tol 1e-5); control (the plain version without entry "
              f"{i}) {c:.3g}", flush=True)
        check(r <= 1e-5 and c > 1e-5, f"{label} segment_sum_flat {vals.shape[0]}: {r}, "
              f"control {c}")

    return [(kf, "rfut_rowwise", hold(kf, "rfut_rowwise", rfut_held, held)),
            (kw, "scatter_rows", hold(kw, "scatter_rows", scatter_held, held)),
            (ks, "segment_sum_flat", hold(ks, "segment_sum_flat", segsum_held, held))]


def elastic_rank_main(argv: list) -> int:
    """One rank process of phase 3o (``chip_smoke.py --elastic-rank
    ARGS``): ``tools.elastic_drill``'s rank entry with ``ARGS``, on the
    parent's card over gloo, the elastic path's kernels held in its
    setup hook; the drill's report gains the held signatures."""
    sys.path.insert(0, str(HERE))
    from libskylark_tpu_torch.tools import elastic_drill

    def setup(rank):
        held = set()
        elastic_holds(f"elastic rank {rank}", held)
        return lambda: {"held": sorted([sig[0], str(sig[1:]).replace("torch.", "")]
                                       for sig in held)}

    return elastic_drill.main(argv, setup=setup)


def spawn_stage(label: str, worlds: list, dev) -> dict:
    """Start every world of a stage together, each rank a
    ``chip_smoke.py --elastic-rank`` process on the one card over gloo,
    and wait for them all (``EL_STAGE_TIMEOUT_S``).  A world is ``(name,
    size, runs, end)``: ``end`` is None (every rank must exit 0 with
    ``DRILL-OK``), or the rank whose own exit ends the world (a
    SIGKILLed victim, a timed-out peer): the other ranks, blocked in a
    collective with it, are then killed.  Returns ``{name: [(rc, stdout,
    report or None) by rank]}``; every process has ended."""
    procs = {}
    t0 = time.perf_counter()
    for name, size, runs, end in worlds:
        store = EL_DIR / f"store-{name}"
        store.unlink(missing_ok=True)
        ranks = []
        for r in range(size):
            log = open(EL_DIR / f"log-{name}-{r}.txt", "w", encoding="utf-8")
            args = ["--rank", str(r), "--world", str(size), "--init", f"file://{store}",
                    "--device", str(dev), "--group-timeout", "120", "--runs", json.dumps(runs)]
            ranks.append((subprocess.Popen(
                [sys.executable, str(HERE / "chip_smoke.py"), "--elastic-rank", *args],
                stdout=log, stderr=subprocess.STDOUT, cwd=str(HERE)), log))
        procs[name] = (ranks, end)
    deadline = time.monotonic() + EL_STAGE_TIMEOUT_S
    try:
        while time.monotonic() < deadline:
            live = False
            for ranks, end in procs.values():
                if end is not None and ranks[end][0].poll() is not None:
                    for p, _ in ranks:
                        if p.poll() is None:
                            p.kill()
                live |= any(p.poll() is None for p, _ in ranks)
            if not live:
                break
            time.sleep(0.2)
    finally:
        for ranks, _ in procs.values():
            for p, log in ranks:
                if p.poll() is None:
                    p.kill()
                p.wait()
                log.close()
    out = {}
    for name, (ranks, _) in procs.items():
        out[name] = []
        for r, (p, _) in enumerate(ranks):
            text = (EL_DIR / f"log-{name}-{r}.txt").read_text(encoding="utf-8", errors="replace")
            for line in text.splitlines():
                if "(held)" in line or line.startswith(("DRILL-TIMEOUT", "chip_smoke: FAILED")):
                    print(f"  [{name} rank {r}] {line}")
            report = None
            if "DRILL-OK" in text:
                report = json.loads(text.split("DRILL-OK", 1)[1].strip().splitlines()[0])
            out[name].append((p.returncode, text, report))
    print(f"elastic {label}: {', '.join(f'{n} ({len(v)} ranks)' for n, v in out.items())} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return out


def elastic_path(sky, dev, reset_counts, read_counts, add_counts, uncounted, smi,
                 graph) -> set:
    """Phase 3o: the elastic multi-process path on the card.  (a) world 1
    on NCCL in this process: ``distributed_sketch_least_squares`` at
    phase 3g's streaming LS shape (JLT, CWT) bitwise the single-process
    ``streaming.sketch_least_squares``, and the distributed trainer at
    phase 3f's BlockADMM shape bitwise ``BlockADMMSolver.train``; (b)-(d)
    worlds of 2 ranks on the one card over gloo, spawned as
    ``--elastic-rank`` processes: the same LS problem uninterrupted, a
    rank SIGKILLed after its first commit and the world resumed, exact
    data shrunk 2 -> 1 and grown 1 -> 2, a straggler past a 2 s deadline;
    the trainer killed after an ADMM chunk and resumed; phase 3c's graph
    in edge blocks; the world-2 trainer's W against world 1's.  Each rank
    holds the kernels it launches against their plain versions
    (:func:`elastic_holds`).  The path's launches are the distributed
    calls' only: the single-process references run ``uncounted()``.
    ``graph`` is (lo, hi, the in-core sketch on the host, its SJLT).
    Returns the held signatures of every process, as ``(kernel,
    signature text)``."""
    import datetime
    import shutil

    import torch.distributed as dist

    from libskylark_tpu_torch.ml.distributed import DistributedBlockADMMTrainer
    from libskylark_tpu_torch.parallel import cross_host_psum
    from libskylark_tpu_torch.resilient import FaultPlan, SimulatedPreemption
    from libskylark_tpu_torch.streaming import ElasticParams, RowPartition, pinned_placer
    from libskylark_tpu_torch.tools import elastic_drill

    card = f"[{smi}]"
    shutil.rmtree(EL_DIR, ignore_errors=True)
    EL_DIR.mkdir(parents=True)
    # The worlds of 2 stream CWT: a JLT pass draws ~0.3 s of Omega a batch
    # (phase 3g), so JLT runs at world 1 only.
    lsq = {"scenario": "lsq", "dtype": "float32", "nrows": EL_M, "ncols": EL_N,
           "batch_rows": EL_BATCH, "s": EL_S, "sketch": "CWT", "planted": True,
           "seed": SEED, "checkpoint_every": EL_EVERY}
    exact = {**lsq, "exact": True, "planted": False}
    train = {"scenario": "train", "dtype": "float32", "nrows": ADMM_M, "d": ADMM_D,
             "batch_rows": EL_ADMM_BATCH, "maps": 2, "map_size": ADMM_S, "tag": "fast",
             "partitions": ADMM_P, "loss": "hinge",
             "maxiter": EL_ADMM_ITERS, "seed": SEED, "checkpoint_every": EL_EVERY}
    lo, hi, SA_ref, S_g = graph
    np.savez(EL_DIR / "edges.npz", lo=lo, hi=hi)
    graph_spec = {"scenario": "graph", "edges": str(EL_DIR / "edges.npz"),
                  "vertices": S_g.n, "graph_s": S_g.s, "sketch_seed": SEED,
                  "batch_rows": GRAPH_BATCH}
    held, held_here = set(), set()  # (kernel, text) of every process; this one's raw

    def clock(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, out

    # The least-squares reference: f64 normal equations of the streamed A
    # (cond(A) ~ 1.04, so they are accurate), and its residual.
    factory, _ = elastic_drill.lsq_problem(lsq, dev)
    G = torch.zeros(EL_N, EL_N, dtype=torch.float64, device=dev)
    c = torch.zeros(EL_N, dtype=torch.float64, device=dev)
    for A_b, b_b in factory(0):
        A64 = A_b.double()
        G += A64.T @ A64
        c += A64.T @ b_b.double()
    x_ls = torch.linalg.solve(G, c)

    def residual(x):
        x = x.to(dev).double()
        return math.sqrt(sum(float(torch.linalg.vector_norm(A_b.double() @ x - b_b.double()))
                             ** 2 for A_b, b_b in factory(0)))

    r_ls = residual(x_ls)

    def ratio_check(label, x):
        ratio, ctl = residual(x) / r_ls, residual(torch.zeros_like(x)) / r_ls
        print(f"elastic {label}: residual / the f64 LS residual {ratio:.5f} (bound "
              f"{LS_RATIO_BOUND}); control (x = 0) {ctl:.4g} {card}")
        check(bool(torch.isfinite(x).all()) and tuple(x.shape) == (EL_N,),
              f"elastic {label}: x not finite of shape ({EL_N},)")
        check(ratio <= LS_RATIO_BOUND and ctl > LS_RATIO_BOUND,
              f"elastic {label}: residual ratio {ratio}, control {ctl}")

    # -- (a) world 1 on NCCL, in this process ---------------------------------
    with __import__("socket").socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"tcp://127.0.0.1:{port}", rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=120))
    backend = dist.get_backend()
    probe = torch.ones(4, device=dev)
    dist.all_reduce(probe)
    print(f"elastic (a): process group backend {dist.get_backend()}, world "
          f"{dist.get_world_size()}, an all_reduce on the card {probe.tolist()} {card}")
    kernels = elastic_holds("elastic (a)", held_here)
    reset_counts()
    t_a = time.perf_counter()
    xs = {}
    for spec in ({**lsq, "sketch": "JLT"}, lsq, exact):
        fac, S = elastic_drill.lsq_problem(spec, dev)
        sp = sky.streaming.StreamParams(placer=pinned_placer(dev), prefetch=0)
        # In turns, single-process first (the first call of a signature
        # pays its hold and its plans' captures); JLT once (~6 s a pass).
        secs_s, secs_d = [], []
        for _ in range(1 if spec["sketch"] == "JLT" else 2):
            with uncounted():
                t, (x_s, _) = clock(lambda: sky.streaming.sketch_least_squares(
                    fac, S, ncols=EL_N, dtype=torch.float32, params=sp))
            secs_s.append(t)
            t, res = clock(lambda: elastic_drill.run(spec, rank=0, device=dev))
            secs_d.append(t)
        same = torch.equal(res["x"], x_s.cpu())
        name = f"{spec['sketch']}{' exact' if spec.get('exact') else ''}"
        print(f"elastic (a) {name} {EL_M} x {EL_N} in {EL_M // EL_BATCH} batches, s = {EL_S}: "
              f"distributed at world 1 on {backend} {secs_d!r} s, single-process stream "
              f"{secs_s!r} s (in turns); x bitwise {same} {card}")
        check(same, f"elastic (a) {name}: world 1 is not bitwise the single-process stream")
        if not spec.get("exact"):
            ratio_check(f"(a) {name} world 1", res["x"])
        xs[name] = res["x"]
    # The entry point users call, linalg.streaming_least_squares, with and
    # without partition= (the policy off: one decision for both calls).
    fac, _ = elastic_drill.lsq_problem(lsq, dev)
    knob = os.environ.get("SKYLARK_POLICY")
    os.environ["SKYLARK_POLICY"] = "0"
    try:
        lp = sky.linalg.LeastSquaresParams(sketch_type="CWT", sketch_size=EL_S)
        x_p, _ = sky.linalg.streaming_least_squares(
            fac, EL_M, EL_N, sky.SketchContext(seed=SEED), lp, stream_params=ElasticParams(
                placer=pinned_placer(dev), prefetch=0), partition=RowPartition(EL_M, EL_BATCH, 1))
        with uncounted():
            x_0, _ = sky.linalg.streaming_least_squares(
                fac, EL_M, EL_N, sky.SketchContext(seed=SEED), lp,
                stream_params=sky.streaming.StreamParams(placer=pinned_placer(dev), prefetch=0))
    finally:
        if knob is None:
            os.environ.pop("SKYLARK_POLICY")
        else:
            os.environ["SKYLARK_POLICY"] = knob
    same = torch.equal(x_p, x_0)
    print(f"elastic (a) linalg.streaming_least_squares CWT with partition= at world 1 bitwise "
          f"without it: {same} {card}")
    check(same, "elastic (a): streaming_least_squares(partition=) at world 1 is not bitwise")
    # The grow drill's first world: world 1 on exact data, preempted after
    # its second committed chunk.
    fac, S = elastic_drill.lsq_problem(exact, dev)
    root_g = EL_DIR / "grow"
    try:
        sky.streaming.distributed_sketch_least_squares(
            fac, S, ncols=EL_N, partition=RowPartition(EL_M, EL_BATCH, 1), dtype=torch.float32,
            params=ElasticParams(placer=pinned_placer(dev), prefetch=0,
                                 checkpoint_dir=str(root_g), checkpoint_every=EL_EVERY),
            fault_plan=FaultPlan(preempt_after_chunk=1))
        fail("elastic (a): the grow drill's world 1 was not preempted")
    except SimulatedPreemption:
        pass
    # The trainer at world 1: bitwise BlockADMMSolver.train, s/iter.
    tfac, maps, admm, classes = elastic_drill.train_problem(train, dev)
    X = torch.cat([Xb for Xb, _ in tfac(0)])
    y = torch.cat([yb for _, yb in tfac(0)]).cpu().numpy()
    # The trainer's feature blocks take the maps' hoisted W (a GEMM over
    # each batch); the reference takes the same W by the forced realized
    # apply over the whole X.
    with uncounted(), forced_env(SKYLARK_FRFT_GEMM="1"):
        secs_ref, ref = clock(
            lambda: sky.ml.BlockADMMSolver("hinge", "l2", maps, admm).train(X, y))
    del X
    part1 = RowPartition(ADMM_M, EL_ADMM_BATCH, 1)
    ep = ElasticParams(placer=pinned_placer(dev), prefetch=0)

    def trainer(iters):
        admm.maxiter = iters
        return DistributedBlockADMMTrainer("hinge", "l2", maps, admm, ep).train(
            tfac, part1, classes=classes, dtype=torch.float32)

    # (c)'s control: world 1 with the last partition's rows left out.
    ctl_spec = {**train, "nrows": ADMM_M - ADMM_M // ADMM_P, "partitions": ADMM_P - 1}
    cfac, cmaps, cadmm, _ = elastic_drill.train_problem(ctl_spec, dev)
    with uncounted():
        W_ctl = DistributedBlockADMMTrainer("hinge", "l2", cmaps, cadmm, ep).train(
            cfac, RowPartition(ctl_spec["nrows"], EL_ADMM_BATCH, 1), classes=classes,
            dtype=torch.float32)[0].W.cpu()

    t1 = min(clock(lambda: trainer(1))[0] for _ in range(2))
    runs = [clock(lambda: trainer(EL_ADMM_ITERS)) for _ in range(2)]
    tN, (model, info) = min(runs[0][0], runs[1][0]), runs[-1][1]
    same = torch.equal(model.W, ref.W) and model.history == ref.history
    per_iter_1 = (tN - t1) / (EL_ADMM_ITERS - 1)
    print(f"elastic (a) DistributedBlockADMMTrainer at world 1 on {backend}, {ADMM_M} x {ADMM_D}, two "
          f"Fastfood maps of {ADMM_S}, P = {ADMM_P}, hinge, {EL_ADMM_ITERS} iterations: W and "
          f"objective bitwise BlockADMMSolver.train (on the forced realized W) {same}; s/iter "
          f"{per_iter_1!r} ((t_{EL_ADMM_ITERS} - t_1)/{EL_ADMM_ITERS - 1}, each the min of 2); "
          f"BlockADMMSolver.train {secs_ref!r} s in all {card}")
    check(same, "elastic (a): the world-1 trainer is not bitwise BlockADMMSolver.train")
    for mod, name, kernel in kernels:
        setattr(mod, name, kernel)
    read_counts("elastic (a)", t_a, ("scatter_rows",))

    def ok_world(label, ranks, runs):
        for r, (rc, text, rep) in enumerate(ranks):
            check(rc == 0 and rep is not None,
                  f"elastic {label} rank {r} exited {rc}:\n{text[-3000:]}")
        reps = [rep for _, _, rep in ranks]
        for i, name in enumerate(runs):
            shas = {rep["runs"][i]["sha"] for rep in reps}
            check(len(shas) == 1, f"elastic {label} {name}: the ranks' results differ")
        return reps

    def sha(reps, name):
        return next(run["sha"] for run in reps[0]["runs"] if run["name"] == name)

    rank_counts = dict.fromkeys(("rfut_rowwise", "rfut_rowwise_sampled", "gather_scaled_rows",
                                 "scatter_rows", "segment_sum_flat"), 0)

    def tally(reps):
        for rep in reps:
            for run in rep["runs"]:
                for k, v in run["launches"].items():
                    rank_counts[k] += v
            held.update((name, text) for name, text in rep["held"])
            print(f"  rank {rep['rank']}/{rep['world']}: backend {rep['backend']}, gloo host "
                  f"copies {rep['host_copies']}, kernels held "
                  f"{sorted({name for name, _ in rep['held']})}")

    # -- (b)-(d) uninterrupted world of 2 over gloo ---------------------------
    # The trainer at 1 iteration twice (the first pays the holds and the
    # plans' captures) and at EL_ADMM_ITERS: s/iter from the warm runs.
    names_b = ["lsq", "exact", "train1", "train1b", "train", "graph"]
    runs_b = [{"name": "lsq", "spec": lsq, "out": str(EL_DIR / "out-lsq")},
              {"name": "exact", "spec": exact},
              {"name": "train1", "spec": {**train, "maxiter": 1}},
              {"name": "train1b", "spec": {**train, "maxiter": 1}},
              {"name": "train", "spec": train, "out": str(EL_DIR / "out-train")},
              {"name": "graph", "spec": graph_spec, "out": str(EL_DIR / "out-graph")}]
    stage = spawn_stage("(b)-(d) uninterrupted", [("w2", 2, runs_b, None)], dev)
    reps = ok_world("(b)-(d) world 2", stage["w2"], names_b)
    tally(reps)
    for rep in reps:  # (launches count on the card only)
        lc = {k: sum(run["launches"][k] for run in rep["runs"]) for k in rank_counts}
        for name in ("scatter_rows", "segment_sum_flat"):
            check(lc[name] > 0 or dev.type != "cuda",
                  f"elastic: rank {rep['rank']} launched no {name}")
    secs = {run["name"]: max(rep["runs"][i]["seconds"] for rep in reps)
            for i, run in enumerate(runs_b)}
    x_u = torch.load(EL_DIR / "out-lsq" / "x-0.pt")
    ratio_check("(b) CWT world 2 over gloo", x_u)
    print(f"elastic (b) CWT {EL_M} x {EL_N} at world 2 over gloo on one card: {secs['lsq']!r} s "
          f"(slowest rank); exact CWT {secs['exact']!r} s {card}")
    per_iter_2 = (secs["train"] - secs["train1b"]) / (EL_ADMM_ITERS - 1)
    print(f"elastic (c) DistributedBlockADMMTrainer at world 2 over gloo on one card (two "
          f"partitions a rank): s/iter {per_iter_2!r} ((t_{EL_ADMM_ITERS} - t_1)/"
          f"{EL_ADMM_ITERS - 1}, slowest rank), against {per_iter_1!r} at world 1 on {backend} "
          f"{card}")
    # The merge: world 2's W against world 1's (the same problem and
    # iterations; only the consensus sum's order and the per-rank batched
    # GEMMs' blocking differ), relative in Frobenius norm.
    W1, W2 = model.W.cpu().double(), torch.load(EL_DIR / "out-train" / "x-0.pt").double()
    rel_w = float(torch.linalg.vector_norm(W2 - W1) / torch.linalg.vector_norm(W1))
    rel_c = float(torch.linalg.vector_norm(W_ctl.double() - W1) / torch.linalg.vector_norm(W1))
    tol_w = EL_W_ULPS * EL_ADMM_ITERS * 2.0 ** -24
    print(f"elastic (c) world 2's W against world 1's: ||W2 - W1|| / ||W1|| {rel_w:.3g} (limit "
          f"{tol_w:.3g}, {EL_W_ULPS} u an iteration); control (world 1 without the last "
          f"partition's rows) {rel_c:.3g} {card}")
    check(bool(torch.isfinite(W2).all()) and W2.shape == W1.shape,
          f"elastic (c): world 2's W not finite of shape {tuple(W1.shape)}")
    check(rel_w <= tol_w and rel_c > tol_w,
          f"elastic (c): world 2's W {rel_w} from world 1's, control {rel_c} (limit {tol_w})")
    SA = torch.load(EL_DIR / "out-graph" / "x-0.pt")
    # One extra sum: the merged partials are rounded once more, so each
    # entry is held to u·|SA| against the in-core sketch (dyadic sums:
    # exact, so bitwise too); the control leaves the first edge block out.
    err_g = (SA.double() - SA_ref.double()).abs()
    bound_g = 2.0 ** -24 * SA_ref.double().abs()
    r_g = float(torch.where(bound_g > 0, err_g / bound_g.clamp(min=1e-300),
                            torch.where(err_g > 0, math.inf, 0.0)).max())
    blk = slice(0, GRAPH_BATCH)
    l_, h_ = torch.from_numpy(lo[blk]), torch.from_numpy(hi[blk])
    first = torch.sparse_coo_tensor(torch.stack([torch.cat([l_, h_]), torch.cat([h_, l_])]),
                                    torch.ones(2 * l_.numel()), (S_g.n, S_g.n),
                                    check_invariants=False)
    from libskylark_tpu_torch.graph import stream as gs

    ctl = SA_ref.double() - gs.incore_adjacency_sketch(first, S_g).double()
    err_c = (SA.double() - ctl).abs()
    r_c = float(torch.where(bound_g > 0, err_c / bound_g.clamp(min=1e-300),
                            torch.where(err_c > 0, math.inf, 0.0)).max())
    same_g = torch.equal(SA, SA_ref)
    print(f"elastic (d) streamed_adjacency_sketch of {lo.size} edges in blocks of {GRAPH_BATCH} "
          f"at world 2 over gloo: {secs['graph']!r} s; vs the single-process sketch: bitwise "
          f"{same_g}, max error / u|SA| {r_g:.3g} (must be <= 1); control (the first block left "
          f"out) {r_c:.3g} {card}")
    check(r_g <= 1.0 and r_c > 1.0, f"elastic (d): {r_g}, control {r_c}")
    del SA, err_g, bound_g, err_c, ctl, first

    # -- faults: kills and a straggler, four worlds at once -------------------
    root_f, root_e, root_t = EL_DIR / "kill", EL_DIR / "shrink", EL_DIR / "train"
    kill = {"kill_after_chunk": EL_KILL_CHUNK, "fault_rank": 1}
    stage = spawn_stage("(b)-(c) faults", [
        ("kill", 2, [{"name": "lsq", "spec": {**lsq, **kill}, "root": str(root_f)}], 1),
        ("kill-exact", 2, [{"name": "exact", "spec": {**exact, **kill},
                            "root": str(root_e)}], 1),
        ("kill-train", 2, [{"name": "train", "spec": {**train, "fault_rank": 1,
                                                      "train_kill_after_chunk": 1},
                            "root": str(root_t)}], 1),
        ("straggler", 2, [{"name": "lsq", "spec": {
            **lsq, "collective_timeout": EL_DEADLINE_S, "slow_at_batch": 2,
            "slow_seconds": EL_SLOW_S, "fault_rank": 1}, "root": str(EL_DIR / "straggler")}],
         0)], dev)
    for name in ("kill", "kill-exact", "kill-train"):
        rc = stage[name][1][0]
        check(rc == -9, f"elastic {name}: the victim exited {rc}, not by its SIGKILL:\n"
                        f"{stage[name][1][1][-2000:]}")
    rc0, text0, _ = stage["straggler"][0]
    check(rc0 == 110 and "DRILL-TIMEOUT phase=psum stragglers=[1]" in text0,
          f"elastic straggler: rank 0 exited {rc0}:\n{text0[-2000:]}")
    print(f"elastic (b) straggler: rank 1 sleeps {EL_SLOW_S:g} s before a batch; rank 0 exits "
          f"110 past the {EL_DEADLINE_S:g} s deadline naming rank 1 ("
          f"{[l for l in text0.splitlines() if l.startswith('DRILL-TIMEOUT')][0]})")

    # -- resumes: the killed worlds, and the grow; the shrink here ------------
    resume = {"resume": True}
    stage = spawn_stage("(b)-(c) resumes", [
        ("resume", 2, [{"name": "lsq", "spec": {**lsq, **resume}, "root": str(root_f)},
                       {"name": "grow", "spec": {**exact, **resume,
                                                 "resume_policy": "repartition"},
                        "root": str(root_g)}], None),
        ("resume-train", 2, [{"name": "train", "spec": {**train, **resume},
                              "root": str(root_t)}], None)], dev)
    reps_r = ok_world("(b) resume", stage["resume"], ["lsq", "grow"])
    reps_t = ok_world("(c) resume", stage["resume-train"], ["train"])
    tally(reps_r + reps_t)
    check(sha(reps_r, "lsq") == sha(reps, "lsq"),
          "elastic (b): the killed-and-resumed world is not bitwise the uninterrupted one")
    check(sha(reps_r, "grow") == sha(reps, "exact"),
          "elastic (b): the grow 1 -> 2 is not bitwise the uninterrupted world of 2")
    check(sha(reps_t, "train") == sha(reps, "train"),
          "elastic (c): the trainer killed and resumed is not bitwise the uninterrupted world")
    b0, b1 = RowPartition(EL_M, EL_BATCH, 2).batch_range(1)
    folded = [rec["attrs"]["batch"] for rec in sky.streaming.read_progress(
        sky.streaming.host_dir(root_f, 1) + "/progress.jsonl") if rec["name"] == "batch"]
    check(folded == list(range(b0, b1)), f"elastic (b): rank 1 folded {folded}")
    grow = reps_r[0]["runs"][1]["replay"]
    print(f"elastic (b) kill: rank 1 SIGKILLed after its first commit ({EL_EVERY} batches), the "
          f"world resumed: x bitwise the uninterrupted world; rank 1 folded each of its batches "
          f"once ({b1 - b0}); grow 1 -> 2 bitwise the uninterrupted world of 2 (replay "
          f"{grow}); trainer killed after ADMM chunk 1 and resumed: W bitwise {card}")
    # The shrink: world 2 killed above, resumed as world 1 (this process).
    fac, S = elastic_drill.lsq_problem(exact, dev)
    reset_counts()
    t_s = time.perf_counter()
    x_shrink, sinfo = sky.streaming.distributed_sketch_least_squares(
        fac, S, ncols=EL_N, partition=RowPartition(EL_M, EL_BATCH, 1), dtype=torch.float32,
        params=ElasticParams(placer=pinned_placer(dev), prefetch=0, checkpoint_dir=str(root_e),
                             checkpoint_every=EL_EVERY, resume=True,
                             resume_policy="repartition"))
    read_counts("elastic (b) shrink", t_s, ("scatter_rows",))
    same = torch.equal(x_shrink.cpu(), xs["CWT exact"])
    print(f"elastic (b) shrink 2 -> 1 on exact data: x bitwise the uninterrupted world 1 {same} "
          f"(replay {sinfo['replay']})")
    check(same and sinfo["replay"]["from_world"] == 2,
          "elastic (b): the shrink 2 -> 1 is not bitwise the uninterrupted world 1")
    dist.destroy_process_group()
    add_counts("elastic (ranks)", rank_counts)
    print(f"elastic: every rank's launches {rank_counts}; cross_host_psum host copies in this "
          f"process {cross_host_psum.host_copies} {card}")
    shutil.rmtree(EL_DIR, ignore_errors=True)
    held.update((sig[0], str(sig[1:]).replace("torch.", "")) for sig in held_here)
    return held


def mesh_path(sky, dev, reset_counts, read_counts, uncounted, smi, edges) -> set:
    """Phase 3p: the explicit sharded schedules (``parallel``) on meshes of
    1, 2 and 4 slots of the one card, and a (2, 2) grid: (a) the dense
    schedules at full width (FJLT rowwise at 131072 x 4096, CWT and FJLT
    on a 2^20 x 32 right-hand-side block, JLT columnwise at 2^20 x 512);
    (b) the sparse schedules on phase 3b's 10^6 x 10^5 COO with 10^7
    nonzeros (CWT, SJLT with nnz = 4), dense and sparse output, and the
    sparse-out capacity at ``suggest_sparse_out_capacity``'s count and one
    less; (c) ``chained_adjacency_sketch`` of phase 3c's graph in core on 1
    and 4 slots against the streamed chain; (d) ``streaming_approximate_svd``
    of a rank-100 2^20 x 1024 f32 matrix on 1 and 4 slots against
    ``mesh=None``.  A mesh of one is held bitwise against the unsharded
    apply; more slots bitwise where no reduction crosses slots and both
    sides take the same route, else within ``MESH_TOL`` of the largest
    entry (a psum reorders f32 sums), and bitwise on integer-valued data;
    each beside a control that misses.  The unsharded references run
    ``uncounted()``, so a ``mesh (x)`` count is the schedules' own.  Slots
    on one card run one after another: the seconds printed are a
    schedule's overhead, not a speed-up.  Returns the held signatures."""
    from libskylark_tpu_torch import parallel as P
    from libskylark_tpu_torch.graph import SimpleGraph
    from libskylark_tpu_torch.graph import stream as gs
    from libskylark_tpu_torch.parallel import collectives as C
    from libskylark_tpu_torch.parallel import mesh as M
    from libskylark_tpu_torch.sketch import kernels_fut as kf
    from libskylark_tpu_torch.sketch import kernels_scatter as ks
    from libskylark_tpu_torch.sketch import kernels_window as kw

    f32 = torch.float32
    card = f"[{smi}]"
    g = torch.Generator(device=dev).manual_seed(SEED + 21)
    held = set()

    def segsum_held(out, vals, keys, segs):
        ref = ks.segment_sum_flat_plain(vals, keys, segs)
        _, r = max_err(out, ref)
        i = int(vals.abs().argmax())
        ctl = ks.segment_sum_flat_plain(torch.cat([vals[:i], vals[i + 1:]]),
                                        torch.cat([keys[:i], keys[i + 1:]]), segs)
        _, c = max_err(out, ctl)
        print(f"mesh (held) segment_sum_flat {vals.shape[0]} -> {segs} {vals.dtype}: vs its "
              f"plain version rel {r:.3g} (tol 1e-5); control (the plain version without entry "
              f"{i}) {c:.3g}")
        check(r <= 1e-5 and c > 1e-5, f"mesh segment_sum_flat {vals.shape[0]}: {r}, control {c}")

    kernels = hold_kernels("mesh", kf, kw, ("rfut_rowwise", "rfut_rowwise_sampled",
                                            "gather_scaled_rows", "scatter_rows"), held)
    kernels.append((ks, "segment_sum_flat", hold(ks, "segment_sum_flat", segsum_held, held)))
    one = P.default_mesh()  # the visible cards: one card, a 1 x 1 mesh
    check(one.size == 1 and one.shape == {P.ROWS: 1, P.COLS: 1},
          f"default_mesh() on one card is {one.shape}")
    meshes = {1: one, **{p: P.make_mesh((p,), (P.ROWS,), devices=[dev] * p) for p in (2, 4)}}
    grid = P.make_mesh((2, 2), ("r", "c"), devices=[dev] * 4)
    times = {}

    def run(name, slots, fn):
        """``fn()``, its synchronized host seconds under ``times[name]``;
        ``slots`` None is the unsharded reference, run uncounted.  A call
        under 2 s is timed again, warm and uncounted: the first holds its
        kernels' signatures against their plain versions."""
        def once():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = fn()
            torch.cuda.synchronize()
            return got, time.perf_counter() - t0

        with uncounted() if slots is None else contextlib.nullcontext():
            out, secs = once()
        if secs < 2.0:
            with uncounted():
                secs = once()[1]
        times.setdefault(name, {})["unsharded" if slots is None else slots] = secs
        return out

    def rel(a, b):
        return float((a.double() - b.double()).abs().max() / b.double().abs().max())

    def held_to(name, got, ref, bitwise, ctl=None):
        """``got`` bitwise ``ref`` or within MESH_TOL, beside a control."""
        same = torch.equal(got, ref)
        r = rel(got, ref)
        c = None if ctl is None else rel(ctl, ref)
        print(f"mesh {name}: bitwise {same}, max |diff| / max |ref| {r:.3g} "
              f"({'must be bitwise' if bitwise else f'bound {MESH_TOL:g}'})"
              + ("" if c is None else f"; control {c:.3g}") + f" {card}")
        check(same if bitwise else r <= MESH_TOL, f"mesh {name}: bitwise {same}, rel {r}")
        if ctl is not None:
            check(c > (0.0 if bitwise else MESH_TOL), f"mesh {name}: the control passes ({c})")

    def swapped(out):
        """The control of a slot-pure schedule: slots 0 and 1 swapped."""
        t = list(out.shards)
        t[0], t[1] = t[1], t[0]
        return M.fully_replicated(M.Sharded(out.mesh, out.spec, out.shape, t))

    try:
        # (a) the dense schedules at full width.
        reset_counts()
        t0 = time.perf_counter()
        A = torch.randn(MESH_RW_M, MESH_RW_N, generator=g, device=dev)
        # S = 1024 takes the sampled kernel; 1000 (not a multiple of 128)
        # rfut_rowwise and the sampling in torch.
        for s in (MESH_RW_S, MESH_RW_S2):
            S = sky.sketch.FJLT(MESH_RW_N, s, sky.SketchContext(seed=SEED))
            name = f"rowwise_sharded FJLT {MESH_RW_M} x {MESH_RW_N} -> {s}"
            ref = run(name, None, lambda: S.apply(A, "rowwise"))
            for p, mesh in meshes.items():
                out = run(name, p, lambda: P.rowwise_sharded(S, A, mesh))
                held_to(f"{name}, {p} slot(s)", M.fully_replicated(out), ref, True,
                        swapped(out) if p > 1 else None)
        del A, ref, out
        B = torch.randn(MESH_B_N, MESH_B_K, generator=g, device=dev)
        for stype in ("CWT", "FJLT"):
            S = sky.sketch.create_sketch(stype, MESH_B_N, MESH_B_S, sky.SketchContext(seed=SEED))
            name = f"columnwise_batch_sharded {stype} {MESH_B_N} x {MESH_B_K} -> {MESH_B_S}"
            ref = run(name, None, lambda: S.apply(B))
            for p, mesh in meshes.items():
                out = run(name, p, lambda: P.columnwise_batch_sharded(S, B, mesh))
                # The row scatter is column-pure; the FJLT's WHT at NB = 2^20
                # is a chain of GEMMs whose algorithm follows the width.
                held_to(f"{name}, {p} slot(s) of {MESH_B_K // p} columns",
                        M.fully_replicated(out), ref, p == 1 or stype == "CWT",
                        swapped(out) if p > 1 else None)
        del B, ref, out
        A = torch.randn(MESH_JLT_N, MESH_JLT_M, generator=g, device=dev)
        S = sky.sketch.JLT(MESH_JLT_N, MESH_JLT_S, sky.SketchContext(seed=SEED))
        name = f"columnwise_sharded JLT {MESH_JLT_N} x {MESH_JLT_M} -> {MESH_JLT_S}"
        ref = run(name, None, lambda: S.apply(A))
        for p, mesh in meshes.items():
            out = run(name, p, lambda: P.columnwise_sharded(S, A, mesh))
            ctl = None
            if p == 2:  # slot 1's Omega window shifted back by one block
                half = MESH_JLT_N // 2
                with uncounted():
                    ctl = C._window_product(S, A[:half], 0) + C._window_product(S, A[half:], 0)
            held_to(f"{name}, {p} slot(s)", out, ref, p == 1, ctl)
        del A, ref, out, ctl
        torch.cuda.empty_cache()
        # The rowwise FJLT at 4096 -> 1000 and 1024 takes the subsampled-
        # Hadamard GEMM: phase 2 and the LS, NLA, policy and plans paths hold
        # the rfut kernels.
        read_counts("mesh (a)", t0, ("gather_scaled_rows", "scatter_rows"))

        # (b) the sparse schedules on phase 3b's shape; integer-valued data
        # (nonzero integers: a zero entry is padding to the sparse-out
        # exchange, which drops it) makes every reordered sum exact.
        reset_counts()
        t0 = time.perf_counter()
        rows = torch.randint(0, SP_ROWS, (SP_NNZ,), generator=g, device=dev)
        cols = torch.randint(0, SP_COLS, (SP_NNZ,), generator=g, device=dev)
        data = torch.randn(SP_NNZ, generator=g, device=dev)
        ints = torch.where(data < 0, -1.0, 1.0) * (1.0 + torch.floor(data.abs() * 4))
        idx = torch.stack([rows, cols])
        A = torch.sparse_coo_tensor(idx, data, (SP_ROWS, SP_COLS), check_invariants=False)
        Ai = torch.sparse_coo_tensor(idx, ints, (SP_ROWS, SP_COLS), check_invariants=False)
        for stype, kw_ in (("CWT", {}), ("SJLT", {"nnz": 4})):
            S = sky.sketch.create_sketch(stype, SP_ROWS, SP_S, sky.SketchContext(seed=SEED),
                                         **kw_)
            name = f"columnwise_sharded_sparse {stype} {SP_ROWS} x {SP_COLS}, {SP_NNZ} nnz -> {SP_S}"
            ref = run(name, None, lambda: S.apply(A, dense_output=True))
            for p, mesh in meshes.items():
                out = run(name, p, lambda: P.columnwise_sharded_sparse(S, A, mesh))
                ctl = None
                if p == 4:  # slot 1's counter windows shifted by one block
                    blk = SP_ROWS // 4
                    with uncounted():
                        slots = C._shard_coo_rows(A, mesh, blk, "control")
                        parts = [C._hash_dense_block(S, d, lr, cc, SP_COLS,
                                                     (k + (k == 1)) * blk, blk)
                                 for k, (d, lr, cc) in enumerate(slots)]
                        ctl = M.psum(parts, dev)
                    del slots, parts
                held_to(f"{name}, {p} slot(s)", out, ref, p == 1, ctl)
            scat = run(name, "4, scatter", lambda: P.columnwise_sharded_sparse(
                S, A, meshes[4], scatter=True))
            check(torch.equal(M.fully_replicated(scat), out),
                  f"mesh {name}: psum_scatter is not bitwise the psum's blocks")
            out2d = run(name, "(2, 2) grid", lambda: P.columnwise_sharded_sparse_2d(S, A, grid))
            held_to(f"columnwise_sharded_sparse_2d {stype} on a (2, 2) grid",
                    M.fully_replicated(out2d), ref, False)
            del ref, out, ctl, scat, out2d
            ref_i = run(f"{name}, integer data", None, lambda: S.apply(Ai, dense_output=True))
            held_to(f"{name}, integer data, 4 slots",
                    P.columnwise_sharded_sparse(S, Ai, meshes[4]), ref_i, True)
            held_to(f"columnwise_sharded_sparse_2d {stype}, integer data, (2, 2) grid",
                    M.fully_replicated(P.columnwise_sharded_sparse_2d(S, Ai, grid)), ref_i, True)
            # The sparse output: to_bcoo() against the unsharded sparse apply.
            sp_ref = run(f"columnwise_sharded_sparse_out {stype}", None, lambda: S.apply(Ai))
            for p in (1, 4):
                got = run(f"columnwise_sharded_sparse_out {stype}", p,
                          lambda: P.columnwise_sharded_sparse_out(S, Ai, meshes[p]).to_bcoo())
                same = (torch.equal(got._indices(), sp_ref._indices())
                        and torch.equal(got._values(), sp_ref._values()))
                print(f"mesh columnwise_sharded_sparse_out {stype}, integer data, {p} slot(s), "
                      f"default capacity: to_bcoo() {got._nnz()} entries, bitwise the unsharded "
                      f"sparse apply ({sp_ref._nnz()} entries) {same} {card}")
                check(same, f"mesh sparse_out {stype} {p} slots: to_bcoo differs")
            del ref_i, sp_ref, got
        # Capacity: suggest_sparse_out_capacity's count drops nothing; one
        # less drops exactly the entries past it in each (source,
        # destination) run of a stable sort on destination.
        S = sky.sketch.CWT(SP_ROWS, SP_S, sky.SketchContext(seed=SEED))
        p, mesh = 4, meshes[4]
        need = P.suggest_sparse_out_capacity(S, Ai, mesh)
        full = P.columnwise_sharded_sparse_out(S, Ai, mesh).todense()
        check(torch.equal(P.columnwise_sharded_sparse_out(S, Ai, mesh, capacity=need).todense(),
                          full), f"mesh sparse_out at capacity {need} is not the default's")
        tight = P.columnwise_sharded_sparse_out(S, Ai, mesh, capacity=need - 1)
        blk, out_blk = SP_ROWS // p, SP_S // p
        bkt, val = S.buckets(device=dev).long(), S.values(device=dev)
        want = torch.zeros(SP_S, SP_COLS, device=dev)
        drops = 0
        for src in range(p):
            sel = (rows // blk == src).nonzero()[:, 0]  # the source's entries in input order
            dest = bkt[rows[sel]] // out_blk
            rank = torch.zeros_like(dest)
            for d in range(p):
                on = dest == d
                rank[on] = torch.arange(int(on.sum()), device=dev)
            keep = rank < need - 1
            drops += int((~keep).sum())
            want.index_put_((bkt[rows[sel[keep]]], cols[sel[keep]]),
                            ints[sel[keep]] * val[rows[sel[keep]]],
                            accumulate=True)
        kept = int((M.fully_replicated(tight.data) != 0).sum())
        got_t = tight.todense()
        print(f"mesh sparse_out capacity on 4 slots: suggest_sparse_out_capacity's {need} drops "
              f"none (bitwise the default capacity); {need - 1} keeps {kept} of {SP_NNZ} "
              f"entries, {SP_NNZ - kept} dropped (expected {drops}), bitwise the plain-torch "
              f"expectation {torch.equal(got_t, want)} {card}")
        check(drops > 0 and SP_NNZ - kept == drops and torch.equal(got_t, want),
              f"mesh sparse_out at capacity {need - 1}: {SP_NNZ - kept} dropped, expected {drops}")
        del full, tight, want, got_t, bkt, val
        # Rowwise: 2^18 rows (the unsharded dense output's limit), the
        # same entries folded onto them.
        ridx = torch.stack([rows % MESH_RW_ROWS, cols])
        Ar = torch.sparse_coo_tensor(ridx, data, (MESH_RW_ROWS, SP_COLS), check_invariants=False)
        Ari = torch.sparse_coo_tensor(ridx, ints, (MESH_RW_ROWS, SP_COLS), check_invariants=False)
        S = sky.sketch.CWT(SP_COLS, SP_S, sky.SketchContext(seed=SEED))
        name = f"rowwise_sharded_sparse CWT {MESH_RW_ROWS} x {SP_COLS}, {SP_NNZ} nnz -> {SP_S}"
        ref = run(name, None, lambda: S.apply(Ar, "rowwise", dense_output=True))
        for p, mesh in meshes.items():
            out = run(name, p, lambda: P.rowwise_sharded_sparse(S, Ar, mesh))
            held_to(f"{name}, {p} slot(s)", M.fully_replicated(out), ref, p == 1,
                    swapped(out) if p > 1 else None)
        ref = run(f"{name}, integer data", None,
                  lambda: S.apply(Ari, "rowwise", dense_output=True))
        held_to(f"{name}, integer data, 4 slots",
                M.fully_replicated(P.rowwise_sharded_sparse(S, Ari, meshes[4])), ref, True)
        sp_ref = run("rowwise_sharded_sparse_out CWT", None, lambda: S.apply(Ari, "rowwise"))
        got = run("rowwise_sharded_sparse_out CWT", 4,
                  lambda: P.rowwise_sharded_sparse_out(S, Ari, meshes[4]).to_bcoo())
        same = (torch.equal(got._indices(), sp_ref._indices())
                and torch.equal(got._values(), sp_ref._values()))
        print(f"mesh rowwise_sharded_sparse_out CWT, integer data, 4 slots: to_bcoo() bitwise the "
              f"unsharded sparse apply {same} {card}")
        check(same, "mesh rowwise_sharded_sparse_out: to_bcoo differs")
        del A, Ai, Ar, Ari, ref, out, rows, cols, data, ints, idx, ridx, sp_ref, got
        torch.cuda.empty_cache()
        read_counts("mesh (b)", t0, ("segment_sum_flat",))

        # (c) the chained sketch of phase 3c's graph: in core (sparse out,
        # then the dense hop) on 1 and 4 slots against the streamed chain.
        reset_counts()
        t0 = time.perf_counter()
        # Two isolated vertices pad n to a multiple of 4 slots (the row
        # blocks must divide it), on both sides of the comparison.
        lo, hi = edges
        n_v = -(-LJ_VERTICES // 4) * 4
        lo_t, hi_t = torch.from_numpy(lo).to(dev), torch.from_numpy(hi).to(dev)
        code = torch.sort(torch.cat([lo_t * n_v + hi_t, hi_t * n_v + lo_t])).values
        G = object.__new__(SimpleGraph)  # CSR straight from the edges: ids are 0..n-1
        G.n, G.vertices, G.index = n_v, range(n_v), None
        G.indptr = np.concatenate([[0], torch.cumsum(torch.bincount(code // n_v, minlength=n_v),
                                                      0).cpu().numpy()])
        G.indices = (code % n_v).cpu().numpy()
        del lo_t, hi_t, code
        S1 = sky.sketch.CWT(n_v, MESH_CHAIN_S1, sky.SketchContext(seed=SEED))
        S2 = sky.sketch.CWT(MESH_CHAIN_S1, MESH_CHAIN_S2, sky.SketchContext(seed=SEED + 1))
        name = f"chained_adjacency_sketch CWT {n_v} -> {MESH_CHAIN_S1} -> {MESH_CHAIN_S2} f32"
        streamed = run(name, "streamed", lambda: gs.chained_adjacency_sketch(
            G, S1, S2, streamed=True, batch_edges=GRAPH_BATCH, dtype=f32, device=dev))
        for p in (1, 4):
            incore = run(name, p, lambda: gs.chained_adjacency_sketch(
                G, S1, S2, mesh=None if p == 1 else meshes[4], dtype=f32, device=dev))
            ctl = None
            if p == 4:  # slot 1's counter window of the second hop shifted by one block
                with uncounted():
                    mid = P.columnwise_sharded_sparse_out(S1, G.adjacency_coo(f32, dev), meshes[4])
                    rb = mid.row_block
                    parts = [C._hash_dense_block(S2, d, lr, cc, n_v, (k + (k == 1)) * rb, rb)
                             for k, (d, lr, cc) in enumerate(mid._slot_entries())]
                    ctl = M.psum(parts, dev)
                del mid, parts
            held_to(f"{name}, in core on {p} slot(s) vs streamed", incore, streamed, True, ctl)
        del G, streamed, incore, ctl
        torch.cuda.empty_cache()
        read_counts("mesh (c)", t0, ("segment_sum_flat",))

        # (d) the streaming randomized SVD with its panels split over the slots.
        reset_counts()
        t0 = time.perf_counter()
        block = sky.linalg.synthetic_lowrank_blocks(sky.SketchContext(seed=SEED), SSVD_M, SSVD_N,
                                                    SSVD_R, noise=SSVD_NOISE, dtype=f32, device=dev)
        name = f"streaming_approximate_svd {SSVD_M} x {SSVD_N} f32, rank {SSVD_R}"
        res = {}
        for p, mesh in ((None, None), (1, one), (4, meshes[4])):
            res[p] = run(name, "mesh=None" if p is None else p,
                         lambda: sky.linalg.streaming_approximate_svd(
                             block, (SSVD_M, SSVD_N), SSVD_R, sky.SketchContext(seed=SEED + 1),
                             block_rows=SSVD_BR, mesh=mesh))
        (u0, s0, V0), (u1, s1, V1), (u4, s4, V4) = res[None], res[1], res[4]
        same = torch.equal(s1, s0) and torch.equal(V1, V0) and torch.equal(u1(0), u0(0))
        sv = float(((s4.double() - s0.double()).abs() / s0.double()).max())
        sv_ctl = float(((s4[1:].double() - s0[:-1].double()).abs() / s0[:-1].double()).max())
        # The rank-100 subspace: sin of the largest principal angle between
        # the two V's.  Single vectors are not held here: with equal weights
        # adjacent sigma lie ~1 % apart, and a vector turns within such a
        # pair by (the perturbation) / (the gap).  The control swaps V0's
        # last column for a unit vector orthogonal to V0.
        def sin_angle(V, W):  # ||W - V V^T W||_2, in f64
            V, W = V.double(), W.double()
            return float(torch.linalg.matrix_norm(W - V @ (V.T @ W), 2))
        sub = sin_angle(V4, V0)
        w = torch.randn(SSVD_N, generator=g, device=dev, dtype=torch.float64)
        w -= V0.double() @ (V0.double().T @ w)
        V0c = torch.cat([V0.double()[:, :-1], (w / w.norm())[:, None]], 1)
        sub_ctl = sin_angle(V4, V0c)
        diag = float((V4.T @ V0).abs().diagonal().min())
        print(f"mesh {name}: 1 slot bitwise mesh=None (s, V, u_block(0)) {same}; 4 slots: sigma "
              f"max rel {sv:.3g} (bound 1e-4; control, sigma one index over, {sv_ctl:.3g}), "
              f"subspace sin angle {sub:.3g} (bound 1e-3; control {sub_ctl:.3g}); min |v4_j . "
              f"v0_j| {diag:.4f} (observed: near-degenerate pairs turn) {card}")
        check(same, f"mesh {name}: one slot is not bitwise mesh=None")
        check(sv <= 1e-4 and sv_ctl > 1e-4 and sub <= 1e-3 and sub_ctl > 1e-3,
              f"mesh {name}: sigma {sv} (control {sv_ctl}), subspace {sub} (control {sub_ctl})")
        # The JAX multichip test's own problem (tests/test_multichip.py:79-106:
        # 4096 x 64, rank 5, well separated sigma), held as it holds it.
        small = sky.linalg.synthetic_lowrank_blocks(sky.SketchContext(seed=41), 4096, 64, 5,
                                                    noise=0.01, dtype=f32, device=dev)
        got = [sky.linalg.streaming_approximate_svd(
            small, (4096, 64), 5, sky.SketchContext(seed=41),
            sky.linalg.SVDParams(num_iterations=1), block_rows=1024, mesh=mesh)
            for mesh in (None, meshes[4])]
        (_, t0s, t0V), (_, t4s, t4V) = got
        sv5 = float(((t4s.double() - t0s.double()).abs() / t0s.double()).max())
        vv5 = float(((t4V.T @ t0V).abs().double()
                     - torch.eye(5, device=dev, dtype=torch.float64)).abs().max())
        vv5_ctl = float(((t4V.T @ t0V.roll(1, 1)).abs().double()
                         - torch.eye(5, device=dev, dtype=torch.float64)).abs().max())
        print(f"mesh streaming_approximate_svd 4096 x 64 f32, rank 5 (the JAX multichip test's): "
              f"4 slots vs mesh=None sigma max rel {sv5:.3g} (bound 1e-4), max | |V4^T V0| - I | "
              f"{vv5:.3g} (bound 1e-3; control, V0's columns rolled by one, {vv5_ctl:.3g}) {card}")
        check(sv5 <= 1e-4 and vv5 <= 1e-3 and vv5_ctl > 1e-3,
              f"mesh rank-5 SVD: sigma {sv5}, V {vv5} (control {vv5_ctl})")
        del res, u0, u1, u4, block, small, got
        torch.cuda.empty_cache()
        read_counts("mesh (d)", t0, ())
    finally:
        for mod, name_, kernel in kernels:
            setattr(mod, name_, kernel)

    # (e) seconds, eager and synchronized, of each schedule beside its
    # unsharded call: slots on one card run in turn, so this is overhead.
    for name, by in times.items():
        cells = ", ".join(f"{k if isinstance(k, str) else f'{k} slot(s)'} {v:.4f} s"
                          for k, v in by.items())
        print(f"mesh time {name}: {cells} (slots share one card: overhead, not speed-up) {card}")
    return held


def shard_path(sky, dev, reset_counts, read_counts, uncounted, smi, cli_files) -> set:
    """Phase 3q: the sharded-input routes (``parallel.routes``, what the
    JAX package leaves to GSPMD) on meshes of 1, 2 and 4 slots of the one
    card: (a) ``solve_regression`` on a row-sharded A at the LS cell
    (2^20 x 512 f32) and at 32768 x 768, through accelerated, sketched
    (FJLT, CWT) and exact; (b) ``approximate_svd``, ``approximate_kernel_
    ridge`` and ``BlockADMMSolver.train`` at phases 3e's and 3f's widths;
    (c) ``skylark_linear`` and ``skylark_svd --shard`` on phase 3l's
    YearPredictionMSD file, bitwise the runs without the flag (one card:
    a mesh of one); (d) ``flagship.dryrun_multichip(4, device="cuda")``;
    (e) the serve LS and predict programs forced over 2 and 4 entries of
    the card, every probe's verdict printed and every answer bitwise the
    serial one; (f) a die-under-load drill on two replicas sharing the
    card.  The unsharded references and the controls run ``uncounted()``,
    so a ``shard (x)`` count is the sharded calls' own, and every first
    launch of a signature is held against its plain version.  Slots on
    one card run in turn: the seconds are overhead, not a speed-up.
    Returns the held signatures."""
    from importlib import import_module

    from libskylark_tpu_torch import parallel as P
    from libskylark_tpu_torch import serve, telemetry
    from libskylark_tpu_torch.parallel import mesh as M
    from libskylark_tpu_torch.resilient import FleetFaultPlan
    from libskylark_tpu_torch.serve import dispatch
    from libskylark_tpu_torch.sketch import kernels_fut as kf
    from libskylark_tpu_torch.sketch import kernels_scatter as ks
    from libskylark_tpu_torch.sketch import kernels_window as kw
    from libskylark_tpu_torch.solvers import RegressionProblem, solve_regression

    card = f"[{smi}]"
    f32 = torch.float32
    g = torch.Generator(device=dev).manual_seed(SEED + 31)
    held = set()
    meshes = {p: P.make_mesh((p,), (P.ROWS,), devices=[dev] * p) for p in SH_SLOTS}
    times = {}

    def segsum_held(out, vals, keys, segs):
        ref = ks.segment_sum_flat_plain(vals, keys, segs)
        _, r = max_err(out, ref)
        i = int(vals.abs().argmax())
        ctl = ks.segment_sum_flat_plain(torch.cat([vals[:i], vals[i + 1:]]),
                                        torch.cat([keys[:i], keys[i + 1:]]), segs)
        _, c = max_err(out, ctl)
        print(f"shard (held) segment_sum_flat {vals.shape[0]} -> {segs} {vals.dtype}: vs its "
              f"plain version rel {r:.3g} (tol 1e-5); control (the plain version without entry "
              f"{i}) {c:.3g}")
        check(r <= 1e-5 and c > 1e-5, f"shard segment_sum_flat {vals.shape[0]}: {r}, control {c}")

    kernels = hold_kernels("shard", kf, kw, ("rfut_rowwise", "rfut_rowwise_sampled",
                                             "gather_scaled_rows", "scatter_rows"), held)
    kernels.append((ks, "segment_sum_flat", hold(ks, "segment_sum_flat", segsum_held, held)))

    def timed(name, slots, fn):
        """``fn()``, its synchronized host seconds under ``times[name]``;
        ``slots`` None is the unsharded reference, run uncounted.  The
        call is timed again, warm and uncounted: the first pays first-use
        costs and holds its kernels' signatures."""
        def once():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = fn()
            torch.cuda.synchronize()
            return got, time.perf_counter() - t0

        with uncounted() if slots is None else contextlib.nullcontext():
            out = once()[0]
        with uncounted():
            secs = once()[1]
        times.setdefault(name, {})["unsharded" if slots is None else slots] = secs
        return out

    def rel(a, b):
        a, b = M.fully_replicated(a).double(), M.fully_replicated(b).double()
        return float((a - b).abs().max() / b.abs().max())

    def agree(name, p, got, ref, tol, ctl):
        """One slot bitwise the unsharded call; more within ``tol`` beside
        a control that misses it."""
        got = M.fully_replicated(got)
        if p == 1:
            same = torch.equal(got, ref)
            print(f"shard {name}, 1 slot: bitwise the unsharded call {same} {card}")
            check(same, f"shard {name}: one slot is not bitwise the unsharded call")
            return
        r, c = rel(got, ref), rel(ctl, ref)
        print(f"shard {name}, {p} slots: max |diff| / max |ref| {r:.3g} (bound {tol:g}); "
              f"control {c:.3g} {card}")
        check(r <= tol and c > tol, f"shard {name}, {p} slots: {r} (control {c})")

    def x_of(out):
        return out[0] if isinstance(out, tuple) else out

    torch.cuda.reset_peak_memory_stats(dev)
    t_phase = time.perf_counter()
    try:
        # (a) solve_regression on a row-sharded A.
        reset_counts()
        t0 = time.perf_counter()
        for m, n in SH_LS:
            A = torch.randn(m, n, generator=g, device=dev)
            b = A @ torch.randn(n, generator=g, device=dev) + SH_NOISE * torch.randn(
                m, generator=g, device=dev)
            solves = (("accelerated", None), ("sketched", "FJLT"), ("sketched", "CWT"),
                      ("exact", None))

            def solve(A_, b_, solver, stype, seed=SEED):
                params = (sky.linalg.LeastSquaresParams(sketch_type=stype) if stype
                          else None)
                return x_of(solve_regression(RegressionProblem(A_), b_, solver,
                                             sky.SketchContext(seed=seed), params=params))

            with uncounted():
                x_sk = solve(A, b, "sketched", "FJLT")
            for solver, stype in solves:
                name = f"solve_regression {solver}{f' {stype}' if stype else ''} {m} x {n} f32"
                ref = timed(name, None, lambda: solve(A, b, solver, stype))
                with uncounted():
                    ctl = solve(A, b, solver, stype, SEED + 1) if solver == "sketched" else x_sk
                for p, mesh in meshes.items():
                    As, bs = P.shard_rows(A, mesh), P.shard_rows(b, mesh)
                    got = timed(name, p, lambda: solve(As, bs, solver, stype))
                    agree(name, p, got, ref, SH_TOL[solver], ctl)
            del A, b, As, bs, ref, ctl, got, x_sk
            torch.cuda.empty_cache()
        read_counts("shard (a)", t0, ("rfut_rowwise", "rfut_rowwise_sampled",
                                      "gather_scaled_rows", "scatter_rows"))

        # (b) the randomized SVD, approximate KRR and BlockADMM.
        reset_counts()
        t0 = time.perf_counter()
        A = (torch.randn(SH_SVD_M, SH_SVD_R, generator=g, device=dev)
             @ torch.randn(SH_SVD_R, SH_SVD_N, generator=g, device=dev)) / SH_SVD_R ** 0.5
        A += 0.01 * torch.randn(SH_SVD_M, SH_SVD_N, generator=g, device=dev)
        sp = sky.linalg.SVDParams(num_iterations=1)
        name = f"approximate_svd {SH_SVD_M} x {SH_SVD_N} f32, rank {SH_SVD_R}"

        def svd(A_):
            return sky.linalg.approximate_svd(A_, SH_SVD_R, sky.SketchContext(seed=SEED), sp)

        U0, s0, V0 = timed(name, None, lambda: svd(A))
        for p, mesh in meshes.items():
            U, s, V = timed(name, p, lambda: svd(P.shard_rows(A, mesh)))
            check(tuple(U.shape) == (SH_SVD_M, SH_SVD_R) and (p == 1 or isinstance(U, M.Sharded)),
                  f"shard {name}: U is {U!r}")
            agree(f"{name} (sigma)", p, s, s0, SH_TOL["svd"],
                  torch.cat([s0[1:], s0[-1:]]))
        del A, U0, V0, U, V
        torch.cuda.empty_cache()
        X = torch.randn(SH_KRR_M, ML_DIM, generator=g, device=dev)
        Y = torch.nn.functional.one_hot(torch.randint(0, ML_CLASSES, (SH_KRR_M,), generator=g,
                                                      device=dev), ML_CLASSES).float()
        kern = sky.ml.GaussianKernel(ML_DIM, sigma=ML_SIGMA)
        name = f"approximate_kernel_ridge {SH_KRR_M} x {ML_DIM} -> {ML_S} f32"

        def krr(X_, seed=SEED):
            return sky.ml.approximate_kernel_ridge(kern, X_, Y if not isinstance(X_, M.Sharded)
                                                   else P.shard_rows(Y, X_.mesh), KRR_LAM,
                                                   ML_S, sky.SketchContext(seed=seed)).W

        W0 = timed(name, None, lambda: krr(X))
        with uncounted():
            W_ctl = krr(X, SEED + 1)
        for p, mesh in meshes.items():
            agree(name, p, timed(name, p, lambda: krr(P.shard_rows(X, mesh))), W0,
                  SH_TOL["krr"], W_ctl)
        del X, Y, W0, W_ctl
        torch.cuda.empty_cache()
        X = torch.randn(ADMM_M, ADMM_D, generator=g, device=dev)
        y = (X[:, :4].sum(1) > 0).long().cpu().numpy()
        name = (f"BlockADMMSolver.train {ADMM_M} x {ADMM_D}, 2 maps of {ADMM_S}, P = {ADMM_P}, "
                f"{SH_ADMM_ITERS} iterations")

        def admm(X_, seed=SEED):
            kk = sky.ml.GaussianKernel(ADMM_D, sigma=ADMM_SIGMA)
            ctx = sky.SketchContext(seed=seed)
            maps = [kk.create_rft(ADMM_S, "regular", ctx) for _ in range(2)]
            return sky.ml.BlockADMMSolver("hinge", "l2", maps, sky.ml.ADMMParams(
                maxiter=SH_ADMM_ITERS, data_partitions=ADMM_P)).train(X_, y)

        m0 = timed(name, None, lambda: admm(X))
        with uncounted():
            W_ctl = admm(X, SEED + 1).W
        for p, mesh in meshes.items():
            mp = timed(name, p, lambda: admm(P.shard_rows(X, mesh)))
            agree(name, p, mp.W, m0.W, SH_TOL["admm"], W_ctl)
            out = mp.predict(P.shard_rows(X, mesh))
            check((p == 1 or isinstance(out, M.Sharded)) and tuple(out.shape) == (ADMM_M, 2),
                  f"shard {name}: predict of a sharded X is {out!r}")
        del X, m0, mp, W_ctl, out
        torch.cuda.empty_cache()
        read_counts("shard (b)", t0, ())

        # (c) the drivers' --shard on one card: a mesh of one, bitwise.
        reset_counts()
        t0 = time.perf_counter()
        out_dir = CLI_DIR / "out"
        out_dir.mkdir(parents=True, exist_ok=True)
        for drv, argv, outs in (
                ("linear", [cli_files["ls"], "--solution", out_dir / "sh_x{tag}.npy"],
                 ("sh_x{tag}.npy",)),
                ("svd", [cli_files["ls"], "-k", CLI_LS_TOP, "-i", 2, "--prefix",
                         out_dir / "sh_y{tag}"],
                 ("sh_y{tag}.U.npy", "sh_y{tag}.S.npy", "sh_y{tag}.V.npy"))):
            main_ = import_module(f"libskylark_tpu_torch.cli.{drv}").main
            for tag, flag in (("0", []), ("1", ["--shard"])):
                args = [str(a).replace("{tag}", tag) for a in argv] + flag
                ctx_ = uncounted() if not flag else contextlib.nullcontext()
                with ctx_:
                    t = time.perf_counter()
                    check(main_(args) == 0, f"shard: skylark_{drv} {' '.join(args)} failed")
                    times.setdefault(f"skylark_{drv} (YearPredictionMSD width)", {})[
                        "--shard" if flag else "without"] = time.perf_counter() - t
            same = all(np.array_equal(np.load(out_dir / f.replace("{tag}", "0")),
                                      np.load(out_dir / f.replace("{tag}", "1"))) for f in outs)
            print(f"shard skylark_{drv} --shard on {cli_files['ls'].name}: bitwise the run "
                  f"without it {same} (one card: a mesh of one) {card}")
            check(same, f"shard: skylark_{drv} --shard differs from the run without it")
        read_counts("shard (c)", t0, ("gather_scaled_rows",))

        # (d) the JAX package's multichip dry run on 4 slots of the card.
        reset_counts()
        t0 = time.perf_counter()
        try:
            sky.flagship.dryrun_multichip(4, device="cuda")
        except AssertionError as e:
            fail(f"shard: dryrun_multichip(4): {e}")
        times["dryrun_multichip(4)"] = {4: time.perf_counter() - t0}
        print(f"shard dryrun_multichip(4, device='cuda'): every step ran and met its check "
              f"{card}")
        read_counts("shard (d)", t0, ("scatter_rows", "segment_sum_flat"))

        # (e) the serve programs forced over 2 and 4 entries of the card,
        # two rounds of distinct requests on one server: round 0's first
        # batch of each program is its probe (a match serves the
        # reference), round 1's batches run the kept sharded programs.
        reset_counts()
        t0 = time.perf_counter()
        A = torch.randn(SH_SV_M, SH_SV_N, generator=g, device=dev).cpu().numpy()
        rng_s = np.random.default_rng(SEED + 32)
        W = rng_s.standard_normal((ML_S, ML_CLASSES)).astype(np.float32)
        rhs = [rng_s.standard_normal(SH_SV_M) for _ in range(2 * SH_SV_REQ)]
        xq = [rng_s.standard_normal(SH_SV_D) for _ in range(2 * SH_SV_REQ)]

        def replica(coalesce):
            # The linger gathers a round submitted to a running server
            # into one batch of each op, the rung its program was kept at.
            srv = serve.Server(serve.ServeParams(max_coalesce=coalesce, warm_start=False,
                                                 prime=False, coalesce_window_ms=200.0),
                               seed=42, device=dev)
            srv.registry.register_system("sys", A, context=sky.SketchContext(seed=9))
            srv.registry.register_model("fm", sky.ml.FeatureMapModel(
                [sky.sketch.GaussianRFT(SH_SV_D, ML_S, sky.SketchContext(seed=5), sigma=20.0)],
                W, device=dev))
            return srv

        rounds = [[serve.make_request("ls_solve", system="sys", b=v)
                   for v in rhs[r * SH_SV_REQ:(r + 1) * SH_SV_REQ]]
                  + [serve.make_request("predict", model="fm", x=v)
                     for v in xq[r * SH_SV_REQ:(r + 1) * SH_SV_REQ]] for r in range(2)]

        def answers(coalesce, rounds):
            srv = replica(coalesce)
            out = []
            for r, reqs in enumerate(rounds):
                futs = [srv.submit(dict(q)) for q in reqs]
                if r == 0:
                    srv.start()
                out.append([f.result(timeout=300) for f in futs])
            srv.stop()
            check(all(a["ok"] for got in out for a in got),
                  f"shard serve: an answer failed {out[0][0]}")
            return out

        def events(got, kind):
            return [e for a in got for e in a["trace"]["events"] if e["kind"] == kind]

        with uncounted():
            serial = answers(1, [rounds[0] + rounds[1]])[0]
        saved = dispatch._local_devices
        try:
            os.environ["SKYLARK_SERVE_SHARD"] = "1"
            for nd in (2, 4):
                dispatch._local_devices = lambda device, nd=nd: [device] * nd
                dispatch.clear_cache()
                got = answers(SH_SV_REQ, rounds)
                verdicts = sorted({(e["op"], e["devices"], e["match"])
                                   for e in events(got[0] + got[1], "sharded_probe")})
                kept = sorted({(e["op"], e["devices"]) for e in events(got[1], "sharded")})
                same = all(np.array_equal(np.asarray(a["result"]), np.asarray(c["result"]))
                           for a, c in zip(serial, got[0] + got[1]))
                print(f"shard serve, {nd} entries of the card: probe verdicts (op, devices, "
                      f"match) {verdicts}; round 1 served by the kept programs (op, devices) "
                      f"{kept}, {len(events(got[1], 'sharded'))} of {len(got[1])} answers; "
                      f"both rounds' answers bitwise the serial ones {same} {card}")
                check(verdicts and {v[0] for v in verdicts} == {"ls", "predict"},
                      f"shard serve: programs probed {verdicts}")
                check({k[0] for k in kept} == {"ls", "predict"},
                      f"shard serve on {nd} entries: round 1 ran no kept sharded program "
                      f"of each op: {kept}")
                check(same, f"shard serve on {nd} entries: answers differ from the serial ones")
        finally:
            dispatch._local_devices = saved
            dispatch.clear_cache()
            os.environ.pop("SKYLARK_SERVE_SHARD", None)
        del A
        read_counts("shard (e)", t0, ())

        # (f) a replica dies under load at tick 2; replicas share the card.
        reset_counts()
        t0 = time.perf_counter()
        small = np.random.default_rng(SEED + 33).standard_normal((4096, 64)).astype(np.float32)

        def drill_replica():
            srv = serve.Server(serve.ServeParams(max_coalesce=8, warm_start=False, prime=False),
                               seed=42, device=dev)
            srv.registry.register_system("sys", small, context=sky.SketchContext(seed=9))
            return srv

        telemetry_was = os.environ.get("SKYLARK_TELEMETRY")
        os.environ["SKYLARK_TELEMETRY"] = "1"
        telemetry.REGISTRY.reset()
        r1, r2 = drill_replica().start(), drill_replica().start()
        router = serve.Router(serve.RouterParams(heartbeat_timeout_s=0.0))
        router.join("r1", server=r1)
        router.join("r2", server=r2)
        plan = FleetFaultPlan(die_under_load_at=2)
        plan.bind_fleet(kill=lambda: r2.stop(0.5))
        scaler = serve.Autoscaler(router, lambda name: drill_replica(), serve.AutoscaleParams(
            min_replicas=1, max_replicas=2, queue_high=1e9, queue_low=-1.0, p99_high_ms=1e-4,
            cooldown_ticks=0, idle_ticks=10**6), fault_plan=plan)
        responses = []
        for _ in range(5):
            responses += [router.call(op="ls_solve", system="sys", b=v)
                          for v in np.random.default_rng(len(responses)).standard_normal(
                              (2, 4096))]
            scaler.step()
        fleet = router.fleet_report()
        snap = telemetry.snapshot()
        router.stop()
        r1.stop()
        for srv in scaler._owned.values():
            srv.stop()
        telemetry.REGISTRY.reset()
        if telemetry_was is None:
            os.environ.pop("SKYLARK_TELEMETRY", None)
        else:
            os.environ["SKYLARK_TELEMETRY"] = telemetry_was
        codes = sorted({r["error"]["code"] for r in responses if not r["ok"]})
        placeable = sorted(n for n, mm in fleet["members"].items() if mm["placeable"])
        print(f"shard die-under-load drill: {len(responses)} calls, error codes {codes} (no "
              f"114 may show), placeable after {placeable}, ejects {snap['router']['ejects']}, "
              f"scale-ups {snap['autoscale']['scale_ups']} {card}")
        check(not codes and len(placeable) == 2 and "r2" not in fleet["members"],
              f"shard drill: codes {codes}, placeable {placeable}")
        read_counts("shard (f)", t0, ())
    finally:
        for mod, name_, kernel in kernels:
            setattr(mod, name_, kernel)

    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    for name, by in times.items():
        cells = ", ".join(f"{k if isinstance(k, str) else f'{k} slot(s)'} {v:.4f} s"
                          for k, v in by.items())
        print(f"shard time {name}: {cells} (slots share one card: overhead, not speed-up) {card}")
    print(f"shard: phase 3q items {time.perf_counter() - t_phase:.1f} s, peak memory allocated "
          f"{peak:.2f} GiB {card}")
    return held


def matmul_path(sky, dev, reset_counts, read_counts, uncounted, smi) -> set:
    """Phase 3r: the matmul routes the JAX package takes outside its
    kernels, each timed beside the route it replaced and held against it
    beside a control that misses (max |diff| / max |ref| printed): (a)
    FJLT's subsampled-Hadamard GEMM against the WHT route
    (``SKYLARK_NO_SRHT_GEMM=1``) at MM_RW_* rowwise f32 and bf16 and
    MM_CW_* columnwise bf16, and the sweep of S over MM_SWEEP_S at both
    widths with the gate's verdict at each; (b) Fastfood's hoisted W
    against the streamed apply at serving's predict block, a streaming-
    KRR panel and the forced realized apply (``SKYLARK_FRFT_GEMM=1``);
    (c) PPT's matmul DFT (``SKYLARK_PPT_DFT=1``) against its FFT in bf16
    at the predict shape; (d) ``mm_f32`` against the f32 lift at
    ``_psd_gram``'s KRR shape and a hash one-hot contract, and phase 3j's
    approximate-KRR rungs again; (e) ridge and the DCT FJLT on a
    row-sharded A on 1, 2 and 4 slots of the card, and the GEMM route's
    columnwise FJLT of a row-sharded A.  Controls run ``uncounted()``;
    every first launch of a kernel signature is held against its plain
    version.  Returns the held signatures."""
    from libskylark_tpu_torch import parallel as P
    from libskylark_tpu_torch.core import precision
    from libskylark_tpu_torch.core.precision import bf16_split3, mm_f32
    from libskylark_tpu_torch.ml.krr import _psd_gram
    from libskylark_tpu_torch.parallel import mesh as M
    from libskylark_tpu_torch.sketch import kernels_fut as kf
    from libskylark_tpu_torch.sketch import kernels_scatter as ks
    from libskylark_tpu_torch.sketch import kernels_window as kw
    from libskylark_tpu_torch.sketch import ppt as ppt_mod
    from libskylark_tpu_torch.solvers import RegressionProblem, solve_regression

    card = f"[{smi}]"
    f32, bf16 = torch.float32, torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(SEED + 37)
    held = set()
    ctx = sky.SketchContext

    def rel(a, b):
        a, b = M.fully_replicated(a).double(), M.fully_replicated(b).double()
        return float((a - b).abs().max() / b.abs().max())

    def against(label, got, ref, ctl, tol, ms=None):
        """``got`` within ``tol`` of ``ref`` (max |diff| / max |ref|) and
        the control outside it; the two routes' times where given."""
        r, c = rel(got, ref), rel(ctl, ref)
        times = f"; {ms[0]!r} ms against {ms[1]!r} ms" if ms else ""
        print(f"matmul {label}: max |diff| / max |ref| {r:.3g} (tol {tol:g}), control "
              f"{c:.3g}{times} {card}")
        check(r <= tol and c > tol, f"matmul {label}: {r} (control {c})")

    def segsum_held(out, vals, keys, segs):
        ref = ks.segment_sum_flat_plain(vals, keys, segs)
        _, r = max_err(out, ref)
        i = int(vals.abs().argmax())
        ctl = ks.segment_sum_flat_plain(torch.cat([vals[:i], vals[i + 1:]]),
                                        torch.cat([keys[:i], keys[i + 1:]]), segs)
        _, c = max_err(out, ctl)
        print(f"matmul (held) segment_sum_flat {vals.shape[0]} -> {segs} {vals.dtype}: vs its "
              f"plain version rel {r:.3g} (tol 1e-5); control (the plain version without entry "
              f"{i}) {c:.3g}")
        check(r <= 1e-5 and c > 1e-5, f"matmul segment_sum_flat {vals.shape[0]}: {r}, control {c}")

    kernels = hold_kernels("matmul", kf, kw, ("rfut_rowwise", "rfut_rowwise_sampled",
                                              "gather_scaled_rows", "scatter_rows"), held)
    kernels.append((ks, "segment_sum_flat", hold(ks, "segment_sum_flat", segsum_held, held)))
    torch.cuda.reset_peak_memory_stats(dev)
    t_phase = time.perf_counter()
    try:
        # -- (a) FJLT: the subsampled-Hadamard GEMM against the WHT route ------
        reset_counts()
        t0 = time.perf_counter()
        X = torch.randn(MM_RW_M, MM_RW_N, generator=g, device=dev)
        A_cw = torch.randn(MM_CW_N, MM_CW_M, generator=g, device=dev).T  # (M, N) column-major
        A_cw = A_cw.contiguous()
        tol = {f32: 1e-5, bf16: 1e-2}

        def fjlt_pair(label, n, s, A, dim, seed=SEED):
            """The gate's verdict, the default apply and the WHT route (knob
            on), each timed; the default held against the WHT route beside
            another seed's sketch."""
            S = sky.sketch.FJLT(n, s, ctx(seed=seed))
            wins = S._gemm_wins(A.dtype)
            t_gemm = time_ms(lambda: S.apply(A, dim), reps=5)
            out = S.apply(A, dim)
            with forced_env(SKYLARK_NO_SRHT_GEMM="1"):
                t_wht = time_ms(lambda: S.apply(A, dim), reps=5)
                ref = S.apply(A, dim)
            with uncounted():
                ctl = sky.sketch.FJLT(n, s, ctx(seed=seed + 1)).apply(A, dim)
            route = "GEMM" if wins else "WHT (the gate says no: both runs take it)"
            against(f"(a) FJLT {label} {A.dtype}: gate -> {route}; default against "
                    f"SKYLARK_NO_SRHT_GEMM=1", out, ref, ctl, tol[A.dtype], (t_gemm, t_wht))
            times[f"FJLT {label} {A.dtype}"] = {"gate": route.split()[0], "default_ms": t_gemm,
                                                 "wht_ms": t_wht}
            return S, out

        times = {}
        for dt in (f32, bf16):
            Xd = X.to(dt)
            S, _ = fjlt_pair(f"rowwise {MM_RW_M} x {MM_RW_N} -> {MM_RW_S}", MM_RW_N, MM_RW_S,
                             Xd, "rowwise")
            check(S._gemm_wins(dt), f"matmul (a): the gate does not take the GEMM at "
                  f"{MM_RW_N} -> {MM_RW_S} {dt}")
            # The hoisted G: the GEMM alone, bitwise the apply.
            ops = S.hoistable_operands(dt, dev)
            t_hoist = time_ms(lambda: S.apply_with_operands(ops, Xd, "rowwise"), reps=5)
            t_g = time_ms(lambda: S._srht_matrix(bf16, dev), reps=5)
            same = torch.equal(S.apply_with_operands(ops, Xd, "rowwise"), S.apply(Xd, "rowwise"))
            print(f"matmul (a) FJLT rowwise {dt}: hoisted G {t_hoist!r} ms (G's build "
                  f"{t_g!r} ms), bitwise the apply {same} {card}")
            check(same, f"matmul (a): hoisted FJLT {dt} is not bitwise the apply")
            times[f"FJLT rowwise {MM_RW_M} x {MM_RW_N} -> {MM_RW_S} {dt}"].update(
                hoisted_ms=t_hoist, build_g_ms=t_g)
            del Xd
        # The f32 GEMM's parts: the split, one bf16 product with an f32 result.
        Xh = bf16_split3(X)
        G16 = S._srht_matrix(bf16, dev)
        t_split = time_ms(lambda: bf16_split3(X), reps=5)
        t_one = time_ms(lambda: mm_f32(Xh[0], G16), reps=5)
        print(f"matmul (a) FJLT rowwise f32 GEMM parts: bf16_split3 of X {t_split!r} ms, one "
              f"bf16 product {MM_RW_M} x {MM_RW_N} x {MM_RW_S} with an f32 result {t_one!r} ms "
              f"(x 3) {card}")
        times[f"FJLT rowwise {MM_RW_M} x {MM_RW_N} -> {MM_RW_S} {f32}"].update(
            split_ms=t_split, one_product_ms=t_one)
        del Xh, G16, ops
        S_cw, _ = fjlt_pair(f"columnwise {MM_CW_M} x {MM_CW_N} -> {MM_CW_S}", MM_CW_M, MM_CW_S,
                            A_cw.to(bf16), "columnwise")
        check(S_cw._gemm_wins(bf16), "matmul (a): the gate does not take the columnwise GEMM")
        for dt in (f32, bf16):
            Xd, Ad = X.to(dt), A_cw.to(dt)
            for s in MM_SWEEP_S:
                fjlt_pair(f"rowwise {MM_RW_M} x {MM_RW_N} -> {s}", MM_RW_N, s, Xd, "rowwise")
                fjlt_pair(f"columnwise {MM_CW_M} x {MM_CW_N} -> {s}", MM_CW_M, s, Ad,
                          "columnwise")
        del Xd, Ad
        torch.cuda.empty_cache()
        read_counts("matmul (a)", t0, ())

        # -- (b) Fastfood: hoisted W against the streamed apply ---------------
        reset_counts()
        t0 = time.perf_counter()
        kern = sky.ml.GaussianKernel(ML_DIM, ML_SIGMA)
        F = kern.create_rft(ML_S, "fast", ctx(seed=SEED + 5))
        F_ctl = kern.create_rft(ML_S, "fast", ctx(seed=SEED + 6))
        ff_tol = {f32: 3e-3, bf16: 2e-2}

        def ff_ref(Xd):
            """The streamed apply in f32 of ``Xd``'s values: a bf16 streamed
            apply rounds its pre-cos values and its epilogue to bf16 (~5e-2
            of the features' scale), which the realized route does in f32."""
            return F.apply(Xd.float(), "rowwise")

        def ff_note(Xd, ref):
            if Xd.dtype == f32:
                return ""
            with uncounted():
                own = rel(F.apply(Xd, "rowwise"), ref)
            return f" (in f32; the streamed bf16 apply itself reads {own:.3g})"
        t_w = time_ms(lambda: F._realized_w(dev), reps=3)
        for label, rows, dt in (("serving's predict block", MM_FF_PREDICT, f32),
                                ("streaming-KRR panel", MM_FF_PANEL, bf16),
                                ("streaming-KRR panel", MM_FF_PANEL, f32)):
            Xb = torch.randn(rows, ML_DIM, generator=g, device=dev).to(dt)
            ops = F.hoistable_operands(dt, dev)
            t_h = time_ms(lambda: F.apply_with_operands(ops, Xb, "rowwise"), reps=5)
            t_s = time_ms(lambda: F.apply(Xb, "rowwise"), reps=5)
            got = F.apply_with_operands(ops, Xb, "rowwise")
            ref = ff_ref(Xb)
            with uncounted():
                ctl = F_ctl.apply(Xb, "rowwise")
            check(got.dtype == dt, f"matmul (b): hoisted Fastfood returned {got.dtype}")
            against(f"(b) Fastfood {label} {rows} x {ML_DIM} -> {ML_S} {dt}: hoisted W "
                    f"against the streamed apply{ff_note(Xb, ref)}", got, ref, ctl, ff_tol[dt],
                    (t_h, t_s))
            times[f"Fastfood {label} {rows} {dt}"] = {"hoisted_ms": t_h, "streamed_ms": t_s}
            del Xb, got, ref, ctl
        print(f"matmul (b) Fastfood W ({ML_S}, {ML_DIM}) f32 realized once per plan or chunk: "
              f"{t_w!r} ms {card}")
        for dt in (f32, bf16):
            Xd = X.to(dt)
            with forced_env(SKYLARK_FRFT_GEMM="1"):
                check(F._realize_wins(dt, MM_RW_M), "matmul (b): the forced gate says no")
                t_r = time_ms(lambda: F.apply(Xd, "rowwise"), reps=3)
                got = F.apply(Xd, "rowwise")
            t_s = time_ms(lambda: F.apply(Xd, "rowwise"), reps=3)
            ref = ff_ref(Xd)
            with uncounted():
                ctl = F_ctl.apply(Xd, "rowwise")
            against(f"(b) Fastfood forced realized apply {MM_RW_M} x {ML_DIM} -> {ML_S} {dt} "
                    f"(SKYLARK_FRFT_GEMM=1) against the streamed apply{ff_note(Xd, ref)}", got,
                    ref, ctl, ff_tol[dt], (t_r, t_s))
            times[f"Fastfood realized apply {MM_RW_M} {dt}"] = {"realized_ms": t_r,
                                                                "streamed_ms": t_s}
            del Xd, got, ref, ctl
        torch.cuda.empty_cache()
        read_counts("matmul (b)", t0, ())

        # -- (c) PPT: the matmul DFT against the FFT, bf16 --------------------
        reset_counts()
        t0 = time.perf_counter()
        pk = sky.ml.PolynomialKernel(ML_DIM, 3, 1.0, 1.0 / ML_DIM)
        Fp = pk.create_rft(MM_PPT_S, "regular", ctx(seed=SEED + 7))
        Xp = X.to(bf16)
        with forced_env(SKYLARK_PPT_DFT="1"):
            check(Fp._dft_wins(bf16, MM_RW_M), "matmul (c): the forced DFT gate says no")
            t_d = time_ms(lambda: Fp.apply(Xp, "rowwise"), reps=5)
            got = Fp.apply(Xp, "rowwise")
        t_f = time_ms(lambda: Fp.apply(Xp, "rowwise"), reps=5)
        fft16 = Fp.apply(Xp, "rowwise")
        ref32 = Fp.apply(X, "rowwise")
        with uncounted():
            ctl = pk.create_rft(MM_PPT_S, "regular", ctx(seed=SEED + 8)).apply(Xp, "rowwise")
        check(got.dtype == bf16, f"matmul (c): the DFT route returned {got.dtype}")
        against(f"(c) PPT q=3 {MM_RW_M} x {ML_DIM} -> {MM_PPT_S} bf16: SKYLARK_PPT_DFT=1 "
                "against the FFT route", got, fft16, ctl, 0.02, (t_d, t_f))
        against(f"(c) PPT q=3 bf16 DFT against the f32 FFT route", got, ref32, ctl, 0.02)
        times[f"PPT {MM_RW_M} bf16"] = {"dft_ms": t_d, "fft_ms": t_f}
        del Xp, got, fft16, ref32, ctl
        read_counts("matmul (c)", t0, ())

        # -- (d) mm_f32 against the lift ---------------------------------------
        reset_counts()
        t0 = time.perf_counter()
        Z = F.apply(X, "rowwise").to(bf16)
        out = _psd_gram(Z.T, Z)
        check(out.dtype == f32, f"matmul (d): _psd_gram of bf16 returned {out.dtype}")
        lift = Z.T.float() @ Z.float()
        ctl = torch.mm(Z.T, Z)  # bf16 x bf16 rounded to bf16: what mm_f32 must not do
        t_m = time_ms(lambda: _psd_gram(Z.T, Z), reps=5)
        t_l = time_ms(lambda: Z.T.float() @ Z.float(), reps=5)
        against(f"(d) _psd_gram Z^T Z, Z ({MM_RW_M}, {ML_S}) bf16: mm_f32 (f32 result) against "
                "the f32 lift; control the bf16-rounded torch.mm", out, lift, ctl, 1e-4,
                (t_m, t_l))
        times["_psd_gram bf16"] = {"mm_f32_ms": t_m, "lift_ms": t_l}
        # Why mm_f32 cuts a long contraction (MM_F32_CHUNK): each against the
        # f64 product, max |diff| / max |ref|.
        ref64 = Z.T.double() @ Z.double()
        one = torch.mm(Z.T, Z, out_dtype=f32) if dev.type == "cuda" else out  # no CPU kernel
        acc = {k: rel(v, ref64) for k, v in (("one call", one), ("mm_f32", out),
                                              ("lift", lift))}
        print(f"matmul (d) the Gram against its f64 product: one torch.mm(out_dtype=f32) over "
              f"K = {MM_RW_M} {acc['one call']:.3g}, mm_f32 in chunks of "
              f"{precision.MM_F32_CHUNK} {acc['mm_f32']:.3g}, the f32 lift {acc['lift']:.3g} "
              f"{card}")
        check(acc["mm_f32"] <= acc["lift"] * 2, f"matmul (d): mm_f32's Gram {acc}")
        times["_psd_gram bf16"].update(err_vs_f64=acc)
        del Z, out, lift, ctl, ref64, one
        cwt = sky.sketch.CWT(MM_RW_N, MM_RW_S, ctx(seed=SEED + 9))
        Mi = cwt._sign_matrix_bf16(1.0, dev)
        for dt in (bf16, f32):
            Xd = X.to(dt)
            out = cwt._onehot_contract(Xd, Mi, sky.sketch.ROWWISE, dt)
            if dt == bf16:
                def lift_fn():
                    return Xd.float() @ Mi.float()
            else:
                parts = bf16_split3(Xd)

                def lift_fn():
                    return sum(p.float() @ Mi.float() for p in parts)
            lift = lift_fn()
            ctl = (torch.mm(Xd, Mi) if dt == bf16 else
                   sum(torch.mm(p, Mi) for p in bf16_split3(Xd)))
            t_m = time_ms(lambda: cwt._onehot_contract(Xd, Mi, sky.sketch.ROWWISE, dt), reps=5)
            t_l = time_ms(lift_fn, reps=5)
            check(out.dtype == f32, f"matmul (d): the one-hot contract returned {out.dtype}")
            against(f"(d) CWT one-hot contract X ({MM_RW_M}, {MM_RW_N}) {dt} -> {MM_RW_S}: "
                    "mm_f32 against the f32 lift; control the bf16-rounded torch.mm", out, lift,
                    ctl, 1e-5, (t_m, t_l))
            times[f"one-hot contract {dt}"] = {"mm_f32_ms": t_m, "lift_ms": t_l}
            del Xd, out, lift, ctl
        if KRR_RUNG_SECS:
            print(f"matmul (d) approximate KRR rungs (phase 3j (f), in turns): f32 "
                  f"{KRR_RUNG_SECS['f32']!r} s, bf16 {KRR_RUNG_SECS['bf16']!r} s {card}")
        read_counts("matmul (d)", t0, ())

        # -- (e) ridge and the FJLT on a row-sharded A ------------------------
        reset_counts()
        t0 = time.perf_counter()
        meshes = {p: P.make_mesh((p,), (P.ROWS,), devices=[dev] * p) for p in SH_SLOTS}
        m, n = NLA_M, NLA_N
        A = torch.randn(m, n, generator=g, device=dev)
        b = A @ torch.randn(n, generator=g, device=dev) + SH_NOISE * torch.randn(
            m, generator=g, device=dev)

        def ridge(A_, solver, lam, seed=SEED):
            out = solve_regression(RegressionProblem(A_, regularization="ridge", lam=lam), b,
                                   solver, ctx(seed=seed))
            return out[0] if isinstance(out, tuple) else out

        for solver in ("exact", "sketched"):
            with uncounted():
                ref = ridge(A, solver, MM_RIDGE_LAM)
                ctl = ridge(A, solver, 2 * MM_RIDGE_LAM)
            for p, mesh in meshes.items():
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                got = ridge(P.shard_rows(A, mesh), solver, MM_RIDGE_LAM)
                torch.cuda.synchronize()
                secs = time.perf_counter() - t1
                label = (f"(e) ridge {solver} lam {MM_RIDGE_LAM:g}, A {m} x {n} f32 on {p} "
                         f"slot(s), {secs:.4f} s")
                if p == 1:
                    same = torch.equal(got, ref)
                    print(f"matmul {label}: bitwise the unsharded call {same} {card}")
                    check(same, f"matmul (e) ridge {solver}: one slot is not the unsharded call")
                else:
                    against(f"{label} (control: lam x 2)", got, ref, ctl, SH_TOL[solver])
        S_d = sky.sketch.FJLT(m, SK_S, ctx(seed=SEED + 10), fut="dct")
        with uncounted():
            ref = S_d.apply(A)
            ctl = sky.sketch.FJLT(m, SK_S, ctx(seed=SEED + 11), fut="dct").apply(A)
        for p, mesh in meshes.items():
            got = S_d.apply(P.shard_rows(A, mesh))
            t_p = time_ms(lambda: S_d.apply(P.shard_rows(A, mesh)), reps=3)
            if p == 1:
                same = torch.equal(got, ref)
                print(f"matmul (e) DCT FJLT {m} x {n} -> {SK_S} f32, 1 slot ({t_p!r} ms): "
                      f"bitwise the unsharded call {same} {card}")
                check(same, "matmul (e) DCT FJLT: one slot is not the unsharded call")
            else:
                against(f"(e) DCT FJLT {m} x {n} -> {SK_S} f32 on {p} slots ({t_p!r} ms)",
                        got, ref, ctl, DCT_TOL)
        del A, b, ref, ctl, got
        for dt in (bf16, f32):
            S_g = sky.sketch.FJLT(MM_CW_M, MM_CW_S, ctx(seed=SEED + 12))
            Ad = A_cw.to(dt)
            with uncounted():
                ref = S_g.apply(Ad)
                ctl = sky.sketch.FJLT(MM_CW_M, MM_CW_S, ctx(seed=SEED + 13)).apply(Ad)
            route = "GEMM" if S_g._gemm_wins(dt) else "Kronecker split"
            for p, mesh in meshes.items():
                got = S_g.apply(P.shard_rows(Ad, mesh))
                if p == 1:
                    same = torch.equal(got, ref)
                    print(f"matmul (e) FJLT {MM_CW_M} x {MM_CW_N} -> {MM_CW_S} {dt} ({route}), "
                          f"1 slot: bitwise the unsharded call {same} {card}")
                    check(same, "matmul (e) FJLT: one slot is not the unsharded call")
                else:
                    against(f"(e) FJLT {MM_CW_M} x {MM_CW_N} -> {MM_CW_S} {dt} on {p} slots "
                            f"({route})", got, ref, ctl, tol[dt])
        del X, A_cw
        torch.cuda.empty_cache()
        read_counts("matmul (e)", t0, ())
    finally:
        for mod, name_, kernel in kernels:
            setattr(mod, name_, kernel)

    print(f"matmul times (CUDA events, median): {json.dumps(times)} {card}")
    print(f"matmul: phase 3r items {time.perf_counter() - t_phase:.1f} s, peak memory allocated "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB {card}")
    return held


T_START = time.perf_counter()


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

    from libskylark_tpu_torch import native

    def reset_counts():
        for w in wrappers.values():
            w.launches = 0
        wrappers["rfut_rowwise"].launches_by_nb = {}
        native.parse_libsvm_bytes.calls = native.parse_libsvm_bytes.bytes = 0
        native.parse_libsvm_bytes.seconds = 0.0

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

    @contextmanager
    def uncounted():
        """Launches inside are no path's: a single-process reference's,
        or a control's, beside the path that is counted."""
        saved = {name: w.launches for name, w in wrappers.items()}
        by_nb = dict(wrappers["rfut_rowwise"].launches_by_nb)
        try:
            yield
        finally:
            for name, w in wrappers.items():
                w.launches = saved[name]
            wrappers["rfut_rowwise"].launches_by_nb = by_nb

    def add_counts(path, counts):
        """A path's launches counted in other processes (the elastic
        ranks), each process's counters starting at 0."""
        for name, count in counts.items():
            launches[name] += count
        path_launches[path] = dict(counts)
        rfut_by_nb[path] = {}
        print(f"{path} path: launches {counts}")

    def memory(phase):
        """The card's memory after a phase, with the plans of every phase
        so far kept (as one process keeps them): the plan cache's bytes
        stay under its bound."""
        st = sky.plans.stats()
        print(f"memory after {phase}: reserved {torch.cuda.memory_reserved(dev) / 2**30:.2f} "
              f"GiB, allocated {torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB; plans "
              f"{st['size']} holding {st['bytes']} bytes (bound {st['max_bytes']}), bypasses "
              f"{st['bypasses']} [{smi}]")
        check(st["bytes"] <= st["max_bytes"], f"after {phase}: the plans hold {st}")

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
    # The rowwise FJLT at 131072 x 4096 takes the subsampled-Hadamard GEMM
    # (its gate holds there), so this path launches no rfut_rowwise.
    read_counts("least-squares", t_main,
                ("rfut_rowwise_sampled", "gather_scaled_rows", "scatter_rows"))

    memory("3a")

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

    memory("3d")

    # -- 3e. randomized NLA, f32 at full width (A_sp: phase 3b's COO) ------
    nla_path(sky, dev, reset_counts, read_counts, A_sp)
    del A_sp

    memory("3e")

    # -- 3f. the kernel machine's training path, at full width ------------
    train_path(sky, dev, reset_counts, read_counts, smi)

    memory("3f")

    # -- 3g. out-of-core streaming, at full width -------------------------
    chunk = stream_path(sky, dev, reset_counts, read_counts, smi, graph)

    memory("3g")

    # -- 3h. the remaining sketches and the graph analytics ----------------
    sketches_path(sky, dev, reset_counts, read_counts, smi, graph)
    del graph

    memory("3h")

    # -- 3i. mixed-precision refinement and the routes around it ----------
    refine_held = refine_path(sky, dev, reset_counts, read_counts, smi)

    memory("3i")

    # -- 3j. the learned policy: the store, its routes and precision rungs
    torch.cuda.reset_peak_memory_stats(dev)
    policy_held = policy_path(sky, dev, reset_counts, read_counts, smi)
    print(f"policy: phase 3j peak memory allocated "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB, plan stats "
          f"{sky.plans.stats()} [{smi}]")
    memory("3j")

    # -- 3k. the plans layer: captured applies and stream steps, warm start
    plans_held = plans_path(sky, dev, reset_counts, read_counts, smi)

    memory("3k")

    # -- 3l. the command-line drivers, on files read from disk -------------
    torch.cuda.empty_cache()
    cli_held, cli_files = cli_path(sky, dev, reset_counts, read_counts, smi)

    memory("3l")

    # -- 3m. the telemetry layer and the randomized Gauss-Seidel solvers ----
    torch.cuda.empty_cache()
    t_3m = time.perf_counter()
    telemetry_held = telemetry_path(sky, dev, reset_counts, read_counts, smi, cli_files)
    print(f"telemetry: phase 3m {time.perf_counter() - t_3m:.1f} s [{smi}]")

    memory("3m")

    # -- 3n. the serving layer: the server at full width -------------------
    torch.cuda.empty_cache()
    t_3n = time.perf_counter()
    serve_held = serve_path(sky, dev, reset_counts, read_counts, smi)
    print(f"serve: phase 3n {time.perf_counter() - t_3n:.1f} s [{smi}]")

    memory("3n")

    # -- 3o. the elastic multi-process path: worlds of 1 (NCCL) and 2 (gloo)
    torch.cuda.empty_cache()
    t_3o = time.perf_counter()
    elastic_held = elastic_path(sky, dev, reset_counts, read_counts, add_counts, uncounted,
                                smi, (lo, hi, SA_ref, S_g))
    print(f"elastic: phase 3o {time.perf_counter() - t_3o:.1f} s [{smi}]")

    memory("3o")

    # -- 3p. the explicit sharded schedules on virtual meshes of the one card
    torch.cuda.empty_cache()
    t_3p = time.perf_counter()
    mesh_held = mesh_path(sky, dev, reset_counts, read_counts, uncounted, smi, (lo, hi))
    print(f"mesh: phase 3p {time.perf_counter() - t_3p:.1f} s [{smi}]")

    memory("3p")

    # -- 3q. the sharded-input routes on virtual meshes of the one card
    torch.cuda.empty_cache()
    t_3q = time.perf_counter()
    shard_held = shard_path(sky, dev, reset_counts, read_counts, uncounted, smi, cli_files)
    print(f"shard: phase 3q {time.perf_counter() - t_3q:.1f} s [{smi}]")

    memory("3q")

    # -- 3r. the matmul routes outside the kernels, and the sharded gaps ----
    torch.cuda.empty_cache()
    t_3r = time.perf_counter()
    matmul_held = matmul_path(sky, dev, reset_counts, read_counts, uncounted, smi)
    print(f"matmul: phase 3r {time.perf_counter() - t_3r:.1f} s [{smi}]")

    memory("3r")

    # -- 4. times at main-path shapes ------------------------------------
    kernels = []

    def row(name, source, replaces, ms, plain_ms, bytes_moved, ops, library_ms,
            path_count=None, err=None, shape=None, split=None):
        b_ms, by = bound(bytes_moved, ops)
        by_path = {p: c[name] for p, c in path_launches.items() if c[name]}
        # Phases 3i's, 3j's, 3l's, 3m's, 3n's, 3o's, 3p's, 3q's and 3r's
        # items, and their sums under "refine", "policy", "cli", "telemetry",
        # "serve", "elastic", "mesh", "shard" and "matmul", on every row.
        for phase in ("refine", "policy", "cli", "telemetry", "serve", "elastic", "mesh",
                      "shard", "matmul"):
            by_path[phase] = sum(c[name] for p, c in path_launches.items()
                                 if p.startswith(f"{phase} ("))
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name] if path_count is None else path_count,
            "launches_by_path": by_path,
            # The signatures phase 3i held against the plain version.
            "refine_held": sorted(str(sig[1:]).replace("torch.", "")
                                  for sig in refine_held if sig[0] == name),
            # ... and those phase 3j held.
            "policy_held": sorted(str(sig[1:]).replace("torch.", "")
                                  for sig in policy_held if sig[0] == name),
            # ... and those phase 3k held (each in an eager run or a plan's
            # warm-up, outside its capture).
            "plans_held": sorted(str(sig[1:]).replace("torch.", "")
                                 for sig in plans_held if sig[0] == name),
            # ... and those phase 3l held.
            "cli_held": sorted(str(sig[1:]).replace("torch.", "")
                               for sig in cli_held if sig[0] == name),
            # ... and those phase 3m held.
            "telemetry_held": sorted(str(sig[1:]).replace("torch.", "")
                                     for sig in telemetry_held if sig[0] == name),
            # ... and those phase 3n held.
            "serve_held": sorted(str(sig[1:]).replace("torch.", "")
                                 for sig in serve_held if sig[0] == name),
            # ... and those phase 3o held, in this process and in its ranks.
            "elastic_held": sorted(text for kernel, text in elastic_held if kernel == name),
            # ... and those phase 3p held.
            "mesh_held": sorted(str(sig[1:]).replace("torch.", "")
                                for sig in mesh_held if sig[0] == name),
            # ... and those phase 3q held.
            "shard_held": sorted(str(sig[1:]).replace("torch.", "")
                                 for sig in shard_held if sig[0] == name),
            # ... and those phase 3r held.
            "matmul_held": sorted(str(sig[1:]).replace("torch.", "")
                                  for sig in matmul_held if sig[0] == name),
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
    # bf16 rfut_rowwise at NB = 2^15, where phase 3j's learned S = 1728
    # (not a multiple of 128) takes it on the 32768 x 768 problem's A^T.
    xb = randn(PL_B_N, PL_B_M, dtype=torch.bfloat16)
    db = torch.from_numpy(rng.choice([-1.0, 1.0], PL_B_M).astype(np.float32)).to(
        dev, torch.bfloat16)
    err_b, _ = max_err(kf.rfut_rowwise(xb, db, PL_B_M), kf.rfut_rowwise_plain(xb, db, PL_B_M))
    row("rfut_rowwise", "libskylark_tpu_torch/csrc/rfut.cu",
        "libskylark_tpu/sketch/pallas_fut.py:192",
        time_ms(lambda: kf.rfut_rowwise(xb, db, PL_B_M)),
        time_ms(lambda: kf.rfut_rowwise_plain(xb, db, PL_B_M), reps=3, warmup=1),
        2 * (2 * PL_B_N * PL_B_M + PL_B_M), PL_B_N * PL_B_M * (math.log2(PL_B_M) + 1), None,
        path_count=sum(at_nb(PL_B_M).values()), err=err_b,
        shape=f"x {PL_B_N} x {PL_B_M} bf16, NB = 2^15 (the policy path's S = 1728)",
        split={"launches_at_nb": at_nb(PL_B_M)})
    del xb, db
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

    print(f"chip_smoke: whole script {time.perf_counter() - T_START:.1f} s [{smi}]")
    print(json.dumps({"kernels": kernels}))
    print(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if len(sys.argv) > 2 and sys.argv[1] == "--elastic-rank":
        sys.exit(elastic_rank_main(sys.argv[2:]))
    else:
        main()
