"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``libskylark_tpu_torch/csrc``, holds
each kernel against its plain PyTorch version at the main paths'
shapes, drives the main paths with every launch counter reset just
before each and read just after it, times each kernel beside its bound,
its plain version and a one-call PyTorch equivalent, and ends with one
JSON line.  The paths:

- sketch-and-solve least squares at 2^20 x 512 with FJLT and CWT, at
  32768 x 1024 with FJLT, and the FJLT rowwise apply at 131072 x 4096;
- the sparse hash sketch at the JAX package's own benchmark shape: CWT
  and SJLT of a 10^6 x 10^5 sparse COO matrix with 10^7 nonzeros to
  1024 rows, dense and sparse output;
- the in-core adjacency sketch and Nyström eigensolve of a planted-
  partition graph at the scale of SNAP com-LiveJournal (3,997,962
  vertices, 34,681,189 edges), generated from the seed.

It exits non-zero, printing no result, without a CUDA device or without
the package beside it.  It imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
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
LS_REPEATS = 3                 # timed solves per LS configuration (median kept)
SEED = 20261016
# Sparse hash sketch (the JAX package's bench.py bench_sparse_cwt shape).
SP_ROWS, SP_COLS, SP_NNZ, SP_S = 1_000_000, 100_000, 10_000_000, 1024
# Planted-partition graph at the scale of SNAP com-LiveJournal.
LJ_VERTICES, LJ_EDGES, LJ_BLOCKS, LJ_INTRA = 3_997_962, 34_681_189, 16, 0.8
ASE_K = 16                     # embedding rank; sketch size 2k as streaming_ase sizes it


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


def bound(bytes_moved: float, ops: float) -> tuple[float, str]:
    t_bytes = bytes_moved / MEM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(out: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    """(max absolute error, that error over max |ref|)."""
    out, ref = out.float(), ref.float()
    abs_err = float((out - ref).abs().max())
    return abs_err, abs_err / max(float(ref.abs().max()), 1e-30)


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
    for log2nb in range(9, 16):
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
    print(f"rfut NB 2^9..2^15, n = NB - 3, f32 and bf16: f32 worst rel {sweep:.3g} (tol 1e-5)")

    T = randn(1 << 20, 512)
    gidx = torch.from_numpy(rng.integers(0, 1 << 20, 2048).astype(np.int32)).to(dev)
    a, _ = max_err(kw.gather_scaled_rows(T, gidx, 0.3125),
                   kw.gather_scaled_rows_plain(T, gidx, 0.3125))
    print(f"gather_scaled_rows T (2^20, 512) S=2048: max abs err {a!r} (must be 0.0)")
    check(a == 0.0, "gather_scaled_rows is not bitwise equal to its plain version")
    errs["gather_scaled_rows"] = a

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
            check(torch.equal(kw.scatter_rows(A, b_bad, v, 2048),
                              kw.scatter_rows(A[keep].contiguous(), b_bad[:, keep],
                                              v[:, keep], 2048)),
                  f"scatter_rows m={cols} does not drop buckets out of range")
            check(rows_partition_bitwise(b_bad, 2048), "scatter_partition with buckets out "
                  "of range is not bitwise scatter_partition_plain")
            # A hot bucket with half the entries: cut into pieces of kw._L,
            # held against the f64 sum.
            b_hot = b.clone()
            b_hot[0, torch.from_numpy(rng.choice(k_, k_ // 2, replace=False)).to(dev)] = 7
            hot = kw.scatter_rows(A, b_hot, v, 2048)
            ref = torch.zeros(2048, cols, dtype=torch.float64, device=dev).index_add_(
                0, b_hot[0].long(), v[0].double()[:, None] * A.double())
            _, r_hot = max_err(hot, ref)
            _, r_plain = max_err(kw.scatter_rows_plain(A, b_hot, v, 2048), ref)
            print(f"scatter_rows A ({k_}, {cols}), {k_ // 2} entries in one bucket: vs f64 "
                  f"sum rel {r_hot:.3g} (tol 1e-5; plain version {r_plain:.3g}); 1 % of "
                  "buckets out of range: bitwise the kept entries' result")
            check(r_hot <= 1e-5, f"scatter_rows hot bucket m={cols}: rel {r_hot} vs f64 sum")
            check(torch.equal(hot, kw.scatter_rows(A, b_hot, v, 2048)),
                  f"scatter_rows hot bucket m={cols} differs run to run")
            check(torch.equal(kw.scatter_rows(A, b_hot, v, 2048, acc=acc), acc + hot),
                  f"scatter_rows hot bucket m={cols} acc fold is not bitwise")
            del b_bad, keep, b_hot, hot, ref
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
    check(torch.equal(ks.segment_sum_flat(vals, keys, tt),
                      ks.segment_sum_flat(vals[keep], keys[keep], tt)),
          "segment_sum_flat does not drop keys out of range")
    print(f"segment_sum_flat/partition with {bad.size} keys out of range: partition bitwise "
          "partition_plain, sum bitwise the sum of the kept entries")
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

    def reset_counts():
        for w in wrappers.values():
            w.launches = 0

    def read_counts(path, t0, expect):
        counts = {name: w.launches for name, w in wrappers.items()}
        print(f"{path} path: {time.perf_counter() - t0:.1f} s, launches {counts}")
        for name in expect:
            check(counts[name] > 0, f"kernel {name} was not launched on the {path} path")
        for name, count in counts.items():
            launches[name] += count
        path_launches[path] = counts

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
    del A_cpu, A_sp, sp_out, dense_out, rows_sp, cols_sp, sketches, S

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
    del lo, hi, g_idx
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
    del A_cpu, A_g, SA, SA_ref, V, X, rows_g, cols_g
    torch.cuda.synchronize()

    # -- 4. times at main-path shapes ------------------------------------
    kernels = []

    def row(name, source, replaces, ms, plain_ms, bytes_moved, ops, library_ms,
            path_count=None, err=None, shape=None, split=None):
        b_ms, by = bound(bytes_moved, ops)
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name] if path_count is None else path_count,
            "max_abs_err": errs[name] if err is None else err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by,
            "library_ms": library_ms, **({"shape": shape} if shape else {}), **(split or {}),
        })
        print(f"time {name}{f' {shape}' if shape else ''}: {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {b_ms:.4f} ms ({by}), library {library_ms}")

    rm, rn = 131072, 4096
    d = torch.from_numpy(rng.choice([-1.0, 1.0], rn).astype(np.float32)).to(dev)
    wht_ops = rm * (rn * math.log2(rn) + rn)
    row("rfut_rowwise", "libskylark_tpu_torch/csrc/rfut.cu",
        "libskylark_tpu/sketch/pallas_fut.py:192",
        time_ms(lambda: kf.rfut_rowwise(A, d, rn)),
        time_ms(lambda: kf.rfut_rowwise_plain(A, d, rn), reps=3, warmup=1),
        4 * (rm * rn + rn + rm * rn), wht_ops, None)
    sidx = torch.from_numpy(rng.integers(0, rn, 1024).astype(np.int32)).to(dev)
    row("rfut_rowwise_sampled", "libskylark_tpu_torch/csrc/rfut.cu",
        "libskylark_tpu/sketch/pallas_fut.py:150",
        time_ms(lambda: kf.rfut_rowwise_sampled(A, d, rn, sidx)),
        time_ms(lambda: kf.rfut_rowwise_sampled_plain(A, d, rn, sidx), reps=3, warmup=1),
        4 * (rm * rn + rn + rm * 1024) + 4 * 1024, wht_ops, None)
    del A
    T = randn(1 << 20, 512)
    uniq = int(torch.unique(gidx).numel())
    scale = torch.tensor(0.3125, device=dev)
    row("gather_scaled_rows", "libskylark_tpu_torch/csrc/window.cu",
        "libskylark_tpu/sketch/pallas_window.py:364",
        time_ms(lambda: kw.gather_scaled_rows(T, gidx, 0.3125)),
        time_ms(lambda: kw.gather_scaled_rows_plain(T, gidx, 0.3125)),
        4 * (uniq * 512 + 2048 * 512) + 4 * 2048, 2048 * 512,
        time_ms(lambda: torch.index_select(T, 0, gidx) * scale))
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
