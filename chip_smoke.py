"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``libskylark_tpu_torch/csrc``, holds
each kernel against its plain PyTorch version at the main path's
shapes, drives the main path (sketch-and-solve least squares at
2^20 x 512 with FJLT and CWT, at 32768 x 1024 with FJLT, and the FJLT
rowwise apply at 131072 x 4096) with every launch counter reset just
before it and read just after, times each kernel beside its bound, its
plain version and a one-call PyTorch equivalent, and ends with one JSON
line.  It exits non-zero, printing no result, without a CUDA device or
without the package beside it.  It imports nothing of JAX.
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
    from libskylark_tpu_torch.sketch import kernels_fut as kf
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

    worst = 0.0
    for nnz, cols in ((1, 512), (4, 512), (1, 1)):  # (1, 1): the LS solve's b vector
        A = T[:, :cols].contiguous()
        b = torch.from_numpy(rng.integers(0, 2048, (nnz, 1 << 20)).astype(np.int32)).to(dev)
        v = randn(nnz, 1 << 20)
        out = kw.scatter_rows(A, b, v, 2048)
        a, r = max_err(out, kw.scatter_rows_plain(A, b, v, 2048))
        worst = max(worst, a)
        print(f"scatter_rows A (2^20, {cols}) -> 2048, nnz={nnz}, "
              f"{kw.scatter_splits(nnz << 20, 2048, cols)} splits: max abs err {a:.3g}, "
              f"rel {r:.3g} (tol 1e-5)")
        check(r <= 1e-5, f"scatter_rows nnz={nnz} disagrees with its plain version")
        again = kw.scatter_rows(A, b, v, 2048)
        check(torch.equal(out, again), f"scatter_rows nnz={nnz} differs run to run")
        acc = randn(2048, cols)
        check(torch.equal(kw.scatter_rows(A, b, v, 2048, acc=acc), acc + out),
              f"scatter_rows nnz={nnz} acc fold is not bitwise acc + scatter_rows")
    print("scatter_rows: bitwise run to run, acc fold bitwise acc + out")
    errs["scatter_rows"] = worst
    del T, A, b, v, out, again, acc
    torch.cuda.synchronize()

    # -- 3. main path ----------------------------------------------------
    wrappers = {
        "rfut_rowwise": kf.rfut_rowwise,
        "rfut_rowwise_sampled": kf.rfut_rowwise_sampled,
        "gather_scaled_rows": kw.gather_scaled_rows,
        "scatter_rows": kw.scatter_rows,
    }
    for w in wrappers.values():
        w.launches = 0
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
    launches = {name: w.launches for name, w in wrappers.items()}
    print(f"main path: {time.perf_counter() - t_main:.1f} s, launches {launches}")
    for name, count in launches.items():
        check(count > 0, f"kernel {name} was not launched on the main path")

    # -- 4. times at main-path shapes ------------------------------------
    kernels = []

    def row(name, source, replaces, ms, plain_ms, bytes_moved, ops, library_ms):
        b_ms, by = bound(bytes_moved, ops)
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": errs[name], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by,
            "library_ms": library_ms,
        })
        print(f"time {name}: {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms "
              f"({by}), library {library_ms}")

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
    b = torch.from_numpy(rng.integers(0, 2048, (1, 1 << 20)).astype(np.int32)).to(dev)
    v = torch.from_numpy(rng.choice([-1.0, 1.0], (1, 1 << 20)).astype(np.float32)).to(dev)
    vA = v[0][:, None] * T
    b_flat = b[0].long()
    lib_out = torch.zeros(2048, 512, device=dev)
    row("scatter_rows", "libskylark_tpu_torch/csrc/window.cu",
        "libskylark_tpu/sketch/pallas_window.py:228",
        time_ms(lambda: kw.scatter_rows(T, b, v, 2048)),
        time_ms(lambda: kw.scatter_rows_plain(T, b, v, 2048), reps=3, warmup=1),
        4 * ((1 << 20) * 512 + 2 * (1 << 20) + 2048 * 512), 2 * (1 << 20) * 512,
        time_ms(lambda: lib_out.index_add_(0, b_flat, vA)))

    print(json.dumps({"kernels": kernels}))
    print(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
