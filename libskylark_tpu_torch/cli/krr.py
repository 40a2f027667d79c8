"""skylark-krr: KRR/RLSC driver (port of ``libskylark_tpu/cli/krr.py``;
≙ ``ml/skylark_krr.cpp:20-34,54-160``).

Algorithm choices mirror the reference's -a flag:
  0 exact kernel ridge, 1 faster (precond CG), 2 approximate (feature map),
  3 sketched approximate, 4 large-scale (block coordinate descent).
The model file is the JAX package's format, so either package predicts
from it.
"""

from __future__ import annotations

import argparse
import sys
import time

from .common import (
    FILE_FORMATS,
    add_device_args,
    add_perf_args,
    add_policy_args,
    add_telemetry_args,
    print_perf_report,
    print_policy_report,
    print_telemetry_report,
    run_scope,
    setup_perf,
    setup_policy,
    setup_telemetry,
)

_ALGS = {0: "exact", 1: "faster", 2: "approximate", 3: "sketched", 4: "largescale"}


def _kernel_params(args) -> dict:
    """--kernel flag → ctor kwargs (≙ the reference's per-kernel flags)."""
    return {
        "linear": {},
        "gaussian": {"sigma": args.sigma},
        "polynomial": {"q": args.q, "c": args.c, "gamma": args.gamma},
        "laplacian": {"sigma": args.sigma},
        "expsemigroup": {"beta": args.beta},
        "matern": {"nu": args.nu, "l": args.l},
    }[args.kernel]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="skylark-krr")
    p.add_argument("--trainfile", required=True)
    p.add_argument("--testfile", default=None)
    p.add_argument("--modelfile", default="model.json")
    p.add_argument("--algorithm", "-a", type=int, default=1, choices=_ALGS)
    p.add_argument("--kernel", "-k", default="gaussian",
                   choices=["linear", "gaussian", "polynomial", "laplacian",
                            "expsemigroup", "matern"])
    p.add_argument("--lambda", dest="lam", type=float, default=0.01)
    p.add_argument("--sigma", "-x", type=float, default=1.0)
    p.add_argument("--q", type=int, default=2)
    p.add_argument("--c", type=float, default=1.0)
    p.add_argument("--gamma", type=float, default=1.0)
    p.add_argument("--beta", type=float, default=1.0)
    p.add_argument("--nu", type=float, default=1.5)
    p.add_argument("--l", type=float, default=1.0)
    p.add_argument("--numfeatures", "-f", type=int, default=1024)
    p.add_argument("--seed", type=int, default=38734)
    p.add_argument("--regression", action="store_true")
    p.add_argument("--use-fast", action="store_true")
    p.add_argument("--tolerance", type=float, default=1e-3)
    p.add_argument("--max-split", type=int, default=0)
    p.add_argument("--sparse", action="store_true")
    p.add_argument("--fileformat", default="libsvm", choices=FILE_FORMATS,
                   help="train/test container (hdf5 via "
                        "skylark-convert2hdf5 or the reference layout)")
    p.add_argument("--x64", action="store_true")
    p.add_argument("--checkpoint-dir", default=None,
                   help="directory for solver checkpoints; enables "
                        "preemption-safe chunked execution of the "
                        "iterative (-a 1) path")
    p.add_argument("--checkpoint-every", type=int, default=25,
                   help="solver iterations per checkpoint round")
    p.add_argument("--resume", action="store_true",
                   help="resume from the newest valid checkpoint in "
                        "--checkpoint-dir")
    p.add_argument("--stream", action="store_true",
                   help="out-of-core training: stream the train file in "
                        "--batch-rows row blocks, accumulating the "
                        "random-feature Gram per batch (approximate "
                        "KRR only; X is never resident)")
    p.add_argument("--batch-rows", type=int, default=4096,
                   help="rows per streamed batch (with --stream)")
    add_device_args(p)
    add_perf_args(p)
    add_policy_args(p)
    add_telemetry_args(p)
    args = p.parse_args(argv)

    setup_perf(args)
    with run_scope(args):
        setup_telemetry(args)
        setup_policy(args)
        is_sparse = args.sparse or args.fileformat == "hdf5_sparse"
        if args.stream:
            return _stream_main(args, is_sparse)
        return _train_main(args)


def _train_main(args) -> int:
    from ..core.context import SketchContext
    from ..ml import KrrParams, kernel_by_name
    from ..ml import krr as krr_mod
    from ..ml import rlsc as rlsc_mod
    from .common import load_dataset, print_test_metrics, sync, to_device

    X, y = load_dataset(args.trainfile, args.fileformat, args.sparse)
    n, d = X.shape
    kernel = kernel_by_name(args.kernel, d, **_kernel_params(args))
    ctx = SketchContext(seed=args.seed)
    params = KrrParams(
        am_i_printing=True,
        log_level=1,
        use_fast=args.use_fast,
        tolerance=args.tolerance,
        max_split=args.max_split,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every,
        resume=args.resume,
    )
    if args.checkpoint_dir and args.algorithm != 1:
        print("warning: --checkpoint-dir applies to the iterative "
              "solver (-a 1); other algorithms run unchunked",
              file=sys.stderr)

    Xj = to_device(X, args)
    t0 = time.perf_counter()
    alg = _ALGS[args.algorithm]
    yj = to_device(y, args) if args.regression else y
    if alg == "exact":
        fn = krr_mod.kernel_ridge if args.regression else rlsc_mod.kernel_rlsc
        model = fn(kernel, Xj, yj, args.lam, params)
    elif alg == "faster":
        fn = (krr_mod.faster_kernel_ridge if args.regression
              else rlsc_mod.faster_kernel_rlsc)
        model = fn(kernel, Xj, yj, args.lam, args.numfeatures, ctx, params)
    elif alg == "approximate":
        fn = (krr_mod.approximate_kernel_ridge if args.regression
              else rlsc_mod.approximate_kernel_rlsc)
        model = fn(kernel, Xj, yj, args.lam, args.numfeatures, ctx, params)
    elif alg == "sketched":
        fn = (krr_mod.sketched_approximate_kernel_ridge if args.regression
              else rlsc_mod.sketched_approximate_kernel_rlsc)
        model = fn(kernel, Xj, yj, args.lam, args.numfeatures, ctx, params)
    else:  # largescale (regression path; classification via coded targets)
        if args.regression:
            model = krr_mod.large_scale_kernel_ridge(
                kernel, Xj, yj, args.lam, args.numfeatures, ctx, params
            )
        else:
            from ..ml.coding import dummy_coding

            T, classes = dummy_coding(y, dtype=Xj.dtype)
            model = krr_mod.large_scale_kernel_ridge(
                kernel, Xj, T, args.lam, args.numfeatures, ctx, params
            )
            model.classes = list(classes.tolist())
    sync()
    dt = time.perf_counter() - t0
    print(f"Training ({alg}) took {dt:.3f} sec")

    # Label coding rides the model JSON (≙ get_column_coding).
    model.save(args.modelfile)
    print(f"Model saved to {args.modelfile}")

    if args.testfile:
        Xt, yt = load_dataset(
            args.testfile, args.fileformat, args.sparse, n_features=d
        )
        print_test_metrics(model, to_device(Xt, args), yt, args.regression)
    print_perf_report(args)
    print_policy_report(args)
    print_telemetry_report(args)
    return 0


def _stream_main(args, is_sparse: bool) -> int:
    """Out-of-core training: one streamed pass of random-feature Gram
    accumulation (``streaming.kernel_ridge``) — the approximate (-a 2)
    path with X never resident.  Classification needs the label coding
    (and so the class set) before the pass; regression only for now."""
    if _ALGS[args.algorithm] != "approximate":
        print("error: --stream supports the approximate feature-map "
              "path only; use -a 2", file=sys.stderr)
        return 2
    if not args.regression:
        print("error: --stream needs --regression (label coding would "
              "need the class set before the pass)", file=sys.stderr)
        return 2

    from ..core.context import SketchContext
    from ..ml import KrrParams, kernel_by_name
    from ..ml import krr as krr_mod
    from ..streaming import StreamParams, skip_batches
    from .common import (in_run_dtype, load_dataset, print_test_metrics, scan_dims,
                         stream_dataset, to_device)

    n, d = scan_dims(args.trainfile, args.fileformat)
    print(f"Streaming {n}x{d} in batches of {args.batch_rows} rows")
    kernel = kernel_by_name(args.kernel, d, **_kernel_params(args))
    kparams = KrrParams(am_i_printing=True, log_level=1)
    def batches(start: int):
        it = stream_dataset(
            args.trainfile, args.fileformat, d, args.batch_rows, is_sparse,
        )
        it = in_run_dtype(it, args)
        return skip_batches(it, start) if start else it

    sp = StreamParams(
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every,
        resume=args.resume,
    )
    t0 = time.perf_counter()
    model = krr_mod.streaming_approximate_kernel_ridge(
        kernel, batches, args.lam, args.numfeatures,
        SketchContext(seed=args.seed), kparams, stream_params=sp,
    )
    dt = time.perf_counter() - t0
    print(f"Training (streamed approximate, "
          f"{model.info['batches']} batches) took {dt:.3f} sec")
    model.save(args.modelfile)
    print(f"Model saved to {args.modelfile}")
    if args.testfile:
        Xt, yt = load_dataset(
            args.testfile, args.fileformat, args.sparse, n_features=d
        )
        print_test_metrics(model, to_device(Xt, args), yt, args.regression)
    print_perf_report(args)
    print_policy_report(args)
    print_telemetry_report(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
