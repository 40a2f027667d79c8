"""skylark-ml: BlockADMM kernel-machine train/predict driver (port of
``libskylark_tpu/cli/ml.py``).

≙ ``ml/skylark_ml.cpp:15-174`` + ``hilbert_options_t``
(``ml/options.hpp:53-381``) + the GetSolver kernel×options → feature-map
factory (``ml/hilbert.hpp:11-219``).  The model file is the JAX package's
format, so either package predicts from it.  ``--distributed`` trains
one rank of the elastic BlockADMM trainer over a ``torch.distributed``
world (``ml.distributed``, ``cli.common.distributed_scope``).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from .common import (
    FILE_FORMATS,
    add_device_args,
    add_distributed_args,
    add_perf_args,
    add_policy_args,
    add_telemetry_args,
    print_perf_report,
    print_policy_report,
    print_telemetry_report,
    distributed_scope,
    run_scope,
    setup_perf,
    setup_policy,
    setup_telemetry,
)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="skylark-ml")
    p.add_argument("--trainfile", default=None)
    p.add_argument("--valfile", default=None)
    p.add_argument("--testfile", default=None)
    p.add_argument("--modelfile", default="model.json")
    p.add_argument("--lossfunction", "-l", default="squared",
                   choices=["squared", "lad", "hinge", "logistic"])
    p.add_argument("--regularizer", "-r", default="l2",
                   choices=["none", "l2", "l1"])
    p.add_argument("--kernel", "-k", default="gaussian",
                   choices=["linear", "gaussian", "polynomial", "laplacian",
                            "expsemigroup", "matern"])
    p.add_argument("--kernelparam", "-g", type=float, default=1.0,
                   help="sigma / beta / gamma by kernel")
    p.add_argument("--kernelparam2", type=float, default=1.0)
    p.add_argument("--kernelparam3", type=float, default=1.0)
    p.add_argument("--lambda", dest="lam", type=float, default=0.01)
    p.add_argument("--rho", type=float, default=1.0)
    p.add_argument("--maxiter", "-i", type=int, default=20)
    p.add_argument("--numfeatures", "-f", type=int, default=1024)
    p.add_argument("--numfeaturepartitions", "-n", type=int, default=4)
    p.add_argument("--datapartitions", type=int, default=1)
    p.add_argument("--regression", action="store_true")
    p.add_argument("--usefast", action="store_true")
    p.add_argument("--seed", "-s", type=int, default=12345)
    p.add_argument("--sparse", action="store_true")
    p.add_argument("--fileformat", default="libsvm", choices=FILE_FORMATS,
                   help="train/val/test container (hdf5 via "
                        "skylark-convert2hdf5 or the reference layout)")
    p.add_argument("--x64", action="store_true")
    p.add_argument("--outputfile", "-o", default=None,
                   help="stream test predictions to this file (bounded "
                        "memory; one prediction per line)")
    p.add_argument("--batch", type=int, default=4096,
                   help="streaming predict batch size")
    p.add_argument("--checkpoint-dir", default=None,
                   help="directory for ADMM checkpoints; enables "
                        "preemption-safe chunked training")
    p.add_argument("--checkpoint-every", type=int, default=5,
                   help="ADMM iterations per checkpoint round")
    p.add_argument("--resume", action="store_true",
                   help="resume training from the newest valid checkpoint "
                        "in --checkpoint-dir")
    add_distributed_args(p, what="train (each rank streams its row partition of "
                                 "--trainfile; one consensus sum per ADMM iteration; "
                                 "--datapartitions must give every rank whole partitions)")
    p.add_argument("--batch-rows", type=int, default=256,
                   help="with --distributed: rows per streamed training "
                        "batch (partition granularity)")
    add_device_args(p)
    add_perf_args(p)
    add_policy_args(p)
    add_telemetry_args(p)
    args = p.parse_args(argv)

    setup_perf(args)
    if args.trainfile is None and args.testfile is None:
        p.error("need --trainfile (train) or --testfile + --modelfile (predict)")
    with run_scope(args), distributed_scope(args):
        setup_telemetry(args)
        setup_policy(args)
        return _run(args)


def _train_distributed(args, X, y, maps, params):
    """One rank of the elastic multi-process trainer: every rank runs the
    same command, streams its row partition, trains in lockstep (one
    consensus sum per iteration) and holds the same model at the end."""
    from ..ml.distributed import DistributedBlockADMMTrainer
    from ..streaming import ElasticParams, RowPartition, world_info
    from .common import float_dtype, to_numpy

    if args.valfile:
        print("warning: --valfile is ignored under --distributed (score the saved model "
              "instead)", file=sys.stderr)
    n = X.shape[0]
    rank, world = world_info()
    partition = RowPartition(nrows=n, batch_rows=args.batch_rows, world_size=world)
    b0, b1 = partition.batch_range(rank)
    print(f"Distributed train: rank {rank}/{world} owns batches [{b0}, {b1}) of "
          f"{partition.num_batches} (resume policy: {args.resume_policy})")
    Xh = torch.from_numpy(to_numpy(X)).to(float_dtype(args))
    yh = np.asarray(to_numpy(y), np.float64)

    def source(start):
        for bi in range(start, partition.num_batches):
            lo, hi = bi * args.batch_rows, min((bi + 1) * args.batch_rows, n)
            yield Xh[lo:hi], yh[lo:hi]

    trainer = DistributedBlockADMMTrainer(
        args.lossfunction, args.regularizer, maps, params,
        ElasticParams(checkpoint_dir=args.checkpoint_dir,
                      checkpoint_every=args.checkpoint_every, resume=args.resume,
                      resume_policy=args.resume_policy,
                      collective_timeout_s=args.collective_timeout))
    model, info = trainer.train(
        source, partition, classes=None if args.regression else np.unique(yh),
        regression=args.regression, dtype=float_dtype(args))
    replays = sum(1 for a in info["recovery"].get("attempts", [])
                  if a.get("action") == "replay")
    print(f"Train report: iters={info['iters']} "
          f"consensus_residual={info['consensus_residual']:.6e} "
          f"precision={info['precision']} replays={replays}")
    return model


def _run(args) -> int:
    from ..core.context import SketchContext
    from ..ml import ADMMParams, BlockADMMSolver, kernel_by_name
    from .common import load_dataset, stream_dataset, sync, to_device, to_numpy

    if args.trainfile:
        X, y = load_dataset(args.trainfile, args.fileformat, args.sparse)
        n, d = X.shape
        kparams = {
            "linear": {},
            "gaussian": {"sigma": args.kernelparam},
            "polynomial": {"q": int(args.kernelparam), "c": args.kernelparam2,
                           "gamma": args.kernelparam3},
            "laplacian": {"sigma": args.kernelparam},
            "expsemigroup": {"beta": args.kernelparam},
            "matern": {"nu": args.kernelparam, "l": args.kernelparam2},
        }[args.kernel]
        kernel = kernel_by_name(args.kernel, d, **kparams)

        # Split numfeatures across partitions (≙ GetSolver block creation).
        J = max(1, args.numfeaturepartitions)
        sizes = [args.numfeatures // J] * J
        sizes[-1] += args.numfeatures - sum(sizes)
        ctx = SketchContext(seed=args.seed)
        tag = "fast" if args.usefast else "regular"
        maps = [kernel.create_rft(sz, tag, ctx) for sz in sizes if sz > 0]

        solver = BlockADMMSolver(
            args.lossfunction,
            args.regularizer,
            maps,
            ADMMParams(
                am_i_printing=True,
                log_level=1,
                rho=args.rho,
                lam=args.lam,
                maxiter=args.maxiter,
                data_partitions=args.datapartitions,
            ),
        )
        Xv = Yv = None
        if args.valfile:
            Xv, Yv = load_dataset(
                args.valfile, args.fileformat, args.sparse, n_features=d
            )
            Xv = to_device(Xv, args)
        Xj = X if args.distributed else to_device(X, args)
        t0 = time.perf_counter()
        if args.distributed:
            model = _train_distributed(args, X, y, maps, solver.params)
        elif args.checkpoint_dir:
            # Preemption-safe path: host rounds of --checkpoint-every ADMM
            # iterations, a rotated CRC-guarded checkpoint after each.
            # Per-iteration validation scoring is a train()-only feature.
            from ..resilient import ResilientParams, ResilientRunner

            if args.valfile:
                print("warning: --valfile is ignored under "
                      "--checkpoint-dir (score the saved model instead)",
                      file=sys.stderr)
            model = ResilientRunner(
                solver.chunked(Xj, y, regression=args.regression),
                ResilientParams(
                    am_i_printing=True,
                    log_level=1,
                    checkpoint_dir=args.checkpoint_dir,
                    checkpoint_every=args.checkpoint_every,
                    resume=args.resume,
                ),
            ).run()
        else:
            model = solver.train(
                Xj,
                y,
                regression=args.regression,
                Xv=Xv,
                Yv=Yv,
            )
        sync()
        print(f"Training took {time.perf_counter() - t0:.3f} sec; "
              f"final objective {float(model.history[-1]):.6e}")
        # The model JSON embeds the label coding (≙ get_column_coding).
        model.save(args.modelfile)
        print(f"Model saved to {args.modelfile}")
    else:
        from ..ml import load_model
        from .common import load_classes

        model = load_model(args.modelfile)
        if getattr(model, "classes", None) is None:
            # Legacy sidecar from pre-embedded-coding saves.
            classes = load_classes(args.modelfile)
            model.classes = None if classes is None else list(classes.tolist())

    if args.testfile:
        d = model.input_dim
        regression = args.regression or getattr(model, "classes", None) is None
        if args.outputfile:
            # Streaming predict (≙ the reference's line-by-line predict IO).
            n_done = correct = 0
            sq_err = sq_nrm = 0.0
            with open(args.outputfile, "w") as out:
                for Xb, yb in stream_dataset(
                    args.testfile, args.fileformat, d, args.batch, args.sparse
                ):
                    Xb = to_device(Xb, args)
                    if regression:
                        pred = to_numpy(model.predict(Xb))
                        pred = pred[:, 0] if pred.ndim > 1 else pred
                        sq_err += float(np.sum((pred - yb) ** 2))
                        sq_nrm += float(np.sum(yb**2))
                    else:
                        pred = to_numpy(model.predict_labels(Xb, model.classes))
                        correct += int((pred == yb).sum())
                    n_done += len(yb)
                    out.writelines(f"{v}\n" for v in pred)
            if regression:
                print(f"Test relative error: "
                      f"{(sq_err / max(sq_nrm, 1e-30)) ** 0.5:.4f} "
                      f"({n_done} examples)")
            else:
                print(f"Test accuracy: {correct * 100.0 / max(n_done, 1):.2f}% "
                      f"({n_done} examples)")
            print(f"Predictions -> {args.outputfile}")
        else:
            from .common import print_test_metrics

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
