"""skylark-linear: accelerated least-squares driver (port of
``libskylark_tpu/cli/linear.py``; ≙ ``nla/skylark_linear.cpp:1-201``):
reads a problem, runs ``faster_least_squares`` (Blendenpik) or the
``--solver`` chosen, writes the solution as ``.npy`` (readable by either
package).

Where the port departs from the JAX driver: ``--cond-est`` sketches A
with CWT whether A is dense or sparse (the JAX driver takes FJLT for a
dense A, and fails on a sparse one: its QR refuses a BCOO), and a sparse
A's sketch comes out dense.  ``--shard`` row-shards A over
``default_mesh()`` (one slot per visible card: on one card the run is
bitwise the run without it) and hands it to
``solve_regression``.  ``--stream --distributed`` runs one rank
of the elastic streaming pass over a ``torch.distributed`` world
(``cli.common.distributed_scope``).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from .common import (
    add_device_args,
    add_distributed_args,
    add_perf_args,
    add_shard_args,
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
    p = argparse.ArgumentParser(prog="skylark-linear")
    p.add_argument("inputfile", help="LIBSVM file: features = A, labels = b")
    p.add_argument("--solution", default="solution.npy")
    p.add_argument("--seed", type=int, default=38734)
    p.add_argument("--solver", default="accelerated",
                   choices=["exact", "sketched", "accelerated", "lsrn",
                            "refine", "auto"],
                   help="'refine' is certified mixed-precision iterative "
                        "refinement; 'auto' lets the adaptive policy route "
                        "between sketch-and-solve, refine, Blendenpik, "
                        "LSRN, and exact from the profile store")
    p.add_argument("--cond-est", action="store_true",
                   help="print a sketched condition / effective-rank "
                        "report of A before solving (a CWT sketch of A, "
                        "QR, cond_est on R, one small SVD)")
    p.add_argument("--sparse", action="store_true")
    p.add_argument("--x64", action="store_true")
    add_shard_args(p)
    p.add_argument("--stream", action="store_true",
                   help="out-of-core sketch-and-solve: stream the input "
                        "in --batch-rows row blocks instead of reading "
                        "it whole (one pass; A is never resident)")
    p.add_argument("--batch-rows", type=int, default=4096,
                   help="rows per streamed batch (with --stream)")
    p.add_argument("--checkpoint-dir", default=None,
                   help="with --stream: checkpoint the partial sketch "
                        "so a killed pass can resume bit-for-bit")
    p.add_argument("--checkpoint-every", type=int, default=8,
                   help="streamed batches per checkpoint round")
    p.add_argument("--resume", action="store_true",
                   help="resume a streamed pass from the newest valid "
                        "checkpoint in --checkpoint-dir")
    add_distributed_args(p, what="with --stream: partition the stream")
    add_device_args(p)
    add_perf_args(p)
    add_policy_args(p)
    add_telemetry_args(p)
    args = p.parse_args(argv)

    setup_perf(args)
    if args.distributed and not args.stream:
        print("error: --distributed rides the streaming path; add --stream", file=sys.stderr)
        return 2
    with run_scope(args) as dev, distributed_scope(args):
        setup_telemetry(args)
        setup_policy(args)
        if args.stream:
            return _stream_main(args)
        return _whole_file_main(args, dev)


def _whole_file_main(args, dev) -> int:
    from ..core.context import SketchContext
    from ..io import read_libsvm
    from ..solvers import RegressionProblem, solve_regression
    from ..parallel import routes
    from .common import shard_input, to_device, to_numpy

    A, b = read_libsvm(args.inputfile, sparse=args.sparse)
    Aj, n_orig = shard_input(args, to_device(A, args), dev)
    if n_orig is not None:
        # Zero rows contribute zero residual: the LS solution is
        # unchanged; pad b to match.
        b = np.concatenate([b, np.zeros(Aj.shape[0] - n_orig)])
    if args.cond_est:
        _print_cond_est(args, Aj)
    t0 = time.perf_counter()
    result = solve_regression(
        RegressionProblem(Aj),
        to_device(b, args),
        solver=args.solver,
        context=SketchContext(seed=args.seed),
    )
    x = result[0] if isinstance(result, tuple) else result
    x = to_numpy(x)
    dt = time.perf_counter() - t0
    xj = torch.as_tensor(x, device=dev)
    both = torch.promote_types(Aj.dtype, xj.dtype)  # as jnp's f32 @ f64 promotes
    if routes.is_sharded(Aj):
        Ax = routes.linear_ops(routes.map_shards(Aj, lambda t: t.to(both)))[0](xj.to(both))
    else:
        Ab, xj = Aj.to(both), xj.to(both)
        Ax = (torch.sparse.mm(Ab, xj[:, None])[:, 0] if Ab.layout == torch.sparse_coo
              else Ab @ xj)
    r = np.linalg.norm(to_numpy(Ax) - b)
    print(f"Solved {A.shape[0]}x{A.shape[1]} ({args.solver}) in {dt:.3f}s; "
          f"residual {r:.6e}")
    info = result[1] if isinstance(result, tuple) else None
    rf = (info or {}).get("refine") if isinstance(info, dict) else None
    if rf:
        gate = rf.get("gate")
        gate_s = f", gate {gate:.3e}" if isinstance(gate, float) else ""
        print(f"Refine: {rf.get('iters')} sweeps (rung {rf.get('rung')}, "
              f"halt {rf.get('halt', 'converged')}{gate_s})")
    np.save(args.solution, x)
    print(f"Solution -> {args.solution}")
    print_perf_report(args)
    print_policy_report(args)
    print_telemetry_report(args)
    return 0


def _print_cond_est(args, Aj) -> None:
    """The serve layer's cond_est report, computed locally: sketch once
    (CWT, ``s = min(max(4n, n + 16), m)``; a sparse A's sketch comes out
    dense), QR, short-budget ``cond_est`` on R (which carries S·A's
    singular values) plus one small SVD for the effective rank — the full
    (m, n) matrix is never probed directly."""
    from .. import plans
    from ..core.context import SketchContext
    from ..sketch.base import create_sketch
    from ..solvers.cond_est import CondEstParams, cond_est

    m, n = (int(d) for d in Aj.shape)
    s = min(max(4 * n, n + 16), m)
    S = create_sketch("CWT", m, s, SketchContext(seed=args.seed))
    if isinstance(Aj, torch.Tensor) and Aj.layout == torch.sparse_coo:
        SA = S.apply(Aj, "columnwise", dense_output=True)
    else:
        SA = plans.apply(S, Aj, "columnwise")
    R = torch.linalg.qr(SA, mode="r").R
    rep = cond_est(R, SketchContext(seed=0x5EED),
                   CondEstParams(iter_lim=60, powerits=25))
    sv = torch.linalg.svdvals(R).cpu().numpy()
    cutoff = float(np.finfo(sv.dtype).eps) * n * float(sv[0])
    print(f"Cond-est: cond {float(rep.cond):.4e}, "
          f"sigma [{float(rep.sigma_min):.4e}, {float(rep.sigma_max):.4e}], "
          f"effective rank {int((sv > cutoff).sum())}/{n} "
          f"(sketch size {s})")


def _stream_main(args) -> int:
    """Out-of-core path: one streamed sketch-and-solve pass.

    ≙ the whole-file path with ``--solver sketched``, but the sketch
    applies decompose over row blocks (``streaming.sketch_least_squares``,
    JLT by default, CWT for a sparse stream) so the file never needs to
    fit in memory.  Other --solver choices need the resident matrix and
    are rejected up front.
    """
    if args.solver not in ("sketched", "accelerated"):
        print(f"error: --stream is sketch-and-solve only; --solver "
              f"{args.solver} needs the resident matrix", file=sys.stderr)
        return 2
    if args.shard:
        print("warning: --shard is a whole-matrix layout; ignored with "
              "--stream", file=sys.stderr)

    from ..core.context import SketchContext
    from ..io import scan_libsvm_dims, stream_libsvm
    from ..linalg import streaming_least_squares
    from ..streaming import ElasticParams, RowPartition, StreamParams, skip_batches, world_info
    from .common import in_run_dtype, to_numpy

    nrows, ncols = scan_libsvm_dims(args.inputfile)
    print(f"Streaming {nrows}x{ncols} in batches of {args.batch_rows} rows")
    def batches(start: int):
        it = stream_libsvm(
            args.inputfile, ncols, batch=args.batch_rows,
            sparse=args.sparse,
        )
        it = in_run_dtype(it, args)
        return skip_batches(it, start) if start else it

    partition = None
    if args.distributed:
        # The elastic face carries the world knobs: the resume policy
        # (strict or repartition) and the collectives' deadline.
        sp = ElasticParams(
            checkpoint_dir=args.checkpoint_dir,
            checkpoint_every=args.checkpoint_every,
            resume=args.resume,
            resume_policy=args.resume_policy,
            collective_timeout_s=args.collective_timeout,
        )
        rank, world = world_info()
        partition = RowPartition(nrows=nrows, batch_rows=args.batch_rows, world_size=world)
        b0, b1 = partition.batch_range(rank)
        print(f"Distributed stream: rank {rank}/{world} owns batches [{b0}, {b1}) of "
              f"{partition.num_batches} (resume policy: {args.resume_policy})")
    else:
        sp = StreamParams(
            checkpoint_dir=args.checkpoint_dir,
            checkpoint_every=args.checkpoint_every,
            resume=args.resume,
        )
    t0 = time.perf_counter()
    x, info = streaming_least_squares(
        batches, nrows, ncols, SketchContext(seed=args.seed),
        sparse=args.sparse, stream_params=sp, partition=partition,
    )
    x = to_numpy(x)
    dt = time.perf_counter() - t0
    print(f"Solved {nrows}x{ncols} (streamed sketch-and-solve, "
          f"{info['batches']} batches) in {dt:.3f}s")
    np.save(args.solution, x)
    print(f"Solution -> {args.solution}")
    print_perf_report(args)
    print_policy_report(args)
    print_telemetry_report(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
