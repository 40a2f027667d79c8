"""skylark-svd: randomized SVD driver (port of ``libskylark_tpu/cli/svd.py``;
≙ ``nla/skylark_svd.cpp:1-477``).

Reads LIBSVM, arc-list graphs (``--filetype arclist`` ≙ the reference's
``ARC_LIST`` + ``ReadArcList``, ``skylark_svd.cpp:169-171,246-248``),
HDF5 (reference layout, ``io/hdf5.py``), or .npy; runs
``approximate_svd`` (or ``approximate_symmetric_svd`` under
``--symmetric`` ≙ ``execute_sym``, ``skylark_svd.cpp:120-222``); writes
U/S/V as .npy, or as the reference's ASCII convention (``El::Write(...,
El::ASCII)`` to ``prefix.U`` / ``prefix.S`` / ``prefix.V``,
``skylark_svd.cpp:110-112``) with ``--ascii``.  ``--profile`` generates a
synthetic low-rank + noise matrix instead of reading a file (≙
``skylark_svd.cpp:37-60``).  ``--shard`` row-shards A over
``default_mesh()`` (zero rows up to a multiple of the slots; U trimmed
back), as the JAX driver does; a sparse A keeps one device.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from .common import (
    add_device_args,
    add_perf_args,
    add_shard_args,
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


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="skylark-svd", description="Randomized (approximate) SVD"
    )
    p.add_argument(
        "inputfile", nargs="?",
        help="LIBSVM / arc-list / HDF5 / .npy matrix",
    )
    p.add_argument("--rank", "-k", type=int, default=6)
    p.add_argument("--seed", type=int, default=38734)
    p.add_argument("--sparse", action="store_true", help="load as a sparse COO")
    p.add_argument(
        "--filetype",
        choices=("auto", "libsvm", "arclist", "hdf5", "npy"),
        default="auto",
        help="input format (auto: by extension, arc-lists need an "
        "explicit 'arclist' like the reference's --filetype ARC_LIST)",
    )
    p.add_argument(
        "--symmetric", action="store_true",
        help="treat the matrix as symmetric (eigendecomposition; writes "
        "S and V only, as the reference's execute_sym)",
    )
    p.add_argument(
        "--lower", action="store_true",
        help="with --symmetric: access the lower triangle (symmetrize "
        "from the lower part; upper is the default)",
    )
    p.add_argument(
        "--ascii", action="store_true",
        help="write prefix.U/.S/.V as ASCII text (the reference's "
        "El::Write convention) instead of .npy",
    )
    p.add_argument(
        "--num-iterations", "-i", type=int, default=None,
        help="power-iteration sweeps (default 0; 1 with --stream, where "
        "f32 q=0 is documented-inaccurate on noisy spectra)",
    )
    p.add_argument("--oversampling-ratio", type=int, default=2)
    p.add_argument("--oversampling-additive", type=int, default=0)
    p.add_argument("--skip-qr", action="store_true")
    p.add_argument("--prefix", default="out", help="output prefix for U/S/V")
    p.add_argument(
        "--profile",
        nargs=2,
        type=int,
        metavar=("M", "N"),
        help="synthetic MxN profiling mode (no input file)",
    )
    p.add_argument("--x64", action="store_true", help="enable float64")
    add_shard_args(p)
    p.add_argument(
        "--stream",
        type=int,
        metavar="BLOCK_ROWS",
        help="with --profile: stream row panels of this size instead of "
        "materializing A (memory-bounded; any M divisible by BLOCK_ROWS)",
    )
    add_device_args(p)
    add_perf_args(p)
    add_policy_args(p)
    add_telemetry_args(p)
    args = p.parse_args(argv)

    setup_perf(args)
    with run_scope(args) as dev:
        setup_telemetry(args)
        setup_policy(args)
        return _run(p, args, dev)


def _run(p, args, dev) -> int:
    from ..core.context import SketchContext
    from ..io import read_libsvm
    from ..linalg import SVDParams, approximate_svd
    from .common import float_dtype, to_device, to_numpy

    if args.num_iterations is None:
        args.num_iterations = 1 if args.stream is not None else 0
    params = SVDParams(
        oversampling_ratio=args.oversampling_ratio,
        oversampling_additive=args.oversampling_additive,
        num_iterations=args.num_iterations,
        skip_qr=args.skip_qr,
    )

    if args.stream is not None:
        if not args.profile:
            p.error("--stream requires --profile (streamed file IO: use the "
                    "library API with a custom block_fn)")
        from ..linalg import streaming_approximate_svd, synthetic_lowrank_blocks

        m, n = args.profile
        ctx = SketchContext(seed=args.seed)
        block_fn = synthetic_lowrank_blocks(
            ctx, m, n, args.rank, noise=0.01, dtype=float_dtype(args), device=dev,
        )
        t0 = time.perf_counter()
        _, s, V = streaming_approximate_svd(
            block_fn, (m, n), args.rank, ctx, params, block_rows=args.stream
        )
        s, V = to_numpy(s), to_numpy(V)
        dt = time.perf_counter() - t0
        np.save(f"{args.prefix}.S.npy", s)
        np.save(f"{args.prefix}.V.npy", V)
        print(f"Rank-{args.rank} streaming SVD of {m}x{n} in {dt:.3f}s "
              f"({m // args.stream} panels; U factored, not saved)")
        print(f"Leading singular values: {s[: min(5, len(s))]}")
        print_perf_report(args)
        print_policy_report(args)
        print_telemetry_report(args)
        return 0

    if args.profile:
        m, n = args.profile
        rng = np.random.default_rng(args.seed)
        k = args.rank
        A = (rng.standard_normal((m, k)) @ rng.standard_normal((k, n))).astype(
            np.float64 if args.x64 else np.float32
        )
        A += 0.01 * rng.standard_normal((m, n)).astype(A.dtype)
    elif args.inputfile:
        ftype = args.filetype
        if ftype == "auto":
            if args.inputfile.endswith(".npy"):
                ftype = "npy"
            elif args.inputfile.endswith((".h5", ".hdf5")):
                ftype = "hdf5"
            else:
                ftype = "libsvm"
        if ftype == "npy":
            A = np.load(args.inputfile)
        elif ftype == "hdf5":
            from ..io import read_hdf5

            A, _ = read_hdf5(args.inputfile, sparse=args.sparse)
        elif ftype == "arclist":
            # ≙ ReadArcList → adjacency SVD (spectral embedding input).
            from ..graph import read_arc_list

            G = read_arc_list(args.inputfile)
            A = G.adjacency_coo(device="cpu") if args.sparse else G.adjacency()
        else:
            A, _ = read_libsvm(args.inputfile, sparse=args.sparse)
    else:
        p.error("need an inputfile or --profile M N")
    A = to_device(A, args)

    def write(suffix, arr):
        # --ascii ≙ El::Write(X, prefix + suffix, El::ASCII): plain text,
        # one matrix row per line (skylark_svd.cpp:110-112).
        if args.ascii:
            np.savetxt(f"{args.prefix}{suffix}", np.atleast_1d(to_numpy(arr)))
        else:
            np.save(f"{args.prefix}{suffix}.npy", to_numpy(arr))

    ctx = SketchContext(seed=args.seed)
    if args.symmetric:
        from ..linalg import approximate_symmetric_svd

        Ad = A.to_dense() if A.layout == torch.sparse_coo else A
        if Ad.shape[0] != Ad.shape[1]:
            p.error("--symmetric needs a square matrix")
        # Access one triangle only (≙ the uplo argument of
        # ApproximateSymmetricSVD; reference defaults to upper).
        tri = torch.tril(Ad) if args.lower else torch.triu(Ad)
        Ad = tri + tri.T - torch.diag(torch.diagonal(Ad))
        t0 = time.perf_counter()
        V, lam = approximate_symmetric_svd(Ad, args.rank, ctx, params)
        V, lam = to_numpy(V), to_numpy(lam)
        dt = time.perf_counter() - t0
        write(".S", lam)
        write(".V", V)
        print(f"Rank-{args.rank} symmetric SVD of {Ad.shape[0]}"
              f"x{Ad.shape[1]} in {dt:.3f}s")
        print(f"Leading eigenvalues: {lam[: min(5, len(lam))]}")
        print_perf_report(args)
        print_policy_report(args)
        print_telemetry_report(args)
        return 0

    from .common import shard_input

    # Zero rows don't affect singular values/V; U is trimmed below.
    A, n_orig = shard_input(args, A, dev)
    t0 = time.perf_counter()
    U, s, V = (to_numpy(t) for t in approximate_svd(A, args.rank, ctx, params))
    dt = time.perf_counter() - t0
    if n_orig is not None:
        U = U[:n_orig]
    write(".U", U)
    write(".S", s)
    write(".V", V)
    print(f"Rank-{args.rank} SVD of {U.shape[0]}x{V.shape[0]} in {dt:.3f}s")
    print(f"Leading singular values: {s[: min(5, len(s))]}")
    print_perf_report(args)
    print_policy_report(args)
    print_telemetry_report(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
