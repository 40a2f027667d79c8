"""skylark-graph-se: approximate adjacency spectral embedding driver
(port of ``libskylark_tpu/cli/graph_se.py``).

≙ ``ml/skylark_graph_se.cpp`` (arc-list → ASE → embeddings file).  The
embeddings go to ``prefix.X.npy`` (readable by either package) and the
vertex names, in id order, to ``prefix.index.txt``.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from .common import add_device_args, run_scope


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="skylark-graph-se")
    p.add_argument("graphfile", help="arc-list file")
    p.add_argument("--rank", "-k", type=int, default=8)
    p.add_argument("--seed", type=int, default=38734)
    p.add_argument("--num-iterations", "-i", type=int, default=2)
    p.add_argument("--sparse", action="store_true")
    p.add_argument(
        "--streamed", action="store_true",
        help="one-pass streamed Nystrom ASE: folds edge blocks, never "
        "materializes the adjacency (forces --num-iterations 0)",
    )
    p.add_argument("--batch-edges", type=int, default=65536)
    p.add_argument("--prefix", default="embedding")
    add_device_args(p)
    args = p.parse_args(argv)

    from ..core.context import SketchContext
    from ..graph import ASEParams, approximate_ase, read_arc_list
    from .common import to_numpy

    with run_scope(args):
        G = read_arc_list(args.graphfile)
        print(f"Read graph: {G.n} vertices, {G.volume // 2} edges")
        if args.streamed:
            params = ASEParams(
                num_iterations=0, streamed=True, batch_edges=args.batch_edges
            )
        else:
            params = ASEParams(
                num_iterations=args.num_iterations, sparse=args.sparse
            )
        X, lam = approximate_ase(
            G,
            args.rank,
            SketchContext(seed=args.seed),
            params,
        )
        X, lam = to_numpy(X), to_numpy(lam)
    np.save(f"{args.prefix}.X.npy", X)
    with open(f"{args.prefix}.index.txt", "w") as f:
        for v in G.vertices:
            f.write(f"{v}\n")
    print(f"Embeddings ({G.n}x{args.rank}) -> {args.prefix}.X.npy; "
          f"eigenvalues: {lam}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
