"""skylark-community: seed-set local community detection driver (port of
``libskylark_tpu/cli/community.py``).

≙ ``ml/skylark_community.cpp`` (interactive mode included).  The
diffusion and the sweep are host code in both packages; ``--device``
only checks that the device asked for exists.
"""

from __future__ import annotations

import argparse
import sys

from .common import add_device_args, run_scope


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="skylark-community")
    p.add_argument("graphfile", help="arc-list file (u v per line)")
    p.add_argument("--seed", "-s", action="append", default=[],
                   help="seed vertex (repeatable)")
    p.add_argument("--alpha", type=float, default=0.85)
    p.add_argument("--gamma", type=float, default=5.0)
    p.add_argument("--epsilon", type=float, default=0.001)
    p.add_argument("--recursive", action="store_true")
    p.add_argument("--interactive", "-i", action="store_true",
                   help="read seed sets from stdin, one line each")
    add_device_args(p)
    args = p.parse_args(argv)

    from ..graph import find_local_cluster, read_arc_list

    with run_scope(args):
        G = read_arc_list(args.graphfile)
        print(f"Read graph: {G.n} vertices, {G.volume // 2} edges")

        def run(seed_names) -> bool:
            for name in seed_names:
                if name not in G.index:
                    print(f"unknown vertex {name!r}")
                    return False
            ids = [G.index[name] for name in seed_names]
            cluster, cond = find_local_cluster(
                G, ids, args.alpha, args.gamma, args.epsilon,
                recursive=args.recursive,
            )
            members = sorted(G.vertices[v] for v in cluster)
            print(f"Conductance: {cond:.6f}")
            print("Cluster:", " ".join(str(m) for m in members))
            return True

        if args.interactive:
            print("Enter seed vertices (space-separated), empty line to quit:")
            for line in sys.stdin:
                names = line.split()
                if not names:
                    break
                run(names)
        else:
            if not args.seed:
                p.error("need at least one --seed (or --interactive)")
            if not run(args.seed):
                return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
