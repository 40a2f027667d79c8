"""Run one cell of the benchmark once, on the card this process finds.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints informational lines, then as the last line of standard output one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``, each
number the correctness comparison read beside its limit.  The same
numbers are the last lines of standard error.  Exits non-zero, printing
no result, without a CUDA card, or if a module of JAX or of the JAX
package was loaded.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark.harness import env  # noqa: E402

env.prepare()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark.harness import registry
    from benchmark.harness.cell import emit, run_cell

    bench = registry.load_benchmark()
    wl = registry.workload(bench, args.workload)
    have = env.card_count()
    if have < int(wl["chips"]):
        print(f"error: {args.workload} needs {wl['chips']} CUDA card(s), found {have}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    from libskylark_tpu_torch import _build

    imported = time.perf_counter()
    _build.build_all()
    built = time.perf_counter()
    result, checks, info, _ = run_cell(bench, args.workload, args.seed, args.seconds,
                                    bool(args.trace), device, STARTED, time.perf_counter)
    info.insert(0, f"set-up: imports {imported - STARTED:.3f} s, kernels {built - imported:.3f} s")
    result["device"]["power_limit_w"] = env.power_limit_w()
    found = env.forbidden_loaded()
    if found:
        print(f"error: modules of JAX or the JAX package were loaded: {found}", file=sys.stderr)
        return 3
    emit(result, checks, info, sys.stdout, sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
