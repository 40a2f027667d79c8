"""Read the two ends that a cell's correctness limit is set between.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,... --control-seeds 1,2,3 \
        --seconds <s> [--out <file.jsonl>]

For each seed, in one process: the cell's inputs and warm-up, a short
window of the cell's own traffic, then the comparison with the plain
reference (the program's reading, the lower end).  For each control
seed also the control's reading (the upper end): the reference put in
the program's place and computed one precision below the configuration
(TF32 inputs for float32, e4m3 cosines for bf16 features), judged
against the same solves.  One JSON line per seed.
"""

from __future__ import annotations

import argparse
import json
import random
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark.harness import env  # noqa: E402

env.prepare()


def read_seed(bench, cell, seed, seconds, control, device, config=None, traffic=None) -> dict:
    """One run of ``cell`` through the harness's own :func:`run_cell`,
    then the control judged on the same solves."""
    import torch

    from benchmark.harness.cell import run_cell

    t0 = time.perf_counter()
    result, _, _, run = run_cell(bench, cell, seed, seconds, False, device, t0,
                                 time.perf_counter, config=config, traffic=traffic)
    drv, win = run.driver, run.window
    gaps = drv.last_gaps
    out = {"cell": cell, "seed": seed, "requests": win.count, "failed": win.failed,
           "correct": result["correct"], "program": max(gaps) if gaps else None,
           "program_all": gaps}
    if control:
        cg = drv.gaps(win.records, random.Random(seed), control=True)
        out["control"] = max(cg) if cg else None
        out["control_min"] = min(cg) if cg else None
    del drv, win, run
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import torch

    from benchmark.harness import registry

    if env.card_count() < 1:
        print("error: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    bench = registry.load_benchmark()
    ctrl = {int(s) for s in args.control_seeds.split(",") if s}
    sink = open(args.out, "a") if args.out else None
    for s in args.seeds.split(","):
        rec = read_seed(bench, args.workload, int(s), args.seconds, int(s) in ctrl, device)
        line = json.dumps(rec)
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()
    if sink:
        sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
