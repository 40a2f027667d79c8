"""Tiny sizes of each cell for the CPU rehearsals, and a helper that runs
a cell through the harness on the CPU.  The limits here are for these
sizes: the CPU's own bf16 GEMM rounds about 1 % of the pre-activations
differently from a float32-accumulated product, which puts the tiny
kernel-ridge fit's gap near 2e-3 (e4m3 control: 2e-2)."""

from __future__ import annotations

import io
import json
import time

import torch

from benchmark.harness import registry
from benchmark.harness.cell import emit, run_cell

SIZES = {
    "ls_sketch_fjlt": ({"rows": 8192, "cols": 32},
                       {"sketch_size": 128, "pool": 4, "warmup": 1, "check_sample": 4,
                        "limits": {"solution_gap": 1e-5}}),
    "ls_blendenpik_cwt": ({"rows": 8192, "cols": 32},
                          {"sketch_size": 128, "pool": 4, "warmup": 1,
                           "limits": {"solution_gap": 5e-6}}),
    "krr_rff_sweeps": ({"rows": 4096, "dim": 256, "features": 128, "block_rows": 512},
                       {"warmup": 1, "limits": {"w_gap": 6e-3}}),
}
CPU = torch.device("cpu")


def full_bench() -> dict:
    """BENCHMARK.json with the parked cells' entries added (``parked.json``):
    the CPU tests hold those cells too."""
    bench = registry.load_benchmark()
    parked = registry.load_benchmark(registry.BENCH_DIR / "parked.json")
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        bench[key] = bench[key] + parked[key]
    return bench


def cell_inputs(cell: str, bench: dict | None = None):
    bench = bench or full_bench()
    wl = registry.workload(bench, cell)
    cfg = registry.config(bench, wl["config"])
    mix = registry.traffic(wl["traffic"])
    size, knobs = SIZES.get(cell, ({}, {}))
    cfg.update(size)
    mix.update(knobs)
    return bench, cfg, mix


def run_tiny(cell: str, *, seed: int = 2 ** 31 + 11, seconds: float = 0.5, trace: bool = False,
             bench: dict | None = None):
    """(last stdout line parsed, stdout, stderr) of one tiny CPU run."""
    bench, cfg, mix = cell_inputs(cell, bench)
    if trace:
        mix["trace_stretch"] = {"start_s": 0.0, "length_s": 0.05}
    result, checks, info, _ = run_cell(bench, cell, seed, seconds, trace, CPU, time.perf_counter(),
                                    time.perf_counter, config=cfg, traffic=mix)
    out, err = io.StringIO(), io.StringIO()
    emit(result, checks, info, out, err)
    return json.loads(out.getvalue().splitlines()[-1]), out.getvalue(), err.getvalue()
