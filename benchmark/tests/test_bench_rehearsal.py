"""A CPU rehearsal of each cell at a tiny size: the harness drives the
port's plain paths and prints a well-formed last line."""

import pytest
import torch

from benchmark.harness import registry

from .tiny import CPU, SIZES, cell_inputs, full_bench, run_tiny

BENCH = full_bench()
CELLS = [wl["name"] for wl in BENCH["workloads"]]


def test_every_cell_has_a_tiny_size():
    assert set(CELLS) == set(SIZES)


@pytest.mark.parametrize("cell", CELLS)
def test_untraced_run_prints_the_end_to_end_metrics(cell):
    line, out, err = run_tiny(cell)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    want = {m["name"]: m["unit"] for m in registry.end_to_end(BENCH, cell)}
    assert {k: v["unit"] for k, v in line["metrics"].items()} == want
    assert all(v["value"] > 0 for v in line["metrics"].values())
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    checks = err.strip().splitlines()
    assert checks and all(c.startswith("check ") and " limit " in c for c in checks)
    assert len(checks) == len(line["checks"])


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_prints_per_layer_metrics_only(cell):
    line, _, _ = run_tiny(cell, trace=True)
    allowed = {m["name"]: m["unit"] for m in registry.per_layer(BENCH, cell)}
    assert line["metrics"] and set(line["metrics"]) <= set(allowed)
    assert all(allowed[k] == v["unit"] for k, v in line["metrics"].items())
    # No device metric is read from a CPU run.
    assert not any(k.startswith(("device_idle", "cuda_kernel", "sketch_roofline", "panel"))
                   for k in line["metrics"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("cell", CELLS)
def test_same_seed_same_inputs(cell):
    _, cfg, mix = cell_inputs(cell)

    def inputs(seed):
        drv = registry.driver(mix["driver"]).Driver(cfg, mix, seed, CPU)
        drv.setup()
        return [t.clone() for t in ((drv.A, drv.B) if hasattr(drv, "A") else (drv.X, drv.y))]

    a, b, c = inputs(2 ** 31 + 5), inputs(2 ** 31 + 5), inputs(2 ** 31 + 6)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])


@pytest.mark.card
def test_a_short_run_on_the_card(card):
    import json
    import subprocess
    import sys

    out = subprocess.run([sys.executable, str(registry.BENCH_DIR / "run.py"), "--workload",
                          "ls_sketch_fjlt", "--seed", "3000000003", "--seconds", "2",
                          "--trace", "0"], capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
