"""Everything is found by name, and a new configuration, traffic mix and
per-layer metric are new files plus new entries: the harness runs them
with no file of it edited."""

import json
import shutil

import pytest

from benchmark.harness import registry

from .tiny import full_bench, run_tiny


@pytest.mark.parametrize("bench", [registry.load_benchmark(), full_bench()],
                         ids=["benchmark", "with_parked"])
def test_every_entry_of_benchmark_json_has_its_files(bench):
    for cfg in bench["configs"]:
        assert registry.config(bench, cfg["name"])["name"] == cfg["name"]
    for wl in bench["workloads"]:
        mix = registry.traffic(wl["traffic"])
        assert hasattr(registry.driver(mix["driver"]), "Driver")
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(registry.reader(m["name"]).read)


@pytest.mark.parametrize("bench", [registry.load_benchmark(), full_bench()],
                         ids=["benchmark", "with_parked"])
def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric(bench):
    for wl in bench["workloads"]:
        e2e = {m["name"] for m in registry.end_to_end(bench, wl["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert registry.per_layer(bench, wl["name"])


def test_unknown_names_raise():
    bench = registry.load_benchmark()
    with pytest.raises(KeyError):
        registry.workload(bench, "no_such_cell")
    with pytest.raises(FileNotFoundError):
        registry.reader("no_such_metric")


def test_a_new_config_mix_and_metric_need_no_edit(tmp_path, monkeypatch):
    """Copy the benchmark, add one file of each kind and their entries,
    and run the new cell through the unchanged harness."""
    root = tmp_path / "repo"
    shutil.copytree(registry.BENCH_DIR, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = registry.load_benchmark()
    cfg = json.loads((registry.REPO / "benchmark/configs/ls_50k_x500_f32.json").read_text())
    cfg.update(name="ls_small_f32", rows=4096, cols=16)
    (root / "benchmark/configs/ls_small_f32.json").write_text(json.dumps(cfg))
    mix = {"driver": "ls_closed_loop", "route": "lsrn", "sketch_type": "JLT",
           "sketch_size": 64, "pool": 2, "warmup": 1, "check_sample": 0,
           "limits": {"solution_gap": 1e-5}}
    (root / "benchmark/traffic/ls_lsrn_jlt.json").write_text(json.dumps(mix))
    (root / "benchmark/metrics/solves_counted.ls.py").write_text(
        "def read(run):\n    return float(run.window.count)\n")
    bench["configs"].append({"name": "ls_small_f32", "source": "x", "reduced": [], "why": "x",
                             "file": "benchmark/configs/ls_small_f32.json"})
    bench["workloads"].append({"name": "ls_lsrn", "config": "ls_small_f32",
                               "traffic": "ls_lsrn_jlt", "chips": 1, "why": "x"})
    bench["end_to_end"][0]["workloads"].append("ls_lsrn")
    bench["per_layer"].append({"name": "solves_counted.ls", "unit": "solves", "better": "higher",
                               "source": "program_counter", "layer": "entry",
                               "moves": "solve_ms", "workloads": ["ls_lsrn"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(registry, "REPO", root)
    monkeypatch.setattr(registry, "BENCH_DIR", root / "benchmark")
    new = registry.load_benchmark()
    line, _, _ = run_tiny("ls_lsrn", bench=new, trace=True)
    assert line["correct"] is True
    assert line["metrics"]["solves_counted.ls"]["value"] == line["attempted"]
    line, _, _ = run_tiny("ls_lsrn", bench=new)
    assert set(line["metrics"]) == {"solve_ms", "setup_s"}
