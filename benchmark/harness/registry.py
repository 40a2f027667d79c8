"""Finds everything by name: the cell, its configuration and traffic mix
in ``BENCHMARK.json``, the traffic's driver, and one reader per metric.

- a configuration is the JSON file its ``configs`` entry names;
- a traffic mix is ``traffic/<traffic>.json``, whose ``driver`` key names
  ``drivers/<driver>.py``;
- a metric is ``metrics/<name>.py``, whose ``read(run)`` returns its
  value, or None where it finds nothing to read.

A new configuration, mix or metric is a new file and a new entry; no
file here changes.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
REPO = BENCH_DIR.parent


def load_benchmark(path: Path | None = None) -> dict:
    return json.loads(Path(path or REPO / "BENCHMARK.json").read_text())


def _named(entries: list, name: str, what: str) -> dict:
    for entry in entries:
        if entry["name"] == name:
            return entry
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    return _named(bench["workloads"], name, "workload")


def config(bench: dict, name: str) -> dict:
    entry = _named(bench["configs"], name, "configuration")
    return json.loads((REPO / entry["file"]).read_text())


def traffic(name: str) -> dict:
    return json.loads((BENCH_DIR / "traffic" / f"{name}.json").read_text())


def _module(path: Path, prefix: str):
    if not path.is_file():
        raise FileNotFoundError(path)
    mod_name = prefix + path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str):
    return _module(BENCH_DIR / "drivers" / f"{name}.py", "benchmark_driver_")


def reader(metric: str):
    return _module(BENCH_DIR / "metrics" / f"{metric}.py", "benchmark_metric_")


def end_to_end(bench: dict, cell: str) -> list[dict]:
    """The end-to-end metrics the cell reports."""
    return [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]


def per_layer(bench: dict, cell: str) -> list[dict]:
    """The per-layer metrics the cell reports: those that list it, and
    those without a list wherever the metric they move is reported."""
    moved = {m["name"] for m in end_to_end(bench, cell)}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in moved)]
