"""``BENCHMARK.json`` and the files it names.

Everything that belongs to one configuration, traffic mix, cell or metric
sits in a file of its own, found by its name:

- a configuration: the ``file`` its entry names (``benchmark/configs/``);
- a traffic mix: ``benchmark/traffic/<traffic>.json``;
- a cell's correctness limits: ``benchmark/cells/<workload>.json``;
- a metric, end-to-end or per-layer: ``benchmark/metrics/<name>.py``, whose
  ``read(run)`` returns the number or None where it finds nothing to read.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_json(path: Path) -> dict:
    with open(path, encoding="utf-8") as fh:
        return json.load(fh)


def manifest(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell(man: dict, workload: str) -> dict:
    for w in man["workloads"]:
        if w["name"] == workload:
            return w
    raise KeyError(f"no workload named {workload!r} in BENCHMARK.json")


def config(man: dict, name: str, root: Path = ROOT) -> dict:
    for c in man["configs"]:
        if c["name"] == name:
            return load_json(root / c["file"])
    raise KeyError(f"no configuration named {name!r} in BENCHMARK.json")


def traffic(name: str, bench_dir: Path = BENCH_DIR) -> dict:
    return load_json(bench_dir / "traffic" / f"{name}.json")


def limits(workload: str, bench_dir: Path = BENCH_DIR) -> dict:
    return load_json(bench_dir / "cells" / f"{workload}.json")


def metrics_of(man: dict, workload: str, trace: bool) -> list:
    """The metrics a run of ``workload`` reports: its end-to-end metrics
    with ``--trace 0``, its per-layer metrics with ``--trace 1``."""
    group = man["per_layer"] if trace else man["end_to_end"]
    return [m for m in group if "workloads" not in m or workload in m["workloads"]]


def reader(name: str, bench_dir: Path = BENCH_DIR):
    path = bench_dir / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("bench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
