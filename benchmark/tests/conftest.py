"""Helpers of the benchmark's CPU tests: the harness on the CPU at tiny
widths, from a copy of the benchmark in a temporary directory.

Run them with ``python -m pytest benchmark/tests -q``; the test marked
``cuda`` runs on the card only (``python -m pytest benchmark/tests -m cuda``).
"""

from __future__ import annotations

import json
import shutil
import sys
import time
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(REPO / "benchmark"), str(REPO)]

# the widest gap allowed at the tiny widths: sound tiny runs of the paged cell
# read 0.017-0.019, its per-row float8 control 0.105-0.145 (CPU runs of the
# harness at these widths, three seeds)
TINY_MAX_GAP = 0.06
# every width of a configuration cut to a size the CPU runs in seconds
TINY = {"hidden_size": 128, "num_hidden_layers": 2, "num_attention_heads": 4,
        "num_key_value_heads": 2, "intermediate_size": 256, "vocab_size": 512}


def load(path: Path) -> dict:
    return json.loads(path.read_text())


def tiny_config(cfg: dict) -> dict:
    cfg = json.loads(json.dumps(cfg))
    cfg["published"].update(TINY)
    eng = cfg["engine"]
    eng["num_slots"] = 8
    if eng.get("kv_pool_pages"):
        eng["kv_pool_pages"] = 8 * 3 + 4 + 1
    return cfg


def tiny_traffic(mix: dict) -> dict:
    mix = json.loads(json.dumps(mix))
    if mix["loop"] == "closed":
        mix.update(clients=6, requests_per_client=8)
        mix["output"] = {"dist": "uniform", "min": 16, "max": 48}
        if "prefixes" in mix:
            mix["prefixes"]["len"] = 256
            mix["prompt"] = {"dist": "uniform", "min": 8, "max": 60}
        else:
            mix["prompt"] = {"dist": "uniform", "min": 10, "max": 100}
    else:
        mix.update(rate_per_s=2.0, warmup_s=2, drain_s=60)
        mix["prompt"] = {"dist": "uniform", "min": 260, "max": 400}
        mix["output"] = {"dist": "uniform", "min": 8, "max": 24}
    return mix


class TinyBench:
    """A copy of the benchmark under ``tmp`` whose traffic is cut to tiny
    sizes; :meth:`run` drives one cell on the CPU with the tiny
    configuration."""

    def __init__(self, tmp: Path):
        self.root = tmp / "checkout"
        bench = self.root / "benchmark"
        bench.mkdir(parents=True)
        for d in ("metrics", "reference", "cells", "traffic", "configs"):
            shutil.copytree(REPO / "benchmark" / d, bench / d)
        shutil.copy(REPO / "BENCHMARK.json", self.root / "BENCHMARK.json")
        for f in (bench / "traffic").glob("*.json"):
            f.write_text(json.dumps(tiny_traffic(load(f))))
        for f in (bench / "cells").glob("*.json"):
            f.write_text(json.dumps(dict(load(f), max_gap=TINY_MAX_GAP)))
        self.manifest = load(self.root / "BENCHMARK.json")

    def config_of(self, workload: str) -> dict:
        cell = next(w for w in self.manifest["workloads"] if w["name"] == workload)
        entry = next(c for c in self.manifest["configs"] if c["name"] == cell["config"])
        return tiny_config(load(self.root / entry["file"]))

    def run(self, workload: str, seed: int = 2 ** 31 + 77, seconds: float = 6.0,
            trace: bool = False, control: bool = False, tiny: bool = True) -> dict:
        """``tiny`` False runs the configuration file as it is."""
        import torch

        from harness import runner

        cfg = self.config_of(workload) if tiny else None
        return runner.run_cell(workload, seed, seconds, trace, torch.device("cpu"),
                               time.monotonic(), root=self.root, config=cfg, control=control)


@pytest.fixture
def tiny_bench(tmp_path):
    return TinyBench(tmp_path)
