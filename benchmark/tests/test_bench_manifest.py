"""BENCHMARK.json against its contract, and every file it names."""

from __future__ import annotations

import re

import pytest
from conftest import REPO, load

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
WIDTHS = re.compile(r"(hidden|intermediate|latent|state|projection|_dim$|_rank$|head|expansion"
                    r"|experts_per_tok)")

MAN = load(REPO / "BENCHMARK.json")
CELLS = [w["name"] for w in MAN["workloads"]]
METRICS = MAN["end_to_end"] + MAN["per_layer"]


def reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def test_top_level_keys_and_command():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert MAN["paths"] == ["benchmark"]
    assert MAN["command"][1].startswith("benchmark/")
    assert 1 <= MAN["run_seconds"] <= 51


@pytest.mark.parametrize("name", [m["name"] for m in METRICS] + CELLS
                         + [c["name"] for c in MAN["configs"]]
                         + [w["traffic"] for w in MAN["workloads"]])
def test_names_use_allowed_characters(name):
    assert NAME.match(name), name


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_entry(metric):
    assert UNIT.match(metric["unit"]), metric["unit"]
    assert metric["better"] in ("lower", "higher")
    assert (REPO / "benchmark" / "metrics" / f"{metric['name']}.py").is_file()
    for cell in metric.get("workloads", []):
        assert cell in CELLS
    if metric in MAN["end_to_end"]:
        assert set(metric) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert set(metric) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert metric["source"] in ("device_trace", "program_span", "program_counter",
                                    "host_clock")
        assert "\n" not in metric["layer"] and 1 <= len(metric["layer"]) <= 200


@pytest.mark.parametrize("metric", MAN["per_layer"], ids=lambda m: m["name"])
def test_moves_target_is_reported_wherever_the_metric_is(metric):
    target = next(m for m in MAN["end_to_end"] if m["name"] == metric["moves"])
    for cell in CELLS:
        if reports(metric, cell):
            assert reports(target, cell), (metric["name"], cell)


@pytest.mark.parametrize("cell", MAN["workloads"], ids=lambda w: w["name"])
def test_every_cell_reports_setup_another_e2e_and_a_layer(cell):
    e2e = [m["name"] for m in MAN["end_to_end"] if reports(m, cell["name"])]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(reports(m, cell["name"]) for m in MAN["per_layer"])
    assert cell["chips"] == 1
    assert len(cell["why"]) <= 200
    assert (REPO / "benchmark" / "traffic" / f"{cell['traffic']}.json").is_file()
    limits = load(REPO / "benchmark" / "cells" / f"{cell['name']}.json")
    assert limits["max_gap"] > 0 and limits["sample_requests"] >= 2


@pytest.mark.parametrize("entry", MAN["configs"], ids=lambda c: c["name"])
def test_config_files(entry):
    cfg = load(REPO / entry["file"])
    assert cfg["name"] == entry["name"]
    assert entry["file"].startswith("benchmark/configs/")
    assert cfg["reduced"] == entry["reduced"]
    assert not [k for k in entry["reduced"] if WIDTHS.search(k)]
    assert (REPO / "benchmark" / cfg["reference"]).is_file()
    assert any(w["config"] == entry["name"] for w in MAN["workloads"])


def test_setup_bound_is_at_most_a_quarter():
    setup = next(m for m in MAN["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] <= 0.25 and "workloads" not in setup
