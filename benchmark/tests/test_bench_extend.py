"""A configuration, a traffic mix, a cell and a per-layer metric are added
with new files and new entries in BENCHMARK.json alone: no file the
benchmark has is edited."""

from __future__ import annotations

import json

from conftest import load, tiny_config

READER = '''"""tokens_generated: tokens the engine generated in the window."""

from harness import readers


def read(run):
    return readers.delta(run, "generated")
'''


def test_a_new_config_mix_cell_and_metric_need_only_new_files(tiny_bench):
    root = tiny_bench.root
    bench = root / "benchmark"
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    cfg = tiny_config(load(bench / "configs" / "mistral-7b-v0.1-int8-paged.json"))
    cfg["name"] = "extra-tiny"  # a dense cache, no prefix reuse
    for key in ("kv_page_size", "kv_pool_pages", "prefix_cache", "prefix_cache_min"):
        cfg["engine"].pop(key)
    (bench / "configs" / "extra-tiny.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "extra_mix.json").write_text(json.dumps({
        "loop": "closed", "clients": 3, "requests_per_client": 6,
        "prompt": {"dist": "uniform", "min": 5, "max": 40},
        "output": {"dist": "uniform", "min": 8, "max": 20}}))
    (bench / "cells" / "extra.cell.json").write_text(json.dumps({"sample_requests": 3,
                                                                 "max_gap": 0.06}))
    (bench / "metrics" / "tokens_generated.py").write_text(READER)
    man = load(root / "BENCHMARK.json")
    man["configs"].append({"name": "extra-tiny", "source": "https://example.org/extra",
                           "file": "benchmark/configs/extra-tiny.json", "reduced": [],
                           "why": "a test"})
    man["workloads"].append({"name": "extra.cell", "config": "extra-tiny",
                             "traffic": "extra_mix", "chips": 1, "why": "a test"})
    setup = next(m for m in man["end_to_end"] if m["name"] == "setup_s")
    man["end_to_end"].append({"name": "extra_tok_s", "unit": "tokens/s", "better": "higher",
                              "bound": 0.25, "source": "host_clock",
                              "workloads": ["extra.cell"]})
    (bench / "metrics" / "extra_tok_s.py").write_text(
        (bench / "metrics" / "output_tok_s.py").read_text())
    man["per_layer"].append({"name": "tokens_generated", "unit": "tokens", "better": "higher",
                             "source": "program_counter", "layer": "generation engine",
                             "moves": "extra_tok_s", "workloads": ["extra.cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    assert all(p.read_bytes() == b for p, b in before.items())
    assert setup in man["end_to_end"]

    res = tiny_bench.run("extra.cell", trace=True, tiny=False)
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"tokens_generated"}
    assert res["metrics"]["tokens_generated"]["value"] > 0
    res = tiny_bench.run("extra.cell", trace=False, tiny=False, seed=5)
    assert set(res["metrics"]) == {"extra_tok_s", "setup_s"}
