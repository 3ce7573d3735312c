"""The traffic generator: the same work for every seed."""

from __future__ import annotations

import collections

import numpy as np
import pytest
from conftest import REPO, load

from harness import loadgen, traffic

MAN = load(REPO / "BENCHMARK.json")
CELLS = MAN["workloads"]
SEEDS = (1, 2 ** 31 + 5)


def mix_of(cell):
    return load(REPO / "benchmark" / "traffic" / f"{cell['traffic']}.json")


def multiset(reqs, phase=None):
    return collections.Counter((len(r.prompt), r.max_new_tokens, r.prefix_len) for r in reqs
                               if phase is None or r.phase == phase)


@pytest.mark.parametrize("cell", CELLS, ids=lambda w: w["name"])
def test_two_seeds_give_the_same_multiset_of_lengths_and_gaps(cell):
    mix = mix_of(cell)
    a, b = (traffic.build(mix, s, 32000, 30.0, 4.0) for s in SEEDS)
    assert multiset(a) == multiset(b)
    for phase in ("warmup", "window", "tail"):
        assert multiset(a, phase) == multiset(b, phase)
    if mix["loop"] == "open":
        for phase in ("warmup", "window", "tail"):
            ga = sorted(r.gap for r in a if r.phase == phase)
            gb = sorted(r.gap for r in b if r.phase == phase)
            assert np.allclose(ga, gb)
        window = [r.due for r in a if r.phase == "window"]
        tail = [r.due for r in a if r.phase == "tail"]
        assert tail[0] - window[0] == pytest.approx(30.0)
    # the same order for every seed; the token ids change with it
    assert [(len(r.prompt), r.max_new_tokens, r.due) for r in a] == \
        [(len(r.prompt), r.max_new_tokens, r.due) for r in b]
    assert any((ra.prompt != rb.prompt).any() for ra, rb in zip(a, b))


@pytest.mark.parametrize("cell", CELLS, ids=lambda w: w["name"])
def test_lengths_stay_in_their_ranges_and_fit_the_engine(cell):
    mix = mix_of(cell)
    cfg = load(REPO / next(c["file"] for c in MAN["configs"] if c["name"] == cell["config"]))
    reqs = traffic.build(mix, 7, cfg["published"]["vocab_size"], 30.0, 4.0)
    pre = mix.get("prefixes", {}).get("len", 0)
    window = cfg["published"].get("sliding_window")
    for r in reqs:
        assert mix["prompt"]["min"] + pre <= len(r.prompt) <= mix["prompt"]["max"] + pre
        assert mix["output"]["min"] <= r.max_new_tokens <= mix["output"]["max"]
        assert len(r.prompt) + r.max_new_tokens <= cfg["engine"]["max_len"]
        if window:  # every context inside the sliding window: it has no effect
            assert len(r.prompt) + r.max_new_tokens <= window
        assert r.prompt.min() >= 1 and r.prompt.max() < cfg["published"]["vocab_size"]


def test_shared_prefixes_each_take_a_quarter():
    cell = next(c for c in CELLS if "sharedprefix" in c["name"])
    reqs = traffic.build(mix_of(cell), 11, 32000, 30.0)
    n = mix_of(cell)["prefixes"]["len"]
    counts = collections.Counter(tuple(r.prompt[:n]) for r in reqs)
    assert sorted(counts.values()) == [len(reqs) // 4] * 4


def test_requests_carry_no_eos_and_are_greedy():
    gen = loadgen.LoadGen.__new__(loadgen.LoadGen)
    gen.spec = {"model": "m"}
    gen.pb = loadgen._pb()
    req = traffic.Request(index=3, prompt=np.arange(1, 9), max_new_tokens=17)
    msg = gen.message(req)
    assert set(msg.parameters) == {"max_new_tokens"}
    assert msg.parameters["max_new_tokens"].int64_param == 17
    assert list(msg.inputs[0].shape) == [1, 8]


def test_quantile_points_are_the_band_midpoints():
    pts = traffic.quantile_points({"dist": "uniform", "min": 0, "max": 9}, 10)
    assert list(pts) == list(range(10))
    gaps = traffic.exponential_gaps(50, 20.0)
    assert gaps.sum() == pytest.approx(20.0) and np.all(np.diff(gaps) > 0)
