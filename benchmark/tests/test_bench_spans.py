"""The readers of the engine's own spans on synthetic runs: the counters at
the window's ends (``c0``, ``c1``) as ``engine.loop_timers`` holds them."""

from __future__ import annotations

from types import SimpleNamespace

import pytest
from conftest import REPO

from harness import manifest

SPANS = {"queue_ms.closed": "request.queue", "prefill_ms.closed": "request.prefill",
         "send_ms.closed": "request.send"}


def run_of(c0, c1, seconds=51.0):
    return SimpleNamespace(c0=c0, c1=c1, seconds=seconds)


def read(name, run):
    return manifest.reader(name, REPO / "benchmark")(run)


def counters(**spans):
    """Totals as the engine keeps them: seconds and ``.n`` of each span."""
    out = {"admit": 0.0, "steps": 0}
    for name, (seconds, n) in spans.items():
        key = name.replace("_", ".")
        out[key], out[key + ".n"] = seconds, n
    return out


@pytest.mark.parametrize("metric", sorted(SPANS))
def test_a_mean_span_reads_the_window_s_seconds_over_its_count(metric):
    key = SPANS[metric].replace(".", "_")
    c0 = counters(**{key: (10.0, 40)})
    c1 = counters(**{key: (2510.0, 140)})
    assert read(metric, run_of(c0, c1)) == pytest.approx(1000.0 * 2500.0 / 100)


@pytest.mark.parametrize("metric", sorted(SPANS))
def test_a_mean_span_reads_nothing_where_its_count_did_not_move(metric):
    key = SPANS[metric].replace(".", "_")
    c0 = counters(**{key: (10.0, 40)})
    assert read(metric, run_of(c0, dict(c0))) is None


def test_the_chunk_share_is_its_seconds_over_the_window():
    c0 = counters(admit_chunk=(3.0, 10))
    c1 = counters(admit_chunk=(28.5, 95))
    assert read("admit_chunk_share.closed", run_of(c0, c1)) == pytest.approx(50.0)
    assert read("admit_chunk_share.closed", run_of(c0, dict(c0))) is None


@pytest.mark.parametrize("metric", sorted(SPANS) + ["admit_chunk_share.closed"])
def test_a_program_without_the_spans_reads_nothing(metric):
    """The parent's engine keeps only the old loop timers."""
    old = {"admit": 1.0, "step": 2.0, "land": 0.1, "dispatch": 1.0, "consume": 1.0,
           "steps": 10, "reused": 0, "hits": 0, "generated": 0, "replays": 0}
    later = {k: v * 2 for k, v in old.items()}
    assert read(metric, run_of(old, later)) is None
