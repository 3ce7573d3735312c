"""The window's arithmetic on synthetic token timelines."""

from __future__ import annotations

import numpy as np
import pytest

from harness import window


def rec(sent, times, max_new=None, phase="window", due=None, error=None, cancelled=False):
    return {"sent": sent, "due": sent if due is None else due, "times": list(times),
            "tokens": [1] * len(times), "max_new": len(times) if max_new is None else max_new,
            "phase": phase, "error": error, "cancelled": cancelled}


def steady(n_streams, rate, t_end, stall=None):
    """``n_streams`` streams, one token each every 1/rate s over [0, t_end),
    none during ``stall`` = (a, b)."""
    out = []
    for i in range(n_streams):
        ts = np.arange(i / (rate * n_streams), t_end, 1.0 / rate)
        if stall is not None:
            ts = ts[(ts < stall[0]) | (ts >= stall[1])]
        out.append(rec(0.0, ts))
    return out


def test_output_rate_counts_every_token_in_the_window():
    recs = steady(4, 50.0, 40.0)
    assert window.output_tok_s(recs, 10.0, 30.0) == pytest.approx(200.0, rel=1e-3)


def test_a_stall_inside_the_window_lowers_the_rate():
    plain = window.output_tok_s(steady(4, 50.0, 40.0), 10.0, 30.0)
    stalled = window.output_tok_s(steady(4, 50.0, 40.0, stall=(15.0, 20.0)), 10.0, 30.0)
    assert stalled == pytest.approx(plain * 15.0 / 20.0, rel=1e-2)


def test_tokens_of_unfinished_requests_count_too():
    recs = [rec(9.0, np.arange(9.5, 12.0, 0.1), max_new=500, cancelled=True)]
    assert window.output_tok_s(recs, 10.0, 11.0) == pytest.approx(10.0, abs=1.0)
    assert window.tpot_ms(recs, 10.0, 11.0, "closed") == []


def test_tpot_is_per_request_and_its_p95_over_all_requests():
    recs = [rec(0.0, np.linspace(1.0, 1.0 + 0.02 * 99, 100)) for _ in range(19)]
    recs.append(rec(0.0, np.linspace(1.0, 1.0 + 0.5 * 99, 100)))  # one slow stream
    tp = window.tpot_ms(recs, 0.0, 100.0, "closed")
    assert len(tp) == 20
    assert tp[0] == pytest.approx(20.0)
    assert window.p95(tp) == pytest.approx(np.percentile(tp, 95))
    assert window.p95(tp) > 20.0


def test_closed_loop_tpot_takes_requests_whose_last_token_lands_in_the_window():
    inside = rec(0.0, [5.0, 6.0, 7.0])
    outside = rec(0.0, [5.0, 6.0, 12.0])
    assert window.tpot_ms([inside, outside], 4.0, 10.0, "closed") == [1000.0]


def test_ttft_runs_from_the_due_time_in_the_open_loop_and_counts_the_missing():
    recs = [rec(2.5, [3.0, 3.1], due=2.0), rec(4.0, [], due=4.0, cancelled=True),
            rec(1.0, [1.5], phase="warmup")]
    ttft = window.ttft_ms(recs, 2.0, 10.0, "open", end=20.0)
    assert ttft == pytest.approx([1000.0, 16000.0])
    assert window.attempted_failed(recs, 2.0, 10.0, "open") == (2, 1)


def test_closed_loop_ttft_takes_the_requests_sent_in_the_window():
    recs = [rec(1.0, [2.0]), rec(5.0, [5.25]), rec(11.0, [11.5])]
    assert window.ttft_ms(recs, 4.0, 10.0, "closed", end=20.0) == [250.0]
