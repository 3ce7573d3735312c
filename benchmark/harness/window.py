"""The window's arithmetic, on the clients' token timelines alone.

A record is one request as the load generator saw it: ``sent`` (and, in
the open loop, ``due``), the arrival time of every token, ``error`` and
``cancelled``. Every figure covers the whole window; none is a median of
chunks.
"""

from __future__ import annotations

from typing import Iterable, List, Optional

import numpy as np


def p95(values: Iterable[float]) -> Optional[float]:
    vals = list(values)
    return float(np.percentile(np.asarray(vals, dtype=np.float64), 95)) if vals else None


def output_tok_s(records, t0: float, t1: float) -> float:
    """Every token that reached a client inside [t0, t1), per second."""
    n = 0
    for r in records:
        times = r["times"]
        if times and times[0] < t1 and times[-1] >= t0:
            n += sum(1 for t in times if t0 <= t < t1)
    return n / (t1 - t0)


def _window_requests(records, t0: float, t1: float, loop: str) -> List[dict]:
    """Open loop: the window's arrivals; closed loop: the requests sent in
    [t0, t1)."""
    if loop == "open":
        return [r for r in records if r["phase"] == "window"]
    return [r for r in records if t0 <= r["sent"] < t1]


def ttft_ms(records, t0: float, t1: float, loop: str, end: float) -> List[float]:
    """Time to first token of each request of the window, on the client's
    clock: from the due time (open loop) or the send (closed loop). A request
    with no first token by ``end`` counts with its wait until ``end``."""
    out = []
    for r in _window_requests(records, t0, t1, loop):
        start = r["due"] if loop == "open" else r["sent"]
        first = r["times"][0] if r["times"] else end
        out.append((first - start) * 1e3)
    return out


def tpot_ms(records, t0: float, t1: float, loop: str) -> List[float]:
    """(last token - first token) / (tokens - 1) of each complete request:
    the window's arrivals (open loop) or those whose last token lands in
    [t0, t1) (closed loop)."""
    out = []
    for r in records:
        times = r["times"]
        if len(times) < 2 or len(times) < r["max_new"]:
            continue
        if loop == "open" and r["phase"] != "window":
            continue
        if loop == "closed" and not t0 <= times[-1] < t1:
            continue
        out.append((times[-1] - times[0]) * 1e3 / (len(times) - 1))
    return out


def attempted_failed(records, t0: float, t1: float, loop: str):
    """Requests of the window, and those of them that failed: an error, or
    (open loop) no first token by the end of the drain."""
    reqs = _window_requests(records, t0, t1, loop)
    failed = sum(1 for r in reqs if r["error"] is not None
                 or (loop == "open" and not r["times"]))
    return len(reqs), failed
