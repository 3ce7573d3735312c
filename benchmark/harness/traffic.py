"""The one traffic generator: a traffic file of parameters -> the requests of a run.

A traffic file (``benchmark/traffic/<mix>.json``) states the loop and the
length distributions; this module turns it into the same requests for every
seed but for their token ids. Each length is taken at the midpoints of ``n``
equal quantile bands of its distribution; the pairing of prompt and output
lengths, the order of the requests and the order of the open loop's gaps
are permutations drawn from a constant seed. So every seed's window holds
the same work in the same order, and the seed draws the token ids (and, in
the run, the weights): a window's tail does not follow the order in which
one seed happened to put the bursts.

Keys of a traffic file:

- ``loop``: ``closed`` (``clients`` streaming clients, each sending its next
  request when its previous one has streamed its last token) or ``open``
  (arrivals at ``rate_per_s`` whatever is in flight).
- ``prompt``, ``output``: ``{"dist": "uniform", "min": a, "max": b}``, token
  counts, both ends included. With ``prefixes`` the prompt length is that of
  the user suffix after the shared prefix.
- ``prefixes``: ``{"count": k, "len": n}``: k shared prefixes of n tokens,
  each taken by exactly 1/k of the requests.
- closed loop: ``requests_per_client`` (a client cycles through its share);
  the window opens once every client has completed one request.
- open loop: ``warmup_s`` of arrivals before the window; the window's
  arrivals span exactly the window; gaps at exponential quantiles scaled to
  that span. ``drain_s`` bounds the wait for the window's requests.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

# the pairing of prompt and output quantiles, the order of the requests and
# of the gaps: the same for every seed
ORDER_SEED = 20240607


@dataclasses.dataclass
class Request:
    """One request of the run, in send order for its client (closed loop)
    or in arrival order (open loop)."""

    index: int
    prompt: np.ndarray          # int64 token ids
    max_new_tokens: int
    prefix: int = -1            # shared prefix id, -1 for none
    prefix_len: int = 0
    client: int = 0             # closed loop: the client that sends it
    due: float = 0.0            # open loop: seconds after the schedule's start
    gap: float = 0.0            # open loop: seconds to the next arrival
    phase: str = "window"       # open loop: warmup | window | tail


def quantile_points(spec: dict, n: int) -> np.ndarray:
    """``n`` integer lengths at the midpoints of ``n`` equal quantile bands
    of a ``uniform`` distribution over [min, max]."""
    if spec.get("dist", "uniform") != "uniform":
        raise ValueError(f"unknown length distribution {spec.get('dist')!r}")
    lo, hi = int(spec["min"]), int(spec["max"])
    q = (np.arange(n) + 0.5) / n
    return np.floor(lo + q * (hi + 1 - lo)).astype(np.int64).clip(lo, hi)


def exponential_gaps(n: int, span_s: float) -> np.ndarray:
    """``n`` gaps at the midpoints of ``n`` quantile bands of an exponential
    distribution, scaled so that they add up to ``span_s``."""
    q = (np.arange(n) + 0.5) / n
    g = -np.log1p(-q)
    return g * (span_s / g.sum())


def _length_pairs(traffic: dict, n: int):
    """(prompt or suffix length, output length, prefix id) for ``n``
    requests: a fixed multiset, fixed pairing."""
    prompts = quantile_points(traffic["prompt"], n)
    outputs = quantile_points(traffic["output"], n)
    pair = np.random.default_rng(ORDER_SEED).permutation(n)
    outputs = outputs[pair]
    pre = traffic.get("prefixes")
    prefix_ids = (np.arange(n) % int(pre["count"])) if pre else np.full(n, -1)
    return prompts, outputs, prefix_ids


def request_count(traffic: dict, seconds: float, tail_s: float = 0.0) -> dict:
    """How many requests each phase holds."""
    if traffic["loop"] == "closed":
        return {"total": int(traffic["clients"]) * int(traffic["requests_per_client"])}
    rate = float(traffic["rate_per_s"])
    warm = int(round(rate * float(traffic.get("warmup_s", 0.0))))
    window = max(1, int(round(rate * seconds)))
    tail = int(round(rate * tail_s))
    return {"warmup": warm, "window": window, "tail": tail, "total": warm + window + tail}


def build(traffic: dict, seed: int, vocab: int, seconds: float, tail_s: float = 0.0
          ) -> List[Request]:
    """The run's requests. Token ids are drawn from ``seed`` in [1, vocab);
    the lengths, their order and the gaps are the same for every seed. Open
    loop: each phase (warm-up, window, the traced run's tail) has a
    multiset of its own, so the window's arrivals depend on ``seconds``
    alone."""
    rng = np.random.default_rng(int(seed))
    order_rng = np.random.default_rng(ORDER_SEED + 1)
    counts = request_count(traffic, seconds, tail_s)
    pre = traffic.get("prefixes")
    prefixes = [rng.integers(1, vocab, int(pre["len"]), dtype=np.int64)
                for _ in range(int(pre["count"]))] if pre else []

    def make(n: int, start_index: int, phase: str) -> List[Request]:
        prompts, outputs, prefix_ids = _length_pairs(traffic, n)
        order = order_rng.permutation(n)
        out = []
        for j, i in enumerate(order):
            pid = int(prefix_ids[i])
            body = rng.integers(1, vocab, int(prompts[i]), dtype=np.int64)
            prompt = np.concatenate([prefixes[pid], body]) if pid >= 0 else body
            out.append(Request(index=start_index + j, prompt=prompt,
                               max_new_tokens=int(outputs[i]), prefix=pid,
                               prefix_len=len(prefixes[pid]) if pid >= 0 else 0,
                               phase=phase))
        return out

    if traffic["loop"] == "closed":
        clients = int(traffic["clients"])
        reqs = make(counts["total"], 0, "window")
        for j, r in enumerate(reqs):
            r.client = j % clients
        return reqs
    if traffic["loop"] != "open":
        raise ValueError(f"unknown loop {traffic['loop']!r}")
    rate = float(traffic["rate_per_s"])
    reqs: List[Request] = []
    t = 0.0
    for phase, n, span in (("warmup", counts["warmup"], counts["warmup"] / rate),
                           ("window", counts["window"], seconds),
                           ("tail", counts["tail"], tail_s)):
        if n == 0:
            continue
        part = make(n, len(reqs), phase)
        gaps = order_rng.permutation(exponential_gaps(n, span))
        for r, g in zip(part, gaps):
            r.due, r.gap = t, float(g)
            t += r.gap
        reqs.extend(part)
    return reqs


def window_start(reqs: List[Request]) -> Optional[float]:
    """Open loop: the due time of the window's first arrival."""
    dues = [r.due for r in reqs if r.phase == "window"]
    return min(dues) if dues else None


def describe(traffic: dict) -> str:
    """One line on the mix, for the run's log."""
    if traffic["loop"] == "closed":
        head = f"closed loop, {traffic['clients']} clients"
    else:
        head = f"open loop at {traffic['rate_per_s']} requests/s"
    pre = traffic.get("prefixes")
    shared = f", {pre['count']} prefixes of {pre['len']}" if pre else ""
    p, o = traffic["prompt"], traffic["output"]
    return f"{head}{shared}, prompt {p['min']}-{p['max']}, output {o['min']}-{o['max']}"
