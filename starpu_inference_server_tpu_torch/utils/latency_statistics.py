"""Latency percentile helpers.

Counterpart of ``starpu_inference_server_tpu/utils/latency_statistics.py``,
unchanged: the client summary-JSON fields mean / p50 / p85 / p95 / p100
(reference: src/core/latency_statistics.hpp and
src/grpc/client/inference_client.hpp:30-67).
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

SUMMARY_PERCENTILES = (50, 85, 95, 100)


def percentile(samples: Sequence[float], pct: float) -> float:
    if not len(samples):
        return 0.0
    return float(np.percentile(np.asarray(samples, dtype=np.float64), pct))


def summarize(samples: Sequence[float]) -> Dict[str, float]:
    """mean/p50/p85/p95/p100 summary matching the reference client's
    write_summary_json fields (inference_client.cpp:277-360)."""
    if not len(samples):
        return {"mean": 0.0, **{f"p{p}": 0.0 for p in SUMMARY_PERCENTILES}}
    arr = np.asarray(samples, dtype=np.float64)
    out = {"mean": float(arr.mean())}
    for p in SUMMARY_PERCENTILES:
        out[f"p{p}"] = float(np.percentile(arr, p))
    return out
