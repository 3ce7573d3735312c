"""The arithmetic behind the metric readers (``benchmark/metrics/*.py``),
on a ``bench.runner.Run``. Each returns None where it finds nothing to
read, and a share of a roofline or a peak is never clipped."""

from __future__ import annotations

from . import window, work
from .model import PEAK_BF16_FLOPS


def delta(run, key: str) -> float:
    return run.c1[key] - run.c0[key]


def ttft_p95(run):
    return window.p95(window.ttft_ms(run.records, run.t0, run.t1, run.loop, run.end))


def admit_share(run):
    """Percent of the window the engine loop spent admitting (host clock)."""
    return 100.0 * delta(run, "admit") / run.seconds


def prefix_reuse_share(run):
    """Percent of the prompt tokens admitted in the window that a cached
    prefix served."""
    if run.spans is None:
        return None
    _, prefills = run.spans.between(run.t0, run.t1)
    reused = delta(run, "reused")
    total = reused + sum(rows for rows, _ in prefills)
    return 100.0 * reused / total if total else None


def mfu(run):
    """The model's operations in the window over the window at the dense
    bf16 peak, percent."""
    if run.spans is None:
        return None
    blocks, prefills = run.spans.between(run.t0, run.t1)
    t = work.tally(run.shape, blocks, prefills)
    flops = t["gemm_flops"] + t["attn_flops"]
    return 100.0 * flops / (run.seconds * PEAK_BF16_FLOPS) if flops else None


def roofline(run, layer: str):
    """Ideal seconds of the traced slice's ``layer`` work over its kernels'
    device seconds, percent."""
    if run.profile is None or run.spans is None:
        return None
    device_s = run.profile.get("by_layer", {}).get(layer, 0.0)
    if device_s <= 0:
        return None
    blocks, prefills = run.spans.between(*run.slice_t)
    t = work.tally(run.shape, blocks, prefills, prefill_attention=not run.paged)
    ideal = t[f"{layer}_ideal_s"]
    return 100.0 * ideal / device_s if ideal else None


def idle_share(run):
    """Percent of the traced slice in which no kernel ran on the device (the
    slice and the busy time both on the trace's clock)."""
    if run.profile is None or not run.profile.get("window_s") or not run.profile.get("kernels"):
        return None
    return 100.0 * (1.0 - run.profile["busy_s"] / run.profile["window_s"])
