"""closed_ttft_p95_ms: the admission queue as the closed loop's clients see it:
95th percentile of send to first token over the requests sent in the window."""

from harness import readers


def read(run):
    return readers.ttft_p95(run) if run.loop == "closed" else None
