"""admit_chunk_share.closed: percent of the window the engine spent
dispatching chunked-prefill chunks (the ``admit.chunk`` span, a part of
``admit_share.closed``), host clock."""

from harness import span_readers


def read(run):
    return span_readers.share(run, "admit.chunk")
