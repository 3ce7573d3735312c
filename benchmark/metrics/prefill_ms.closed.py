"""prefill_ms.closed: mean time from admission to the first token sampled
(lookup, grant, chunks, landing) of the requests that got their first
token in the window, the engine's ``request.prefill`` span."""

from harness import span_readers


def read(run):
    return span_readers.mean_ms(run, "request.prefill")
