"""queue_ms.closed: mean wait of the requests admitted in the window, from
submit to admission (a slot and its pages granted), the engine's
``request.queue`` span."""

from harness import span_readers


def read(run):
    return span_readers.mean_ms(run, "request.queue")
