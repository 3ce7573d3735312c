"""send_ms.closed: mean time from a first token sampled to its stream
response handed to gRPC (``ModelStreamInfer``), the ``request.send`` span
of the requests whose first response went out in the window."""

from harness import span_readers


def read(run):
    return span_readers.mean_ms(run, "request.send")
