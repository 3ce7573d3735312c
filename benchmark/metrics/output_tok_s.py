"""output_tok_s: every streamed token a client received inside the window, per second."""

from harness import window


def read(run):
    return window.output_tok_s(run.records, run.t0, run.t1)
