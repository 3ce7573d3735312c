"""gemm_roofline.closed: the linear layers' ideal time (weights once a step
or pass at their stored width, or the products at the bf16 peak) over their
kernels' device time in the traced slice, percent."""

from harness import readers


def read(run):
    return readers.roofline(run, "gemm")
