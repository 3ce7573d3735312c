"""attn_roofline.closed: attention's ideal time (the int8 cache read once, or
the products at the bf16 peak) over its kernels' device time in the traced
slice, percent."""

from harness import readers


def read(run):
    return readers.roofline(run, "attn")
