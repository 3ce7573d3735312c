"""mfu: the model's operations in the window (prompt tokens prefilled, tokens
decoded, attention over each token's context) over window x 989.4 TFLOP/s."""

from harness import readers


def read(run):
    return readers.mfu(run)
