"""setup_s: process start to the window's opening (weights, CUDA libraries, the
server's warm-up and graph capture, the traffic's warm-up)."""


def read(run):
    return run.setup_s
