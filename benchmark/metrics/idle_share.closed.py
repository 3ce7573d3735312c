"""idle_share.closed: percent of the traced slice in which no kernel ran."""

from harness import readers


def read(run):
    return readers.idle_share(run)
