"""prefix_reuse_share: prefix_tokens_reused over the window divided by the prompt
tokens admitted in it (reused + prefilled), percent."""

from harness import readers


def read(run):
    return readers.prefix_reuse_share(run)
