"""admit_share.closed: percent of the window the generation engine spent in
admission (loop_timers["admit"]: _admit_pending, _advance_chunk, _prefill_many)."""

from harness import readers


def read(run):
    return readers.admit_share(run)
