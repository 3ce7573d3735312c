"""Readers of the generation engine's own spans (``engine.loop_timers``:
host seconds under a span's name and, under ``<name>.n``, how many ended),
read as differences across the window's ends. Each returns None where the
span's count did not move, or where the program keeps no such span."""

from __future__ import annotations


def _delta(run, key: str):
    if key not in run.c0 or key not in run.c1:
        return None
    return run.c1[key] - run.c0[key]


def mean_ms(run, name: str):
    """Mean milliseconds of the ``name`` spans that ended in the window."""
    n = _delta(run, name + ".n")
    if not n:
        return None
    return 1000.0 * _delta(run, name) / n


def share(run, name: str):
    """Percent of the window spent in ``name`` spans (host clock)."""
    if not _delta(run, name + ".n"):
        return None
    return 100.0 * _delta(run, name) / run.seconds
