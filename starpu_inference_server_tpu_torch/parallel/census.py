"""Collective census: a program's collectives by the mesh axes their
groups span.

Counterpart of ``starpu_inference_server_tpu/parallel/census.py``, for
the same audit (which collectives ride which axis, so that a layout can
be checked for "the pipe hops and tensor-parallel sums stay on their
axes"). The JAX census reads the partitioned HLO text, one count per
instruction; here every collective call of ``parallel/collectives.py``
is counted as it runs, by (operation, axis), on the rank that makes it,
so a count is per call: a pipelined decode step over M microgroups and
L/S layers a stage shows M hops on ``pipe`` and two sums on ``model``
per layer and microgroup (one per row-parallel projection) on every
rank of a ``model`` group. Rank 0's commands (the ``control`` label)
are not collectives of the program and are left out.

Across launchers (``parallel/mesh.py``), :func:`crossing_calls` keeps the
calls over the axes whose groups hold ranks of more than one launcher
(``RankMesh.crossing``, in every rank's statistics): the JAX census's
question of which collectives ride the host boundary. On the two-tier
shape (data=2 across two launchers x model=4 inside each) that is the
``data`` all-gathers only, and every all-reduce is over ``model``.
"""

from __future__ import annotations

from typing import Dict, Union

from .collectives import CollectiveStats


def collectives_by_axis(stats: Union[CollectiveStats, dict]) -> Dict[str, Dict[str, int]]:
    """``{"all-reduce": {"model": 36}, "collective-permute": {"pipe": 8}}``
    from a rank's :class:`~.collectives.CollectiveStats` (or its
    ``snapshot()``): operation -> axis label (``expert+model`` for a sum
    over both) -> calls."""
    calls = stats.calls if isinstance(stats, CollectiveStats) else {
        tuple(k.split("/", 1)): n for k, n in stats["calls"].items()}
    census: Dict[str, Dict[str, int]] = {}
    for (op, axis), n in sorted(calls.items()):
        if axis == "control" or not n:
            continue
        census.setdefault(op, {})[axis] = n
    return census


def crossing_calls(census: Dict[str, Dict[str, int]], crossing) -> Dict[str, Dict[str, int]]:
    """The part of a :func:`collectives_by_axis` census over the axis labels
    of ``crossing`` (``RankMesh.crossing``: the collectives that cross
    launchers)."""
    out: Dict[str, Dict[str, int]] = {}
    for op, by_axis in census.items():
        kept = {axis: n for axis, n in by_axis.items() if axis in crossing}
        if kept:
            out[op] = kept
    return out
