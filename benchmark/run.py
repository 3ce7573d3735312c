"""Run one cell of the port's benchmark once.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cell's GPUs. The last
line of standard output is the result (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and
last ``checks``: each number compared beside its limit); everything else,
the program's log included, goes to standard error, whose last lines are
the same numbers compared. ``--control 1`` also reads the control (the
reference at float8) on the same sample; the benchmark's own runs leave it
off. See ``PERF.md`` for the cells, metrics and limits.
"""

from __future__ import annotations

import time

STARTED = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "benchmark"), str(ROOT)]
# libraries the port may load must not bring JAX in with them
for _var in ("USE_FLAX", "USE_JAX", "USE_TF"):
    os.environ[_var] = "0"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    parser.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    result_out = sys.stdout
    sys.stdout = sys.stderr  # the program's log must not follow the result line

    import torch

    from harness import manifest, runner

    cell = manifest.cell(manifest.manifest(ROOT), args.workload)
    chips = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        runner.log(f"{args.workload} needs {chips} CUDA device(s); "
                   f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    result = runner.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                             torch.device("cuda", 0), STARTED, root=ROOT,
                             control=bool(args.control), chips=chips)
    found = runner.forbidden_loaded()
    if found:
        runner.log("JAX or the JAX package was loaded in this process: " + ", ".join(found))
        return 3
    for name, c in result["checks"].items():
        runner.log(f"compared {name}: {c['value']} (limit {c['limit']})")
    result_out.write(json.dumps(result) + "\n")
    result_out.flush()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
