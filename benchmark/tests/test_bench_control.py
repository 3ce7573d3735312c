"""The control on the card: the reference at float8 activations (one scale
a row), put in the program's place, must fail each cell's limit, while the
program meets it.

Runs every cell at its own size, three seeds each, through
``benchmark/run.py --control 1`` with a short window (about 2 minutes a
seed on one H100): ``python -m pytest benchmark/tests -m cuda``. Skips without a
card.
"""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
from conftest import REPO, load

MAN = load(REPO / "BENCHMARK.json")
SEEDS = (2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("workload", [w["name"] for w in MAN["workloads"]])
def test_the_control_fails_the_limit_the_program_meets(workload, seed):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", workload, "--seed", str(seed),
         "--seconds", "10", "--trace", "0", "--control", "1"],
        capture_output=True, text=True, cwd=str(REPO), timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    checks = res["checks"]
    assert res["correct"], checks
    assert not res["control_correct"], checks
    assert checks["control_max_gap"]["value"] > checks["max_gap"]["limit"]
