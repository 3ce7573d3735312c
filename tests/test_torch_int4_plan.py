"""The quantized matmul kernels' launch plan, on the CPU.

``ops/matmul_kernels.py:matmul_plan`` picks the tile variant and the
split of K that ``csrc/quant_matmul.cuh`` launches int4_matmul (K1),
int8_matmul (K2) and int4_matmul_w4a8 (K6) with; the kernels themselves
run only on the card (``tests/test_torch_cuda_kernels.py``). Here the
plan of each is held, for every dense shape of llama-1b at the rows the
decoder gives it (M = 1 lm_head, 16, the prefill buckets 64-512, decode
128), for the card test's ragged shapes and, for K2, the ResNet-18 fc,
on an H100's 132 SMs, to what the kernel needs: splits that cover K's
k-tiles exactly with none empty, a grid of at least one block per SM
wherever the output tiles alone fall short, and a workspace only when K
is split.
"""

import math
from pathlib import Path

import pytest

from starpu_inference_server_tpu_torch.models import decoder as td
from starpu_inference_server_tpu_torch.ops import matmul_kernels as mk

SMS = 132  # H100 SXM

_spec = td.get_spec("llama-1b", {})
_q, _kv, _d = _spec.q_heads, _spec.kv_heads, _spec.head_dim
LLAMA_1B = {  # layer: (K, N)
    "qkv": (_spec.hidden, (_q + 2 * _kv) * _d),
    "o": (_q * _d, _spec.hidden),
    "gate_up": (_spec.hidden, 2 * _spec.intermediate),
    "down": (_spec.intermediate, _spec.hidden),
    "lm_head": (_spec.hidden, _spec.vocab),
}
CASES = {f"{name}-m{m}": (m, k, n) for name, (k, n) in LLAMA_1B.items()
         for m in (1, 16, 64, 128, 256, 512)}
CASES.update({f"ragged-{m}x{k}x{n}": (m, k, n)
              for m, k, n in ((1, 64, 130), (17, 98, 257), (200, 2048, 384))})
# K2 and K6: the same shapes, K2's card-test edges (M = 63, N % 16 != 0,
# K off the 64-deep stage) and K2's ResNet-18 fc
OTHER_CASES = dict(CASES)
OTHER_CASES.update({f"ragged-{m}x{k}x{n}": (m, k, n)
                    for m, k, n in ((63, 2048, 11000), (17, 5504, 2056), (1, 1000, 2048))})
OTHER_CASES.update({f"fc-m{m}": (m, 512, 1000) for m in (1, 8, 32)})
OTHER = [(kernel, case) for kernel in ("int8_matmul", "int4_matmul_w4a8")
         for case in sorted(OTHER_CASES)]


def _split_range(s, splits, k):
    """The k-tiles split ``s`` sums: csrc/quant_matmul.cuh's kt0 and nk."""
    ktiles = math.ceil(k / mk.QMM_BK)
    return range(s * ktiles // splits, (s + 1) * ktiles // splits)


def _tiles(plan, m, n):
    bm, bn = mk.QMM_TILES[plan.variant]
    return math.ceil(m / bm) * math.ceil(n / bn)


def _check_cover(kernel, m, k, n):
    plan = mk.matmul_plan(kernel, m, n, k, SMS)
    ktiles = math.ceil(k / mk.QMM_BK)
    assert 1 <= plan.splits <= ktiles
    ranges = [_split_range(s, plan.splits, k) for s in range(plan.splits)]
    assert all(len(r) > 0 for r in ranges)  # no split is empty
    assert [t for r in ranges for t in r] == list(range(ktiles))  # each k-tile once, in order


def _check_grid(kernel, m, k, n):
    plan = mk.matmul_plan(kernel, m, n, k, SMS)
    tiles = _tiles(plan, m, n)
    rows = mk.QMM_MAX_ROWS[plan.variant]
    assert rows is None or m <= rows  # the variant takes these rows
    assert plan.variant == 0 or m > mk.QMM_MAX_ROWS[plan.variant - 1]  # ... and is the first that does
    assert plan.grid == tiles * plan.splits
    # one block per SM, unless K has fewer k-tiles than that needs; where
    # the tiles fall short, K is split (a layer whose tiles fill the card
    # may still be split where the cost model gains by it)
    assert plan.grid >= SMS or plan.splits == math.ceil(k / mk.QMM_BK)
    if tiles < SMS:
        assert plan.splits > 1 or math.ceil(k / mk.QMM_BK) == 1


def _check_workspace(kernel, m, k, n):
    plan = mk.matmul_plan(kernel, m, n, k, SMS)
    assert plan.workspace == (plan.splits * m * n if plan.splits > 1 else 0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_splits_cover_the_k_tiles_exactly(case):
    _check_cover("int4_matmul", *CASES[case])


@pytest.mark.parametrize("case", sorted(CASES))
def test_grid_fills_one_wave_where_the_tiles_fall_short(case):
    _check_grid("int4_matmul", *CASES[case])


@pytest.mark.parametrize("case", sorted(CASES))
def test_workspace_only_when_split(case):
    _check_workspace("int4_matmul", *CASES[case])


@pytest.mark.parametrize("kernel,case", OTHER)
def test_int8_and_w4a8_splits_cover_the_k_tiles_exactly(kernel, case):
    _check_cover(kernel, *OTHER_CASES[case])


@pytest.mark.parametrize("kernel,case", OTHER)
def test_int8_and_w4a8_grids_fill_one_wave_where_the_tiles_fall_short(kernel, case):
    _check_grid(kernel, *OTHER_CASES[case])


@pytest.mark.parametrize("kernel,case", OTHER)
def test_int8_and_w4a8_workspace_only_when_split(kernel, case):
    _check_workspace(kernel, *OTHER_CASES[case])


@pytest.mark.parametrize("kernel", ["int8_matmul", "int4_matmul_w4a8"])
def test_decode_steps_of_int8_and_w4a8_fill_the_card(kernel):
    """At the int8 decode batches (16 and 64 slots) and the W4A8 one (16)
    every llama-1b layer launches at least one block per SM: the narrow
    layers through a split of K, where the old kernels ran 32 blocks at
    N = 2048."""
    for m in (16, 64):
        for name, (k, n) in LLAMA_1B.items():
            plan = mk.matmul_plan(kernel, m, n, k, SMS)
            assert plan.grid >= SMS, (m, name, plan)
            assert (plan.splits > 1) == (_tiles(plan, m, n) < SMS)


def test_decode_shapes_split_and_lm_head_does_not():
    """At the decode batch of 128 rows the narrow layers need a split to
    fill the card; the lm_head's 250 tiles do not."""
    plans = {name: mk.matmul_plan("int4_matmul", 128, n, k, SMS)
             for name, (k, n) in LLAMA_1B.items()}
    assert all(plans[name].splits > 1 for name in ("qkv", "o", "gate_up", "down"))
    assert plans["lm_head"].splits == 1 and plans["lm_head"].grid >= SMS
    assert mk.matmul_plan("int4_matmul", 1, 32000, 2048, SMS).variant == 0


def test_kernel_source_sums_splits_without_float_atomics():
    """The split partial sums are added by a second kernel in a fixed
    order, so two calls give the same bits: no atomicAdd in the shared
    body, which K1, K2 and K6 all launch through."""
    csrc = Path(mk.__file__).resolve().parent.parent / "csrc"
    src = (csrc / "quant_matmul.cuh").read_text()
    assert "atomicAdd" not in src
    assert "splitk_reduce" in src
    for name in ("int4_matmul", "int8_matmul", "int4_matmul_w4a8"):
        kernel = (csrc / f"{name}.cu").read_text()
        assert '#include "quant_matmul.cuh"' in kernel and "atomicAdd" not in kernel
