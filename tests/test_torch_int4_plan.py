"""int4_matmul's launch plan, on the CPU.

``ops/matmul_kernels.py:int4_matmul_plan`` picks the tile variant and the
split of K that ``csrc/int4_matmul.cu`` launches with; the kernel itself
runs only on the card (``tests/test_torch_cuda_kernels.py``). Here the
plan is held, for every dense shape of llama-1b at the rows the decoder
gives it (M = 1 lm_head, 16, the prefill buckets 64-512, decode 128) and
for the card test's ragged shapes, on an H100's 132 SMs, to what the
kernel needs: splits that cover K's k-tiles exactly with none empty, a
grid of at least one block per SM wherever the output tiles alone fall
short, and a workspace only when K is split.
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


def _split_range(s, splits, k):
    """The k-tiles split ``s`` sums: csrc/int4_matmul.cu's kt0 and nk."""
    ktiles = math.ceil(k / mk.INT4_BK)
    return range(s * ktiles // splits, (s + 1) * ktiles // splits)


def _tiles(plan, m, n):
    bm, bn = mk.INT4_TILES[plan.variant]
    return math.ceil(m / bm) * math.ceil(n / bn)


@pytest.mark.parametrize("case", sorted(CASES))
def test_splits_cover_the_k_tiles_exactly(case):
    m, k, n = CASES[case]
    plan = mk.int4_matmul_plan(m, n, k, SMS)
    ktiles = math.ceil(k / mk.INT4_BK)
    assert 1 <= plan.splits <= ktiles
    ranges = [_split_range(s, plan.splits, k) for s in range(plan.splits)]
    assert all(len(r) > 0 for r in ranges)  # no split is empty
    assert [t for r in ranges for t in r] == list(range(ktiles))  # each k-tile once, in order


@pytest.mark.parametrize("case", sorted(CASES))
def test_grid_fills_one_wave_where_the_tiles_fall_short(case):
    m, k, n = CASES[case]
    plan = mk.int4_matmul_plan(m, n, k, SMS)
    tiles = _tiles(plan, m, n)
    bm, _ = mk.INT4_TILES[plan.variant]
    assert m <= bm or plan.variant == len(mk.INT4_TILES) - 1  # the rows fit one tile, or the largest
    assert plan.variant == 0 or m > mk.INT4_TILES[plan.variant - 1][0]  # ... and the smallest that fits
    assert plan.grid == tiles * plan.splits
    if tiles >= SMS:
        assert plan.splits == 1
    else:  # one block per SM, unless K has fewer k-tiles than that needs
        assert plan.grid >= SMS or plan.splits == math.ceil(k / mk.INT4_BK)
        assert plan.splits > 1 or math.ceil(k / mk.INT4_BK) == 1


@pytest.mark.parametrize("case", sorted(CASES))
def test_workspace_only_when_split(case):
    m, k, n = CASES[case]
    plan = mk.int4_matmul_plan(m, n, k, SMS)
    assert plan.workspace == (plan.splits * m * n if plan.splits > 1 else 0)


def test_decode_shapes_split_and_lm_head_does_not():
    """At the decode batch of 128 rows the narrow layers need a split to
    fill the card; the lm_head's 250 tiles do not."""
    plans = {name: mk.int4_matmul_plan(128, n, k, SMS) for name, (k, n) in LLAMA_1B.items()}
    assert all(plans[name].splits > 1 for name in ("qkv", "o", "gate_up", "down"))
    assert plans["lm_head"].splits == 1 and plans["lm_head"].grid >= SMS
    assert mk.int4_matmul_plan(1, 32000, 2048, SMS).variant == 0


def test_kernel_source_sums_splits_without_float_atomics():
    """The split partial sums are added by a second kernel in a fixed
    order, so two calls give the same bits: no atomicAdd in the source."""
    src = (Path(mk.__file__).resolve().parent.parent / "csrc" / "int4_matmul.cu").read_text()
    assert "atomicAdd" not in src
    assert "int4_splitk_reduce" in src
