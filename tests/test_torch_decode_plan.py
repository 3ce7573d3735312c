"""The split plan of the port's decode-side attention kernels
(``ops/decode_attention.py:decode_split_plan``), on the CPU.

The bf16 route of K3, K9-K11 and K12a-d cuts each slot's context into
ranges of whole 64-position tiles when the (KV head, slot) pairs alone
would leave the card short of blocks, and merges the ranges' partials
in order. The plan reads static shapes only, so a CUDA graph of a call
replays with any lengths. These tests hold it at the shapes the configs
give it: 1 to 128 slots, 64 to 1024 positions (a dense cache, or pages
of 16 and 256 rows), windows of 1, 5 and 9 rows, llama-tiny's heads
(4 KV heads, rep 2, head_dim 32) and llama-1b's (8, 4, 64).
"""

import inspect
import math

import numpy as np
import pytest

from starpu_inference_server_tpu_torch.ops import decode_attention as da

HEADS = {"tiny": (4, 2, 32), "llama-1b": (8, 4, 64)}
SLOTS = (1, 4, 16, 64, 128)
POSITIONS = (64, 200, 1024)
WINDOWS = (1, 5, 9)
LAYOUTS = {"dense": None, "page16": 16, "page256": 256}


def _t(t, layout):
    """Positions the kernel sees: a dense cache's T, or the table's
    max_pages * page for a paged cache of the same capacity."""
    page = LAYOUTS[layout]
    return t if page is None else math.ceil(t / page) * page


def _owner(plan, pos):
    return pos // plan.positions


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("heads", sorted(HEADS))
@pytest.mark.parametrize("w", WINDOWS)
@pytest.mark.parametrize("t", POSITIONS)
@pytest.mark.parametrize("s", SLOTS)
def test_every_position_lies_in_exactly_one_split(s, t, w, heads, layout):
    hkv, rep, d = HEADS[heads]
    t = _t(t, layout)
    plan = da.decode_split_plan(s, hkv, t, w, rep, d)
    assert plan.positions % da.DECODE_TILE == 0
    assert 1 <= plan.splits <= math.ceil(t / da.DECODE_TILE)
    # split i owns [i L, (i + 1) L): every position in exactly one, none empty
    owners = np.arange(t) // plan.positions
    assert owners.min() == 0 and owners.max() == plan.splits - 1
    assert sorted(set(owners.tolist())) == list(range(plan.splits))
    assert plan.splits * plan.positions >= t > (plan.splits - 1) * plan.positions
    # one (acc [R, D], max, sum) per split, row and (KV head, slot), or none
    rows = w * rep
    want = plan.splits * s * hkv * rows * (d + 2) if plan.splits > 1 else 0
    assert plan.workspace == want


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("heads", sorted(HEADS))
@pytest.mark.parametrize("s", SLOTS)
def test_one_split_where_the_heads_and_slots_fill_the_card(s, heads, sms):
    hkv, rep, d = HEADS[heads]
    for t in POSITIONS:
        for w in WINDOWS:
            plan = da.decode_split_plan(s, hkv, t, w, rep, d, sms)
            if s * hkv >= da.DECODE_FILL * sms:
                assert plan.splits == 1 and plan.workspace == 0
            else:  # a split short of the fill only where the tiles run out
                assert (s * hkv * plan.splits >= da.DECODE_FILL * sms
                        or plan.splits == math.ceil(t / da.DECODE_TILE))
    if s == 128 and heads == "llama-1b":  # llama_decoder.yml's graphed step: no merge kernel
        assert da.decode_split_plan(s, hkv, 1024, 1, rep, d, sms).splits == 1


def test_the_plan_takes_no_lengths():
    params = list(inspect.signature(da.decode_split_plan).parameters)
    assert params == ["s", "hkv", "t", "w", "rep", "d", "sms"]


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("w", WINDOWS)
@pytest.mark.parametrize("s", (1, 4, 16))
def test_one_plan_serves_any_lengths(s, w, seed):
    """The plan of a shape, drawn once, covers the live positions of any
    lengths: each live position of a slot (< lengths + W, clamped to T)
    falls in a split the launch has, and the splits the merge reads
    (ceil(live / L)) are launched ones."""
    hkv, rep, d = HEADS["llama-1b"]
    t = 1024
    plan = da.decode_split_plan(s, hkv, t, w, rep, d)
    rng = np.random.default_rng(seed)
    for lengths in (rng.integers(0, t - w + 1, s), np.zeros(s, int), np.full(s, t - w)):
        assert da.decode_split_plan(s, hkv, t, w, rep, d) is plan
        for n in np.clip(lengths + w, 1, t):
            live_splits = math.ceil(n / plan.positions)
            assert 1 <= live_splits <= plan.splits
            assert _owner(plan, n - 1) == live_splits - 1


# head dims no body is built for, and no rows; any W * rep is taken (row
# groups), so W = 9 at rep 8 and D = 64 is no longer outside
@pytest.mark.parametrize("d,w,rep", [(48, 1, 4), (16, 1, 1), (512, 1, 1), (64, 1, 0)])
def test_a_shape_outside_the_body_raises(d, w, rep):
    with pytest.raises(ValueError):
        da.decode_split_plan(16, 8, 1024, w, rep, d)
