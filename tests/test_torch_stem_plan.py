"""The grid of the port's fused ResNet stem kernel
(``ops/stem_kernel.py:stem_plan``), on the CPU.

``csrc/fused_stem.cu`` cuts each image into 8 x 7 work items of 7 x 8
pooled outputs. Up to what the card holds at once (two blocks an SM) it
launches one block an item; past that a persistent grid of that many
blocks, each taking every grid-th item, so that a block stages the
weight once and streams the next item's input in while it computes.
These tests hold the plan at the serving batches (1-32 images) and a
few larger ones, on an H100 SXM (132 SMs) and a PCIe card (114).
"""

import re
from pathlib import Path

import pytest

from starpu_inference_server_tpu_torch.ops import stem_kernel as sk

SOURCE = (Path(sk.__file__).resolve().parent.parent / "csrc" / "fused_stem.cu").read_text()


def _constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("batch", list(range(1, 33)) + [48, 64, 128])
def test_every_block_has_work_and_the_card_is_filled(batch, sms):
    blocks = sk.stem_plan(batch, sms)
    items = batch * sk.STEM_ITEMS_PER_IMAGE
    assert blocks == min(items, sk.STEM_BLOCKS_PER_SM * sms)
    # block k takes items k, k + blocks, ...: every item once, every block
    # at least one, and no block more than one item beyond another
    taken = sorted(i for k in range(blocks) for i in range(k, items, blocks))
    assert taken == list(range(items))
    loads = [len(range(k, items, blocks)) for k in range(blocks)]
    assert min(loads) >= 1 and max(loads) - min(loads) <= 1


def test_items_match_the_kernel():
    pooled_rows, pooled_cols = _constant("kPR"), _constant("kPC")
    assert 56 % pooled_rows == 0 and 56 % pooled_cols == 0
    assert sk.STEM_ITEMS_PER_IMAGE == (56 // pooled_rows) * (56 // pooled_cols)


def test_the_planned_blocks_fit_an_sm():
    # shared memory of one block for bf16 output (the served route): the
    # weight, the affine, two patch buffers and the bf16 y tile
    rows = 2 * _constant("kPR") + 1
    cols = 2 * _constant("kPC") + 1
    patch = (rows + 3) * _constant("kZPitch")
    y_tile = rows * cols * (64 + 8) * 2
    smem = 192 * 64 * 2 + 2 * 64 * 4 + 2 * patch + y_tile
    # 228 KB an SM, 1 KB of it reserved per block
    assert sk.STEM_BLOCKS_PER_SM * (smem + 1024) <= 228 * 1024


@pytest.mark.parametrize("batch", [0, -1])
def test_an_empty_batch_has_no_plan(batch):
    with pytest.raises(ValueError):
        sk.stem_plan(batch)
