"""JAX-free anchor: the port reproduces ci/golden/llama-golden.npz.

The fixture was recorded by scripts/make_golden_fixtures.py: llama-1b
widths (hidden 2048, heads 32/8, intermediate 5504, vocab 32000), 2
layers, seq 64, batch 4, weights from seed 20260820 and token ids from
seed 20260821 (``rng.integers(0, 30522, (4, 64))``, as
utils/input_generator.py draws INT64 ids of width >= 64). The port
rebuilds the model from the seed alone and runs its own forward_logits;
nothing of the JAX package is imported here."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from starpu_inference_server_tpu_torch.models import build_model
from starpu_inference_server_tpu_torch.utils.config import ModelSettings, QuantMode

GOLDEN = Path(__file__).resolve().parent.parent / "ci" / "golden" / "llama-golden.npz"


@pytest.fixture(scope="module")
def golden():
    rec = np.load(GOLDEN)
    meta = json.loads(str(rec["meta"]))
    rng = np.random.default_rng(meta["input_seed"])
    ids = rng.integers(0, 30522, size=(meta["batch"], meta["options"]["seq_len"]),
                       dtype=np.int64)
    return rec, meta, torch.from_numpy(ids)


def _logits(meta, ids, quant):
    torch.manual_seed(0)
    model = build_model(
        ModelSettings(family=meta["family"], compute_dtype="FP32", quantization=quant,
                      options=meta["options"]),
        seed=meta["seed"], device="cpu",
    )
    with torch.no_grad():
        return model.apply({"input_ids": ids})["logits"].numpy()


def test_fp32_logits_reproduce_the_golden_fixture(golden):
    rec, meta, ids = golden
    logits = _logits(meta, ids, QuantMode.NONE)
    np.testing.assert_array_equal(logits.argmax(-1).astype(np.int32), rec["argmax_logits"])
    last = rec["last_logits"]
    # same f32 math as the recording; only summation order differs
    rel = np.abs(logits[:, -1] - last).max() / np.abs(last).mean()
    assert rel < 1e-3, rel


def test_int4_logits_within_golden_drift_gate(golden):
    rec, meta, ids = golden
    logits = _logits(meta, ids, QuantMode.INT4)
    # the drift measure of scripts/accuracy_check.py:160-166 (strided
    # sample, mean |got - rec| / mean |rec|) at its 1e-3 gate
    flat = logits.astype(np.float32).ravel()
    stride = max(1, flat.size // 4096)
    got = flat[::stride][:4096]
    want = rec["q_int4_logits"]
    drift = float((np.abs(got - want) / (np.abs(want).mean() + 1e-9)).mean())
    assert drift <= 1e-3, drift
