"""The plain reference against the port's CPU path, at a tiny width of each
configuration, on the benchmark's own weight tree."""

from __future__ import annotations

import pytest
import torch
from conftest import REPO, load, tiny_config

from harness import check, model, weights

MAN = load(REPO / "BENCHMARK.json")
CONFIGS = [tiny_config(load(REPO / c["file"])) for c in MAN["configs"]]


def reference_module(cfg):
    return check.load_reference(REPO, cfg)


def port_spec(shape):
    from starpu_inference_server_tpu_torch.models.decoder import DecoderSpec

    return DecoderSpec(hidden=shape.hidden, layers=shape.layers, q_heads=shape.q_heads,
                       kv_heads=shape.kv_heads, intermediate=shape.intermediate,
                       vocab=shape.vocab)


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: c["name"])
def test_reference_equals_the_port_forward_without_the_cache_rounding(cfg, monkeypatch):
    """Without the int8 cache round trip, the reference's f32 logits are
    the port's f32 teacher-forced forward on the same tree."""
    from starpu_inference_server_tpu_torch.models.decoder import forward_logits

    shape = model.shape_of(cfg)
    tree = weights.make(shape, 5, torch.device("cpu"))
    ref = reference_module(cfg)
    monkeypatch.setattr(ref, "_int8_round_trip", lambda x: x)
    ids = torch.randint(1, shape.vocab, (2, 40), generator=torch.Generator().manual_seed(1))
    want = forward_logits(port_spec(shape), tree, ids, torch.float32)
    got = ref.logits(tree, shape, [ids[0], ids[1]], [0, 0], torch.device("cpu"))
    for i in range(2):
        assert torch.allclose(got[i], want[i], atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: c["name"])
def test_reference_follows_the_port_s_cached_decode(cfg):
    """Prefill through the port's int8 cache, then teacher-forced decode
    steps: the reference's logits at those positions agree within the
    in-prompt cache rounding the port leaves out of its prefill."""
    from starpu_inference_server_tpu_torch.models.decoder import decode_step, init_cache, prefill

    shape = model.shape_of(cfg)
    spec = port_spec(shape)
    tree = weights.make(shape, 9, torch.device("cpu"))
    seq = torch.randint(1, shape.vocab, (48,), generator=torch.Generator().manual_seed(2))
    p = 32
    cache = init_cache(spec, 1, 64)
    _, first = prefill(spec, tree, cache, seq[:p], p, 0, torch.float32)
    port = [first]
    for t in range(p, len(seq)):
        _, lg = decode_step(spec, tree, cache, seq[t:t + 1].to(torch.int32),
                            torch.ones(1, dtype=torch.bool), torch.float32)
        port.append(lg[0])
    port = torch.stack(port)[:-1]
    ref = reference_module(cfg).logits(tree, shape, [seq[:-1]], [p - 1], torch.device("cpu"))[0]
    assert ref.shape == port.shape
    scale = ref.abs().max()
    assert (ref - port).abs().max() < 0.05 * scale


def test_the_gap_of_the_reference_s_own_greedy_tokens_is_zero():
    cfg = CONFIGS[0]
    shape = model.shape_of(cfg)
    tree = weights.make(shape, 3, torch.device("cpu"))
    ref = reference_module(cfg)
    prompt = torch.randint(1, shape.vocab, (20,), generator=torch.Generator().manual_seed(4))
    lg = ref.logits(tree, shape, [prompt], [19], torch.device("cpu"))[0]
    tok = int(lg[-1].argmax())
    picked = [{"index": 0, "tokens": [tok]}]
    out = check.gaps(ref, tree, shape, {0: prompt.numpy()}, picked, torch.device("cpu"))
    assert out["max_gap"] == 0.0
    wrong = [{"index": 0, "tokens": [int(lg[-1].argmin())]}]
    assert check.gaps(ref, tree, shape, {0: prompt.numpy()}, wrong,
                      torch.device("cpu"))["max_gap"] > 1.0
