"""BERT encoder family (bert-base-uncased, bert-large-uncased).

Counterpart of ``starpu_inference_server_tpu/models/bert.py``: the same
variants, options (``num_layers``, ``seq_len``, ``vocab_size``),
parameter tree and RNG order, and the same contract: INT64 ``input_ids``
and ``attention_mask`` [S] per sample in, FP32 ``last_hidden_state``
[S, H] out. Post-LN blocks: MHA -> Add&LN -> FFN(GELU) -> Add&LN, layer
norms at eps 1e-12. At S >= 512 the attention runs the bidirectional
attention kernel when kernels are on (``ops/nn.py:_attention``).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..ops import nn
from ..utils.config import TensorSpec
from .registry import ModelDefinition, register_family

# variant -> (hidden, layers, heads, intermediate)
_VARIANTS = {
    "bert-base-uncased": (768, 12, 12, 3072),
    "bert-large-uncased": (1024, 24, 16, 4096),
}

VOCAB_SIZE = 30522
MAX_POSITIONS = 512
TYPE_VOCAB = 2
DEFAULT_SEQ_LEN = 128


def _linear_init(rng: np.random.Generator, cin: int, cout: int) -> Dict[str, Any]:
    return {
        "w": (rng.standard_normal((cin, cout)) * 0.02).astype(np.float32),
        "b": np.zeros((cout,), np.float32),
    }


def _ln_init(dim: int) -> Dict[str, Any]:
    return {"gamma": np.ones((dim,), np.float32), "beta": np.zeros((dim,), np.float32)}


def _layer_init(rng, hidden, intermediate) -> Dict[str, Any]:
    return {
        "attn": {
            "q": _linear_init(rng, hidden, hidden),
            "k": _linear_init(rng, hidden, hidden),
            "v": _linear_init(rng, hidden, hidden),
            "o": _linear_init(rng, hidden, hidden),
        },
        "attn_ln": _ln_init(hidden),
        "ffn": {
            "fc1": _linear_init(rng, hidden, intermediate),
            "fc2": _linear_init(rng, intermediate, hidden),
        },
        "ffn_ln": _ln_init(hidden),
    }


def _layer_apply(p, x, mask, heads, dtype, mesh=None):
    attn_out = nn.multi_head_attention(p["attn"], x, mask, heads, dtype, mesh=mesh)
    x = nn.layer_norm(p["attn_ln"], x + attn_out, eps=1e-12)
    h = nn.dense(p["ffn"]["fc1"], x, dtype)
    h = nn.gelu(h)
    h = nn.dense(p["ffn"]["fc2"], h, dtype, mesh=mesh)
    return nn.layer_norm(p["ffn_ln"], x + h, eps=1e-12)


def _build_bert(variant: str, options) -> ModelDefinition:
    hidden, layers, heads, intermediate = _VARIANTS[variant]
    layers = int(options.get("num_layers", layers))
    seq_len = int(options.get("seq_len", DEFAULT_SEQ_LEN))
    vocab = int(options.get("vocab_size", VOCAB_SIZE))

    def init_params(rng: np.random.Generator):
        return {
            "embeddings": {
                "word": {"w": (rng.standard_normal((vocab, hidden)) * 0.02).astype(np.float32)},
                "position": {
                    "w": (rng.standard_normal((MAX_POSITIONS, hidden)) * 0.02).astype(np.float32)
                },
                "token_type": {
                    "w": (rng.standard_normal((TYPE_VOCAB, hidden)) * 0.02).astype(np.float32)
                },
                "ln": _ln_init(hidden),
            },
            "layers": [_layer_init(rng, hidden, intermediate) for _ in range(layers)],
        }

    def apply(params, inputs, dtype, mesh=None):
        """``mesh``: tensor-parallel over ``model`` (the rank's shard by the
        transformer rules: feature-sharded embeddings gathered before the
        first layer norm, q/k/v and fc1 column-parallel on local heads, o
        and fc2 row-parallel) on the rank's rows of the batch."""
        ids = inputs["input_ids"].to(torch.int64)
        mask = inputs.get("attention_mask")
        b, s = ids.shape
        emb = params["embeddings"]
        x = nn.embedding(emb["word"], ids, dtype)
        positions = torch.arange(s, device=ids.device)
        x = x + nn.embedding(emb["position"], positions, dtype)[None, :, :]
        x = x + nn.embedding(emb["token_type"], torch.zeros_like(ids), dtype)
        x = nn.layer_norm(emb["ln"], nn.gather_features(x, mesh), eps=1e-12)
        for layer in params["layers"]:
            x = _layer_apply(layer, x, mask, heads, dtype, mesh)
        return {"last_hidden_state": x.to(torch.float32)}

    return ModelDefinition(
        family=variant,
        init_params=init_params,
        apply=apply,
        input_specs=(
            TensorSpec("input_ids", (seq_len,), "INT64"),
            TensorSpec("attention_mask", (seq_len,), "INT64"),
        ),
        output_specs=(TensorSpec("last_hidden_state", (seq_len, hidden), "FP32"),),
    )


for _variant in _VARIANTS:
    register_family(_variant)(lambda options, _v=_variant: _build_bert(_v, options))

# aliases of the reference's config naming (models/bert.yml)
register_family("bert")(lambda options: _build_bert("bert-base-uncased", options))
register_family("bert-large")(lambda options: _build_bert("bert-large-uncased", options))
