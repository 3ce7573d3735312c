"""A configuration file -> the shapes the benchmark counts with, and the
port's server config that serves it.

A configuration file (``benchmark/configs/<name>.json``) holds the model's
published ``config.json`` keys under ``published``, the keys cut to size
under ``reduced`` (with the values run in ``published``), the weight
quantisation, the cache kind and the engine options. The operation and byte
counts here are the yardstick of ``mfu`` and of the rooflines: they follow
from these shapes alone, never from the calls the port makes.
"""

from __future__ import annotations

import dataclasses

# NVIDIA H100 SXM data sheet: dense bf16 tensor-core peak and HBM3 bandwidth
PEAK_BF16_FLOPS = 989.4e12
PEAK_HBM_BYTES_S = 3.35e12

# published keys that are read; every other published key is recorded only
_KEYS = ("hidden_size", "num_hidden_layers", "num_attention_heads", "num_key_value_heads",
         "intermediate_size", "vocab_size", "rope_theta", "rms_norm_eps")


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    hidden: int
    layers: int
    q_heads: int
    kv_heads: int
    intermediate: int
    vocab: int
    rope_theta: float
    rms_norm_eps: float
    weight_bits: int

    @property
    def head_dim(self) -> int:
        return self.hidden // self.q_heads

    @property
    def qkv_out(self) -> int:
        return (self.q_heads + 2 * self.kv_heads) * self.head_dim

    def layer_linear_params(self) -> int:
        h = self.hidden
        return h * self.qkv_out + self.q_heads * self.head_dim * h + h * 2 * self.intermediate \
            + self.intermediate * h

    def linear_params(self, lm_head: bool = True) -> int:
        """Parameters of the matrix products a token passes through."""
        return self.layers * self.layer_linear_params() + (self.hidden * self.vocab if lm_head else 0)

    def weight_bytes(self) -> float:
        """Bytes of every linear weight at its stored width, with one f32 scale
        per output column (the lm head included; the embedding is gathered)."""
        h, i = self.hidden, self.intermediate
        cols = self.layers * (self.qkv_out + h + 2 * i + h) + self.vocab
        return self.linear_params() * self.weight_bits / 8.0 + 4.0 * cols

    def kv_bytes_per_position(self) -> float:
        """int8 K and V of one position in every layer, with their f32
        per-(position, head) scales."""
        return self.layers * 2 * self.kv_heads * (self.head_dim + 4)

    def attn_flops(self, context: float) -> float:
        """Scores and weighted values of one query token over ``context``
        keys, in every layer."""
        return 4.0 * self.layers * self.q_heads * self.head_dim * context

    def token_flops(self, context: float, lm_head: bool = True) -> float:
        """One token through the model at ``context`` keys."""
        return 2.0 * self.linear_params(lm_head) + self.attn_flops(context)


def shape_of(config: dict) -> Shape:
    p = config["published"]
    missing = [k for k in _KEYS if k not in p]
    if missing:
        raise ValueError(f"configuration {config['name']} lacks {missing}")
    bits = {"int4": 4, "int8": 8}[config["quantization"]]
    return Shape(name=config["name"], hidden=int(p["hidden_size"]),
                 layers=int(p["num_hidden_layers"]), q_heads=int(p["num_attention_heads"]),
                 kv_heads=int(p["num_key_value_heads"]),
                 intermediate=int(p["intermediate_size"]), vocab=int(p["vocab_size"]),
                 rope_theta=float(p["rope_theta"]), rms_norm_eps=float(p["rms_norm_eps"]),
                 weight_bits=bits)


def server_config(config: dict, shape: Shape, seed: int, address: str) -> dict:
    """The port's runtime config (its YAML schema, as a mapping) serving
    ``config``: the port's llama-class decoder at these widths, the
    configuration's engine options, no metrics exposer, no monitor."""
    options = dict(config["engine"])
    options.update(hidden=shape.hidden, layers=shape.layers, q_heads=shape.q_heads,
                   kv_heads=shape.kv_heads, intermediate=shape.intermediate, vocab=shape.vocab)
    return {
        "name": config["name"],
        "model": {"family": config["port_family"], "compute_dtype": config["compute_dtype"],
                  "quantization": config["quantization"], "options": options},
        "inputs": [{"name": "input_ids", "dims": [options["max_len"]], "dtype": "INT64"}],
        "outputs": [{"name": "logits", "dims": [options["max_len"], shape.vocab],
                     "dtype": "FP32"}],
        "pool_size": 1,
        "max_batch_size": 1,
        "batch_coalesce_timeout_ms": 0,
        "batching_strategy": "disabled",
        "max_queue_size": 4096,
        "max_inflight_tasks": 1024,
        "metrics_enabled": False,
        "congestion": {"enabled": False},
        "server": {"address": address},
        "seed": int(seed) % (2 ** 31),
        "verbosity": "info",
    }
