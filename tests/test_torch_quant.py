"""Port quantization vs the JAX package: bitwise on the same numpy weights.

Both packages compute absmax, an IEEE f32 division and round-half-to-even,
so int8 values, f32 scales and packed bytes must be identical."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from starpu_inference_server_tpu.ops import quant as jq
from starpu_inference_server_tpu_torch.ops import quant as tq


def _weights(shape, seed=0):
    w = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    w[:, 3] = 0.0  # an all-zero column takes scale 1
    return w


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("shape", [(64, 48), (130, 7)])
def test_quantize_per_channel_bitwise(bits, shape):
    w = _weights(shape)
    jw, js = jq.quantize_per_channel(jnp.asarray(w), bits=bits)
    tw, ts = tq.quantize_per_channel(torch.from_numpy(w), bits=bits)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        tq.dequantize(tw, ts, torch.float32).numpy(),
        np.asarray(jq.dequantize(jw, js, jnp.float32)),
    )


def test_quantize_activations_bitwise():
    x = _weights((9, 40), seed=1)
    x[2] = 0.0
    jx, jsx = jq.quantize_activations(jnp.asarray(x))
    tx, tsx = tq.quantize_activations(torch.from_numpy(x))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(tsx.numpy(), np.asarray(jsx))


def test_pack_unpack_int4_bitwise_and_roundtrip():
    w_q = np.random.default_rng(2).integers(-7, 8, (64, 33)).astype(np.int8)
    packed = tq.pack_int4(torch.from_numpy(w_q))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jq.pack_int4(jnp.asarray(w_q))))
    np.testing.assert_array_equal(tq.unpack_int4(packed).numpy(), w_q)
    rows = torch.tensor([[0, 1], [63, 17]])
    np.testing.assert_array_equal(tq.unpack_int4_rows(packed, rows).numpy(), w_q[rows.numpy()])
    with pytest.raises(ValueError):
        tq.pack_int4(torch.zeros((3, 2), dtype=torch.int8))


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_and_pack_tree_bitwise(bits):
    rng = np.random.default_rng(3)
    tree = {
        "embed": {"w": rng.standard_normal((16, 8)).astype(np.float32)},
        "layers": [{"norm": {"gamma": np.ones((8,), np.float32)},
                    "proj": {"w": rng.standard_normal((8, 12)).astype(np.float32),
                             "b": np.zeros((12,), np.float32)}}],
        "odd": {"w": rng.standard_normal((5, 4)).astype(np.float32)},
    }
    jt = jax.tree.map(np.asarray, jq.pack_int4_tree(jq.maybe_quantize_tree(tree, bits)))
    from starpu_inference_server_tpu_torch.weights import params_from_numpy

    tt = tq.pack_int4_tree(tq.maybe_quantize_tree(params_from_numpy(tree), bits))

    def flat(node, prefix=""):
        if isinstance(node, dict):
            for k, v in node.items():
                yield from flat(v, f"{prefix}/{k}")
        elif isinstance(node, list):
            for i, v in enumerate(node):
                yield from flat(v, f"{prefix}/{i}")
        else:
            yield prefix, node

    jf, tf = dict(flat(jt)), dict(flat(tt))
    assert jf.keys() == tf.keys()
    for key, jv in jf.items():
        tv = tf[key]
        if isinstance(tv, torch.Tensor):
            np.testing.assert_array_equal(tv.numpy(), jv, err_msg=key)
        else:  # 'bits'
            assert tv == int(jv), key
    if bits == 4:
        assert "w_p4" in tt["embed"]["w"] and "w_q" in tt["odd"]["w"]  # odd K stays unpacked
