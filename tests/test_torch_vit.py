"""The port's ViT against the JAX package's, on the CPU.

ViT-B/16 at full width (dim 768, 12 heads, MLP 3072, 224x224 images,
1000 classes) cut to 2 encoder layers, batch 2, FP32 compute, in every
quant mode, with the kernel routes forced on (the JAX package's Pallas
kernels in interpret mode, the port's plain kernel versions: the int8
matmul on the head's 2 rows) and off. Both packages build the model from
the same seed; ViT-L/16's parameter tree has the JAX package's
structure and shapes, and its first layer the same numbers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from starpu_inference_server_tpu.models import build_model as jax_build
from starpu_inference_server_tpu.models import vit as jvit
from starpu_inference_server_tpu.ops import nn as jnn
from starpu_inference_server_tpu.ops import pallas_kernels as jpk
from starpu_inference_server_tpu.utils.config import ModelSettings as JSettings
from starpu_inference_server_tpu.utils.config import QuantMode as JQuant
from starpu_inference_server_tpu_torch.models import vit as tvit
from starpu_inference_server_tpu_torch.models.registry import build_model, get_family
from starpu_inference_server_tpu_torch.ops import matmul_kernels as tmk
from starpu_inference_server_tpu_torch.ops import nn as tnn
from starpu_inference_server_tpu_torch.utils.config import ModelSettings, QuantMode

OPTS = {"num_layers": 2}


@pytest.fixture(autouse=True)
def reset_switches():
    jpk.set_interpret(True)
    yield
    jpk.set_interpret(False)
    jnn.set_use_pallas(False)
    jnn.set_w8a8(False)
    tnn.set_use_kernels(None)
    tnn.set_w8a8(False)


def _image():
    return np.random.default_rng(2).standard_normal((2, 3, 224, 224)).astype(np.float32)


@pytest.mark.parametrize("kernels", [True, False], ids=["kernels", "plain"])
@pytest.mark.parametrize("quant", ["none", "int8", "int4", "w8a8", "w4a8"])
def test_vit_b_16_matches_jax(quant, kernels):
    jm = jax_build(JSettings(family="vit_b_16", compute_dtype="FP32", quantization=JQuant(quant),
                             options=OPTS), seed=0)
    tm = build_model(ModelSettings(family="vit_b_16", compute_dtype="FP32",
                                   quantization=QuantMode(quant), options=OPTS),
                     seed=0, device="cpu")
    w8a8 = quant in ("w8a8", "w4a8")
    jnn.set_use_pallas(kernels)
    jnn.set_w8a8(w8a8)
    tnn.set_use_kernels(kernels)
    tnn.set_w8a8(w8a8)
    x = _image()
    want = np.asarray(jm.apply({"input": jnp.asarray(x)})["output"])
    with torch.inference_mode():
        got = tm.apply({"input": torch.from_numpy(x)})["output"].numpy()
    assert got.shape == (2, 1000) and np.isfinite(got).all()
    assert (got.argmax(-1) == want.argmax(-1)).all()
    if w8a8:
        # The patch conv and every s8 x s8 contraction are bit-equal to
        # JAX's (tests/test_torch_nn.py), but the layer norms sum in
        # another order: an activation one f32 ulp away from XLA's can
        # round to the neighbouring int8 level of its row (fc1, fc2, the
        # head). Read at 2.4e-3 / 5.8e-3 (W8A8) and 2.2e-4 / 7e-7 (W4A8)
        # mean relative error, kernels on / off; limit 2e-2.
        rel = np.abs(got - want).mean() / np.abs(want).mean()
        assert rel < 2e-2, rel
    else:
        # f32 sums in another order (reads below 3.1e-5 on logits of mean
        # magnitude 0.76)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert tmk.launches["int8_matmul"] == 0  # CPU tensors take the plain version


class _Shape:
    """A stand-in for an initialiser's draw: keeps only its shape."""

    def __init__(self, shape):
        self.shape = tuple(shape)

    def __mul__(self, other):
        return self

    def astype(self, dtype):
        return self


class _ShapeRng:
    def standard_normal(self, shape):
        return _Shape(shape)


def _shapes(tree):
    return jax.tree.map(lambda a: tuple(a.shape), tree,
                        is_leaf=lambda a: isinstance(a, _Shape))


def test_vit_l_16_param_tree_has_the_jax_shapes():
    """ViT-L/16 at its registered depth (24 layers, dim 1024, 16 heads, MLP
    4096): the same tree and leaf shapes as the JAX package's, drawn in
    the same order (a stand-in generator records the draws' shapes)."""
    want = _shapes(jvit._build_vit("vit_l_16", {}).init_params(_ShapeRng()))
    got = _shapes(get_family("vit_l_16").init_params(_ShapeRng()))
    assert got == want
    assert len(got["blocks"]) == 24 and got["patch_embed"]["w"] == (16, 16, 3, 1024)
    assert got["pos_embed"] == (1, 197, 1024) and got["head"]["w"] == (1024, 1000)
    assert got["blocks"][0]["mlp"]["fc1"]["w"] == (1024, 4096)


def test_vit_l_16_first_layer_has_the_same_weights():
    opts = {"num_layers": 1}
    want = jvit._build_vit("vit_l_16", opts).init_params(np.random.default_rng(7))
    got = tvit._build_vit("vit_l_16", opts).init_params(np.random.default_rng(7))
    flat_want, tree_want = jax.tree.flatten(want)
    flat_got, tree_got = jax.tree.flatten(got)
    assert tree_got == tree_want
    assert all(np.array_equal(a, b) for a, b in zip(flat_got, flat_want))
