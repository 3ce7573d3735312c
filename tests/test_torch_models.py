"""The port's BERT and ResNet against the JAX package's, on the CPU.

Both packages build the model from the same seed (the same numpy
weights, quantized by each package's own code), run the same numpy
inputs, with the kernel routes forced on (the JAX package's Pallas
kernels in interpret mode, the port's plain kernel versions) and off.
BERT-base runs at full width, 2 layers, s = 512 (so the attention takes
the bidirectional-attention gate) and a small vocabulary; ResNet-18 at
full size, batch 2, with the unfused and the fused stem."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from starpu_inference_server_tpu.models import build_model as jax_build
from starpu_inference_server_tpu.ops import nn as jnn
from starpu_inference_server_tpu.ops import pallas_kernels as jpk
from starpu_inference_server_tpu.ops import prefill_attention as jpa
from starpu_inference_server_tpu.ops import stem_kernel as jsk
from starpu_inference_server_tpu.utils.config import ModelSettings as JSettings
from starpu_inference_server_tpu.utils.config import QuantMode as JQuant
from starpu_inference_server_tpu_torch.models import resnet
from starpu_inference_server_tpu_torch.models.registry import build_model
from starpu_inference_server_tpu_torch.ops import matmul_kernels as tmk
from starpu_inference_server_tpu_torch.ops import nn as tnn
from starpu_inference_server_tpu_torch.ops import prefill_attention as tpa
from starpu_inference_server_tpu_torch.ops import stem_kernel as tsk
from starpu_inference_server_tpu_torch.utils.config import ModelSettings, QuantMode

BERT_OPTS = {"num_layers": 2, "seq_len": 512, "vocab_size": 1024}


@pytest.fixture(autouse=True)
def reset_switches():
    for mod in (jpk, jpa, jsk):
        mod.set_interpret(True)
    yield
    for mod in (jpk, jpa, jsk):
        mod.set_interpret(False)
    jnn.set_use_pallas(False)
    jnn.set_w8a8(False)
    tnn.set_use_kernels(None)
    tnn.set_w8a8(False)


def _run_both(family, quant, options, inputs, kernels):
    """(port output, JAX output) as numpy, FP32 compute."""
    jm = jax_build(JSettings(family=family, compute_dtype="FP32", quantization=JQuant(quant),
                             options=options), seed=0)
    tm = build_model(ModelSettings(family=family, compute_dtype="FP32",
                                   quantization=QuantMode(quant), options=options),
                     seed=0, device="cpu")
    w8a8 = quant == "w8a8"
    jnn.set_use_pallas(kernels)
    jnn.set_w8a8(w8a8)
    tnn.set_use_kernels(kernels)
    tnn.set_w8a8(w8a8)
    name = jm.definition.output_specs[0].name
    want = np.asarray(jm.apply({k: jnp.asarray(v) for k, v in inputs.items()})[name])
    with torch.inference_mode():
        got = tm.apply({k: torch.from_numpy(v) for k, v in inputs.items()})[name].numpy()
    return got, want


def _bert_inputs():
    rng = np.random.default_rng(1)
    ids = rng.integers(0, BERT_OPTS["vocab_size"], (2, 512)).astype(np.int64)
    mask = np.ones((2, 512), np.int64)
    mask[1, 300:] = 0  # a padded sample
    return {"input_ids": ids, "attention_mask": mask}


@pytest.mark.parametrize("kernels", [True, False], ids=["kernels", "plain"])
@pytest.mark.parametrize("quant", ["none", "int8", "w8a8"])
def test_bert_base_matches_jax(quant, kernels):
    before = tpa.launches["bidirectional_attention"]
    got, want = _run_both("bert-base-uncased", quant, BERT_OPTS, _bert_inputs(), kernels)
    assert got.shape == (2, 512, 768) and np.isfinite(got).all()
    if quant == "w8a8":
        # the per-row int8 activation quantization is exact in both, but an
        # activation whose f32 value differs in its last bit (sums in
        # another order) may round to the neighbouring int8 level: one
        # quantum (1/127 of the row max) moves at that element. A few
        # percent of outputs move by such flips (max ~0.02 of values
        # O(1)); the mean stays at the f32 noise level.
        rel = np.abs(got - want).mean() / np.abs(want).mean()
        assert rel < 5e-4, rel
        assert np.abs(got - want).max() < 5e-2
    else:
        # the JAX package's own BERT tolerance (test_bidirectional_attention.py),
        # on every row: padding rows attend the valid keys in both packages
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    assert tpa.launches["bidirectional_attention"] == before  # CPU never launches


def _image():
    return np.random.default_rng(2).standard_normal((2, 3, 224, 224)).astype(np.float32)


# the fused stem is a kernel route: with kernels off both packages take
# the s2d stem, so that case would repeat the plain s2d one
@pytest.mark.parametrize("kernels,stem", [(True, "s2d"), (True, "fused"), (False, "s2d")],
                         ids=["kernels-s2d", "kernels-fused", "plain-s2d"])
@pytest.mark.parametrize("quant", ["none", "int8"])
def test_resnet18_matches_jax(quant, kernels, stem):
    opts = {"stem_fused": stem == "fused"}
    got, want = _run_both("resnet18", quant, opts, {"input": _image()}, kernels)
    assert got.shape == (2, 1000) and np.isfinite(got).all()
    # f32 convs summed in another order through 20 layers; logits are
    # O(1), so 1e-3 of their mean magnitude is far above that noise
    scale = np.abs(want).mean()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3 * scale)
    assert (got.argmax(-1) == want.argmax(-1)).all()
    assert tmk.launches["int8_matmul"] == 0 and tsk.launches["fused_stem"] == 0


def _xla_rsqrt(t):
    """XLA:CPU's f32 rsqrt (vrsqrtps and two FMA Newton steps), which is
    within an ulp of the correctly rounded 1/sqrt that torch.rsqrt gives."""
    return torch.from_numpy(np.asarray(jax.lax.rsqrt(jnp.asarray(t.numpy()))).copy())


@pytest.mark.parametrize("kernels", [True, False], ids=["kernels", "plain"])
@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_resnet18_w8a8_matches_jax(monkeypatch, layout, kernels):
    """ResNet-18 W8A8 at full width, batch 2, on the NCHW and the NHWC
    wire. Every conv is the exact s8 x s8 conv with one activation scale
    over the batch, in both packages. The one difference is the batch
    norm's rsqrt: XLA:CPU's is one ulp off the correctly rounded value in
    a tenth of inputs (here rsqrt(1 + 1e-5)), every activation moves by an
    ulp, and the per-tensor requantization of the next conv turns some
    into neighbouring int8 levels. With XLA's rsqrt in the port's batch
    norm the logits agree to f32 noise (read 1.1e-7 mean relative, limit
    1e-5); with the port's own, within 2e-2 (read 3.3e-3 / 7.2e-3,
    kernels on / off), with the argmax equal."""
    img = _image()
    if layout == "NHWC":
        img = np.ascontiguousarray(img.transpose(0, 2, 3, 1))
    opts = {"input_layout": layout}
    got, want = _run_both("resnet18", "w8a8", opts, {"input": img}, kernels)
    assert got.shape == (2, 1000) and np.isfinite(got).all()
    assert (got.argmax(-1) == want.argmax(-1)).all()
    rel = np.abs(got - want).mean() / np.abs(want).mean()
    assert rel < 2e-2, rel
    monkeypatch.setattr(torch, "rsqrt", _xla_rsqrt)
    got, want = _run_both("resnet18", "w8a8", opts, {"input": img}, kernels)
    rel = np.abs(got - want).mean() / np.abs(want).mean()
    assert rel < 1e-5, rel
    assert (got.argmax(-1) == want.argmax(-1)).all()


def test_fused_stem_matches_the_unfused_stem():
    """The JAX package's own check (test_stem_kernel.py) on the port:
    the fused stem (bf16 stem weights) against the s2d stem in f32."""
    x = torch.from_numpy(_image())
    outs = {}
    for fused in (False, True):
        m = build_model(ModelSettings(family="resnet18", compute_dtype="FP32",
                                      options={"stem_fused": fused}), seed=0, device="cpu")
        tnn.set_use_kernels(True)
        with torch.inference_mode():
            outs[fused] = m.apply({"input": x})["output"].numpy()
    ref, got = outs[False], outs[True]
    rel = np.abs(got - ref) / (np.abs(ref).mean() + 1e-9)
    assert rel.mean() < 2e-3, rel.mean()
    assert (got.argmax(-1) == ref.argmax(-1)).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_fused_stem_glue_rounds_first_with_the_same_bits(monkeypatch, layout, dtype):
    """``_stem_fused`` rounds the image to bf16 before the space-to-depth
    rearrange and the pad (half the bytes through both copies). Rounding
    is elementwise, so the kernel gets, and gives, the same bits as from
    the f32 image rearranged, padded and rounded after."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((2, 3, 224, 224)).astype(np.float32))
    if layout == "NHWC":
        x = x.permute(0, 2, 3, 1).contiguous()
    stem = {"fused_w": torch.from_numpy(rng.standard_normal((192, 64)).astype(np.float32) * 0.1)
            .to(torch.bfloat16),
            "scale": torch.from_numpy(rng.random(64).astype(np.float32) + 0.5),
            "shift": torch.from_numpy(rng.standard_normal(64).astype(np.float32) * 0.1)}
    seen = []
    kernel = tsk.fused_stem

    def spy(zp, *args, **kwargs):
        seen.append(zp)
        return kernel(zp, *args, **kwargs)

    monkeypatch.setattr(tsk, "fused_stem", spy)
    got = resnet._stem_fused(stem, x, dtype, layout)
    zp = torch.nn.functional.pad(resnet._s2d_rearrange(x, layout), (0, 0, 3, 3, 3, 3))
    assert seen[0].dtype == torch.bfloat16 and torch.equal(seen[0], zp.to(torch.bfloat16))
    want = tsk.fused_stem_plain(zp, stem["fused_w"], stem["scale"], stem["shift"], dtype)
    assert got.dtype == dtype and torch.equal(got, want)


@pytest.mark.parametrize("family,options", [
    ("add_one", {"dims": [3]}), ("identity", {"dims": [3]}), ("matmul", {"dim": 16}),
])
def test_small_models_match_jax(family, options):
    x = np.random.default_rng(3).standard_normal((4, options.get("dim", 3))).astype(np.float32)
    got, want = _run_both(family, "int8", options, {"input": x}, kernels=True)
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)
