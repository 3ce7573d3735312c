"""Guards of the port's boundaries.

- In a fresh interpreter, importing every module of
  ``starpu_inference_server_tpu_torch`` and ``chip_smoke`` leaves
  ``jax`` and the JAX package out of ``sys.modules``, and the packages
  the port imports only inside the functions that need them
  (``tensorstore`` for Orbax checkpoints, ``transformers`` for the BERT
  client's tokenizer) too; the engine path
  (config -> model -> generation engine or batch engine and runner, and
  chip_smoke) also stays clear of ``grpc`` and ``yaml``.
- Every file in ``configs/`` parses to the same values in both packages,
  and each llama config the generation engine serves builds from its
  yml on the CPU (one layer, the yml's widths) and generates, in the
  standard cache layout and with ``kv_cache_layout: flat`` set in code;
  ``vit_l_16.yml``, ``resnet18_nhwc.yml`` and ``moe_decoder.yml`` each
  start a port server on the CPU (cut in depth) and answer a request.
- ``chip_smoke.py`` fails, printing no result, without CUDA and outside
  a checkout.
"""

import dataclasses
import enum
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from starpu_inference_server_tpu.utils import config as jcfg
from starpu_inference_server_tpu_torch.utils import config as tcfg
from starpu_inference_server_tpu_torch.utils import dtypes as tdt
from starpu_inference_server_tpu_torch.utils.exceptions import UnknownConfigKeyError

ROOT = Path(__file__).resolve().parent.parent
PKG = "starpu_inference_server_tpu_torch"

ALL_MODULES = """
import importlib, pkgutil, sys
import {pkg}
for info in pkgutil.walk_packages({pkg}.__path__, "{pkg}."):
    importlib.import_module(info.name)
import chip_smoke
"""

ENGINE_PATH = """
import sys
from {pkg}.serving.generation import build_generation_engine
from {pkg}.core.engine import ModelEngine
from {pkg}.serving.runner import TaskRunner
from {pkg}.utils.config import parse_config
from {pkg}.ops import decode_attention, prefill_attention, matmul_kernels, nn, stem_kernel
from {pkg}.ops.decode_attention import (window_decode_attention, paged_decode_attention,
                                        paged_window_decode_attention, flat_decode_attention,
                                        flat_window_decode_attention,
                                        flat_paged_decode_attention,
                                        flat_paged_window_decode_attention)
from {pkg}.ops.matmul_kernels import int4_matmul_w4a8
from {pkg}.models.paged_decoder import paged_decode_step, paged_verify_step
import chip_smoke
"""


def _leaked(code, banned):
    check = (
        "\nbad = sorted(m for m in sys.modules if m.split('.')[0] in %r)\nprint(bad)\n" % (banned,)
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code.format(pkg=PKG) + check], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return out.stdout.strip().splitlines()[-1]


@pytest.mark.parametrize("which", ["all_modules", "engine_path"])
def test_port_imports_no_jax(which):
    code = ALL_MODULES if which == "all_modules" else ENGINE_PATH
    banned = ("jax", "jaxlib", "starpu_inference_server_tpu", "tensorstore", "orbax",
              "transformers")
    if which == "engine_path":
        banned += ("grpc", "yaml")
    assert _leaked(code, banned) == "[]"


def _plain(obj):
    if dataclasses.is_dataclass(obj):
        return {f.name: _plain(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, enum.Enum):
        return obj.value
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    return obj


@pytest.mark.parametrize("path", sorted((ROOT / "configs").glob("*.yml")), ids=lambda p: p.stem)
def test_every_config_parses_to_equal_values(path):
    assert _plain(tcfg.load_config(str(path))) == _plain(jcfg.load_config(str(path)))


SERVED = ("llama_decoder", "llama_w4a8", "llama_speculative", "llama_prompt_lookup",
          "llama_paged")


@pytest.mark.parametrize("name", SERVED)
def test_served_llama_config_builds_and_generates_on_cpu(name):
    """Each generation config of the port, from its yml, cut to one layer
    at the yml's widths (llama-1b: hidden 2048, vocab 32000; the draft
    keeps its own four layers): the engine builds on the CPU with every
    option the yml sets and answers a greedy request."""
    import numpy as np

    from starpu_inference_server_tpu_torch.serving.generation import build_generation_engine

    path = ROOT / "configs" / f"{name}.yml"
    cfg = tcfg.load_config(str(path))
    assert _plain(cfg) == _plain(jcfg.load_config(str(path)))
    opts = dict(cfg.model.options, layers=1)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, options=opts))
    eng = build_generation_engine(cfg, device="cpu")
    assert eng.spec.hidden == 2048 and eng.spec.vocab == 32000 and eng.spec.layers == 1
    assert bool(eng.draft_spec) == ("draft_variant" in opts)
    assert eng.kv_page_size == int(opts.get("kv_page_size", 0))
    assert eng.prefix_cache == bool(opts.get("prefix_cache", False))
    eng.start()
    try:
        out = eng.generate(np.arange(1, 41, dtype=np.int32), max_new_tokens=3, timeout=300)
    finally:
        eng.stop()
    assert len(out) == 3 and all(0 <= t < 32000 for t in out)


@pytest.mark.parametrize("name", SERVED)
def test_served_llama_config_builds_flat_and_generates_on_cpu(name):
    """The same configs with ``kv_cache_layout: flat`` set in code (no yml
    sets it): the target cache, its pages and the draft's cache are flat,
    the engine runs at the yml's pipeline depth, and a greedy request is
    answered."""
    import numpy as np

    from starpu_inference_server_tpu_torch.serving.generation import build_generation_engine

    cfg = tcfg.load_config(str(ROOT / "configs" / f"{name}.yml"))
    opts = dict(cfg.model.options, layers=1, kv_cache_layout="flat")
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, options=opts))
    eng = build_generation_engine(cfg, device="cpu")
    assert eng.flat_cache and eng.cache.flat
    assert eng.draft_spec is None or eng._draft_cache.flat
    assert eng.pipeline_depth == int(opts.get("decode_pipeline_depth", 2))
    eng.start()
    try:
        out = eng.generate(np.arange(1, 41, dtype=np.int32), max_new_tokens=3, timeout=300)
    finally:
        eng.stop()
    assert len(out) == 3 and all(0 <= t < 32000 for t in out)


# the configs this slice serves, each cut so that a CPU builds and runs it:
# depth (ViT-L/16 to one layer, moe-8x1b to one layer with two of its eight
# experts: a layer at full width is 270M parameters an expert pair) and the
# batch buckets (to 1 and 2)
NEW_SERVED = {
    "vit_l_16": dict(options={"num_layers": 1}, max_batch_size=2),
    "resnet18_nhwc": dict(options={}, max_batch_size=2),
    "moe_decoder": dict(options={"layers": 1, "num_experts": 2}),
}


@pytest.mark.parametrize("name", sorted(NEW_SERVED))
def test_new_served_config_starts_a_server_on_cpu(name, tmp_path):
    """``vit_l_16.yml`` (INT8 ViT-L/16), ``resnet18_nhwc.yml`` (W8A8
    ResNet-18, NHWC wire) and ``moe_decoder.yml`` (moe-8x1b, int8, the
    1x1x1 expert mesh) start a port server from their yml at full width,
    cut as ``NEW_SERVED`` says (``metrics_port: 0``, traces under
    ``tmp_path``): the batch configs warm up their pipeline and answer a
    request of one sample, the MoE config gets the generation engine and
    answers a greedy request."""
    import asyncio

    import numpy as np
    import torch

    from starpu_inference_server_tpu_torch.grpc.server import InferenceServer
    from starpu_inference_server_tpu_torch.ops import nn

    path = ROOT / "configs" / f"{name}.yml"
    cfg = tcfg.load_config(str(path))
    cut = NEW_SERVED[name]
    model = dataclasses.replace(cfg.model, options=dict(cfg.model.options, **cut["options"]))
    cfg = dataclasses.replace(cfg, model=model, metrics_port=0,
                              trace_output=str(tmp_path / "trace"),
                              max_batch_size=cut.get("max_batch_size", cfg.max_batch_size))
    server = InferenceServer(cfg, device="cpu")
    try:
        server.start_pipeline(warmup=True)
        if name == "moe_decoder":
            eng = server.generation_engine
            assert server.runner is None and eng.spec.is_moe and eng.spec.hidden == 2048
            out = eng.generate(np.arange(1, 41, dtype=np.int32), max_new_tokens=3, timeout=300)
            assert len(out) == 3 and all(0 <= t < 32000 for t in out)
        else:
            assert server.generation_engine is None
            assert nn.w8a8_enabled() == (name == "resnet18_nhwc")
            spec = cfg.inputs[0]
            x = np.random.default_rng(0).standard_normal((1, *spec.dims)).astype(np.float32)
            out = server.engine.conform_outputs(server.engine.fetch(
                server.engine.run_padded({spec.name: torch.from_numpy(x)})))["output"]
            assert out.shape == (1, 1000) and np.isfinite(out).all()
    finally:
        asyncio.new_event_loop().run_until_complete(server.shutdown())
        nn.set_w8a8(False)


def test_config_keeps_strict_keys_and_suggestions():
    raw = {"name": "m", "model": "llama-tiny", "inputs": [{"name": "x", "dims": [2],
                                                          "dtype": "INT64"}],
           "outputs": [{"name": "y", "dims": [2], "dtype": "FP32"}], "pool_size": 1,
           "batch_coalesce_timeout_ms": 0, "batching_strategy": "disabled",
           "max_queu_size": 4}
    with pytest.raises(UnknownConfigKeyError, match="max_queue_size"):
        tcfg.parse_config(raw)


def test_wire_dtypes_without_ml_dtypes():
    import numpy as np
    import torch

    bf = torch.tensor([1.5, -2.25], dtype=torch.bfloat16)
    raw = bf.view(torch.uint16).numpy().tobytes()
    assert torch.equal(tdt.torch_from_wire(raw, "BF16"), bf)
    assert tdt.numpy_dtype("BF16") == np.uint16 and tdt.torch_dtype("bf16") == torch.bfloat16
    assert tdt.wire_name(torch.int64) == "INT64" and tdt.wire_name(np.float32) == "FP32"
    assert tdt.element_size("BF16") == 2


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_fails_without_cuda_or_repo(where, tmp_path):
    script = ROOT / "chip_smoke.py"
    if where == "alone":
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = tmp_path / "chip_smoke.py", tmp_path
    else:
        cwd = ROOT
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
