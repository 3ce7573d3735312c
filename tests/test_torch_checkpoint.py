"""Orbax checkpoints in the port: a directory written by the JAX package's
``ocp.StandardCheckpointer`` (in the test itself) restores through the
port's ``load_params`` (``tensorstore``, no Orbax, no jax) to the tree the
JAX package's ``load_params`` restores: dict against list, the same keys,
bit-equal leaves. For every family the registry serves, a port model
built from the directory answers bit-equal to the same model built from
the seed. Edge cases of the layout (a bf16 leaf, a 0-d leaf, a key
containing '.', an empty dict, an empty list and None, a dict with digit
keys) and Orbax's other layouts (a directory per leaf, zarr v3) each
restore as Orbax restores them; a directory that is not such a
checkpoint, a missing leaf and a missing ``tensorstore`` raise
``ModelLoadError``."""

import json
import sys

import jax
import ml_dtypes
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch

from starpu_inference_server_tpu.models import registry as jreg
from starpu_inference_server_tpu_torch.models import registry as treg
from starpu_inference_server_tpu_torch.utils.config import ModelSettings, QuantMode
from starpu_inference_server_tpu_torch.utils.exceptions import ModelLoadError
from starpu_inference_server_tpu_torch.weights import params_from_numpy

SEED = 3

# every family the registry serves, cut to a few layers at small widths
FAMILIES = {
    "llama-tiny": {"layers": 2, "hidden": 64, "q_heads": 4, "kv_heads": 2,
                   "intermediate": 128, "vocab": 256, "seq_len": 16},
    "bert-base-uncased": {"num_layers": 2, "vocab_size": 256, "seq_len": 16},
    "resnet18": {"image_size": 32, "num_classes": 10},
    "vit_b_16": {"num_layers": 2, "image_size": 32, "num_classes": 10},
    "moe-tiny": {"layers": 2, "hidden": 64, "q_heads": 4, "kv_heads": 2,
                 "intermediate": 128, "vocab": 256, "seq_len": 16},
}


def _save(path, tree):
    with ocp.StandardCheckpointer() as ckptr:
        ckptr.save(path, tree)
    return str(path)


def _assert_same_tree(got, want, where="root"):
    """Equal structure (dict against list, the same keys) and bit-equal leaves."""
    assert type(got) is type(want), f"{where}: {type(got).__name__} vs {type(want).__name__}"
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), where
        for k in want:
            _assert_same_tree(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same_tree(g, w, f"{where}/{i}")
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape, where
        assert got.tobytes() == want.tobytes(), where
    else:
        assert got == want, where


def _jax_restored(path):
    """The JAX package's ``load_params`` of ``path``, leaves as numpy arrays."""
    return jax.tree.map(lambda x: x if isinstance(x, (int, float)) else np.asarray(x),
                        jreg.load_params(path))


def _inputs(family, options):
    rng = np.random.default_rng(11)
    if family in ("llama-tiny", "moe-tiny"):
        return {"input_ids": rng.integers(0, options["vocab"], (2, 16)).astype(np.int64)}
    if family == "bert-base-uncased":
        mask = np.ones((2, 16), np.int64)
        mask[1, 10:] = 0
        return {"input_ids": rng.integers(0, options["vocab_size"], (2, 16)).astype(np.int64),
                "attention_mask": mask}
    return {"input": rng.standard_normal((2, 3, 32, 32)).astype(np.float32)}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_checkpoint_restores_like_jax_and_builds_the_seeded_model(family, tmp_path):
    options = FAMILIES[family]
    tree = jreg.get_family(family, options).init_params(np.random.default_rng(SEED))
    path = _save(tmp_path / "ckpt", tree)

    restored = treg.load_params(path)
    _assert_same_tree(restored, _jax_restored(path))
    assert "jax" not in type(restored).__module__

    def settings(params):
        return ModelSettings(family=family, compute_dtype="FP32", params=params,
                             options=options)

    from_dir = treg.build_model(settings(path), device="cpu")
    from_seed = treg.build_model(settings("random"), seed=SEED, device="cpu")
    inputs = {k: torch.from_numpy(v) for k, v in _inputs(family, options).items()}
    with torch.no_grad():
        got, want = from_dir.apply(inputs), from_seed.apply(inputs)
    assert sorted(got) == sorted(want)
    for name in want:
        assert torch.isfinite(want[name]).all()
        assert torch.equal(got[name], want[name]), name


def test_quantized_build_from_a_checkpoint_equals_the_seeded_one(tmp_path):
    """The int8 tree of a checkpoint (quantized after the load, as in
    ``build_model``) equals the seeded int8 tree leaf for leaf."""
    options = FAMILIES["bert-base-uncased"]
    tree = jreg.get_family("bert-base-uncased", options).init_params(
        np.random.default_rng(SEED))
    path = _save(tmp_path / "ckpt", tree)

    def build(params):
        settings = ModelSettings(family="bert-base-uncased", quantization=QuantMode.INT8,
                                 params=params, options=options)
        return treg.build_model(settings, seed=SEED, device="cpu").params

    got, want = build(path), build("random")
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
    for (where, g), (_, w) in zip(flat_got, flat_want):
        assert (torch.equal(g, w) if isinstance(w, torch.Tensor) else g == w), where


EDGE_CASES = {
    "bf16_leaf": {"w": np.array([1.5, -2.0, 3.0e-3], dtype=ml_dtypes.bfloat16)},
    "zero_d_leaf": {"scale": np.array(0.25, np.float32), "w": np.ones((2, 2), np.float32)},
    "key_with_a_dot": {"x.y": [np.arange(3, dtype=np.int32)], "x": {"y": np.zeros(2)}},
    "empty_dict": {"empty": {}, "w": np.ones(3, np.float32)},
    "empty_list_and_none": {"empty": [], "none": None, "w": [np.ones(3, np.float32)]},
    "digit_keys": {"experts": {"0": np.ones(2, np.float32), "1": np.zeros(2, np.float32)},
                   "layers": [np.full(2, 3.0, np.float32), np.full(2, 4.0, np.float32)]},
}


@pytest.mark.parametrize("case", sorted(EDGE_CASES))
def test_edge_case_restores_as_orbax_restores_it(case, tmp_path):
    path = _save(tmp_path / "ckpt", EDGE_CASES[case])
    restored = treg.load_params(path)
    _assert_same_tree(restored, _jax_restored(path))
    tensors = params_from_numpy(restored)
    if case == "bf16_leaf":
        assert restored["w"].dtype == ml_dtypes.bfloat16
        assert tensors["w"].dtype == torch.bfloat16
        assert tensors["w"].view(torch.int16).numpy().tobytes() == restored["w"].tobytes()
    elif case == "zero_d_leaf":
        assert tensors["scale"].shape == () and float(tensors["scale"]) == 0.25
    elif case == "key_with_a_dot":
        assert isinstance(restored["x.y"], list) and isinstance(restored["x"], dict)
    elif case == "empty_dict":
        assert restored["empty"] == {} and tensors["empty"] == {}
    elif case == "empty_list_and_none":
        assert restored["empty"] == [] and restored["none"] is None
    elif case == "digit_keys":  # a dict stays a dict, a list a list
        assert isinstance(restored["experts"], dict) and isinstance(restored["layers"], list)


# Orbax's other layouts: a zarr directory per leaf (no OCDBT), zarr v3 arrays
LAYOUTS = {
    "plain_directories": lambda: ocp.StandardCheckpointHandler(use_ocdbt=False),
    "zarr3": lambda: ocp.PyTreeCheckpointHandler(use_zarr3=True),
}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_other_layouts_restore_as_orbax_restores_them(layout, tmp_path):
    tree = {"w": np.arange(6, dtype=np.float32).reshape(2, 3), "s": np.array(2.0, np.float32),
            "layers": [{"b": np.ones(2, np.int8)}], "empty": {}}
    handler = LAYOUTS[layout]()
    save = (ocp.args.StandardSave if isinstance(handler, ocp.StandardCheckpointHandler)
            else ocp.args.PyTreeSave)
    with ocp.Checkpointer(handler) as ckptr:
        ckptr.save(tmp_path / "ckpt", args=save(tree))
    meta = json.loads((tmp_path / "ckpt" / "_METADATA").read_text())
    assert (meta["use_ocdbt"], meta["use_zarr3"]) == {"plain_directories": (False, False),
                                                      "zarr3": (True, True)}[layout]
    path = str(tmp_path / "ckpt")
    _assert_same_tree(treg.load_params(path), _jax_restored(path))


def _missing_leaf(path):
    _save(path, {"w": np.ones(2, np.float32)})
    meta = json.loads((path / "_METADATA").read_text())
    entry = dict(meta["tree_metadata"]["('w',)"])
    entry["key_metadata"] = [{"key": "gone", "key_type": 2}]
    meta["tree_metadata"]["('gone',)"] = entry
    (path / "_METADATA").write_text(json.dumps(meta))


NOT_CHECKPOINTS = {
    "empty_directory": lambda path: path.mkdir(),
    "bad_metadata": lambda path: (path.mkdir(), (path / "_METADATA").write_text("{}")),
    "missing_leaf": _missing_leaf,
}


@pytest.mark.parametrize("case", sorted(NOT_CHECKPOINTS))
def test_a_directory_that_is_not_a_checkpoint_raises(case, tmp_path):
    path = tmp_path / "ckpt"
    NOT_CHECKPOINTS[case](path)
    with pytest.raises(ModelLoadError, match="failed to restore orbax checkpoint") as err:
        treg.load_params(str(path))
    assert str(path) in str(err.value)


def test_without_tensorstore_a_directory_raises_naming_it(tmp_path, monkeypatch):
    """Where ``tensorstore`` is not installed the loader refuses the
    directory; it falls back to nothing."""
    path = _save(tmp_path / "ckpt", {"w": np.ones(2, np.float32)})
    monkeypatch.setitem(sys.modules, "tensorstore", None)
    with pytest.raises(ModelLoadError, match="tensorstore"):
        treg.load_params(path)
