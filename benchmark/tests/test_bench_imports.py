"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level names; the reference imports nothing of the port."""

from __future__ import annotations

import ast
import subprocess
import sys

from conftest import REPO

from harness import runner


def test_the_check_compares_whole_top_level_names(monkeypatch):
    fake = object()
    for name in ("jaxfoo", "starpu_inference_server_tpu_torch.ops", "flaxen", "jaxlib_x"):
        monkeypatch.setitem(sys.modules, name, fake)
    assert not [m for m in runner.forbidden_loaded() if m in
                ("jaxfoo", "starpu_inference_server_tpu_torch.ops", "flaxen", "jaxlib_x")]
    for name in ("jax.numpy", "starpu_inference_server_tpu.serving", "flax"):
        monkeypatch.setitem(sys.modules, name, fake)
    found = runner.forbidden_loaded()
    assert {"jax.numpy", "starpu_inference_server_tpu.serving", "flax"} <= set(found)


def test_a_run_s_imports_load_no_jax():
    """Import everything a run imports, in a fresh interpreter (the port's
    server, engine, models and kernels, the harness, the reference)."""
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "import harness.runner, harness.serve, harness.trace, harness.weights, harness.loadgen\n"
        "import starpu_inference_server_tpu_torch.grpc.server\n"
        "import starpu_inference_server_tpu_torch.ops._build as b; b.launch_counters()\n"
        "from harness import check, manifest\n"
        "man = manifest.manifest()\n"
        "check.load_reference(manifest.ROOT, manifest.config(man, man['configs'][0]['name']))\n"
        "for m in man['end_to_end'] + man['per_layer']: manifest.reader(m['name'])\n"
        "print(harness.runner.forbidden_loaded())\n"
    ) % (str(REPO / "benchmark"), str(REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=str(REPO))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_reference_imports_nothing_of_the_port():
    for path in (REPO / "benchmark" / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] in ("math", "typing", "torch", "numpy", "__future__"), \
                    (path.name, n)


def test_the_harness_reads_no_jax_benchmark_file():
    for path in (REPO / "benchmark").rglob("*.py"):
        if path.parent.name == "tests":
            continue
        text = path.read_text()
        for name in ("bench.py", "BENCH_r", "BASELINE.json", "MULTICHIP_r"):
            assert name not in text, (path, name)
