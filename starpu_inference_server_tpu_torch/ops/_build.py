"""Build and bind the port's CUDA kernels (``csrc/*.cu``).

Each ``csrc/<name>.cu`` has a plain C interface and becomes its own
shared library, compiled on first use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/cuda_kernels/<name>-<hash>.so csrc/<name>.cu

and loaded with ``ctypes``. The file name carries a hash of the sources
(the ``.cu`` and every ``.cuh``), so an edit rebuilds and an unchanged
tree reuses the library. The libraries go to ``build/cuda_kernels`` at
the root of the checkout (listed in ``.gitignore``). No PyTorch header
is included, so a build takes about a minute, not several;
:func:`build_all` starts one ``nvcc`` per source at once.

Calling convention: every pointer and the CUDA stream go as
``c_void_p``, integers as ``c_int``; each entry point returns
``cudaGetLastError()`` and :func:`check` raises if it is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List

CSRC = Path(__file__).resolve().parent.parent / "csrc"
KERNELS = ("int4_matmul", "decode_attention", "causal_attention",
           "chunk_prefill_attention", "int8_matmul", "bidirectional_attention",
           "fused_stem", "int4_matmul_w4a8", "window_decode_attention",
           "paged_decode_attention", "paged_window_decode_attention",
           "flat_decode_attention", "flat_window_decode_attention",
           "flat_paged_decode_attention", "flat_paged_window_decode_attention")

# dtype codes shared with csrc/common.cuh
F32 = 0
BF16 = 1

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    return CSRC.parent.parent / "build" / "cuda_kernels"


def nvcc_path() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the port's "
        "CUDA kernels are compiled on first use and need the CUDA toolkit"
    )


def _source_hash(name: str) -> str:
    h = hashlib.sha256()
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _target(name: str) -> Path:
    return build_dir() / f"{name}-{_source_hash(name)}.so"


def _nvcc_cmd(name: str, out: Path) -> List[str]:
    return [
        nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
        "-I", str(CSRC), "-o", str(out), str(CSRC / f"{name}.cu"),
    ]


def build_all(names: Iterable[str] = KERNELS) -> Dict[str, str]:
    """Compile every kernel library that is not built yet, one ``nvcc``
    per source, all started together. Returns ``{name: ptxas report}``
    for the ones compiled now; raises with nvcc's output on failure."""
    build_dir().mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        target = _target(name)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp.so")
        procs[name] = (tmp, target, subprocess.Popen(
            _nvcc_cmd(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True,
        ))
    reports = {}
    failures = []
    for name, (tmp, target, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name}.cu:\n{out}")
            continue
        os.replace(tmp, target)  # atomic: a concurrent build never sees half a file
        reports[name] = out
    if failures:
        raise RuntimeError("\n".join(failures))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use
    together with every other missing kernel library (in parallel, so a
    server's warmup pays for one build, not one per kernel in a row)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            target = _target(name)
            if not target.exists():
                build_all(KERNELS)
            lib = ctypes.CDLL(str(target))
            _libs[name] = lib
        return lib


def bind(name: str, symbol: str, n_ptrs: int, n_ints: int):
    """ctypes function ``symbol`` of library ``name`` taking ``n_ptrs``
    pointers, then ``n_ints`` ints, then the stream; returns int."""
    fn = getattr(load(name), symbol)
    fn.argtypes = (
        [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {what} failed to launch: cudaError {rc}")


def launch_counters() -> tuple:
    """The launch-count tables of every kernel wrapper module: each
    wrapper adds one to its entry where it launches its kernel."""
    from . import decode_attention, matmul_kernels, prefill_attention, stem_kernel

    return (matmul_kernels.launches, decode_attention.launches, prefill_attention.launches,
            stem_kernel.launches)


def stream_ptr(tensor) -> int:
    import torch

    return torch.cuda.current_stream(tensor.device).cuda_stream
