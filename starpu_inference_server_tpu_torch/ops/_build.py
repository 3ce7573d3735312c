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
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional

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

_lock = threading.RLock()  # held by build_all and load: one build at a time
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


def _source_hash(name: str, csrc: Path = CSRC) -> str:
    h = hashlib.sha256()
    for path in sorted(csrc.glob("*.cuh")) + [csrc / f"{name}.cu"]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _target(name: str, csrc: Path = CSRC, out: Optional[Path] = None) -> Path:
    return (out or build_dir()) / f"{name}-{_source_hash(name, csrc)}.so"


def _nvcc_cmd(name: str, out: Path, csrc: Path = CSRC) -> List[str]:
    return [
        nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
        "-I", str(csrc), "-o", str(out), str(csrc / f"{name}.cu"),
    ]


def build_all(names: Iterable[str] = KERNELS,
              seconds: Optional[Dict[str, float]] = None, csrc: Path = CSRC,
              out: Optional[Path] = None) -> Dict[str, str]:
    """Compile every kernel library that is not built yet, one ``nvcc``
    per source, all started together. Returns ``{name: ptxas report}``
    for the ones compiled now (and puts each one's nvcc wall seconds in
    ``seconds``, when given); raises with nvcc's output on failure. A
    thread may run it while others call :func:`load`, which waits.
    ``csrc`` and ``out``: another tree's sources, built into a directory
    of their own by the same command (to compare build times; the port
    loads only its own)."""
    with _lock:
        return _build_missing(names, seconds, csrc, out or build_dir())


def _build_missing(names, seconds, csrc, out_dir) -> Dict[str, str]:
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    done = {}

    def wait(name, proc, t0):
        out, _ = proc.communicate()
        done[name] = (out, time.perf_counter() - t0)

    for name in names:
        target = _target(name, csrc, out_dir)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp.so")
        proc = subprocess.Popen(_nvcc_cmd(name, tmp, csrc), stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        waiter = threading.Thread(target=wait, args=(name, proc, time.perf_counter()))
        waiter.start()
        procs[name] = (tmp, target, proc, waiter)
    reports = {}
    failures = []
    for name, (tmp, target, proc, waiter) in procs.items():
        waiter.join()
        out, took = done[name]
        if seconds is not None:
            seconds[name] = took
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
