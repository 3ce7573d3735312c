"""PyTorch + CUDA port of the inference server, for NVIDIA Hopper (sm_90a).

This package sits beside ``starpu_inference_server_tpu`` (the JAX
reference) and mirrors its module layout, so each module here has a
counterpart of the same name there. It imports ``torch`` and never
``jax``, and it imports nothing of the JAX package: the jax-free modules
it needs are its own copies.

Ported so far: decoder generation over gRPC (``grpc/server.py`` ->
``serving/generation.py`` -> ``models/decoder.py``) with the four
kernels that path runs, each hand-written in CUDA C++ under ``csrc/``:
``int4_matmul``, ``decode_attention``, ``causal_attention`` and
``chunk_prefill_attention``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
on CPU tensors each kernel wrapper runs its plain PyTorch version.
"""

__version__ = "0.1.0"
