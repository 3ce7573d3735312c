"""Tensor ops of the port: quantization, dense layers and the hand-written
CUDA kernels (``csrc/``) with their plain PyTorch versions."""
