"""Token sampling on the device, equal to the JAX engine's ``jax.random``.

The JAX engine samples a slot's token with ``jax.random.categorical``
under the key ``fold_in(PRNGKey(seed), progress)``
(``starpu_inference_server_tpu/serving/generation.py:_sample_tokens``).
This module is the port's own copy of that arithmetic, written from JAX
0.9.0's sources for its default configuration (``threefry2x32`` keys,
``jax_threefry_partitionable`` on, Gumbel mode "low"):

- :func:`prng_key` is ``prng.threefry_seed``: a key is the pair
  (seed >> 32, seed & 0xFFFFFFFF);
- :func:`threefry_2x32` is the 20-round Threefry-2x32 hash;
- :func:`fold_in` hashes the counter pair (0, data) under the key;
- :func:`random_bits` is the partitionable 32-bit path: element i of a
  flat shape hashes the counter pair (i >> 32, i & 0xFFFFFFFF) and is
  the XOR of the two output words;
- :func:`uniform`, :func:`gumbel` and :func:`categorical` are
  ``jax.random``'s, bit for bit in their f32 arithmetic; the Gumbel
  noise takes its logarithms from :func:`log_f32`, a copy of XLA's CPU
  f32 ``log``;
- :func:`sample_tokens` is ``_sample_tokens``: greedy argmax where the
  temperature is 0, else temperature and top-k masking with ``-inf``,
  then the Gumbel-max draw.

uint32 words are held in int64 tensors and masked to 32 bits after every
operation that can carry past them, and the logarithm's fused
multiply-adds run in f64, so the same code gives the same bits on the
CPU and on the card. Plain PyTorch: no kernel of this repository.
"""

from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA
_F32_TINY = float(np.finfo(np.float32).tiny)


def _f32(c: float) -> float:
    """``c`` rounded to f32. Constants enter the f32 arithmetic below as
    Python scalars (a tensor made from one would copy to the card and
    sync the host); rounded first, they convert exactly whatever
    precision the operation takes them in."""
    return float(np.float32(c))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & M32) | (x >> (32 - r))


def threefry_2x32(k0, k1, x0, x1):
    """Threefry-2x32 of the counter words (``x0``, ``x1``) under the key
    (``k0``, ``k1``); int64 tensors of uint32 values that broadcast
    together. Returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ _KS_PARITY)
    x0 = (x0 + k0) & M32
    x1 = (x1 + k1) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x0, x1


def prng_key(seed: torch.Tensor) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for integer seeds (any shape): keys
    int64 [..., 2] holding (seed >> 32, seed & 0xFFFFFFFF). A uint32 seed
    gives (0, seed)."""
    seed = seed.to(torch.int64)
    return torch.stack([(seed >> 32) & M32, seed & M32], dim=-1)


def fold_in(key: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``: keys [..., 2], data [...]
    (taken as uint32) -> keys [..., 2]."""
    data = data.to(torch.int64) & M32
    o0, o1 = threefry_2x32(key[..., 0], key[..., 1], torch.zeros_like(data), data)
    return torch.stack([o0, o1], dim=-1)


def random_bits(key: torch.Tensor, n: int) -> torch.Tensor:
    """32-bit random words of shape (n,) for each key: keys [..., 2] ->
    int64 [..., n] of uint32 values (JAX's ``random_bits(key, 32, (n,))``)."""
    count = torch.arange(n, dtype=torch.int64, device=key.device)
    o0, o1 = threefry_2x32(key[..., 0, None], key[..., 1, None], count >> 32, count & M32)
    return o0 ^ o1


def uniform(key: torch.Tensor, n: int, minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, (n,), float32, minval, maxval)`` for each
    key: the top 23 bits as the mantissa of a float in [1, 2), minus 1,
    scaled into [minval, maxval)."""
    bits = random_bits(key, n)
    one = 0x3F800000  # the bits of 1.0f
    floats = ((bits >> 9) | one).to(torch.int32).view(torch.float32) - 1.0
    lo, hi = _f32(minval), _f32(maxval)
    span = _f32(np.float32(hi) - np.float32(lo))
    return (floats * span + lo).clamp(min=lo)


# XLA's f32 logarithm on the CPU: Cephes' polynomial for log(1 + m) on
# [sqrt(1/2) - 1, sqrt(2) - 1], evaluated in XLA's order with its fused
# multiply-adds. torch.log's f32 result differs from it by an ulp in about
# a fifth of the inputs; this copy gives XLA's bits for every positive
# normal input.
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
          1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
          3.3333331174e-1)
_LOG_Q1 = -2.12194440e-4
_LOG_Q2 = 0.693359375
_SQRT_HALF = 0.707106781186547524


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """f32 a * b + c rounded once (``b`` and ``c`` tensors or f32-valued
    scalars): the f32 product is exact in f64, so only the f64 sum rounds
    before the f32 rounding (a double rounding that lands on an f32 tie
    has probability about 2^-29)."""
    return (a.double() * b + c).float()


def log_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU ``log`` of positive normal f32 values, bit for bit."""
    bits = x.view(torch.int32)
    mant = ((bits & ~0x7F800000) | 0x3F000000).view(torch.float32)  # in [0.5, 1)
    e = ((bits >> 23) - 0x7E).to(torch.float32)
    low = mant < _f32(_SQRT_HALF)
    m = (mant - 1.0) + torch.where(low, mant, torch.zeros_like(mant))
    e = e - low.to(torch.float32)
    p = [_f32(c) for c in _LOG_P]
    m2 = m * m
    m3 = m2 * m
    y = _fma(m, p[0], p[1])
    y1 = _fma(m, p[3], p[4])
    y2 = _fma(m, p[6], p[7])
    y = _fma(y, m, p[2])
    y1 = _fma(y1, m, p[5])
    y2 = _fma(y2, m, p[8])
    y = _fma(y, m3, y1)
    y = _fma(y, m3, y2)
    y = _fma(y, m3, e * _f32(_LOG_Q1))
    m = m - m2 * 0.5
    return (m + y) + e * _f32(_LOG_Q2)


def gumbel(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.gumbel(key, (n,), float32)`` in mode "low" for each
    key: -log(-log(u)), u uniform in [tiny, 1), with XLA's logarithm."""
    return -log_f32(-log_f32(uniform(key, n, _F32_TINY, 1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits)`` along the last axis, one key
    per row: keys [..., 2], f32 logits [..., V] -> int64 [...], the first
    maximum of Gumbel noise plus the logits."""
    return torch.argmax(gumbel(key, logits.shape[-1]) + logits, dim=-1)


def top_k_mask(scaled: torch.Tensor, top_k: torch.Tensor, k_max: int) -> torch.Tensor:
    """``scaled`` with every logit under its row's ``top_k``-th largest set
    to -inf (rows with ``top_k`` 0 keep everything). ``k_max`` (a host
    int) is at least every row's ``top_k``: the k-th value is read from
    the row's ``k_max`` largest, as JAX reads it from the sorted row."""
    if k_max <= 0:
        return scaled
    k_max = min(k_max, scaled.shape[-1])
    top = torch.topk(scaled, k_max, dim=-1).values
    kth = top.gather(-1, (top_k.to(torch.int64) - 1).clamp(0, k_max - 1)[..., None])
    drop = (top_k > 0)[..., None] & (scaled < kth)
    return torch.where(drop, torch.full_like(scaled, -float("inf")), scaled)


def sample_rows(logits: torch.Tensor, temps: torch.Tensor, top_k: torch.Tensor,
                keys: torch.Tensor, k_max: int) -> torch.Tensor:
    """The sampled branch of ``_sample_tokens`` for rows that sample:
    f32 logits [N, V], temps f32 [N], top_k [N], keys [N, 2] -> int64
    [N]. ``k_max``: a host int at least every ``top_k`` (0: no top-k)."""
    scaled = logits / temps.clamp(min=1e-6)[:, None]
    return categorical(keys, top_k_mask(scaled, top_k, k_max))


def sample_tokens(logits: torch.Tensor, temps: torch.Tensor, top_k: torch.Tensor,
                  seeds: torch.Tensor, progress: torch.Tensor) -> torch.Tensor:
    """JAX ``_sample_tokens`` with the engine's keys: f32 logits [S, V],
    temps f32 [S] (0 = greedy), top_k [S] (0 = off), uint32 seeds [S] and
    progress [S] -> int32 [S]. Row s samples under ``fold_in(PRNGKey(
    seeds[s]), progress[s])``. Every row's noise is drawn here; the
    engine draws it only for the rows that sample (``sample_rows``)."""
    greedy = torch.argmax(logits, dim=-1)
    keys = fold_in(prng_key(seeds), progress)
    sampled = sample_rows(logits, temps, top_k, keys, logits.shape[-1])
    return torch.where(temps > 0, sampled, greedy).to(torch.int32)
