"""Fused INT8-KV decode attention: plain decode, verify windows, paged,
in the standard and the FLAT cache layouts.

Each function replaces TPU kernels of
``starpu_inference_server_tpu/ops/decode_attention.py`` with a CUDA
kernel written by hand in ``csrc/``:

- ``decode_attention`` (``_grouped_kernel`` and ``_kernel``):
  ``csrc/decode_attention.cu``. One query row per slot against the dense
  cache.
- ``window_decode_attention`` (``_grouped_window_kernel`` and
  ``_window_kernel``): ``csrc/window_decode_attention.cu``. W query rows
  per slot (the speculative verify window); row ``w`` attends positions
  ``<= lengths[s] + w``.
- ``paged_decode_attention`` (``_paged_kernel``):
  ``csrc/paged_decode_attention.cu``. The decode function over a page
  pool ``[N, page, Hkv, D]`` read through a table ``[S, max_pages]``.
- ``paged_window_decode_attention`` (``_paged_window_kernel``):
  ``csrc/paged_window_decode_attention.cu``. The window function through
  the table; a window may cross a page.
- ``flat_decode_attention``, ``flat_window_decode_attention``,
  ``flat_paged_decode_attention`` and
  ``flat_paged_window_decode_attention`` (``_flat_kernel``,
  ``_flat_window_kernel``, ``_flat_paged_kernel``,
  ``_flat_paged_window_kernel``): ``csrc/flat_*.cu``, the four functions
  above over the FLAT layout.

Layouts. Standard: ``k``/``v`` int8 ``[S, T, Hkv, D]`` (pools
``[N, page, Hkv, D]``), scales f32 ``[S, T, Hkv]`` (``[N, page, Hkv]``).
FLAT: ``k``/``v`` int8 ``[S, T, Hkv*D]`` (``[N, page, Hkv*D]``), scales
f32 ``[S, Hkv, T]`` (``[N, Hkv, page]``). The K/V bytes of the two are
identical; only the scales move. As in the JAX package, the four public
standard functions take a 3-D cache or pool as FLAT and hand it to the
flat function; each flat function reads the flat cache in place (no
transpose, no copy), with its own entry in ``launches``.

Bound on the H100: device-memory bytes (the live int8 K/V rows and
scales, read once per call). Bodies: bf16 queries, in all eight
kernels, run one tensor-core body, ``csrc/decode_mma.cuh`` (decode is
its W = 1 case): a work item is one (KV head, slot, context split) and
serves every query row of the head (``rep`` heads, times W for a
window) as m16 tiles of ``mma.sync``, so each K/V byte is read once;
its 4 warps split the keys of each 64-position tile, the int8 rows
widen to bf16 in registers, and tiles stop at the last live position.
Any ``rep`` and head dims 32, 64, 80, 96, 128 and 256: a KV head's rows
are cut into row groups of at most ``16 * (256 // D)`` rows
(:func:`decode_group_rows`), one block row each in the same launch, and
each group reads the head's K/V (a decode at D <= 128 up to rep 32 is one
group; MQA's 71 heads, a verify window at rep 16 and D = 256 are more).
f32 queries (the FP32 witnesses) keep the CUDA-core bodies of
``csrc/common.cuh``: ``decode_attention_body`` for K3 and its flat twin,
``window_attention`` for the other six. The layout is the address
functor of the body (``DenseRows`` / ``PagedRows``, standard or flat),
so a flat kernel has its twin's bits on the same logical cache.

Splits. On the bf16 route :func:`decode_split_plan` cuts the context
into ranges of whole 64-position tiles when the (KV head, slot) pairs
alone would leave the card short of blocks. It reads static shapes
only, never ``lengths`` (a device tensor, new at every replay of a CUDA
graph), so one plan serves every call of a shape. With more than one
split each block writes its partial (max, sum, accumulator) in f32 to a
workspace the wrapper allocates, and a second kernel of the same call
merges the splits in split order, skipping those wholly past the
slot's last live position: no atomics, the same bits on every call. The
merge is part of the call and counts no launch of its own.

Beside each, a ``*_plain`` function computes the same thing in plain
PyTorch: CPU tensors take it, and on the card it is only the reference
the kernel is checked against. A flat plain function views the flat
cache as standard and calls the standard plain function.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from ..monitoring.trace import ranged
from . import _build
from .matmul_kernels import _sm_count

launches = {"decode_attention": 0, "window_decode_attention": 0,
            "paged_decode_attention": 0, "paged_window_decode_attention": 0,
            "flat_decode_attention": 0, "flat_window_decode_attention": 0,
            "flat_paged_decode_attention": 0, "flat_paged_window_decode_attention": 0}

_fns = {}

# the tensor-core body (csrc/decode_mma.cuh): head dims, positions a
# staged tile, and the blocks an SM that the split plan aims for
DECODE_HEAD_DIMS = (32, 64, 80, 96, 128, 256)
DECODE_TILE = 64
DECODE_FILL = 2
H100_SMS = 132


class DecodeSplitPlan(NamedTuple):
    splits: int     # context ranges, one block each per (KV head, slot)
    positions: int  # L: split i owns positions [i L, (i + 1) L)
    workspace: int  # f32 elements of the split partials (0 with one split)


def decode_group_rows(rows: int, d: int, f32_heads: bool = False) -> int:
    """The query rows of a row group, which every launch passes to its
    kernel (the bodies only check it against their limits): a KV head's
    ``rows`` (W * rep) cut into as few groups as fit a block, as even as
    whole rows allow (``ceil(rows / group rows)`` groups, only the last
    one shorter). A block takes at most 16 * (256 // d) rows on the
    tensor-core body (``csrc/decode_mma.cuh``: m16 tiles whose
    accumulators stay at 128 floats a thread) and on the f32 window body
    (``csrc/common.cuh``: 16 outputs a thread), and min(8, 1024 // d)
    heads on the f32 decode body of K3 and K12a (``f32_heads``)."""
    most = min(8, 1024 // d) if f32_heads else 16 * (256 // d)
    groups = math.ceil(rows / most)
    return math.ceil(rows / groups)


@functools.lru_cache(maxsize=None)
def decode_split_plan(s: int, hkv: int, t: int, w: int, rep: int, d: int,
                      sms: int = H100_SMS) -> DecodeSplitPlan:
    """How the bf16 decode-side kernels cut the context of ``s`` slots of
    ``t`` positions (``hkv`` KV heads, ``w`` query rows a slot, ``rep``
    query heads a KV head, head dim ``d``) on a card of ``sms`` SMs.

    One split where the (KV head, row group, slot) work items already
    give ``DECODE_FILL`` blocks an SM; else at least as many splits as
    make up that count, at most one a 64-position tile, each a whole
    number of tiles.
    Static quantities only: the plan never sees ``lengths``, so a CUDA
    graph of a call replays with any lengths. The workspace holds each
    split's accumulator [R, D] and (max, sum) [R, 2] per (KV head, slot),
    R = w * rep, whatever the row groups. Raises outside the body's
    limits (``d`` in ``DECODE_HEAD_DIMS``)."""
    rows = w * rep
    if d not in DECODE_HEAD_DIMS or rows < 1 or min(s, hkv, t) < 1:
        raise ValueError(f"decode kernels need D in {DECODE_HEAD_DIMS} "
                         f"(S={s}, Hkv={hkv}, T={t}, W={w}, rep={rep}, D={d})")
    tiles = math.ceil(t / DECODE_TILE)
    items = s * hkv * math.ceil(rows / decode_group_rows(rows, d))
    want = min(tiles, math.ceil(DECODE_FILL * sms / items))
    splits = 1 if want <= 1 else math.ceil(tiles / (tiles // want))
    positions = DECODE_TILE * math.ceil(tiles / splits)
    workspace = splits * s * hkv * rows * (d + 2) if splits > 1 else 0
    return DecodeSplitPlan(splits, positions, workspace)


def _plan(q, s, hkv, t, w, rep, d, f32_heads=False):
    """(workspace or None, split count, group rows) of a launch: the
    plan's splits on the bf16 route, one split and no workspace on the
    f32 route (``f32_heads``: the f32 decode body's groups). The caller
    holds the workspace until the launch is enqueued."""
    if q.dtype != torch.bfloat16:
        return None, 1, decode_group_rows(w * rep, d, f32_heads)
    group_rows = decode_group_rows(w * rep, d)
    plan = decode_split_plan(s, hkv, t, w, rep, d, _sm_count(q.device))
    if plan.splits == 1:
        return None, 1, group_rows
    return (torch.empty(plan.workspace, dtype=torch.float32, device=q.device), plan.splits,
            group_rows)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _bound(name: str, n_ptrs: int, n_ints: int):
    """The ctypes entry ``sis_<name>`` of ``csrc/<name>.cu``, bound once."""
    fn = _fns.get(name)
    if fn is None:
        fn = _fns[name] = _build.bind(name, f"sis_{name}", n_ptrs, n_ints)
    return fn


def _dtype_code(name, q) -> int:
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name} takes f32 or bf16 queries, got {q.dtype}")
    return _build.BF16 if q.dtype == torch.bfloat16 else _build.F32


def _int8_caches(name, caches):
    """Contiguous int8 K/V (16-byte aligned) and f32 scales."""
    if caches[0].dtype != torch.int8 or caches[1].dtype != torch.int8:
        raise TypeError(f"{name} needs an int8 cache")
    out = [caches[0].contiguous(), caches[1].contiguous(),
           caches[2].to(torch.float32).contiguous(), caches[3].to(torch.float32).contiguous()]
    for a in out[:2]:
        if a.data_ptr() % 16:
            raise ValueError(f"{name} needs 16-byte aligned K/V")
    return out


def _aligned(q):
    """q contiguous and 16-byte aligned (the tensor-core body loads it 16
    bytes a thread): a view at an odd offset is copied."""
    q = q.contiguous()
    return q.clone() if q.data_ptr() % 16 else q


def _check_head_dim(name, d) -> None:
    """Both routes of the eight kernels take any rep and W (row groups)
    and the head dims their bodies are built for."""
    if d not in DECODE_HEAD_DIMS:
        raise ValueError(f"{name} kernel needs D in {DECODE_HEAD_DIMS} (D={d})")


def _finish(name, rc, out, out_dtype):
    _build.check(rc, name)
    launches[name] += 1
    return out if out_dtype == out.dtype else out.to(out_dtype)


# -- the flat layout as standard views (plain versions only) -----------------

def std_kv_view(a: torch.Tensor, hkv: int) -> torch.Tensor:
    """FLAT K/V ``[..., Hkv*D]`` as standard ``[..., Hkv, D]`` (a view)."""
    return a.unflatten(-1, (hkv, a.shape[-1] // hkv))


def std_scale_view(a: torch.Tensor) -> torch.Tensor:
    """FLAT scales ``[..., Hkv, T]`` as standard ``[..., T, Hkv]`` (a
    view)."""
    return a.transpose(-1, -2)


def _std_caches(k, v, ks, vs):
    hkv = ks.shape[-2]
    return std_kv_view(k, hkv), std_kv_view(v, hkv), std_scale_view(ks), std_scale_view(vs)


def _check_flat(q_heads, d, rep, k, ks, rows_per_scale_row, what):
    """A flat cache's widths: K/V ``[.., Hkv*D]``, scales ``[.., Hkv, T]``
    (``T`` = ``rows_per_scale_row``)."""
    hkv = q_heads // rep
    if q_heads != hkv * rep or k.shape[-1] != hkv * d or ks.shape[-2:] != (hkv, rows_per_scale_row):
        raise ValueError(f"q heads {q_heads}, D {d}, rep {rep} vs flat {what} "
                         f"{tuple(k.shape)} with scales {tuple(ks.shape)}")
    return hkv


# -- dense decode ------------------------------------------------------------

def decode_attention_plain(q, k_cache, v_cache, k_scale, v_scale, lengths,
                           rep: int, out_dtype=None) -> torch.Tensor:
    """Dequantize, score in f32 (1/sqrt(D)), mask positions > lengths[s]
    with -1e30, softmax in f32, weighted sum of V. Output [S, Hq, D]."""
    s, hq, d = q.shape
    t = k_cache.shape[1]
    out_dtype = out_dtype or q.dtype
    k = k_cache.to(torch.float32) * k_scale.unsqueeze(-1)
    v = v_cache.to(torch.float32) * v_scale.unsqueeze(-1)
    k = k.repeat_interleave(rep, dim=2)  # [S, T, Hq, D]
    v = v.repeat_interleave(rep, dim=2)
    logits = torch.einsum("shd,sthd->sht", q.to(torch.float32), k) / math.sqrt(d)
    pos = torch.arange(t, device=q.device)
    mask = pos[None, None, :] <= lengths.to(torch.int64)[:, None, None]
    logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("sht,sthd->shd", probs, v).to(out_dtype)


def _decode_launch(name, q, caches, lengths, t, hkv, rep, out_dtype):
    """decode_attention and its flat twin: one C signature."""
    s, hq, d = q.shape
    code = _dtype_code(name, q)
    _check_head_dim(name, d)
    caches = _int8_caches(name, caches)
    q = _aligned(q)
    lengths = lengths.to(torch.int32).contiguous()
    out = torch.empty((s, hq, d), dtype=q.dtype, device=q.device)
    ws, splits, group_rows = _plan(q, s, hkv, t, 1, rep, d, f32_heads=True)
    rc = _bound(name, 8, 8)(
        q.data_ptr(), *(a.data_ptr() for a in caches), lengths.data_ptr(), out.data_ptr(),
        _ptr(ws), s, t, hkv, rep, d, code, splits, group_rows, _build.stream_ptr(q))
    return _finish(name, rc, out, out_dtype)


@ranged("ops.attn")
def decode_attention(q, k_cache, v_cache, k_scale, v_scale, lengths,
                     rep: int, out_dtype=None) -> torch.Tensor:
    """q [S, Hq, D] against the int8 cache; returns [S, Hq, D] in
    ``out_dtype`` (default q's). A 3-D cache is FLAT and goes to
    :func:`flat_decode_attention`. CUDA tensors launch the kernel, CPU
    tensors take the plain version."""
    if k_cache.dim() == 3:
        return flat_decode_attention(q, k_cache, v_cache, k_scale, v_scale, lengths, rep,
                                     out_dtype)
    s, hq, d = q.shape
    _, t, hkv, dk = k_cache.shape
    if hq != hkv * rep or dk != d:
        raise ValueError(f"q {tuple(q.shape)} vs cache {tuple(k_cache.shape)}, rep {rep}")
    out_dtype = out_dtype or q.dtype
    if not q.is_cuda:
        return decode_attention_plain(q, k_cache, v_cache, k_scale, v_scale,
                                      lengths, rep, out_dtype)
    return _decode_launch("decode_attention", q, (k_cache, v_cache, k_scale, v_scale), lengths,
                          t, hkv, rep, out_dtype)


def flat_decode_attention_plain(q, k_cache, v_cache, k_scale, v_scale, lengths,
                                rep: int, out_dtype=None) -> torch.Tensor:
    """:func:`decode_attention_plain` on the flat cache viewed as
    standard."""
    return decode_attention_plain(q, *_std_caches(k_cache, v_cache, k_scale, v_scale), lengths,
                                  rep, out_dtype)


def flat_decode_attention(q, k_cache, v_cache, k_scale, v_scale, lengths,
                          rep: int, out_dtype=None) -> torch.Tensor:
    """q [S, Hq, D] against the FLAT int8 cache (K/V [S, T, Hkv*D],
    scales [S, Hkv, T]); returns [S, Hq, D]. CUDA tensors launch the
    kernel, CPU tensors take the plain version."""
    s, hq, d = q.shape
    t = k_cache.shape[1]
    hkv = _check_flat(hq, d, rep, k_cache, k_scale, t, "cache")
    out_dtype = out_dtype or q.dtype
    if not q.is_cuda:
        return flat_decode_attention_plain(q, k_cache, v_cache, k_scale, v_scale, lengths,
                                           rep, out_dtype)
    return _decode_launch("flat_decode_attention", q, (k_cache, v_cache, k_scale, v_scale),
                          lengths, t, hkv, rep, out_dtype)


# -- verify windows ------------------------------------------------------------

def window_decode_attention_plain(q, k_cache, v_cache, k_scale, v_scale, lengths,
                                  rep: int, out_dtype=None) -> torch.Tensor:
    """q [S, W, Hq, D]: dequantize, score in f32 (1/sqrt(D)), mask
    positions > lengths[s] + w with -1e30, softmax in f32, weighted sum
    of V. Output [S, W, Hq, D]."""
    s, w, hq, d = q.shape
    t = k_cache.shape[1]
    out_dtype = out_dtype or q.dtype
    k = (k_cache.to(torch.float32) * k_scale.unsqueeze(-1)).repeat_interleave(rep, dim=2)
    v = (v_cache.to(torch.float32) * v_scale.unsqueeze(-1)).repeat_interleave(rep, dim=2)
    logits = torch.einsum("swhd,sthd->swht", q.to(torch.float32), k) / math.sqrt(d)
    pos = torch.arange(t, device=q.device)
    last = lengths.to(torch.int64)[:, None] + torch.arange(w, device=q.device)[None, :]
    mask = pos[None, None, None, :] <= last[:, :, None, None]
    logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("swht,sthd->swhd", probs, v).to(out_dtype)


def _window_launch(name, q, caches, lengths, t, hkv, rep, out_dtype):
    """window_decode_attention and its flat twin: one C signature."""
    s, w, hq, d = q.shape
    code = _dtype_code(name, q)
    _check_head_dim(name, d)
    caches = _int8_caches(name, caches)
    q = _aligned(q)
    lengths = lengths.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    ws, splits, group_rows = _plan(q, s, hkv, t, w, rep, d)
    rc = _bound(name, 8, 9)(
        q.data_ptr(), *(a.data_ptr() for a in caches), lengths.data_ptr(), out.data_ptr(),
        _ptr(ws), s, t, w, hkv, rep, d, code, splits, group_rows, _build.stream_ptr(q))
    return _finish(name, rc, out, out_dtype)


def window_decode_attention(q, k_cache, v_cache, k_scale, v_scale, lengths,
                            rep: int, out_dtype=None) -> torch.Tensor:
    """q [S, W, Hq, D] (row w at position lengths[s] + w, its KV already
    written) against the int8 cache; returns [S, W, Hq, D] in
    ``out_dtype`` (default q's). A 3-D cache is FLAT and goes to
    :func:`flat_window_decode_attention`. CUDA tensors launch the kernel,
    CPU tensors take the plain version."""
    if k_cache.dim() == 3:
        return flat_window_decode_attention(q, k_cache, v_cache, k_scale, v_scale, lengths,
                                            rep, out_dtype)
    s, w, hq, d = q.shape
    _, t, hkv, dk = k_cache.shape
    if hq != hkv * rep or dk != d:
        raise ValueError(f"q {tuple(q.shape)} vs cache {tuple(k_cache.shape)}, rep {rep}")
    out_dtype = out_dtype or q.dtype
    if not q.is_cuda:
        return window_decode_attention_plain(q, k_cache, v_cache, k_scale, v_scale, lengths,
                                             rep, out_dtype)
    return _window_launch("window_decode_attention", q, (k_cache, v_cache, k_scale, v_scale),
                          lengths, t, hkv, rep, out_dtype)


def flat_window_decode_attention_plain(q, k_cache, v_cache, k_scale, v_scale, lengths,
                                       rep: int, out_dtype=None) -> torch.Tensor:
    """:func:`window_decode_attention_plain` on the flat cache viewed as
    standard."""
    return window_decode_attention_plain(q, *_std_caches(k_cache, v_cache, k_scale, v_scale),
                                         lengths, rep, out_dtype)


def flat_window_decode_attention(q, k_cache, v_cache, k_scale, v_scale, lengths,
                                 rep: int, out_dtype=None) -> torch.Tensor:
    """q [S, W, Hq, D] against the FLAT int8 cache (K/V [S, T, Hkv*D],
    scales [S, Hkv, T]); returns [S, W, Hq, D]. CUDA tensors launch the
    kernel, CPU tensors take the plain version."""
    s, w, hq, d = q.shape
    t = k_cache.shape[1]
    hkv = _check_flat(hq, d, rep, k_cache, k_scale, t, "cache")
    out_dtype = out_dtype or q.dtype
    if not q.is_cuda:
        return flat_window_decode_attention_plain(q, k_cache, v_cache, k_scale, v_scale,
                                                  lengths, rep, out_dtype)
    return _window_launch("flat_window_decode_attention", q,
                          (k_cache, v_cache, k_scale, v_scale), lengths, t, hkv, rep, out_dtype)


# -- paged caches ----------------------------------------------------------------

def gather_pages(pool, table):
    """[N, page, ...] pool + [S, MP] table -> [S, MP * page, ...] logical
    rows (the paged decoder's plain route reads its cache through it)."""
    g = pool[table.to(torch.int64)]
    return g.reshape(g.shape[0], g.shape[1] * g.shape[2], *g.shape[3:])


def gather_flat_scale_pages(pool, table):
    """FLAT scale pool [N, Hkv, page] + [S, MP] table -> standard
    [S, MP * page, Hkv] logical rows (the JAX package's
    ``_gather_slot_scales_flat``)."""
    g = pool[table.to(torch.int64)].transpose(2, 3)  # [S, MP, page, Hkv]
    return g.reshape(g.shape[0], g.shape[1] * g.shape[2], g.shape[3])


def _gather_all(k_pool, v_pool, k_scale, v_scale, table):
    """Standard pools, or FLAT pools (3-D), gathered to the slots'
    standard logical rows."""
    if k_pool.dim() == 3:
        hkv = k_scale.shape[1]
        return (std_kv_view(gather_pages(k_pool, table), hkv),
                std_kv_view(gather_pages(v_pool, table), hkv),
                gather_flat_scale_pages(k_scale, table), gather_flat_scale_pages(v_scale, table))
    return (gather_pages(k_pool, table), gather_pages(v_pool, table),
            gather_pages(k_scale, table), gather_pages(v_scale, table))


def paged_window_decode_attention_plain(q, k_pool, v_pool, k_scale, v_scale, table, lengths,
                                        rep: int, out_dtype=None) -> torch.Tensor:
    """The window function on the slots' logical rows, gathered through
    the table."""
    return window_decode_attention_plain(
        q, *_gather_all(k_pool, v_pool, k_scale, v_scale, table), lengths, rep, out_dtype)


def paged_decode_attention_plain(q, k_pool, v_pool, k_scale, v_scale, table, lengths,
                                 rep: int, out_dtype=None) -> torch.Tensor:
    """q [S, Hq, D]: :func:`decode_attention_plain` on the slots' logical
    rows, gathered through the table."""
    return decode_attention_plain(
        q, *_gather_all(k_pool, v_pool, k_scale, v_scale, table), lengths, rep, out_dtype)


# the flat pools gather to the same logical rows
flat_paged_decode_attention_plain = paged_decode_attention_plain
flat_paged_window_decode_attention_plain = paged_window_decode_attention_plain


def _paged_launch(name, q, caches, table, lengths, page, hkv, rep, out_dtype):
    """The four paged kernels: q [S, Hq, D] (decode, W = 1) or
    [S, W, Hq, D] (window); the window kernels take W after the page."""
    window = q.dim() == 4
    w, d = (q.shape[1] if window else 1), q.shape[-1]
    code = _dtype_code(name, q)
    _check_head_dim(name, d)
    caches = _int8_caches(name, caches)
    q = _aligned(q)
    table = table.to(torch.int32).contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    ws, splits, group_rows = _plan(q, q.shape[0], hkv, table.shape[1] * page, w, rep, d)
    ints = ((q.shape[0], table.shape[1], page) + ((w,) if window else ())
            + (hkv, rep, d, code, splits, group_rows))
    rc = _bound(name, 9, len(ints))(
        q.data_ptr(), *(a.data_ptr() for a in caches), table.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), _ptr(ws), *ints, _build.stream_ptr(q))
    return _finish(name, rc, out, out_dtype)


@ranged("ops.attn")
def paged_decode_attention(q, k_pool, v_pool, k_scale, v_scale, table, lengths,
                           rep: int, out_dtype=None) -> torch.Tensor:
    """q [S, Hq, D] against the paged int8 cache (pools [N, page, Hkv, D],
    table [S, max_pages]); slot s attends logical positions <=
    lengths[s]. Returns [S, Hq, D]. 3-D pools are FLAT and go to
    :func:`flat_paged_decode_attention`. CUDA tensors launch the kernel,
    CPU tensors take the plain version."""
    if k_pool.dim() == 3:
        return flat_paged_decode_attention(q, k_pool, v_pool, k_scale, v_scale, table, lengths,
                                           rep, out_dtype)
    s, hq, d = q.shape
    _, page, hkv, dk = k_pool.shape
    if hq != hkv * rep or dk != d:
        raise ValueError(f"q {tuple(q.shape)} vs pool {tuple(k_pool.shape)}, rep {rep}")
    out_dtype = out_dtype or q.dtype
    if not q.is_cuda:
        return paged_decode_attention_plain(q, k_pool, v_pool, k_scale, v_scale, table,
                                            lengths, rep, out_dtype)
    return _paged_launch("paged_decode_attention", q, (k_pool, v_pool, k_scale, v_scale), table,
                         lengths, page, hkv, rep, out_dtype)


def paged_window_decode_attention(q, k_pool, v_pool, k_scale, v_scale, table, lengths,
                                  rep: int, out_dtype=None) -> torch.Tensor:
    """q [S, W, Hq, D] against the paged int8 cache: the window function
    through the table. Returns [S, W, Hq, D]. 3-D pools are FLAT and go to
    :func:`flat_paged_window_decode_attention`. CUDA tensors launch the
    kernel, CPU tensors take the plain version."""
    if k_pool.dim() == 3:
        return flat_paged_window_decode_attention(q, k_pool, v_pool, k_scale, v_scale, table,
                                                  lengths, rep, out_dtype)
    s, w, hq, d = q.shape
    _, page, hkv, dk = k_pool.shape
    if hq != hkv * rep or dk != d:
        raise ValueError(f"q {tuple(q.shape)} vs pool {tuple(k_pool.shape)}, rep {rep}")
    out_dtype = out_dtype or q.dtype
    if not q.is_cuda:
        return paged_window_decode_attention_plain(q, k_pool, v_pool, k_scale, v_scale, table,
                                                   lengths, rep, out_dtype)
    return _paged_launch("paged_window_decode_attention", q,
                         (k_pool, v_pool, k_scale, v_scale), table, lengths, page, hkv, rep,
                         out_dtype)


def flat_paged_decode_attention(q, k_pool, v_pool, k_scale, v_scale, table, lengths,
                                rep: int, out_dtype=None) -> torch.Tensor:
    """q [S, Hq, D] against FLAT page pools (K/V [N, page, Hkv*D], scales
    [N, Hkv, page]) through the table. Returns [S, Hq, D]. CUDA tensors
    launch the kernel, CPU tensors take the plain version."""
    s, hq, d = q.shape
    page = k_pool.shape[1]
    hkv = _check_flat(hq, d, rep, k_pool, k_scale, page, "pool")
    out_dtype = out_dtype or q.dtype
    if not q.is_cuda:
        return flat_paged_decode_attention_plain(q, k_pool, v_pool, k_scale, v_scale, table,
                                                 lengths, rep, out_dtype)
    return _paged_launch("flat_paged_decode_attention", q, (k_pool, v_pool, k_scale, v_scale),
                         table, lengths, page, hkv, rep, out_dtype)


def flat_paged_window_decode_attention(q, k_pool, v_pool, k_scale, v_scale, table, lengths,
                                       rep: int, out_dtype=None) -> torch.Tensor:
    """q [S, W, Hq, D] against FLAT page pools through the table. Returns
    [S, W, Hq, D]. CUDA tensors launch the kernel, CPU tensors take the
    plain version."""
    s, w, hq, d = q.shape
    page = k_pool.shape[1]
    hkv = _check_flat(hq, d, rep, k_pool, k_scale, page, "pool")
    out_dtype = out_dtype or q.dtype
    if not q.is_cuda:
        return flat_paged_window_decode_attention_plain(q, k_pool, v_pool, k_scale, v_scale,
                                                        table, lengths, rep, out_dtype)
    return _paged_launch("flat_paged_window_decode_attention", q,
                         (k_pool, v_pool, k_scale, v_scale), table, lengths, page, hkv, rep,
                         out_dtype)
