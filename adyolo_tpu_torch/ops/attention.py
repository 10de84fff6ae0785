"""Plain PyTorch multi-head attention: the reference the Hopper attention
kernels are held against.

Counterpart of ``MHSA.attend`` in :mod:`adyolo_tpu.models.resnet_conformer`
(``:234-246``), its query-blocked route (``:254-267``) and, with dropout,
of the flash kernels' ``_fwd_kernel`` / ``_bwd_kernel``
(``adyolo_tpu/ops/flash_mhsa.py:74-146``).  Layout ``(B, T, H, dh)`` as the
Dense layers give it; scores are float32, scaled by ``dh ** -0.5``; keys
``j >= kv_len[b]`` get ``finfo(float32).min`` before the softmax.

* ``T <= BLOCK_THRESHOLD``: one fused pass over the ``(B, H, T, T)`` scores.
* ``T > BLOCK_THRESHOLD``: query blocks of ``bq`` rows, ``bq`` the first of
  ``(800, 600, 400, 240, 160, 80, 8)`` that divides ``T`` and is ``< T``, so
  a 38400-frame clip never allocates ``(B, H, T, T)``.  Eval only.

A batch row with ``kv_len == 0`` returns zeros, as the long-clip kernel does
(``adyolo_tpu/ops/flash_mhsa.py:316-325``), and gets zero gradients.

Dropout on the probabilities (training): the rate is quantized to
``thresh = round(rate * 256)``; a probability is kept when its 32-bit hash
is ``>= thresh << 24`` and then scaled by ``256 / (256 - thresh)``; the
softmax normaliser sums the undropped probabilities.  The bits are the
splitmix32 position hash of the JAX kernels' interpret mode
(``flash_mhsa.py:64-71``), indexed by the JAX blocking (:func:`dropout_bits`),
so the masks agree bit for bit with ``flash_mhsa(..., interpret=True)`` and
with the Hopper kernels.

bfloat16 q/k/v (bf16 training) take the JAX kernels' rounding points
(``flash_mhsa.py:101-104``, ``:129-146``): scores, softmax and every
product's sums in float32; the dropped and scaled probabilities rounded to
bfloat16 before P·V; the output rounded to bfloat16.  At rate 0 these are
also the rounding points of JAX's XLA attention on bfloat16 q/k/v
(``adyolo_tpu/models/resnet_conformer.py:230-246``: f32 scores from bf16
q and k, f32 softmax, probabilities rounded to bf16, P·V of bf16
operands), the path of JAX's bf16 serving artifact: this is the port's
plain bf16 eval attention (the CPU kernel of ``adyolo::mhsa_eval``).  Backward: ``dpd``
and ``rowsum(dp∘p)`` in float32, ``ds·scale`` and ``pd`` rounded to
bfloat16, ``dq``, ``dk`` and ``dv`` summed in float32 and rounded to
bfloat16.  float32 and float64 inputs round nowhere.

On a CUDA device the model does not run this module: it goes through
:func:`adyolo_tpu_torch.ops.hopper_attention.flash_attention` (the eval
forward through the op ``adyolo::mhsa_eval``, :mod:`.library`).
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["BLOCK_THRESHOLD", "query_block", "pick_bq", "dropout_thresh",
           "head_range", "dropout_bits", "mhsa_attention", "mhsa_attention_bwd"]

BLOCK_THRESHOLD = 2400  # frames; read at call time (tests monkeypatch it)
_BQ = (800, 600, 400, 240, 160, 80, 8)
_JAX_BQ = (512, 400, 256, 200, 160, 128, 80, 64, 40, 32, 16, 8)
_M32 = 0xFFFFFFFF


def query_block(T: int) -> Optional[int]:
    """The query block of the blocked route, or None (then fused)."""
    return next((c for c in _BQ if T % c == 0 and c < T), None)


def pick_bq(T: int) -> int:
    """The JAX flash kernel's query block (``flash_mhsa.py:149-154``); the
    dropout hash is indexed by it."""
    return next((min(c, T) for c in _JAX_BQ if T % c == 0), T)


def dropout_thresh(rate: float) -> int:
    """The u8 drop threshold of ``rate``: ``round(rate * 256)``, 0.2 -> 51."""
    return int(round(rate * 256.0))


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for int64 ``x`` in [0, 2**32), without int64
    overflow (the constant is split into 16-bit halves)."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def head_range(H: int, heads=None) -> tuple:
    """``(head_offset, heads_total)`` of a call over ``H`` heads: ``heads``
    checked (the call holds heads ``[head_offset, head_offset + H)`` of
    ``heads_total``), or ``(0, H)`` when None."""
    h0, ht = (0, H) if heads is None else (int(heads[0]), int(heads[1]))
    if h0 < 0 or h0 + H > ht:
        raise ValueError(f"heads [{h0}, {h0 + H}) do not lie in the model's {ht}")
    return h0, ht


def dropout_bits(B: int, H: int, T: int, seed: torch.Tensor,
                 heads: Optional[tuple] = None) -> torch.Tensor:
    """The uint32 keep bits of every (b, h, query, key), as int64
    ``(B, H, T, T)`` on ``seed``'s device.

    ``x = i*Tp + j + seed*0x9E3779B9 + lane*0x85EBCA6B`` (mod 2**32) with the
    JAX blocking ``bq = pick_bq(T)``, ``nq = T // bq``,
    ``Tp = ceil(T / 128) * 128``, ``lane = (b*Ht + h0 + h)*nq + q // bq``,
    ``i = q % bq`` and ``j`` the key; then two xor-shift-multiply rounds and
    ``x ^ (x >> 16)``.  ``seed``: int32 tensor of one element; ``heads``:
    ``(h0, Ht)`` when the H heads are ``[h0, h0 + H)`` of a model's ``Ht``
    (a tensor-parallel shard: its bits are the full model's of those
    heads), None for ``(0, H)``."""
    h0, ht = head_range(H, heads)
    dev = seed.device
    bq = pick_bq(T)
    nq, Tp = T // bq, -(-T // 128) * 128
    q = torch.arange(T, device=dev, dtype=torch.int64)
    b = torch.arange(B, device=dev, dtype=torch.int64).reshape(B, 1, 1, 1)
    h = torch.arange(H, device=dev, dtype=torch.int64).reshape(1, H, 1, 1)
    lane = (b * ht + h0 + h) * nq + (q // bq)[:, None]  # (B, H, T, 1)
    base = (_mul32(seed.reshape(()).to(torch.int64) & _M32, 0x9E3779B9)
            + _mul32(lane & _M32, 0x85EBCA6B))
    x = ((q % bq)[:, None] * Tp + q[None, :] + base) & _M32
    x = _mul32(x ^ (x >> 16), 0x7FEB352D)
    x = _mul32(x ^ (x >> 15), 0x846CA68B)
    return x ^ (x >> 16)


def _keep(B, H, T, thresh, seed, heads=None):
    """(keep mask (B, H, T, T), keep-scale), or (None, 1.0) at thresh 0."""
    if thresh <= 0:
        return None, 1.0
    if seed is None:
        raise ValueError("dropout needs a seed")
    return (dropout_bits(B, H, T, seed, heads) >= (thresh << 24),
            256.0 / (256.0 - thresh))


def _acc(dtype):
    """The dtype products are summed in: at least float32."""
    return torch.promote_types(dtype, torch.float32)


def _probs(q, k, key_mask, scale):
    acc = _acc(q.dtype)
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(acc), k.to(acc)) * scale
    if key_mask is not None:
        s = torch.where(key_mask[:, None, None, :], s,
                        torch.finfo(torch.float32).min)
    return torch.softmax(s, dim=-1)


def _attend(q, k, v, key_mask, scale, keep=None, kscale=1.0):
    p = _probs(q, k, key_mask, scale)
    if keep is not None:
        p = torch.where(keep, p * kscale, 0.0)
    acc = p.dtype
    p = p.to(v.dtype).to(acc)  # bfloat16 v: P rounded before P.V
    return torch.einsum("bhqk,bkhd->bqhd", p, v.to(acc)).to(v.dtype)


def _key_mask(kv_len, T, device):
    if kv_len is None:
        return None
    return torch.arange(T, device=device)[None, :] < kv_len.to(device)[:, None]


def _zero_empty_rows(x, kv_len):
    if kv_len is None:
        return x
    return x * (kv_len.to(x.device) > 0).to(x.dtype)[:, None, None, None]


def mhsa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   kv_len: Optional[torch.Tensor] = None, *, rate: float = 0.0,
                   seed: Optional[torch.Tensor] = None,
                   heads: Optional[tuple] = None) -> torch.Tensor:
    """dropout(softmax(mask(q·kᵀ·dh^-0.5)))·v over ``(B, T, H, dh)`` q/k/v
    (float32, float64, or bfloat16 at the JAX kernels' rounding points);
    differentiable by autograd, which for bfloat16 is not K3's rounding:
    :func:`mhsa_attention_bwd` is.

    ``kv_len``: optional ``(B,)`` count of valid keys (a prefix); None means
    every key is valid.  ``rate``/``seed``: dropout on the probabilities
    (``seed`` an int32 tensor of one element; needed when ``rate > 0``,
    which takes the fused route only); ``heads``: the ``(head_offset,
    heads_total)`` of a head shard (:func:`dropout_bits`).  Returns
    ``(B, T, H, dh)``."""
    B, T, H, dh = q.shape
    thresh = dropout_thresh(rate)
    if thresh >= 256:  # everything dropped (U8Dropout's convention)
        return torch.zeros_like(q)
    scale = dh ** -0.5
    key_mask = _key_mask(kv_len, T, q.device)
    bq = query_block(T)
    if T <= BLOCK_THRESHOLD or bq is None:
        keep, kscale = _keep(B, H, T, thresh, seed, heads)
        out = _attend(q, k, v, key_mask, scale, keep, kscale)
    elif thresh > 0:
        raise ValueError(f"attention dropout needs T <= {BLOCK_THRESHOLD}, "
                         f"got T={T}")
    else:
        out = torch.cat([_attend(q[:, i:i + bq], k, v, key_mask, scale)
                         for i in range(0, T, bq)], dim=1)
    return _zero_empty_rows(out, kv_len)


def mhsa_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       kv_len: Optional[torch.Tensor], do: torch.Tensor, *,
                       rate: float = 0.0, seed: Optional[torch.Tensor] = None,
                       heads: Optional[tuple] = None):
    """``(dq, dk, dv)`` of :func:`mhsa_attention` for the output gradient
    ``do``, written out as the TPU kernel K3 computes them
    (``flash_mhsa.py:107-146``): recompute p and the keep mask;
    ``dpd = do·vᵀ``; ``dp = keep·kscale·dpd``;
    ``ds = p∘(dp − rowsum(dp∘p))·scale``; ``dq = ds·k``, ``dk = dsᵀ·q``,
    ``dv = pdᵀ·do`` with ``pd = keep·kscale·p``.  Fused route only.
    bfloat16: ``ds`` and ``pd`` rounded to bfloat16 before the three
    products, whose float32 sums are rounded to bfloat16."""
    B, T, H, dh = q.shape
    thresh = dropout_thresh(rate)
    if thresh >= 256:
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    scale = dh ** -0.5
    acc = _acc(q.dtype)
    p = _probs(q, k, _key_mask(kv_len, T, q.device), scale)
    dpd = torch.einsum("bqhd,bkhd->bhqk", do.to(acc), v.to(acc))
    keep, kscale = _keep(B, H, T, thresh, seed, heads)
    if keep is None:
        pd, dp = p, dpd
    else:
        pd = torch.where(keep, p * kscale, 0.0)
        dp = torch.where(keep, dpd * kscale, 0.0)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True)) * scale
    ds, pd = ds.to(q.dtype).to(acc), pd.to(v.dtype).to(acc)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.to(acc)).to(q.dtype)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.to(acc)).to(k.dtype)
    dv = torch.einsum("bhqk,bqhd->bkhd", pd, do.to(acc)).to(v.dtype)
    return tuple(_zero_empty_rows(g, kv_len) for g in (dq, dk, dv))
