"""Plain PyTorch multi-head attention: the reference the Hopper attention
kernel is held against.

Counterpart of ``MHSA.attend`` in :mod:`adyolo_tpu.models.resnet_conformer`
(``:234-246``) and its query-blocked route (``:254-267``), eval only (no
dropout).  Layout ``(B, T, H, dh)`` as the Dense layers give it; scores are
float32, scaled by ``dh ** -0.5``; keys ``j >= kv_len[b]`` get
``finfo(float32).min`` before the softmax.

* ``T <= BLOCK_THRESHOLD``: one fused pass over the ``(B, H, T, T)`` scores.
* ``T > BLOCK_THRESHOLD``: query blocks of ``bq`` rows, ``bq`` the first of
  ``(800, 600, 400, 240, 160, 80, 8)`` that divides ``T`` and is ``< T``, so
  a 38400-frame clip never allocates ``(B, H, T, T)``.

A batch row with ``kv_len == 0`` returns zeros, as the long-clip kernel does
(``adyolo_tpu/ops/flash_mhsa.py:316-325``).

On a CUDA device the model does not run this module: it goes through
:func:`adyolo_tpu_torch.ops.hopper_attention.flash_attention`.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["BLOCK_THRESHOLD", "query_block", "mhsa_attention"]

BLOCK_THRESHOLD = 2400  # frames; read at call time (tests monkeypatch it)
_BQ = (800, 600, 400, 240, 160, 80, 8)


def query_block(T: int) -> Optional[int]:
    """The query block of the blocked route, or None (then fused)."""
    return next((c for c in _BQ if T % c == 0 and c < T), None)


def _attend(q, k, v, key_mask, scale):
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if key_mask is not None:
        s = torch.where(key_mask[:, None, None, :], s,
                        torch.finfo(torch.float32).min)
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)


def mhsa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """softmax(mask(q·kᵀ·dh^-0.5))·v over ``(B, T, H, dh)`` float32 q/k/v.

    ``kv_len``: optional ``(B,)`` count of valid keys (a prefix); None means
    every key is valid.  Returns ``(B, T, H, dh)``."""
    B, T, H, dh = q.shape
    scale = dh ** -0.5
    key_mask = None
    if kv_len is not None:
        kv_len = kv_len.to(q.device)
        key_mask = torch.arange(T, device=q.device)[None, :] < kv_len[:, None]
    bq = query_block(T)
    if T <= BLOCK_THRESHOLD or bq is None:
        out = _attend(q, k, v, key_mask, scale)
    else:
        out = torch.cat([_attend(q[:, i:i + bq], k, v, key_mask, scale)
                         for i in range(0, T, bq)], dim=1)
    if kv_len is not None:
        out = out * (kv_len > 0).to(out.dtype)[:, None, None, None]
    return out
