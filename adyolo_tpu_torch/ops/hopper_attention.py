"""Wrapper of the hand-written Hopper attention kernel (``csrc/attention.cu``).

One online-softmax forward kernel replaces two TPU kernels of
``adyolo_tpu/ops/flash_mhsa.py``, and is launched from two routes that are
counted apart:

* ``"k2"`` for ``T <= attention.BLOCK_THRESHOLD`` (2400 frames): K2,
  ``_fwd_kernel`` via ``_flash_fwd``, at dropout rate 0 (eval);
* ``"k4"`` for longer clips: K4, ``_long_kernel`` via ``flash_mhsa_long``.

Dispatch is by the tensor's device: a CPU tensor goes to the plain
:func:`adyolo_tpu_torch.ops.attention.mhsa_attention`; a CUDA tensor goes to
the kernel, or the call raises.  There is no fallback from one to the other.

``LAUNCHES`` counts kernel launches per route; a count is bumped right after
a launch is accepted, and nowhere else.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..utils.build import load_library
from . import attention

__all__ = ["flash_attention", "route", "LAUNCHES"]

LAUNCHES = {"k2": 0, "k4": 0}

_DH = 64  # the kernel's head dim

_bound = None


def _entry():
    global _bound
    if _bound is None:
        fn = load_library().adyolo_mhsa_fwd
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        _bound = fn
    return _bound


def route(T: int) -> str:
    """The route (and TPU kernel counterpart) of a ``T``-frame call."""
    return "k2" if T <= attention.BLOCK_THRESHOLD else "k4"


def _check(q, k, v, kv_len):
    if q.ndim != 4:
        raise ValueError(f"q must be (B, T, H, dh), got {tuple(q.shape)}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if x.shape != q.shape or x.device != q.device:
            raise ValueError(f"{name} must match q's shape and device, got "
                             f"{tuple(x.shape)} on {x.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if kv_len is not None and tuple(kv_len.shape) != (q.shape[0],):
        raise ValueError(f"kv_len must be (B,) = ({q.shape[0]},), got "
                         f"{tuple(kv_len.shape)}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention over ``(B, T, H, dh)`` float32 q/k/v with the first
    ``kv_len[b]`` keys valid (all when None); see
    :func:`~adyolo_tpu_torch.ops.attention.mhsa_attention`.  On CUDA the
    kernel needs ``dh == 64`` and an int32 ``kv_len`` on the same device."""
    _check(q, k, v, kv_len)
    if q.device.type == "cpu":
        return attention.mhsa_attention(q, k, v, kv_len)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    B, T, H, dh = q.shape
    if dh != _DH:
        raise ValueError(f"the kernel takes dh == {_DH}, got {dh}")
    if kv_len is None:
        kv_len = torch.full((B,), T, dtype=torch.int32, device=q.device)
    elif kv_len.dtype != torch.int32 or kv_len.device != q.device:
        raise ValueError(f"kv_len must be int32 on {q.device}, got "
                         f"{kv_len.dtype} on {kv_len.device}")
    kv_len = kv_len.contiguous()
    fn = _entry()
    with torch.cuda.device(q.device):
        out = torch.empty_like(q)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
                out.data_ptr(), B, T, H, dh, stream)
    if rc != 0:
        raise RuntimeError(f"attention kernel launch refused: cudaError {rc}")
    LAUNCHES[route(T)] += 1
    return out
