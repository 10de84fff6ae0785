"""Wrapper of the hand-written Hopper attention kernels (``csrc/attention.cu``).

The kernels replace three TPU kernels of ``adyolo_tpu/ops/flash_mhsa.py``
and are launched from four routes that are counted apart:

* ``"k2"``: the eval forward for ``T <= attention.BLOCK_THRESHOLD`` (2400
  frames): K2, ``_fwd_kernel`` via ``_flash_fwd``, at dropout rate 0;
* ``"k4"``: the eval forward for longer clips: K4, ``_long_kernel`` via
  ``flash_mhsa_long``;
* ``"k2_dropout"``: the train forward (K2 with its dropout branch), which
  also writes the row logsumexp for the backward;
* ``"k3"``: the backward, K3, ``_bwd_kernel`` via ``_flash_bwd``.

A call takes the train pair (``k2_dropout`` forward, ``k3`` backward, one
``torch.autograd.Function``) when its rate is above 0 or autograd records
it; training needs ``T <= BLOCK_THRESHOLD``, as in the JAX package, whose
longer training chunks would take the XLA path.

Dispatch is by the tensor's device: a CPU tensor goes to the plain
:func:`adyolo_tpu_torch.ops.attention.mhsa_attention` (differentiable by
autograd); a CUDA tensor goes to the kernels, or the call raises.  There is
no fallback from one to the other.

``LAUNCHES`` counts launches per route; a count is bumped right after a
launch is accepted, and nowhere else.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..utils.build import load_library
from . import attention

__all__ = ["flash_attention", "route", "LAUNCHES"]

LAUNCHES = {"k2": 0, "k4": 0, "k2_dropout": 0, "k3": 0}

_DH = 64  # the kernels' head dim

_bound = {}

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "adyolo_mhsa_fwd": [_P] * 5 + [_I] * 4 + [_P],
    "adyolo_mhsa_fwd_train": [_P] * 7 + [_I] * 7 + [_P],
    "adyolo_mhsa_bwd": [_P] * 12 + [_I] * 7 + [_P],
}


def _entry(name):
    if name not in _bound:
        fn = getattr(load_library(), name)
        fn.restype = ctypes.c_int
        fn.argtypes = _SIGNATURES[name]
        _bound[name] = fn
    return _bound[name]


def route(T: int) -> str:
    """The eval route (and TPU kernel counterpart) of a ``T``-frame call."""
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


def _int32_on(x, device, name):
    if x.dtype != torch.int32 or x.device != device:
        raise ValueError(f"{name} must be int32 on {device}, got {x.dtype} "
                         f"on {x.device}")
    return x.contiguous()


def _launch(name, *args):
    rc = _entry(name)(*args)
    if rc != 0:
        raise RuntimeError(f"attention kernel launch refused ({name}): "
                           f"cudaError {rc}")


def _hash_args(T):
    """The JAX blocking that indexes the dropout hash: (bq, Tp)."""
    return attention.pick_bq(T), -(-T // 128) * 128


class _TrainAttention(torch.autograd.Function):
    """The train pair: forward on route ``k2_dropout``, backward on ``k3``."""

    @staticmethod
    def forward(ctx, q, k, v, kv_len, seed, thresh):
        B, T, H, dh = q.shape
        out = torch.empty_like(q)
        lse = torch.empty((B, H, T), device=q.device, dtype=torch.float32)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        _launch("adyolo_mhsa_fwd_train", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                kv_len.data_ptr(), seed.data_ptr(), out.data_ptr(), lse.data_ptr(),
                B, T, H, dh, thresh, *_hash_args(T), stream)
        LAUNCHES["k2_dropout"] += 1
        ctx.save_for_backward(q, k, v, kv_len, seed, out, lse)
        ctx.thresh = thresh
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, kv_len, seed, out, lse = ctx.saved_tensors
        B, T, H, dh = q.shape
        dout = dout.contiguous()
        dq, dk, dv = (torch.empty_like(q) for _ in range(3))
        delta = torch.empty_like(lse)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        _launch("adyolo_mhsa_bwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                kv_len.data_ptr(), seed.data_ptr(), out.data_ptr(),
                dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                dk.data_ptr(), dv.data_ptr(), B, T, H, dh, ctx.thresh,
                *_hash_args(T), stream)
        LAUNCHES["k3"] += 1
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_len: Optional[torch.Tensor] = None, *, rate: float = 0.0,
                    seed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention over ``(B, T, H, dh)`` float32 q/k/v with the first
    ``kv_len[b]`` keys valid (all when None) and dropout ``rate`` on the
    probabilities (``seed``: int32 tensor of one element); see
    :func:`~adyolo_tpu_torch.ops.attention.mhsa_attention`.  On CUDA the
    kernels need ``dh == 64`` and int32 ``kv_len``/``seed`` on q's device."""
    _check(q, k, v, kv_len)
    if q.device.type == "cpu":
        return attention.mhsa_attention(q, k, v, kv_len, rate=rate, seed=seed)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    B, T, H, dh = q.shape
    if dh != _DH:
        raise ValueError(f"the kernels take dh == {_DH}, got {dh}")
    thresh = attention.dropout_thresh(rate)
    if thresh >= 256:  # everything dropped (U8Dropout's convention)
        return torch.zeros_like(q)
    if kv_len is None:
        kv_len = torch.full((B,), T, dtype=torch.int32, device=q.device)
    kv_len = _int32_on(kv_len, q.device, "kv_len")
    train = thresh > 0 or (torch.is_grad_enabled()
                           and any(x.requires_grad for x in (q, k, v)))
    with torch.cuda.device(q.device):
        if train:
            if T > attention.BLOCK_THRESHOLD:
                raise ValueError(f"training attention needs T <= "
                                 f"{attention.BLOCK_THRESHOLD}, got T={T}")
            if seed is None:
                if thresh > 0:
                    raise ValueError("dropout needs a seed")
                seed = torch.zeros((1,), dtype=torch.int32, device=q.device)
            seed = _int32_on(seed, q.device, "seed").reshape(1)
            return _TrainAttention.apply(q, k, v, kv_len, seed, thresh)
        out = torch.empty_like(q)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        _launch("adyolo_mhsa_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                kv_len.data_ptr(), out.data_ptr(), B, T, H, dh, stream)
    LAUNCHES[route(T)] += 1
    return out
