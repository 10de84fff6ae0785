"""Wrapper of the hand-written Hopper attention kernels (``csrc/attention.cu``).

The kernels replace three TPU kernels of ``adyolo_tpu/ops/flash_mhsa.py``
and are launched from seven routes that are counted apart:

* ``"k2"``: the eval forward for ``T <= attention.BLOCK_THRESHOLD`` (2400
  frames): K2, ``_fwd_kernel`` via ``_flash_fwd``, at dropout rate 0;
* ``"k2_bf16"``: the same on bfloat16 q/k/v (bf16 serving), on the bf16
  train forward's kernel built without dropout: bfloat16 products with
  float32 sums, P rounded to bfloat16 before P·V, the output rounded to
  bfloat16;
* ``"k4"``: the eval forward for longer clips: K4, ``_long_kernel`` via
  ``flash_mhsa_long``.  A bfloat16 eval call above 2400 frames (long-clip
  bf16 serving) runs ``k4`` on float32 copies of q/k/v, its output rounded
  to bfloat16, and is counted under ``k4``;
* ``"k2_dropout"``: the train forward (K2 with its dropout branch), which
  also writes the row logsumexp for the backward;
* ``"k3"``: the backward, K3, ``_bwd_kernel`` via ``_flash_bwd``;
* ``"k2_dropout_bf16"`` and ``"k3_bf16"``: the same pair on bfloat16
  q/k/v (bf16 training), bfloat16 tensor-core products with float32 sums
  at the JAX kernels' rounding points; the forward also writes its output
  in float32, from which the backward takes ``D = rowsum(dO∘O)``.

A call is routed by its dropout rate (the module's: 0.2 in training, 0
in eval, as JAX routes by its ``train`` flag), then by T and by whether
autograd records it:

* rate > 0: the train pair, ``k2_dropout`` forward and ``k3`` backward in
  one ``torch.autograd.Function``; ``T > BLOCK_THRESHOLD`` raises, as in
  the JAX package, whose longer training chunks would take the XLA path;
* rate 0, ``T <= BLOCK_THRESHOLD``: ``k2`` (``k2_bf16``), or, when
  autograd records the call, the train pair at rate 0, which has a
  backward (as JAX's ``flash_mhsa`` custom VJP does at rate 0);
* rate 0, ``T > BLOCK_THRESHOLD``: ``k4`` whatever the grad mode; when
  autograd records the call, inside a ``torch.autograd.Function`` whose
  backward raises: no kernel has a backward for K4 (the JAX package has
  none either).

q/k/v are float32 or bfloat16.  The dtype picks the kernel; nothing is
cast, but for bfloat16 ``k4``.

The eval forward (rate 0, autograd not recording) is the custom op
``adyolo::mhsa_eval`` (:mod:`adyolo_tpu_torch.ops.library`; its CUDA kernel
is :func:`eval_forward`), one op in an exported serving graph; the train
pair is ``adyolo::mhsa_train`` and ``adyolo::mhsa_train_bwd`` (CUDA kernels
:func:`train_forward` and :func:`train_backward`) inside one
``torch.autograd.Function``.  Dispatch is by the tensor's device: a CPU
tensor goes to the plain
:func:`adyolo_tpu_torch.ops.attention.mhsa_attention` (differentiable by
autograd, except on the long eval route, which raises in its backward on
both devices; bfloat16 training through the train pair's ops, whose CPU
kernels are the plain forward and the written-out
:func:`~adyolo_tpu_torch.ops.attention.mhsa_attention_bwd`, K3's rounding);
a CUDA tensor goes to the kernels, or the call raises.  There is no
fallback from one to the other.

``LAUNCHES`` counts launches per route; a count is bumped right after a
launch is accepted, and nowhere else.  A forward on a grid under a wave
runs its key tiles in splits and a merge (two device kernels, one count);
the wrapper keeps the split plan per device and shape and allocates the
merge's scratch.  ``KERNELS`` counts the device kernels of those
launches by kernel name (:func:`forward_kernels`,
:func:`backward_kernels`), bumped with ``LAUNCHES``: what a profile of
the calls must hold (``utils/profiling.py::kernels_launched``).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from ..utils.build import launch_error, load_library
from . import attention

__all__ = ["flash_attention", "eval_forward", "train_forward", "train_backward",
           "route", "forward_kernels", "backward_kernels", "LAUNCHES", "KERNELS"]

LAUNCHES = {"k2": 0, "k4": 0, "k2_dropout": 0, "k3": 0, "k2_dropout_bf16": 0,
            "k3_bf16": 0, "k2_bf16": 0}
KERNELS = {"mhsa_fwd_kernel": 0, "mhsa_fwd_bf16_kernel": 0, "mhsa_fwd_merge_kernel": 0,
           "mhsa_bwd_dq_kernel": 0, "mhsa_bwd_dkdv_kernel": 0, "mhsa_bwd_dq_bf16_kernel": 0,
           "mhsa_bwd_dkdv_bf16_kernel": 0}

_DH = 64  # the kernels' head dim
_DTYPES = (torch.float32, torch.bfloat16)


class _Pair(NamedTuple):
    """The train pair of one dtype: its routes and C entry points."""
    fwd_route: str
    bwd_route: str
    fwd_entry: str
    bwd_entry: str
    splits_entry: str


_TRAIN = {torch.float32: _Pair("k2_dropout", "k3", "adyolo_mhsa_fwd_train",
                               "adyolo_mhsa_bwd", "adyolo_mhsa_fwd_splits"),
          torch.bfloat16: _Pair("k2_dropout_bf16", "k3_bf16", "adyolo_mhsa_fwd_train_bf16",
                                "adyolo_mhsa_bwd_bf16", "adyolo_mhsa_fwd_bf16_splits")}

_bound = {}
_plans = {}  # (device index, dtype, B, T, H) -> (key splits, scratch floats) of a forward

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "adyolo_mhsa_fwd_splits": [_I] * 3,
    "adyolo_mhsa_fwd_bf16_splits": [_I] * 3,
    "adyolo_mhsa_fwd_scratch_floats": [_I] * 4,
    "adyolo_mhsa_fwd": [_P] * 6 + [_I] * 5 + [_P],
    "adyolo_mhsa_fwd_bf16": [_P] * 6 + [_I] * 5 + [_P],
    "adyolo_mhsa_fwd_train": [_P] * 8 + [_I] * 10 + [_P],
    "adyolo_mhsa_fwd_train_bf16": [_P] * 9 + [_I] * 10 + [_P],
    "adyolo_mhsa_bwd": [_P] * 12 + [_I] * 9 + [_P],
    "adyolo_mhsa_bwd_bf16": [_P] * 12 + [_I] * 9 + [_P],
}
_RESTYPES = {"adyolo_mhsa_fwd_scratch_floats": ctypes.c_longlong}


def _entry(name):
    if name not in _bound:
        fn = getattr(load_library(), name)
        fn.restype = _RESTYPES.get(name, ctypes.c_int)
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
        if x.dtype not in _DTYPES or x.dtype != q.dtype:
            raise TypeError(f"{name} must be float32 or bfloat16, as q, got "
                            f"{x.dtype} (q {q.dtype})")
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


def forward_kernels(dtype, splits):
    """The device kernels of one forward launch on ``dtype`` q/k/v in
    ``splits`` key splits (``csrc/attention.cu::launch_fwd``,
    ``launch_fwd_bf16``): the forward kernel, and the merge above one
    split."""
    fwd = "mhsa_fwd_bf16_kernel" if dtype == torch.bfloat16 else "mhsa_fwd_kernel"
    return {fwd: 1, "mhsa_fwd_merge_kernel": 1} if splits > 1 else {fwd: 1}


def backward_kernels(dtype):
    """The device kernels of one backward launch on ``dtype`` q/k/v: the dq
    pass, then the dk/dv pass (``adyolo_mhsa_bwd``, ``adyolo_mhsa_bwd_bf16``)."""
    sfx = "_bf16" if dtype == torch.bfloat16 else ""
    return {f"mhsa_bwd_dq{sfx}_kernel": 1, f"mhsa_bwd_dkdv{sfx}_kernel": 1}


def _count(rt, kernels):
    LAUNCHES[rt] += 1
    for name, n in kernels.items():
        KERNELS[name] += n


def _launch(name, *args):
    rc = _entry(name)(*args)
    if rc != 0:
        raise launch_error("attention kernel launch refused", rc)


def _hash_args(T, head_offset, heads_total):
    """The dropout hash's indexing: the JAX blocking (bq, Tp) and the
    launch's heads within the model's (head_offset, heads_total)."""
    return attention.pick_bq(T), -(-T // 128) * 128, head_offset, heads_total


def _fwd_plan(q):
    """``(splits, scratch pointer, scratch)`` of a forward on ``q``'s
    shape, dtype and device (the current one): the kernel's key splits
    and, when above 1, scratch for the merge, which the caller holds until
    the launch is queued."""
    B, T, H, _ = q.shape
    key = (q.device.index, q.dtype, B, T, H)
    plan = _plans.get(key)
    if plan is None:
        splits = _entry(_TRAIN[q.dtype].splits_entry)(B, T, H)
        if splits < 1:
            raise launch_error("attention kernel: no split plan", -splits)
        n = _entry("adyolo_mhsa_fwd_scratch_floats")(B, T, H, splits) if splits > 1 else 0
        plan = _plans[key] = (splits, n)
    splits, n = plan
    if splits == 1:
        return 1, 0, None
    scratch = torch.empty((n,), device=q.device, dtype=torch.float32)
    return splits, scratch.data_ptr(), scratch


def _eval_launch(q, k, v, kv_len, rt):
    """One eval kernel launch on route ``rt`` (``k2``, ``k4`` on float32,
    ``k2_bf16`` on bfloat16 q/k/v) on the current CUDA device."""
    B, T, H, dh = q.shape
    out = torch.empty_like(q)
    splits, ptr, _scratch = _fwd_plan(q)
    stream = torch.cuda.current_stream().cuda_stream
    entry = "adyolo_mhsa_fwd_bf16" if q.dtype == torch.bfloat16 else "adyolo_mhsa_fwd"
    _launch(entry, q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
            out.data_ptr(), ptr, B, T, H, dh, splits, stream)
    _count(rt, forward_kernels(q.dtype, splits))
    return out


def eval_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The eval forward on CUDA q/k/v (the CUDA kernel of
    ``adyolo::mhsa_eval``): float32 on ``k2`` (``T <= BLOCK_THRESHOLD``)
    or ``k4``; bfloat16 on ``k2_bf16``, or above ``BLOCK_THRESHOLD`` on
    ``k4`` over float32 copies of q/k/v with the output rounded to
    bfloat16.  ``kv_len`` None: every key valid."""
    B, T, H, dh = q.shape
    if dh != _DH:
        raise ValueError(f"the kernels take dh == {_DH}, got {dh}")
    with torch.cuda.device(q.device):
        if kv_len is None:
            kv_len = torch.full((B,), T, dtype=torch.int32, device=q.device)
        kv_len = _int32_on(kv_len, q.device, "kv_len")
        rt = route(T)
        if q.dtype == torch.bfloat16:
            if rt == "k4":
                return _eval_launch(q.float(), k.float(), v.float(), kv_len,
                                    rt).to(torch.bfloat16)
            rt = "k2_bf16"
        return _eval_launch(q, k, v, kv_len, rt)


def train_forward(q, k, v, kv_len, seed, rate, heads):
    """The train forward on CUDA q/k/v (the CUDA kernel of
    ``adyolo::mhsa_train``): route ``k2_dropout`` (float32) or
    ``k2_dropout_bf16`` (bfloat16) at dropout ``rate`` on heads ``heads =
    (head_offset, heads_total)``.  Returns ``(out, out32, lse)``: ``out32``
    the bfloat16 forward's float32 output (0 elements for float32, whose
    ``out`` is float32), ``lse`` the row logsumexp ``(B, H, T)``."""
    B, T, H, dh = q.shape
    pair = _TRAIN[q.dtype]
    with torch.cuda.device(q.device):
        out = torch.empty_like(q)
        lse = torch.empty((B, H, T), device=q.device, dtype=torch.float32)
        splits, ptr, _scratch = _fwd_plan(q)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
                seed.data_ptr(), out.data_ptr()]
        if q.dtype == torch.bfloat16:
            out32 = torch.empty(q.shape, device=q.device, dtype=torch.float32)
            ptrs.append(out32.data_ptr())
        else:
            out32 = q.new_empty((0,), dtype=torch.float32)
        _launch(pair.fwd_entry, *ptrs, lse.data_ptr(), ptr, B, T, H, dh,
                attention.dropout_thresh(rate), *_hash_args(T, *heads), splits, stream)
    _count(pair.fwd_route, forward_kernels(q.dtype, splits))
    return out, out32, lse


def train_backward(q, k, v, kv_len, seed, out32, lse, dout, rate, heads):
    """The train backward on CUDA tensors (the CUDA kernel of
    ``adyolo::mhsa_train_bwd``): route ``k3`` or ``k3_bf16``, from the
    forward's float32 output ``out32`` (its ``out`` for float32) and
    ``lse``.  Returns ``(dq, dk, dv)``."""
    B, T, H, dh = q.shape
    pair = _TRAIN[q.dtype]
    with torch.cuda.device(q.device):
        dq, dk, dv = (torch.empty_like(q) for _ in range(3))
        delta = torch.empty_like(lse)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        _launch(pair.bwd_entry, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                kv_len.data_ptr(), seed.data_ptr(), out32.data_ptr(),
                dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                dk.data_ptr(), dv.data_ptr(), B, T, H, dh, attention.dropout_thresh(rate),
                *_hash_args(T, *heads), stream)
    _count(pair.bwd_route, backward_kernels(q.dtype))
    return dq, dk, dv


class _TrainAttention(torch.autograd.Function):
    """The train pair through ``adyolo::mhsa_train`` and
    ``adyolo::mhsa_train_bwd``: on CUDA the kernels of q's dtype
    (:func:`train_forward`, :func:`train_backward`); on the CPU the plain
    pair, :func:`~adyolo_tpu_torch.ops.attention.mhsa_attention` and the
    written-out backward at K3's rounding points (the bfloat16 route)."""

    @staticmethod
    def forward(ctx, q, k, v, kv_len, seed, rate, heads):
        out, out32, lse = torch.ops.adyolo.mhsa_train(q, k, v, kv_len, seed, rate, *heads)
        ctx.save_for_backward(q, k, v, kv_len, seed,
                              out if q.dtype == torch.float32 else out32, lse)
        ctx.rate, ctx.heads = rate, heads
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, kv_len, seed, out32, lse = ctx.saved_tensors
        grads = torch.ops.adyolo.mhsa_train_bwd(q, k, v, kv_len, seed, out32, lse,
                                                dout.to(q.dtype).contiguous(), ctx.rate,
                                                *ctx.heads)
        return (*grads, None, None, None, None)


class _LongAttention(torch.autograd.Function):
    """The long eval route under autograd: ``adyolo::mhsa_eval`` (``k4`` on
    CUDA, the plain attention on the CPU); no backward on either device."""

    @staticmethod
    def forward(ctx, q, k, v, kv_len):
        return torch.ops.adyolo.mhsa_eval(q, k, v, kv_len)

    @staticmethod
    def backward(ctx, dout):
        raise NotImplementedError(
            f"eval attention at T > {attention.BLOCK_THRESHOLD} (route k4, K4 "
            "flash_mhsa_long) has no backward; train at T <= "
            f"{attention.BLOCK_THRESHOLD}, or run eval under torch.no_grad()")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_len: Optional[torch.Tensor] = None, *, rate: float = 0.0,
                    seed: Optional[torch.Tensor] = None,
                    heads: Optional[tuple] = None) -> torch.Tensor:
    """Attention over ``(B, T, H, dh)`` q/k/v with the first ``kv_len[b]``
    keys valid (all when None) and dropout ``rate`` on the probabilities
    (``seed``: int32 tensor of one element; ``heads``: ``(head_offset,
    heads_total)`` when q/k/v hold heads ``[head_offset, head_offset + H)``
    of a model's ``heads_total``, a tensor-parallel rank's shard, whose keep
    bits are then the full model's of those heads; None: ``(0, H)``); see
    :func:`~adyolo_tpu_torch.ops.attention.mhsa_attention`.  ``rate > 0``
    picks the training route, which needs ``T <= BLOCK_THRESHOLD``; the
    eval route above it has no backward.  float32 or bfloat16.  On CUDA
    the kernels need ``dh == 64`` and int32 ``kv_len``/``seed`` on q's
    device."""
    _check(q, k, v, kv_len)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")
    B, T, H, dh = q.shape
    thresh = attention.dropout_thresh(rate)
    train = thresh > 0
    long = T > attention.BLOCK_THRESHOLD
    if train and long:
        raise ValueError(f"training attention needs T <= "
                         f"{attention.BLOCK_THRESHOLD}, got T={T}")
    records = torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v))
    if not (train or records):
        return torch.ops.adyolo.mhsa_eval(q, k, v, kv_len)
    if long:
        return _LongAttention.apply(q, k, v, kv_len)
    heads = attention.head_range(H, heads)
    if q.device.type == "cpu":
        if q.dtype == torch.bfloat16:
            return _TrainAttention.apply(q, k, v, kv_len, seed, rate, heads)
        return attention.mhsa_attention(q, k, v, kv_len, rate=rate, seed=seed, heads=heads)
    if dh != _DH:
        raise ValueError(f"the kernels take dh == {_DH}, got {dh}")
    if thresh >= 256:  # everything dropped (U8Dropout's convention)
        return torch.zeros_like(q)
    if kv_len is None:
        kv_len = torch.full((B,), T, dtype=torch.int32, device=q.device)
    kv_len = _int32_on(kv_len, q.device, "kv_len")
    with torch.cuda.device(q.device):
        if seed is None:
            if thresh > 0:
                raise ValueError("dropout needs a seed")
            seed = torch.zeros((1,), dtype=torch.int32, device=q.device)
        seed = _int32_on(seed, q.device, "seed").reshape(1)
        return _TrainAttention.apply(q, k, v, kv_len, seed, rate, heads)
