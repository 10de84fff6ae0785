"""Shared model building blocks (counterpart of
:mod:`adyolo_tpu.models.layers`).

Convolutions run NCHW ``(B, C, T, F)`` inside the encoder; the JAX package
runs ``(B, T, F, C)``.  Every block takes an optional ``frame_mask (B, T)``
so bucketed clips reproduce exact-length numerics: padded frames are
re-zeroed after every conv and BN, and the SE squeeze averages over valid
frames only.

In training mode ``BatchNorm`` normalises with the batch statistics and
updates its running stats the JAX package's way (biased variance, flax
momentum 0.9), :class:`U8Dropout` drops with the u8 threshold, and
``BiGRU`` drops between its layers.

Compute dtype, as flax's ``dtype=``: the parameters stay float32 and the
convolutions, linears and LayerNorms here compute in their input's dtype,
casting the weight to it at use (:class:`Conv2d`, :class:`Conv1d`,
:class:`Linear`; :class:`LayerNorm` normalises in at least float32 and
returns the input's dtype).  So an encoder that casts its input to
bfloat16 runs its stack in bfloat16, and a float32 input runs as plain
``nn`` modules do.  ``BatchNorm`` keeps its statistics in at least float32
and applies ``x * mul + shift`` in the input's dtype.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel import mesh

__all__ = ["apply_frame_mask", "pool_mask", "stats_dtype", "Conv2d", "Conv1d",
           "Linear", "LayerNorm", "BatchNorm", "frozen_running_stats", "global_batch_stats",
           "U8Dropout", "Conv3x3", "SELayer", "SEBasicBlock",
           "SelfAttentionPooling", "reverse_sequence", "BiGRU"]

GRU_DROPOUT = 0.3  # between the BiGRU's layers (reference resnet.py:153)


def apply_frame_mask(x: torch.Tensor, frame_mask: Optional[torch.Tensor],
                     time_dim: int = 1) -> torch.Tensor:
    """Zero the padded frames of ``x``; its axis ``time_dim`` is time and
    axis 0 is batch.  mask: (B, T) bool."""
    if frame_mask is None:
        return x
    shape = [1] * x.ndim
    shape[0], shape[time_dim] = frame_mask.shape
    return x * frame_mask.reshape(shape).to(x.dtype)


def pool_mask(frame_mask: Optional[torch.Tensor], factor: int
              ) -> Optional[torch.Tensor]:
    """The frame mask after a stride-``factor`` time pool (valid lengths
    are multiples of the total pool factor, so slicing is exact)."""
    if frame_mask is None:
        return None
    return frame_mask[:, ::factor]


def stats_dtype(dtype: torch.dtype) -> torch.dtype:
    """At least float32: where statistics, softmaxes and the encoders'
    tails run (float64 stays float64)."""
    return torch.promote_types(dtype, torch.float32)


def _in_dtype_of(x: torch.Tensor, fn, weight, bias):
    """``fn(x, weight, bias)`` in x's dtype, the parameters cast to it.  A
    bfloat16 product on the CPU is computed in float32 on the bfloat16
    values and rounded once, which is what the card's bfloat16 conv and
    GEMM compute (float32 sums): oneDNN's CPU bfloat16 convolution gives
    wrong sums at some shapes (torch 2.13: 256 -> 512 channels, 3x3,
    stride (1, 2) on 2 frequency bins, errors above the output's max)."""
    w = weight.to(x.dtype)
    b = None if bias is None else bias.to(x.dtype)
    if x.device.type == "cpu" and x.dtype == torch.bfloat16:
        f = torch.float32
        return fn(x.to(f), w.to(f), None if b is None else b.to(f)).to(x.dtype)
    return fn(x, w, b)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computing in its input's dtype (weight and bias cast
    to it at use; the parameters stay as they are)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _in_dtype_of(x, self._conv_forward, self.weight, self.bias)


class Conv1d(nn.Conv1d):
    """``nn.Conv1d`` computing in its input's dtype, as :class:`Conv2d`."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _in_dtype_of(x, self._conv_forward, self.weight, self.bias)


class Linear(nn.Linear):
    """``nn.Linear`` computing in its input's dtype, as :class:`Conv2d`."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _in_dtype_of(x, F.linear, self.weight, self.bias)


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` that normalises in at least float32 and returns its
    input's dtype, as flax's ``LayerNorm(dtype=...)`` does."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.to(stats_dtype(x.dtype)), self.normalized_shape,
                         self.weight, self.bias, self.eps)
        return y.to(x.dtype)


class BatchNorm(nn.Module):
    """BatchNorm as the JAX package computes it (``layers.py:133-155``):
    ``x * mul + shift`` with ``mul = rsqrt(var + eps) * weight`` and
    ``shift = bias - mean * mul``.  Channels are dim 1 (NCHW convs), or the
    last dim with ``channel_last=True`` (the conformer conv module's
    ``(B, T, C)``, normalised in place of a transpose).

    Eval uses the running stats.  Training uses the batch's: one-pass
    ``E[x²] − E[x]²`` **biased** variance, clamped at 0, and updates the
    running stats in place to ``0.9 * ra + 0.1 * batch`` (flax's momentum)
    with that biased variance (torch's ``nn.BatchNorm2d`` would use the
    unbiased one).  Building the module runs no forward, so building
    updates nothing (flax's ``is_initializing`` guard); nor does a forward
    inside :func:`frozen_running_stats` (a checkpointed block's recompute).

    The statistics are taken in at least float32 and ``mul`` / ``shift``
    are cast to the input's dtype, so a bfloat16 input is normalised by
    one multiply-add in bfloat16 (``layers.py:133-155``).

    Under data parallelism (inside :func:`global_batch_stats`) the batch
    statistics are the global batch's, as XLA partitions the JAX step's
    batch mean: the per-rank sums of x and x² and the element count are
    summed over ``group`` by one differentiable all-reduce, in at least
    float32, before the variance and the running-stat update, so every
    rank normalises alike and keeps the same running stats."""

    momentum = 0.9
    update_stats = True
    group = None  # the process group of the global batch; None: this batch

    def __init__(self, channels: int, eps: float = 1e-5,
                 channel_last: bool = False):
        super().__init__()
        self.eps = eps
        self.channel_last = channel_last
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            axes = tuple(range(x.ndim - 1)) if self.channel_last else \
                (0,) + tuple(range(2, x.ndim))
            xf = x.to(stats_dtype(x.dtype))
            if self.group is None:
                mean = xf.mean(dim=axes)
                var = torch.clamp((xf * xf).mean(dim=axes) - mean * mean, min=0.0)
            else:  # the global batch's: sums of x, x² and the count over the ranks
                s1 = xf.sum(dim=axes)
                n = torch.full_like(s1, xf.numel() // s1.numel())
                s = mesh.all_reduce_sum(torch.stack([s1, (xf * xf).sum(dim=axes), n]),
                                        self.group)
                mean = s[0] / s[2]
                var = torch.clamp(s[1] / s[2] - mean * mean, min=0.0)
            if self.update_stats:
                with torch.no_grad():
                    m = self.momentum
                    self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                    self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        shift = self.bias - mean * mul
        mul, shift = mul.to(x.dtype), shift.to(x.dtype)
        if self.channel_last:
            return x * mul + shift
        shape = (1, -1) + (1,) * (x.ndim - 2)
        return x * mul.reshape(shape) + shift.reshape(shape)


@contextlib.contextmanager
def frozen_running_stats(module: nn.Module):
    """Training-mode forwards of ``module`` inside the context leave every
    ``BatchNorm``'s running stats as they are (they still normalise with
    the batch's): a checkpointed block's recompute must not update them a
    second time."""
    bns = [m for m in module.modules() if isinstance(m, BatchNorm)]
    for m in bns:
        m.update_stats = False
    try:
        yield
    finally:
        for m in bns:
            m.update_stats = True


@contextlib.contextmanager
def global_batch_stats(module: nn.Module, group):
    """Training-mode forwards of ``module`` inside the context (the remat
    recompute in the backward included) normalise every ``BatchNorm`` by
    the statistics of the global batch over ``group``'s ranks."""
    bns = [m for m in module.modules() if isinstance(m, BatchNorm)]
    for m in bns:
        m.group = group
    try:
        yield
    finally:
        for m in bns:
            m.group = None


class U8Dropout(nn.Module):
    """Dropout driven by uint8 random bits (``layers.py:158-188``): the rate
    is quantized to ``t = round(rate * 256)`` (0.2 -> 51), an element is
    kept when its bits are ``>= t`` and scaled by ``256 / (256 - t)``;
    ``t >= 256`` gives zeros.  The keep-scale is rounded to the input's
    dtype first, as JAX's ``jnp.asarray(scale, x.dtype)`` (bfloat16: 1.25).
    The bits come from ``generator`` (the device's default one when None),
    not from JAX's threefry stream.  Identity in eval.

    ``shard = (i, n)`` (tensor parallelism): ``x`` is piece ``i`` of ``n``
    of a tensor split along its last axis; the bits of the whole tensor are
    drawn and ``x``'s piece kept, so the mask is the unsharded model's and
    the generator advances alike on every rank."""

    shard: Optional[Tuple[int, int]] = None

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        thresh = int(round(self.rate * 256.0))
        if not self.training or thresh <= 0:
            return x
        if thresh >= 256:  # uint8(256) would wrap to "keep all"
            return torch.zeros_like(x)
        shape, (i, n) = x.shape, self.shard or (0, 1)
        bits = torch.randint(0, 256, (*shape[:-1], shape[-1] * n), dtype=torch.uint8,
                             device=x.device, generator=generator)
        if n > 1:
            bits = bits.narrow(-1, i * shape[-1], shape[-1])
        scale = float(torch.tensor(256.0 / (256.0 - thresh), dtype=x.dtype))
        return torch.where(bits >= thresh, x * scale, 0.0)


def Conv3x3(in_ch: int, out_ch: int, bias: bool = False) -> Conv2d:
    """3x3 convolution, padding 1 ("SAME"), NCHW."""
    return Conv2d(in_ch, out_ch, 3, padding=1, bias=bias)


class SELayer(nn.Module):
    """Squeeze-and-excitation, reduction 8; the squeeze is a (masked)
    global mean over (T, F).  All in the input's dtype."""

    def __init__(self, channels: int, reduction: int = 8):
        super().__init__()
        self.fc1 = Linear(channels, channels // reduction)
        self.fc2 = Linear(channels // reduction, channels)

    def forward(self, x: torch.Tensor, frame_mask=None) -> torch.Tensor:
        # x: (B, C, T, F)
        if frame_mask is None:
            y = x.mean(dim=(2, 3))
        else:
            m = frame_mask[:, None, :, None].to(x.dtype)
            y = (x * m).sum(dim=(2, 3)) / (m.sum(dim=(2, 3)) * x.shape[3] + 1e-12)
        y = torch.sigmoid(self.fc2(F.relu(self.fc1(y))))
        return x * y[:, :, None, None]


class SEBasicBlock(nn.Module):
    """SE residual block: conv3x3 -> ReLU -> BN -> conv3x3 -> BN -> SE ->
    (+ residual, 1x1 conv + BN when the width changes) -> ReLU.  The
    conv -> ReLU -> BN order of the first conv is the reference's."""

    def __init__(self, in_ch: int, planes: int, reduction: int = 8):
        super().__init__()
        self.conv1 = Conv3x3(in_ch, planes)
        self.bn1 = BatchNorm(planes)
        self.conv2 = Conv3x3(planes, planes)
        self.bn2 = BatchNorm(planes)
        self.se = SELayer(planes, reduction)
        if in_ch != planes:
            self.down_conv = Conv2d(in_ch, planes, 1, bias=False)
            self.down_bn = BatchNorm(planes)
        else:
            self.down_conv = None

    def forward(self, x: torch.Tensor, frame_mask=None) -> torch.Tensor:
        out = apply_frame_mask(self.bn1(F.relu(self.conv1(x))), frame_mask, 2)
        out = apply_frame_mask(self.bn2(self.conv2(out)), frame_mask, 2)
        out = self.se(out, frame_mask)
        residual = x
        if self.down_conv is not None:
            residual = apply_frame_mask(self.down_bn(self.down_conv(x)),
                                        frame_mask, 2)
        return apply_frame_mask(F.relu(out + residual), frame_mask, 2)


class SelfAttentionPooling(nn.Module):
    """Attention pooling over frequency: a scalar score per (t, f),
    softmax over f, weighted sum.  x: (B, T, F, C) -> (B, T, C)."""

    def __init__(self, dim: int):
        super().__init__()
        self.W = nn.Linear(dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        attn = torch.softmax(self.W(x)[..., 0], dim=-1)  # (B, T, F)
        return torch.einsum("btfc,btf->btc", x, attn)


def reverse_sequence(x: torch.Tensor, lengths: Optional[torch.Tensor]
                     ) -> torch.Tensor:
    """Reverse each (B, T, ...) sequence within its valid length; padded
    frames stay at the tail."""
    if lengths is None:
        return torch.flip(x, dims=(1,))
    B, T = x.shape[:2]
    t = torch.arange(T, device=x.device)[None, :]
    L = lengths.to(x.device)[:, None]
    idx = torch.where(t < L, L - 1 - t, t)
    idx = idx.reshape(B, T, *([1] * (x.ndim - 2))).expand_as(x)
    return torch.gather(x, 1, idx)


class BiGRU(nn.Module):
    """Multi-layer bidirectional GRU as two unidirectional ``nn.GRU`` per
    layer (``l{i}_fwd``, ``l{i}_bwd``).  The backward direction reads the
    length-aware :func:`reverse_sequence` of its input and its output is
    reversed back, so it starts from the last *valid* frame; the forward
    direction runs through padded frames, whose outputs the caller
    ignores.  In training, :class:`U8Dropout` at ``dropout`` (0.3: t = 77,
    keep-scale 256/179) on every layer's output but the last, as torch's
    ``nn.GRU(dropout=...)`` and the JAX package (``layers.py:415-438``);
    its bits come from the ``generator`` passed to ``forward``."""

    def __init__(self, input_dim: int, hidden: int, num_layers: int = 2,
                 dropout: float = GRU_DROPOUT):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            d = input_dim if i == 0 else 2 * hidden
            self.add_module(f"l{i}_fwd", nn.GRU(d, hidden, batch_first=True))
            self.add_module(f"l{i}_bwd", nn.GRU(d, hidden, batch_first=True))
        self.drop = U8Dropout(dropout)

    def forward(self, x: torch.Tensor, lengths=None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        for i in range(self.num_layers):
            fwd, _ = getattr(self, f"l{i}_fwd")(x)
            bwd, _ = getattr(self, f"l{i}_bwd")(reverse_sequence(x, lengths))
            x = torch.cat([fwd, reverse_sequence(bwd, lengths)], dim=-1)
            if i < self.num_layers - 1:
                x = self.drop(x, generator)
        return x
