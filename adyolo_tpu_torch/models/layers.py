"""Shared model building blocks (counterpart of
:mod:`adyolo_tpu.models.layers`).

Convolutions run NCHW ``(B, C, T, F)`` inside the encoder; the JAX package
runs ``(B, T, F, C)``.  Every block takes an optional ``frame_mask (B, T)``
so bucketed clips reproduce exact-length numerics: padded frames are
re-zeroed after every conv and BN, and the SE squeeze averages over valid
frames only.

In training mode ``BatchNorm`` normalises with the batch statistics and
updates its running stats the JAX package's way (biased variance, flax
momentum 0.9), and :class:`U8Dropout` drops with the u8 threshold.  The
GRU's training (and its inter-layer dropout) waits for SE-ResNet34
training: ``BiGRU`` in training mode raises.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["apply_frame_mask", "pool_mask", "BatchNorm", "U8Dropout",
           "Conv3x3", "SELayer", "SEBasicBlock", "SelfAttentionPooling",
           "reverse_sequence", "BiGRU"]

_NOT_TRAINED = ("training mode is not yet ported (ROADMAP.md, port queue: "
                "SE-ResNet34 training)")


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
    updates nothing (flax's ``is_initializing`` guard)."""

    momentum = 0.9

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
            mean = x.mean(dim=axes)
            var = torch.clamp((x * x).mean(dim=axes) - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        shift = self.bias - mean * mul
        if self.channel_last:
            return x * mul + shift
        shape = (1, -1) + (1,) * (x.ndim - 2)
        return x * mul.reshape(shape) + shift.reshape(shape)


class U8Dropout(nn.Module):
    """Dropout driven by uint8 random bits (``layers.py:158-188``): the rate
    is quantized to ``t = round(rate * 256)`` (0.2 -> 51), an element is
    kept when its bits are ``>= t`` and scaled by ``256 / (256 - t)``;
    ``t >= 256`` gives zeros.  The bits come from ``generator`` (the
    device's default one when None), not from JAX's threefry stream.
    Identity in eval."""

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
        bits = torch.randint(0, 256, x.shape, dtype=torch.uint8,
                             device=x.device, generator=generator)
        return torch.where(bits >= thresh, x * (256.0 / (256.0 - thresh)), 0.0)


def Conv3x3(in_ch: int, out_ch: int, bias: bool = False) -> nn.Conv2d:
    """3x3 convolution, padding 1 ("SAME"), NCHW."""
    return nn.Conv2d(in_ch, out_ch, 3, padding=1, bias=bias)


class SELayer(nn.Module):
    """Squeeze-and-excitation, reduction 8; the squeeze is a (masked)
    global mean over (T, F)."""

    def __init__(self, channels: int, reduction: int = 8):
        super().__init__()
        self.fc1 = nn.Linear(channels, channels // reduction)
        self.fc2 = nn.Linear(channels // reduction, channels)

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
            self.down_conv = nn.Conv2d(in_ch, planes, 1, bias=False)
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
    ignores."""

    def __init__(self, input_dim: int, hidden: int, num_layers: int = 2):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            d = input_dim if i == 0 else 2 * hidden
            self.add_module(f"l{i}_fwd", nn.GRU(d, hidden, batch_first=True))
            self.add_module(f"l{i}_bwd", nn.GRU(d, hidden, batch_first=True))

    def forward(self, x: torch.Tensor, lengths=None) -> torch.Tensor:
        if self.training:
            raise NotImplementedError(f"BiGRU: {_NOT_TRAINED}")
        for i in range(self.num_layers):
            fwd, _ = getattr(self, f"l{i}_fwd")(x)
            bwd, _ = getattr(self, f"l{i}_bwd")(reverse_sequence(x, lengths))
            x = torch.cat([fwd, reverse_sequence(bwd, lengths)], dim=-1)
        return x
