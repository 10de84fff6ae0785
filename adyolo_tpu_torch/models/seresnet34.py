"""SE-ResNet34 + BiGRU SELD encoder (counterpart of
:mod:`adyolo_tpu.models.seresnet34`), eval and training.

* stem: 3x3 conv (bias) -> ReLU -> BN
* 4 stages of SEBasicBlocks [3, 4, 6, 3] x [32, 64, 128, 256] channels;
  stages 2 and 3 open with a 2x2 average pool (T/4, F/4), the frame mask
  pooled alongside
* self-attention pooling over frequency -> (B, T/4, 256)
* 2-layer BiGRU (128 per direction, dropout 0.3 between the layers in
  training) on ``feat_lengths // 4`` valid frames, then LayerNorm + tanh

``dtype`` (the compute dtype, bfloat16 in bf16 training and serving)
casts the input of the stem, so the conv stack, its BatchNorm applies and
the SE layers run in it; the attention pooling, the BiGRU and the LayerNorm run in float32
(``seresnet34.py:70-110``).  The JAX package's packed stages are TPU
layouts of the same math and are not ported.

Input ``(B, T, F, C)`` channel-last, as in the JAX package; the conv stack
runs NCHW.  DCASE shapes: (B, 800, 64, 7) -> (B, 200, 256).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import (BatchNorm, BiGRU, Conv3x3, SEBasicBlock,
                     SelfAttentionPooling, apply_frame_mask, pool_mask,
                     stats_dtype)

__all__ = ["SEResNet34"]

_LAYERS = (3, 4, 6, 3)
_FILTERS = (32, 64, 128, 256)
_POOLS = (False, True, True, False)


class SEResNet34(nn.Module):
    def __init__(self, in_channels: int = 7, enc_out_dim: int = 256,
                 time_pool: int = 4):
        super().__init__()
        self.time_pool = time_pool
        self.conv1 = Conv3x3(in_channels, _FILTERS[0], bias=True)
        self.bn1 = BatchNorm(_FILTERS[0])
        self.blocks = []  # (name, pool before it)
        in_ch = _FILTERS[0]
        for stage, (n_blocks, planes, pool) in enumerate(
                zip(_LAYERS, _FILTERS, _POOLS)):
            for b in range(n_blocks):
                name = f"layer{stage + 1}_block{b}"
                self.add_module(name, SEBasicBlock(in_ch, planes))
                self.blocks.append((name, pool and b == 0))
                in_ch = planes
        self.attention = SelfAttentionPooling(in_ch)
        self.gru = BiGRU(in_ch, enc_out_dim // 2, num_layers=2)
        self.norm = nn.LayerNorm(enc_out_dim, eps=1e-5)

    def forward(self, x: torch.Tensor,
                feat_lengths: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """x: (B, T, F, C); feat_lengths: optional (B,) valid frame counts;
        generator: the GRU dropout's bits in training; dtype: the conv
        stack's compute dtype (None: x's).  Returns (B, T // 4,
        enc_out_dim) in at least float32."""
        frame_mask = None
        if feat_lengths is not None:
            feat_lengths = feat_lengths.to(x.device)
            t = torch.arange(x.shape[1], device=x.device)
            frame_mask = t[None, :] < feat_lengths[:, None]
            x = apply_frame_mask(x, frame_mask)

        if dtype is not None:
            x = x.to(dtype)
        x = x.permute(0, 3, 1, 2).contiguous()  # (B, C, T, F)
        x = apply_frame_mask(self.bn1(F.relu(self.conv1(x))), frame_mask, 2)
        for name, pool in self.blocks:
            if pool:
                x = F.avg_pool2d(x, 2)
                frame_mask = pool_mask(frame_mask, 2)
                x = apply_frame_mask(x, frame_mask, 2)
            x = getattr(self, name)(x, frame_mask)

        x = x.permute(0, 2, 3, 1).to(stats_dtype(x.dtype))
        x = self.attention(x)  # (B, T/4, 256)
        lengths = None if feat_lengths is None else feat_lengths // self.time_pool
        return torch.tanh(self.norm(self.gru(x, lengths, generator)))
