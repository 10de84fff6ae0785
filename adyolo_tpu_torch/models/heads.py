"""AD-YOLO output head (counterpart of
:func:`adyolo_tpu.models.heads.ADYOLOHead`): two Linears with no
nonlinearity between them, emitting raw logits ``G0*G1*A*(K+3)`` wide
(the sigmoid/tanh split happens in the decoder)."""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn as nn

__all__ = ["ADYOLOHead", "adyolo_out_dim"]


def adyolo_out_dim(nb_classes: int, grid_size: Tuple[float, float],
                   nb_anchors: int) -> int:
    g0 = math.ceil(360 / grid_size[0])
    g1 = math.ceil(180 / grid_size[1])
    return g0 * g1 * nb_anchors * (nb_classes + 3)


class ADYOLOHead(nn.Module):
    def __init__(self, nb_classes: int, grid_size=(45.0, 45.0),
                 nb_anchors: int = 5, enc_dim: int = 256, ffn_dim: int = 256):
        super().__init__()
        self.yolo_fc1 = nn.Linear(enc_dim, ffn_dim)
        self.yolo_fc2 = nn.Linear(
            ffn_dim, adyolo_out_dim(nb_classes, grid_size, nb_anchors))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.yolo_fc2(self.yolo_fc1(x))  # raw logits (B, T, out)
