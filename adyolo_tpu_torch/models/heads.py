"""SELD output heads (counterpart of :mod:`adyolo_tpu.models.heads`).

Every head is two Linears with no nonlinearity between them (reference
``src/models/linearheads.py:32-38``), then a format-specific output
activation:

* SEDDOA: ``sigmoid(K activity) ‖ tanh(3K doa)``;
* ACCDOA: ``tanh(3K)``;
* ADPIT:  ``tanh(3 tracks x 3K)``;
* ADYOLO: raw logits ``G0*G1*A*(K+3)`` wide (the sigmoid/tanh split
  happens in the loss and the decoder).

The attributes carry the flax modules' names (``sed_fc1``, ``doa_fc2``,
``accdoa_fc1``, ``adpit_fc2``, ``yolo_fc1`` ...), so
:mod:`adyolo_tpu_torch.convert` maps them one to one.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn as nn

__all__ = ["SEDDOAHead", "ACCDOAHead", "ADPITHead", "ADYOLOHead",
           "adyolo_out_dim"]


def adyolo_out_dim(nb_classes: int, grid_size: Tuple[float, float],
                   nb_anchors: int) -> int:
    g0 = math.ceil(360 / grid_size[0])
    g1 = math.ceil(180 / grid_size[1])
    return g0 * g1 * nb_anchors * (nb_classes + 3)


class _MLP(nn.Module):
    """``<name>_fc1`` -> ``<name>_fc2``, no nonlinearity between them."""

    def __init__(self, names, enc_dim: int, ffn_dim: int, out_dims):
        super().__init__()
        self.names = tuple(names)
        for name, out in zip(self.names, out_dims):
            setattr(self, f"{name}_fc1", nn.Linear(enc_dim, ffn_dim))
            setattr(self, f"{name}_fc2", nn.Linear(ffn_dim, out))

    def mlp(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return getattr(self, f"{name}_fc2")(getattr(self, f"{name}_fc1")(x))


class SEDDOAHead(_MLP):
    def __init__(self, nb_classes: int, enc_dim: int = 256, ffn_dim: int = 256):
        super().__init__(("sed", "doa"), enc_dim, ffn_dim,
                         (nb_classes, 3 * nb_classes))

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, T, 4K)
        return torch.cat([torch.sigmoid(self.mlp("sed", x)),
                          torch.tanh(self.mlp("doa", x))], dim=-1)


class ACCDOAHead(_MLP):
    def __init__(self, nb_classes: int, enc_dim: int = 256, ffn_dim: int = 256):
        super().__init__(("accdoa",), enc_dim, ffn_dim, (3 * nb_classes,))

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, T, 3K)
        return torch.tanh(self.mlp("accdoa", x))


class ADPITHead(_MLP):
    def __init__(self, nb_classes: int, enc_dim: int = 256, ffn_dim: int = 256,
                 n_tracks: int = 3):
        super().__init__(("adpit",), enc_dim, ffn_dim,
                         (n_tracks * 3 * nb_classes,))

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, T, 9K)
        return torch.tanh(self.mlp("adpit", x))


class ADYOLOHead(_MLP):
    def __init__(self, nb_classes: int, grid_size=(45.0, 45.0),
                 nb_anchors: int = 5, enc_dim: int = 256, ffn_dim: int = 256):
        super().__init__(("yolo",), enc_dim, ffn_dim,
                         (adyolo_out_dim(nb_classes, grid_size, nb_anchors),))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.mlp("yolo", x)  # raw logits (B, T, out)
