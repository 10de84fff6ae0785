"""Spherical distance (counterpart of :func:`adyolo_tpu.ops.angular.
gc_distance_deg`, the part the AD-YOLO loss uses)."""
from __future__ import annotations

import torch

__all__ = ["gc_distance_deg"]


def gc_distance_deg(uv1: torch.Tensor, uv2: torch.Tensor,
                    clip_eps: float = 0.0) -> torch.Tensor:
    """Great-circle distance in degrees between two (..., 2) [azi, ele] deg
    tensors (broadcasting).  ``clip_eps=1e-7`` matches the loss's clip of
    the cosine (reference ``loss.py:187``); 0 the decoder's."""
    a1, e1 = torch.deg2rad(uv1[..., 0]), torch.deg2rad(uv1[..., 1])
    a2, e2 = torch.deg2rad(uv2[..., 0]), torch.deg2rad(uv2[..., 1])
    cos = (torch.sin(e1) * torch.sin(e2)
           + torch.cos(e1) * torch.cos(e2) * torch.cos(torch.abs(a1 - a2)))
    cos = torch.clamp(cos, -1.0 + clip_eps, 1.0 - clip_eps)
    return torch.rad2deg(torch.arccos(cos))
