"""The AD-YOLO training loss (counterpart of
:func:`adyolo_tpu.models.losses.adyolo_loss`, its scatter form
``_adyolo_loss_scatter``, ``losses.py:347-440``).

The reference's ragged target list and boolean-indexed BCE partitions
(``src/models/loss.py:189-251``) are masked sums over a fixed-capacity
padded target tensor with exact denominator bookkeeping.  For each unify
threshold τ the responsible anchors are ``D < τ ∪ argmin_a D``; duplicate
(cell, anchor) hits collapse as boolean indexing does in the reference,
here with ``scatter_reduce(..., "amax")`` one-hot grids.  BCE follows
torch ``nn.BCELoss`` (per-element terms clamped at 100), computed from the
logits through softplus.

The JAX package's scatter-free sorted form exists for the TPU's lowering of
scatters and is not ported; ``impl`` other than ``"scatter"`` raises.  The
other formats' losses (SED-DOA, ACCDOA, ADPIT) wait for their heads.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import LossGains
from ..ops.angular import gc_distance_deg
from ..ops.grid import GridGeometry

__all__ = ["adyolo_loss"]

_BCE_CLAMP = 100.0  # torch BCELoss clamps log at -100


def _bce_logits_pos(z):
    """BCE(sigmoid(z), 1) = softplus(-z), clamped like torch."""
    return torch.clamp(F.softplus(-z), max=_BCE_CLAMP)


def _bce_logits_neg(z):
    """BCE(sigmoid(z), 0) = softplus(z), clamped like torch."""
    return torch.clamp(F.softplus(z), max=_BCE_CLAMP)


def _uv_unnormalize(u, v, scale, off_u, off_v,
                    clamp_ele: Tuple[float, float] = (-90.0, 90.0)):
    """tanh (u, v) -> degrees: overlap-scaled span + cell-center offset,
    elevation clamp, azimuth wrap into [-180, 180) (``losses.py:146``)."""
    u = u * float(scale[0]) + off_u
    v = torch.clamp(v * float(scale[1]) + off_v, clamp_ele[0], clamp_ele[1])
    u = torch.where(u >= 180.0, u - 360.0, u)
    u = torch.where(u < -180.0, u + 360.0, u)
    return u, v


def _onehot_max(n: int, idx: torch.Tensor, hit: torch.Tensor) -> torch.Tensor:
    """``zeros(n).at[idx].max(hit)`` as float: 1 where any hit lands."""
    out = torch.zeros(n, device=hit.device, dtype=torch.float32)
    return out.scatter_reduce(0, idx, hit.to(torch.float32), "amax")


def adyolo_loss(logits: torch.Tensor, targets: torch.Tensor,
                target_mask: torch.Tensor, geom: GridGeometry, nb_classes: int,
                train_unify: Sequence[float] = (45.0, 25.0, 10.0),
                gains: LossGains = LossGains(),
                frame_mask: Optional[torch.Tensor] = None,
                impl: str = "scatter") -> torch.Tensor:
    """AD-YOLO loss.

    logits:      (B, T, G0*G1*A*(K+3)) raw head output
    targets:     (M, 7) padded [batch, frame, Gi, Gj, class, U, V]
    target_mask: (M,) bool validity
    frame_mask:  optional (B, T) frame validity: anchors of padded frames
    leave the negative-objectness set and every denominator
    """
    if impl != "scatter":
        raise ValueError(f"adyolo_loss: impl must be 'scatter', got {impl!r} "
                         "(the sorted form is TPU-only and not ported)")
    B, T, _ = logits.shape
    g0, g1 = geom.nb_grids
    A = geom.nb_anchors
    K = nb_classes
    NP = B * T * g0 * g1 * A
    dev = logits.device

    x = logits.reshape(NP, K + 3)
    z_obj = x[:, 0]
    z_cls = x[:, 1:K + 1]  # (NP, K)

    # (u, v) tanh -> degrees per flat (cell, anchor) index; the cell-center
    # offset pattern repeats every g0*g1*A entries (loss.py:204-213)
    scale = geom.uv_to_degrees_scale()
    off = [torch.as_tensor(np.repeat(geom.offset[..., c].reshape(-1), A),
                           device=dev).repeat(B * T) for c in (0, 1)]
    u, v = _uv_unnormalize(torch.tanh(x[:, K + 1]), torch.tanh(x[:, K + 2]),
                           scale, off[0], off[1])

    valid = target_mask.to(device=dev, dtype=torch.bool)
    t = targets.to(dev)
    ti = t[:, :5].to(torch.int64)
    cell = ((ti[:, 0] * T + ti[:, 1]) * g0 + ti[:, 2]) * g1 + ti[:, 3]
    cell = torch.where(valid, cell, 0)
    ci = torch.where(valid, ti[:, 4], 0)

    anchor_flat = cell[:, None] * A + torch.arange(A, device=dev)[None, :]  # (M, A)
    pred_uv = torch.stack([u[anchor_flat], v[anchor_flat]], dim=-1)  # (M, A, 2)
    D = gc_distance_deg(pred_uv, t[:, None, 5:7], clip_eps=1e-7)  # (M, A)
    amin = F.one_hot(torch.argmin(D, dim=1), A).to(torch.bool) if len(D) else \
        torch.zeros_like(D, dtype=torch.bool)

    pos_all = _bce_logits_pos(z_obj)
    neg_all = _bce_logits_neg(z_obj)
    anchor_valid = None
    if frame_mask is not None:
        anchor_valid = frame_mask.to(dev).reshape(-1).to(torch.float32) \
            .repeat_interleave(g0 * g1 * A)  # (NP,)

    total = torch.zeros((), device=dev, dtype=torch.float32)
    n_taus = len(train_unify)
    for i, tau in enumerate(train_unify):
        resp = ((D < tau) | amin) & valid[:, None]
        objf = _onehot_max(NP, anchor_flat.reshape(-1), resp.reshape(-1))
        cls_idx = (anchor_flat * K + ci[:, None]).reshape(-1)  # into (NP, K)
        y = _onehot_max(NP * K, cls_idx, resp.reshape(-1)).reshape(NP, K)

        n_pos = objf.sum()
        n_pos_f = torch.clamp(n_pos, min=1.0)
        pos_loss = (pos_all * objf).sum() / n_pos_f
        if anchor_valid is None:
            n_neg_f = torch.clamp(NP - n_pos, min=1.0)
            neg_loss = (neg_all * (1.0 - objf)).sum() / n_neg_f
        else:
            n_neg_f = torch.clamp(anchor_valid.sum() - n_pos, min=1.0)
            neg_loss = (neg_all * (1.0 - objf) * anchor_valid).sum() / n_neg_f
        cls_elem = _bce_logits_pos(z_cls) * y + _bce_logits_neg(z_cls) * (1.0 - y)
        class_loss = (cls_elem * objf[:, None]).sum() / (n_pos_f * K)

        if i == 0:
            # angular term: every responsible (target, anchor) pair counts,
            # duplicates included
            respf = resp.to(torch.float32)
            n_resp = torch.clamp(respf.sum(), min=1.0)
            total = total + ((D / 180.0 * respf).sum() / n_resp) * gains.angular_gain

        total = total + (pos_loss * gains.object_gain
                         + neg_loss * gains.nonobj_gain
                         + class_loss * gains.class_gain) / n_taus
    return total
