"""SELD training losses (counterpart of :mod:`adyolo_tpu.models.losses`,
reference ``src/models/loss.py``).

* :func:`seddoa_loss`: BCE(sed) + 1000·MSE(doa), optionally with the DOA
  output gated by the activity target (masked-SEDDOA);
* :func:`accdoa_loss`: MSE;
* :func:`adpit_loss`: the 13-permutation track PIT with the pad-target
  trick, the permutation of least MSE chosen per (frame, class);
* :func:`adyolo_loss`: the AD-YOLO loss in the JAX package's scatter form
  (``_adyolo_loss_scatter``, ``losses.py:347-440``), below.

Every mean runs over the valid frames of an optional (B, T) frame mask.
BCE on probabilities follows torch ``nn.BCELoss`` as the JAX package
writes it (:func:`_log_clamped`), not ``F.binary_cross_entropy``.

AD-YOLO:
The reference's ragged target list and boolean-indexed BCE partitions
(``src/models/loss.py:189-251``) are masked sums over a fixed-capacity
padded target tensor with exact denominator bookkeeping.  For each unify
threshold τ the responsible anchors are ``D < τ ∪ argmin_a D``; duplicate
(cell, anchor) hits collapse as boolean indexing does in the reference,
here with ``scatter_reduce(..., "amax")`` one-hot grids.  BCE follows
torch ``nn.BCELoss`` (per-element terms clamped at 100), computed from the
logits through softplus.

The JAX package's scatter-free sorted form exists for the TPU's lowering of
scatters and is not ported; ``impl`` other than ``"scatter"`` raises.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import LossGains
from ..ops.angular import gc_distance_deg
from ..ops.grid import GridGeometry

__all__ = ["seddoa_loss", "accdoa_loss", "adpit_loss", "adyolo_loss", "bce_probs"]

_BCE_CLAMP = 100.0  # torch BCELoss clamps log at -100
_F32_TINY = 1.1754944e-38  # smallest normal float32


def _log_clamped(p: torch.Tensor) -> torch.Tensor:
    """``log(p).clamp(min=-100)`` as the JAX package computes it
    (``losses.py:42-55``): below the smallest normal float32 the clamp
    value -100 is returned directly (a saturated sigmoid, p == 0, costs
    100), and the gradient there is 0.  In the subnormal band this differs
    from torch's BCELoss, as the JAX package does."""
    raw = torch.log(torch.clamp(p, min=_F32_TINY))
    return torch.where(p < _F32_TINY, torch.full_like(p, -_BCE_CLAMP), raw)


def bce_probs(p: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Elementwise BCE on probabilities, torch ``nn.BCELoss`` convention."""
    return -(y * _log_clamped(p) + (1.0 - y) * _log_clamped(1.0 - p))


def _frame_mean(x: torch.Tensor, frame_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Mean over (B, T, ...) restricted to the valid frames: ``x.mean()``
    without a mask, else the mean of ``x[b, :t_valid]`` over every row."""
    if frame_mask is None:
        return x.mean()
    fm = frame_mask.to(device=x.device, dtype=x.dtype)
    per_frame = int(np.prod(x.shape[2:]))
    denom = torch.clamp(fm.sum() * per_frame, min=1.0)
    return (x * fm.reshape(fm.shape + (1,) * (x.ndim - 2))).sum() / denom


def seddoa_loss(output: torch.Tensor, target: torch.Tensor, nb_classes: int,
                masked_mse: bool, frame_mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    """output / target (B, T, 4K) = [sed K ‖ doa 3K] (``losses.py:89-101``).
    ``masked_mse`` gates the DOA output by the activity target, tiled
    [x K, y K, z K] as ``jnp.tile(sed_t, (1, 1, 3))``."""
    sed_o, doa_o = output[..., :nb_classes], output[..., nb_classes:]
    sed_t, doa_t = target[..., :nb_classes], target[..., nb_classes:]
    sed_loss = _frame_mean(bce_probs(sed_o, sed_t), frame_mask)
    if masked_mse:
        doa_o = doa_o * sed_t.repeat(1, 1, 3)
    doa_loss = _frame_mean((doa_o - doa_t) ** 2, frame_mask)
    return sed_loss + 1000.0 * doa_loss


def accdoa_loss(output: torch.Tensor, target: torch.Tensor,
                frame_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    return _frame_mean((output - target) ** 2, frame_mask)


# slot permutations of the ADPIT pad-target scheme (reference loss.py:91-121):
# slot ids A0=0, B0=1, B1=2, C0=3, C1=4, C2=5; each row lists the 3 track
# assignments; the pad is the sum of the two *other* groups' canonical perms.
_ADPIT_PERMS = (
    (0, 0, 0),  # A0A0A0 (+ pad B0B0B1 + C0C1C2)
    (1, 1, 2), (1, 2, 1), (1, 2, 2), (2, 1, 1), (2, 1, 2), (2, 2, 1),  # B perms
    (3, 4, 5), (3, 5, 4), (4, 3, 5), (4, 5, 3), (5, 3, 4), (5, 4, 3),  # C perms
)
# the pad of a permutation, by its first slot (losses.py:139)
_ADPIT_PAD = {0: 0, 1: 1, 3: 3, 2: 1, 4: 3, 5: 3}


def adpit_loss(output: torch.Tensor, target: torch.Tensor, nb_classes: int,
               frame_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """output (B, T, 9K); target (B, T, 6, 4, K) (``losses.py:119-143``).
    Per (frame, class) the permutation of least MSE is taken (``argmin``,
    the first on ties, then a gather), so the gradient flows into that
    permutation only."""
    B, T = target.shape[:2]
    K = nb_classes
    # activity-gated slot DOAs: (B, T, 6, 3, K)
    slot = target[:, :, :, 0:1, :] * target[:, :, :, 1:, :]
    s = [slot[:, :, i] for i in range(6)]
    a = torch.cat([s[0], s[0], s[0]], dim=2)
    b = torch.cat([s[1], s[1], s[2]], dim=2)
    c = torch.cat([s[3], s[4], s[5]], dim=2)
    pads = {0: b + c, 1: a + c, 3: a + b}  # pad4A / pad4B / pad4C

    out = output.reshape(B, T, 9, K)
    per_perm = []
    for perm in _ADPIT_PERMS:
        tgt = torch.cat([s[perm[0]], s[perm[1]], s[perm[2]]], dim=2)
        tgt = tgt + pads[perm[0] if perm[0] in (0, 1, 3) else {2: 1, 4: 3, 5: 3}[perm[0]]]
        per_perm.append(((out - tgt) ** 2).mean(dim=2))  # (B, T, K)
    stack = torch.stack(per_perm, dim=0)  # (13, B, T, K)
    chosen = stack.gather(0, stack.argmin(dim=0, keepdim=True))[0]
    return _frame_mean(chosen, frame_mask)


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
                impl: str = "scatter",
                reduce_counts: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
                ) -> torch.Tensor:
    """AD-YOLO loss.

    logits:      (B, T, G0*G1*A*(K+3)) raw head output
    targets:     (M, 7) padded [batch, frame, Gi, Gj, class, U, V]
    target_mask: (M,) bool validity
    frame_mask:  optional (B, T) frame validity: anchors of padded frames
    leave the negative-objectness set and every denominator
    reduce_counts: optional; under data parallelism the sum over the ranks
    of a vector of counts.  The denominators (the anchor count, each τ's
    positives and the responsible pairs) are then the global batch's,
    summed before their clamps at 1, and the result is this rank's share:
    its own sums over the global counts, which the ranks' shares add up
    to the loss of the global batch (``adyolo_tpu/models/losses.py:413-432``
    over globalized targets).
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

    resps = [((D < tau) | amin) & valid[:, None] for tau in train_unify]
    objfs = [_onehot_max(NP, anchor_flat.reshape(-1), r.reshape(-1)) for r in resps]
    # the denominators' counts: anchors, each τ's positives, responsible pairs
    n_anchor = NP if anchor_valid is None else anchor_valid.sum()
    n_pos = [objf.sum() for objf in objfs]
    n_resp = resps[0].to(torch.float32).sum()
    if reduce_counts is not None:
        c = reduce_counts(torch.stack([torch.as_tensor(n_anchor, dtype=torch.float32,
                                                       device=dev), *n_pos, n_resp]))
        n_anchor, n_pos, n_resp = c[0], list(c[1:-1]), c[-1]

    total = torch.zeros((), device=dev, dtype=torch.float32)
    n_taus = len(train_unify)
    for i, (resp, objf) in enumerate(zip(resps, objfs)):
        cls_idx = (anchor_flat * K + ci[:, None]).reshape(-1)  # into (NP, K)
        y = _onehot_max(NP * K, cls_idx, resp.reshape(-1)).reshape(NP, K)

        n_pos_f = torch.clamp(n_pos[i], min=1.0)
        pos_loss = (pos_all * objf).sum() / n_pos_f
        n_neg_f = torch.clamp(n_anchor - n_pos[i], min=1.0)
        if anchor_valid is None:
            neg_loss = (neg_all * (1.0 - objf)).sum() / n_neg_f
        else:
            neg_loss = (neg_all * (1.0 - objf) * anchor_valid).sum() / n_neg_f
        cls_elem = _bce_logits_pos(z_cls) * y + _bce_logits_neg(z_cls) * (1.0 - y)
        class_loss = (cls_elem * objf[:, None]).sum() / (n_pos_f * K)

        if i == 0:
            # angular term: every responsible (target, anchor) pair counts,
            # duplicates included
            respf = resp.to(torch.float32)
            total = total + ((D / 180.0 * respf).sum()
                             / torch.clamp(n_resp, min=1.0)) * gains.angular_gain

        total = total + (pos_loss * gains.object_gain
                         + neg_loss * gains.nonobj_gain
                         + class_loss * gains.class_gain) / n_taus
    return total
