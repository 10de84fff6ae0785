"""The reference AD-YOLO loss (sadPororo/AD-YOLO ``src/models/loss.py``,
arXiv:2303.15703 eq. 3-6), over padded targets ``(M, 7)`` ``[clip, frame,
Gi, Gj, class, azi, ele]`` and their mask.

For each unify threshold tau the anchors of a target's cell that predict
within tau of it (and always its nearest one) are responsible.  The loss
is, averaged over the thresholds, the objectness BCE of the responsible
anchors over their count, the non-objectness BCE of the others over
theirs, and the class BCE of the responsible anchors over their count
times the classes; plus, at the first threshold, the great-circle
distance / 180 over every responsible (target, anchor) pair.  BCE is
``nn.BCELoss``'s, each term at most 100 (``softplus`` of the logit).
Gains: angular 5, object 1, non-object 5, class 3."""
from __future__ import annotations


import torch
import torch.nn.functional as F

__all__ = ["adyolo_loss", "uv_degrees", "gc_deg"]


def gc_deg(a1, e1, a2, e2, eps=0.0):
    a1, e1, a2, e2 = (torch.deg2rad(t) for t in (a1, e1, a2, e2))
    c = (torch.sin(e1) * torch.sin(e2)
         + torch.cos(e1) * torch.cos(e2) * torch.cos(torch.abs(a1 - a2)))
    return torch.rad2deg(torch.arccos(torch.clamp(c, -1.0 + eps, 1.0 - eps)))


def uv_degrees(zu, zv, grid, shape_lead, ele_max=90.0):
    """tanh of the (u, v) logits ``(..., G0, G1, A)`` -> azimuth and
    elevation in degrees: cell centre + tanh x (0.5 + overlap) x cell,
    elevation clamped, azimuth wrapped into [-180, 180)."""
    dev = zu.device
    off = torch.as_tensor(grid.offset, device=dev)  # (G0, G1, 2)
    sc = grid.uv_scale
    bshape = (1,) * shape_lead + tuple(grid.nb_grids) + (1,)
    u = torch.tanh(zu) * float(sc[0]) + off[..., 0].reshape(bshape)
    v = torch.clamp(torch.tanh(zv) * float(sc[1]) + off[..., 1].reshape(bshape), -90.0, ele_max)
    u = torch.where(u >= 180.0, u - 360.0, u)
    return torch.where(u < -180.0, u + 360.0, u), v


def _bce_pos(z):
    return torch.clamp(F.softplus(-z), max=100.0)


def _bce_neg(z):
    return torch.clamp(F.softplus(z), max=100.0)


def adyolo_loss(logits, targets, mask, grid, nb_classes, taus, gains):
    B, T, _ = logits.shape
    g0, g1 = grid.nb_grids
    A, K = grid.nb_anchors, nb_classes
    dev = logits.device
    x = logits.reshape(B, T, g0, g1, A, K + 3)
    u, v = uv_degrees(x[..., K + 1], x[..., K + 2], grid, 2)
    z_obj = x[..., 0].reshape(-1)  # (NP,) anchors in (b, t, gi, gj, a) order
    z_cls = x[..., 1:K + 1].reshape(-1, K)
    u, v = u.reshape(-1), v.reshape(-1)
    NP = z_obj.shape[0]

    tg = torch.as_tensor(targets, device=dev)[torch.as_tensor(mask, device=dev)]
    idx = tg[:, :5].long()
    cell = ((idx[:, 0] * T + idx[:, 1]) * g0 + idx[:, 2]) * g1 + idx[:, 3]
    anchors = cell[:, None] * A + torch.arange(A, device=dev)  # (M, A)
    D = gc_deg(u[anchors], v[anchors], tg[:, 5:6], tg[:, 6:7], eps=1e-7)
    nearest = torch.zeros_like(D, dtype=torch.bool)
    if len(D):
        nearest[torch.arange(len(D), device=dev), D.argmin(dim=1)] = True

    total = logits.new_zeros(())
    for i, tau in enumerate(taus):
        resp = (D < tau) | nearest
        hit = torch.zeros(NP, device=dev).index_put_((anchors[resp],),
                                                     torch.ones(int(resp.sum()), device=dev),
                                                     accumulate=True) > 0
        cls_hit = torch.zeros(NP, K, device=dev)
        rows = anchors[resp]
        cols = idx[:, 4][:, None].expand_as(anchors)[resp]
        cls_hit[rows, cols] = 1.0
        objf = hit.float()
        n_pos = torch.clamp(objf.sum(), min=1.0)
        n_neg = torch.clamp(NP - objf.sum(), min=1.0)
        pos = (_bce_pos(z_obj) * objf).sum() / n_pos
        neg = (_bce_neg(z_obj) * (1.0 - objf)).sum() / n_neg
        cls = ((_bce_pos(z_cls) * cls_hit + _bce_neg(z_cls) * (1.0 - cls_hit))
               * objf[:, None]).sum() / (n_pos * K)
        if i == 0:
            total = total + gains["angular_gain"] * (D / 180.0 * resp.float()).sum() / \
                torch.clamp(resp.float().sum(), min=1.0)
        total = total + (pos * gains["object_gain"] + neg * gains["nonobj_gain"]
                         + cls * gains["class_gain"]) / len(taus)
    return total
