"""The reference AD-YOLO decode (sadPororo/AD-YOLO ``src/datasets.py``
``LabelPostProcessor``, conn-merge): per label frame, the anchors whose
objectness clears tau; their class confidences (class x objectness) that
clear tau; per class, the connected groups of those candidates closer
than the unify threshold (great-circle degrees), each merged into one
detection: the unit vector of the candidates' directions weighted by
``softmax(exp(conf^2 / tau))``.

The sigmoid, tanh and degree conversion run elementwise in torch on the
logits' own device and dtype; the grouping runs in float64 numpy.  A
frame's detections come back as rows ``[class, x, y, z]`` sorted, so two
decodes compare as sets."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .loss import uv_degrees

__all__ = ["class_confidence", "threshold_at_rate", "decode_clip", "compare_detections"]

_ELE_MAX = 90.0 - 1e-7


def _cart(u, v):
    a, e = np.radians(u), np.radians(v)
    return np.stack([np.cos(a) * np.cos(e), np.sin(a) * np.cos(e), np.sin(e)], axis=-1)


def _gc(u1, v1, u2, v2):
    a1, e1, a2, e2 = (np.radians(t) for t in (u1, v1, u2, v2))
    c = np.sin(e1) * np.sin(e2) + np.cos(e1) * np.cos(e2) * np.cos(np.abs(a1 - a2))
    return np.degrees(np.arccos(np.clip(c, -1.0, 1.0)))


def _merge_class(conf, u, v, unify, temp):
    n = len(conf)
    if n == 1:
        return [_cart(u, v)[0]]
    d = _gc(u[:, None], v[:, None], u[None, :], v[None, :])
    near = d < unify
    left = np.ones(n, bool)
    out = []
    for seed in np.argsort(-conf, kind="stable"):
        if not left[seed]:
            continue
        group = np.zeros(n, bool)
        group[seed] = True
        while True:
            grown = near[group].any(axis=0) & left
            grown[seed] = True
            if (grown == group).all():
                break
            group = grown
        left &= ~group
        s = np.exp(conf[group] ** 2 / temp)
        w = np.exp(s - s.max())
        vec = (_cart(u[group], v[group]) * (w / w.sum())[:, None]).sum(axis=0)
        out.append(vec / np.linalg.norm(vec))
    return out


def _confidences(logits, frames, grid, nb_classes):
    g0, g1 = grid.nb_grids
    A, K = grid.nb_anchors, nb_classes
    x = logits[:frames].reshape(frames, g0, g1, A, K + 3)
    probs = torch.sigmoid(x[..., :K + 1])
    obj = probs[..., 0]
    return x, obj, probs[..., 1:] * obj[..., None]


@torch.no_grad()
def class_confidence(logits: torch.Tensor, frames: int, grid, nb_classes: int) -> torch.Tensor:
    """Every (frame, anchor, class) confidence, class x objectness, of one
    clip's logits ``(T, P)`` over its first ``frames`` label frames, flat."""
    return _confidences(logits, frames, grid, nb_classes)[2].flatten()


def threshold_at_rate(conf: torch.Tensor, frames: int, rate: float) -> float:
    """The tau that ``round(rate * frames)`` of the confidences ``conf``
    clear (at least one): midway between that largest and the next, as a
    float32 value, so that both sides of a comparison read it alike."""
    n = min(max(1, round(rate * frames)), conf.numel() - 1)
    top = torch.topk(conf.double(), n + 1).values
    return float(np.float32((top[n - 1] + top[n]).item() / 2))


@torch.no_grad()
def decode_clip(logits: torch.Tensor, frames: int, grid, nb_classes: int, tau: float,
                unify: float) -> Dict[int, np.ndarray]:
    """``{frame: (n, 4) [class, x, y, z] rows, sorted}`` of one clip's
    logits ``(T, P)`` over its first ``frames`` label frames."""
    x, obj, cls = _confidences(logits, frames, grid, nb_classes)
    K = nb_classes
    u, v = uv_degrees(x[..., K + 1], x[..., K + 2], grid, 1, ele_max=_ELE_MAX)
    obj, cls = obj.reshape(frames, -1).cpu().numpy(), cls.reshape(frames, -1, K).cpu().numpy()
    u, v = u.reshape(frames, -1).cpu().numpy(), v.reshape(frames, -1).cpu().numpy()
    out = {}
    for t, a in zip(*np.nonzero(obj > tau)):
        out.setdefault(int(t), []).append(a)
    dets = {}
    for t, anchors in out.items():
        anchors = np.asarray(anchors)
        i, c = np.nonzero(cls[t, anchors] > tau)
        rows = []
        for k in np.unique(c):
            sel = anchors[i[c == k]]
            conf = cls[t, sel, k].astype(np.float64)
            for vec in _merge_class(conf, u[t, sel].astype(np.float64),
                                    v[t, sel].astype(np.float64), unify, tau):
                rows.append([float(k), *vec])
        if rows:
            dets[t] = np.asarray(sorted(rows))
    return dets


def compare_detections(program: Dict[int, list], reference: Dict[int, np.ndarray],
                       tol: float = 1e-6) -> int:
    """The number of label frames whose detections differ: another count,
    another class, or a direction further than ``tol`` in any coordinate."""
    bad = 0
    for t in set(program) | set(reference):
        p = np.asarray(sorted(program.get(t, [])), np.float64).reshape(-1, 4)
        r = np.asarray(reference.get(t, np.zeros((0, 4))), np.float64).reshape(-1, 4)
        if p.shape != r.shape or (len(p) and (np.abs(p - r).max() > tol)):
            bad += 1
    return bad
