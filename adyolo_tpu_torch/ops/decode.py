"""AD-YOLO decoding: model logits -> per-frame event lists (+ NMS).

Counterpart of the AD-YOLO branch of :mod:`adyolo_tpu.ops.decode`:

* on the device: grid reshape, sigmoid/tanh, degree un-normalisation
  (cell offset + overlap-scaled span), elevation clamp, azimuth wrap,
  class confidence = class x objectness, then a per-frame top-k compaction
  by objectness so only ``k`` candidates per frame cross to the host;
* on the host: the confidence filters and the per-class NMS of the native
  kernel (:mod:`adyolo_tpu_torch.ops.nms_native`, ``native/nms.cpp``).

The top-k is exact whenever at most ``k`` anchors of every frame clear the
confidence threshold; otherwise the full grid is decoded instead.  Other
output formats (SED-DOA, ACCDOA, ADPIT) are not ported yet.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from . import nms_native
from .grid import GridGeometry

__all__ = ["adyolo_decode_grid", "PostProcessor"]

_ELE_MAX = 90.0 - 1e-7  # inference clamp (datasets.py:764)


def adyolo_decode_grid(logits: torch.Tensor, geom: GridGeometry,
                       nb_classes: int,
                       clamp_ele: Tuple[float, float] = (-90.0, 90.0)):
    """Reshape ``(..., G0*G1*A*(K+3))`` logits to the grid and decode.

    Returns ``(conf_logits, uv_deg)``: ``(..., G0, G1, A, K+1)`` logits of
    [objectness, classes] and ``(..., G0, G1, A, 2)`` (azimuth, elevation)
    in degrees, azimuth wrapped into [-180, 180).
    """
    g0, g1 = geom.nb_grids
    A = geom.nb_anchors
    lead = logits.shape[:-1]
    x = logits.reshape(*lead, g0, g1, A, nb_classes + 3)
    conf_logits = x[..., : nb_classes + 1]
    scale = geom.uv_to_degrees_scale()  # numpy (2,)
    bshape = (1,) * len(lead) + (g0, g1, 1)
    off = torch.as_tensor(geom.offset, device=logits.device)  # (g0, g1, 2)
    u = torch.tanh(x[..., nb_classes + 1]) * float(scale[0]) + off[..., 0].reshape(bshape)
    v = torch.tanh(x[..., nb_classes + 2]) * float(scale[1]) + off[..., 1].reshape(bshape)
    v = torch.clamp(v, clamp_ele[0], clamp_ele[1])
    u = torch.where(u >= 180.0, u - 360.0, u)
    u = torch.where(u < -180.0, u + 360.0, u)
    return conf_logits, torch.stack([u, v], dim=-1)


def _device_decode(logits, geom: GridGeometry, nb_classes: int):
    """(B, T, P) -> (class_conf (B,T,G0,G1,A,K), obj_conf, uv_deg)."""
    conf_logits, uv = adyolo_decode_grid(logits, geom, nb_classes,
                                         clamp_ele=(-90.0, _ELE_MAX))
    probs = torch.sigmoid(conf_logits)
    obj = probs[..., 0]
    return probs[..., 1:] * obj[..., None], obj, uv


def _device_decode_topk(logits, geom: GridGeometry, nb_classes: int, k: int):
    """Decode + per-frame top-k by objectness, packed as one
    ``(B, T, k, 1+K+2)`` tensor ``[obj | cls | uv]``."""
    cls, obj, uv = _device_decode(logits, geom, nb_classes)
    B, T = obj.shape[:2]
    val, idx = torch.topk(obj.reshape(B, T, -1), k, dim=-1)
    cls_k = torch.gather(cls.reshape(B, T, -1, nb_classes), 2,
                         idx[..., None].expand(B, T, k, nb_classes))
    uv_k = torch.gather(uv.reshape(B, T, -1, 2), 2,
                        idx[..., None].expand(B, T, k, 2))
    return torch.cat([val[..., None], cls_k, uv_k], dim=-1)


class PostProcessor:
    """AD-YOLO post-processing.  ``postprocess(output, valid_label_frames)``
    takes one clip's raw logits (1, T, D), on any device, and returns
    ``{frame: [[class, x, y, z], ...]}``."""

    def __init__(self, cfg: Config):
        if cfg.args.loss != "adyolo":
            raise NotImplementedError(f"not yet ported: loss {cfg.args.loss!r}")
        if not nms_native.available():
            raise RuntimeError("the native NMS library (native/nms.cpp) could "
                               "not be built or loaded; g++ is required")
        self.nb_classes = cfg.data.nb_classes
        self.conf_thresh = float(cfg.train.conf_thresh)
        self.clss_thresh = float(cfg.train.clss_thresh)
        self.unify_thresh = float(cfg.train.unify_thresh)
        self.nms = cfg.train.nms
        self.geom = GridGeometry(tuple(cfg.train.grid_size), cfg.train.g_overlap,
                                 cfg.train.nb_anchors)
        self.decode_topk = int(cfg.train.decode_topk)

    def set_conf_thresh(self, thresh: float) -> None:
        self.conf_thresh = float(thresh)
        self.clss_thresh = float(thresh)

    @torch.no_grad()
    def adyolo_candidates(self, output: torch.Tensor):
        """Host candidate arrays ``(cls_conf (T,n,K), obj_conf (T,n),
        uv (T,n,2))`` of the first clip of ``output`` (B, T, D)."""
        K = self.nb_classes
        n_anchors = self.geom.nb_predicts
        T = output.shape[1]
        k = min(self.decode_topk, n_anchors) if self.decode_topk else n_anchors
        if k < n_anchors:
            p = _device_decode_topk(output, self.geom, K, k)[0].cpu().numpy()
            # truncation guard: exact unless the k-th candidate of some
            # frame still clears the threshold
            if float(p[:, -1, 0].max()) <= self.conf_thresh:
                return p[..., 1:K + 1], p[..., 0], p[..., K + 1:]
        cls, obj, uv = _device_decode(output, self.geom, K)
        return (cls[0].reshape(T, -1, K).cpu().numpy(),
                obj[0].reshape(T, -1).cpu().numpy(),
                uv[0].reshape(T, -1, 2).cpu().numpy())

    def _frame_dets(self, cand_cls, cand_uv) -> Optional[List]:
        """Class-threshold filter + per-class NMS of one frame's candidates."""
        i, j = np.nonzero(cand_cls > self.clss_thresh)
        if len(i) == 0:
            return None
        rows = np.stack([j.astype(np.float64), cand_cls[i, j],
                         cand_uv[i, 0], cand_uv[i, 1]], axis=1)
        rows = rows[np.argsort(-rows[:, 1], kind="stable")]
        dets = nms_native.nms_frame(rows, self.nms, self.unify_thresh,
                                    self.clss_thresh)
        return dets.tolist() if len(dets) else None

    def postprocess(self, output: torch.Tensor,
                    valid_label_frames: Optional[int] = None) -> Dict:
        cls_conf, obj_conf, uv = self.adyolo_candidates(output)
        T = cls_conf.shape[0]
        if valid_label_frames is not None:
            T = min(T, valid_label_frames)
        sel_all = obj_conf[:T] > self.conf_thresh
        res: Dict[int, List] = {}
        for t in np.nonzero(sel_all.any(axis=1))[0]:
            sel = sel_all[t]
            dets = self._frame_dets(cls_conf[t][sel], uv[t][sel])
            if dets:
                res[int(t)] = dets
        return res
