"""AD-YOLO decoding: model logits -> per-frame event lists (+ NMS).

Counterpart of the AD-YOLO branch of :mod:`adyolo_tpu.ops.decode`:

* on the device: grid reshape, sigmoid/tanh, degree un-normalisation
  (cell offset + overlap-scaled span), elevation clamp, azimuth wrap,
  class confidence = class x objectness, then a per-frame top-k compaction
  by objectness so only ``k`` candidates per frame cross to the host;
* on the host: the confidence filters and the per-class NMS of the native
  kernel (:mod:`adyolo_tpu_torch.ops.nms_native`, ``native/nms.cpp``).

The top-k is exact whenever at most ``k`` anchors of every frame clear the
confidence threshold; otherwise the full grid is decoded instead.  Every
decode goes through one sparse candidate set (``candidates``, decoded by
``postprocess_cached``); the trainer's threshold scan builds it once per
clip at the scan's smallest τ, with the top-k guarded at that τ, so one
forward serves every τ exactly.  Other output formats (SED-DOA, ACCDOA, ADPIT) are not
ported yet.
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

    # conf-threshold arbitration hooks (reference datasets.py:529-534)
    def get_conf_thresh(self) -> float:
        return self.conf_thresh

    def set_conf_thresh(self, thresh: float) -> None:
        self.conf_thresh = float(thresh)
        self.clss_thresh = float(thresh)

    @torch.no_grad()
    def adyolo_candidates(self, output: torch.Tensor,
                          min_conf: Optional[float] = None):
        """Host candidate arrays ``(cls_conf (T,n,K), obj_conf (T,n),
        uv (T,n,2))`` of the first clip of ``output`` (B, T, D).

        ``min_conf`` bounds the top-k truncation guard when the candidates
        are to be decoded again under several thresholds (the cached
        decode of the τ-arbitration): pass the smallest τ of the scan so
        the compaction is exact for all of them."""
        K = self.nb_classes
        n_anchors = self.geom.nb_predicts
        T = output.shape[1]
        guard = self.conf_thresh if min_conf is None else float(min_conf)
        k = min(self.decode_topk, n_anchors) if self.decode_topk else n_anchors
        if k < n_anchors:
            p = _device_decode_topk(output, self.geom, K, k)[0].cpu().numpy()
            # truncation guard: exact unless the k-th candidate of some
            # frame still clears the threshold
            if float(p[:, -1, 0].max()) <= guard:
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

    def candidates(self, output: torch.Tensor,
                   min_conf: Optional[float] = None) -> Tuple:
        """The sparse candidate set of one clip's output: the anchors whose
        objectness clears ``min_conf`` (default: the current threshold),
        frame-major, with the top-k guarded at ``min_conf``.  It holds
        O(active detections), not O(T x grid), and :meth:`postprocess_cached`
        decodes it exactly at any threshold not below ``min_conf``; the
        τ-arbitration builds it once at the scan's smallest τ.  The layout
        is the JAX package's ``("sparse", T, ...)`` cache with the tag
        replaced by ``min_conf``."""
        mc = self.conf_thresh if min_conf is None else float(min_conf)
        cls_conf, obj_conf, uv = self.adyolo_candidates(output, min_conf=mc)
        tt, nn = np.nonzero(obj_conf > mc)
        return (mc, obj_conf.shape[0], tt.astype(np.int32),
                obj_conf[tt, nn], cls_conf[tt, nn], uv[tt, nn])

    def postprocess_cached(self, cached,
                           valid_label_frames: Optional[int] = None) -> Dict:
        """The detections of a :meth:`candidates` set at the current
        thresholds, over the first ``valid_label_frames`` frames.  Raises
        ``ValueError`` below the set's ``min_conf``, where it would miss
        candidates."""
        min_conf, T_full, tt, obj, cls, uv = cached
        if self.conf_thresh < min_conf:
            raise ValueError(f"threshold {self.conf_thresh} is below the "
                             f"candidate set's min_conf {min_conf}")
        T = T_full if valid_label_frames is None else min(T_full, int(valid_label_frames))
        keep = (obj > self.conf_thresh) & (tt < T)
        tt, cls, uv = tt[keep], cls[keep], uv[keep]
        res: Dict[int, List] = {}
        if len(tt) == 0:
            return res
        # rows are frame-major (np.nonzero order): group by frame
        uniq, starts = np.unique(tt, return_index=True)
        ends = np.append(starts[1:], len(tt))
        for t, s, e in zip(uniq, starts, ends):
            dets = self._frame_dets(cls[s:e], uv[s:e])
            if dets:
                res[int(t)] = dets
        return res

    def postprocess(self, output: torch.Tensor,
                    valid_label_frames: Optional[int] = None) -> Dict:
        return self.postprocess_cached(self.candidates(output), valid_label_frames)
