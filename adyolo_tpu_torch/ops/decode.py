"""DOA decoding: model output -> per-frame event lists (+ NMS).

Counterpart of :mod:`adyolo_tpu.ops.decode` (reference
``LabelPostProcessor``, ``src/datasets.py:485-919``).  The dense formats
decode on the host in numpy, as the JAX package does: SED-DOA by the
activity threshold, ACCDOA by the norm of each class's vector, ADPIT by
the norms of its three tracks and their unification (tracks closer than
the unify threshold merge).  AD-YOLO:

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
forward serves every τ exactly.  A dense format's candidate set is its
raw output on the host.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..utils.profiling import count, span
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


def _host(output, valid: Optional[int] = None) -> np.ndarray:
    """One clip's output (1, T, D), tensor or array -> (T, D) float32 numpy,
    cut to its first ``valid`` frames."""
    if isinstance(output, torch.Tensor):
        output = output.detach().to("cpu", torch.float32).numpy()
    out = np.asarray(output, np.float32)
    return out.reshape(-1, out.shape[-1])[:valid]


class PostProcessor:
    """Post-processing of the config's loss.  ``postprocess(output,
    valid_label_frames)`` takes one clip's raw output (1, T, D), on any
    device, and returns ``{frame: [[class, x, y, z], ...]}``."""

    def __init__(self, cfg: Config):
        self.loss = cfg.args.loss
        self.nb_classes = cfg.data.nb_classes
        self.conf_thresh = float(cfg.train.conf_thresh)
        self.clss_thresh = float(cfg.train.clss_thresh)
        self.unify_thresh = float(cfg.train.unify_thresh)
        self.nms = cfg.train.nms
        if self.loss == "adyolo":
            if not nms_native.available():
                raise RuntimeError("the native NMS library (native/nms.cpp) could "
                                   "not be built or loaded; g++ is required")
            self.geom = GridGeometry(tuple(cfg.train.grid_size),
                                     cfg.train.g_overlap, cfg.train.nb_anchors)
            self.decode_topk = int(cfg.train.decode_topk)

    # conf-threshold arbitration hooks (reference datasets.py:529-534)
    def get_conf_thresh(self) -> float:
        return self.conf_thresh

    def set_conf_thresh(self, thresh: float) -> None:
        self.conf_thresh = float(thresh)
        self.clss_thresh = float(thresh)

    # -- dense formats (adyolo_tpu/ops/decode.py:220-304) --------------------

    def _seddoa(self, output, valid) -> Dict:
        """Activity above the threshold (reference datasets.py:536-564)."""
        out = _host(output, valid)
        K = self.nb_classes
        res: Dict[int, List] = {}
        for t, c in zip(*np.nonzero(out[:, :K] > self.conf_thresh)):
            res.setdefault(int(t), []).append(
                [int(c), float(out[t, K + c]), float(out[t, 2 * K + c]),
                 float(out[t, 3 * K + c])])
        return res

    def _accdoa(self, output, valid) -> Dict:
        """Activity = ||xyz|| above the threshold (datasets.py:566-597)."""
        out = _host(output, valid)
        xyz = out.reshape(-1, 3, self.nb_classes)
        act = np.sqrt((xyz ** 2).sum(axis=1)) > self.conf_thresh
        res: Dict[int, List] = {}
        for t, c in zip(*np.nonzero(act)):
            res.setdefault(int(t), []).append(
                [int(c), float(xyz[t, 0, c]), float(xyz[t, 1, c]), float(xyz[t, 2, c])])
        return res

    def _adpit(self, output, valid) -> Dict:
        """The 3-track unification (datasets.py:600-738): the pair cosines
        and similarity flags are computed over the whole clip at once; the
        python loop visits only the active (frame, class) pairs."""
        out = _host(output, valid)
        K = self.nb_classes
        T = out.shape[0]
        tracks = out.reshape(T, 3, 3, K)  # (T, track, xyz, class)
        act = np.sqrt((tracks ** 2).sum(axis=2)) > self.conf_thresh  # (T, 3, K)
        norm = tracks / np.sqrt((tracks ** 2).sum(axis=2, keepdims=True) + 1e-10)
        sim = {}
        for (i, j) in ((0, 1), (1, 2), (2, 0)):
            cosv = np.clip((norm[:, i] * norm[:, j]).sum(axis=1), -1, 1)
            sim[(i, j)] = (act[:, i] & act[:, j]
                           & (np.degrees(np.arccos(cosv)) < self.unify_thresh))

        res: Dict[int, List] = {}

        def emit(t, c, xyz):
            res.setdefault(int(t), []).append([int(c)] + [float(v) for v in xyz])

        for t, c in zip(*np.nonzero(act.any(axis=1))):
            a = act[t, :, c]
            f01, f12, f20 = (bool(sim[p][t, c]) for p in ((0, 1), (1, 2), (2, 0)))
            tr = tracks[t, :, :, c]  # (track, xyz)
            n_sim = f01 + f12 + f20
            if n_sim == 0:
                for i in range(3):
                    if a[i]:
                        emit(t, c, tr[i])
            elif n_sim == 1:
                # the pair that agrees is averaged; the third track, if
                # active, is emitted first
                i, j, k = (0, 1, 2) if f01 else (1, 2, 0) if f12 else (2, 0, 1)
                if a[k]:
                    emit(t, c, tr[k])
                emit(t, c, (tr[i] + tr[j]) / 2)
            else:  # every track agrees: one unconditional average
                emit(t, c, (tr[0] + tr[1] + tr[2]) / 3)
        return res

    # -- AD-YOLO --------------------------------------------------------------

    @torch.no_grad()
    def adyolo_candidates(self, output: torch.Tensor,
                          min_conf: Optional[float] = None):
        """Host candidate arrays ``(cls_conf (T,n,K), obj_conf (T,n),
        uv (T,n,2))`` of the first clip of ``output`` (B, T, D).

        ``min_conf`` bounds the top-k truncation guard when the candidates
        are to be decoded again under several thresholds (the cached
        decode of the τ-arbitration): pass the smallest τ of the scan so
        the compaction is exact for all of them."""
        with span("decode.candidates"):
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
                   min_conf: Optional[float] = None):
        """A dense format's raw output on the host ((T, D) float32); for
        AD-YOLO the sparse candidate set of one clip's output: the anchors whose
        objectness clears ``min_conf`` (default: the current threshold),
        frame-major, with the top-k guarded at ``min_conf``.  It holds
        O(active detections), not O(T x grid), and :meth:`postprocess_cached`
        decodes it exactly at any threshold not below ``min_conf``; the
        τ-arbitration builds it once at the scan's smallest τ.  The layout
        is the JAX package's ``("sparse", T, ...)`` cache with the tag
        replaced by ``min_conf``."""
        if self.loss != "adyolo":
            return _host(output)
        mc = self.conf_thresh if min_conf is None else float(min_conf)
        cls_conf, obj_conf, uv = self.adyolo_candidates(output, min_conf=mc)
        tt, nn = np.nonzero(obj_conf > mc)
        return (mc, obj_conf.shape[0], tt.astype(np.int32),
                obj_conf[tt, nn], cls_conf[tt, nn], uv[tt, nn])

    def postprocess_cached(self, cached,
                           valid_label_frames: Optional[int] = None) -> Dict:
        """The detections of a :meth:`candidates` set at the current
        thresholds, over the first ``valid_label_frames`` frames.  Raises
        ``ValueError`` below an AD-YOLO set's ``min_conf``, where it would
        miss candidates.  An AD-YOLO decode counts its label frames and
        the rows the host loop visits (``decode.label_frames`` and
        ``decode.candidates`` in :data:`~adyolo_tpu_torch.utils.profiling.COUNTERS`)."""
        if self.loss != "adyolo":
            return self.postprocess(cached, valid_label_frames)
        min_conf, T_full, tt, obj, cls, uv = cached
        if self.conf_thresh < min_conf:
            raise ValueError(f"threshold {self.conf_thresh} is below the "
                             f"candidate set's min_conf {min_conf}")
        T = T_full if valid_label_frames is None else min(T_full, int(valid_label_frames))
        keep = (obj > self.conf_thresh) & (tt < T)
        tt, cls, uv = tt[keep], cls[keep], uv[keep]
        count("decode.label_frames", T)
        count("decode.candidates", len(tt))
        res: Dict[int, List] = {}
        if len(tt) == 0:
            return res
        with span("decode.nms"):
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
        if self.loss in ("seddoa", "masked-seddoa"):
            return self._seddoa(output, valid_label_frames)
        if self.loss == "accdoa":
            return self._accdoa(output, valid_label_frames)
        if self.loss == "adpit":
            return self._adpit(output, valid_label_frames)
        return self.postprocess_cached(self.candidates(output), valid_label_frames)
