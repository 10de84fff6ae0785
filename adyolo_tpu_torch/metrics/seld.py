"""DCASE SELD metrics: ER / F / LE / LR / SELD with Hungarian matching
(the port's copy of :mod:`adyolo_tpu.metrics.seld`, host numpy code).

Behavioral re-implementation of ``src/utils/seld_metrics.py`` (itself
adapted from the official DCASE scorer): location-sensitive detection
(20° DOA threshold, substitution/deletion/insertion error rate) +
class-sensitive localization (LE/LR), scored over 1-second segment blocks
with Hungarian gt<->pred track association, macro or micro averaging,
``SELD = (ER + (1 - F) + LE/180 + (1 - LR)) / 4``, jackknife confidence
intervals, and the polyphony-restricted re-scoring variants.

Semantics preserved exactly, including corner cases:

* when both gt and pred contain a class in a block but no frame aligns,
  the reference adds ``nb_pred_doas`` to FN (seld_metrics.py:325-329) —
  mirrored;
* per-block track identity is the DOA's row position within its frame
  (seld_metrics.py:303);
* pred files are segmented against the *reference* clip length
  (seld_metrics.py:438);
* ``LE = 180`` for classes with zero DE_TP (seld_metrics.py:251, 262).

The Hungarian solve runs on host (tiny matrices, <= polyphony count):
scipy's C++ ``linear_sum_assignment``, swappable for the bundled native
solver (``adyolo_tpu_torch.metrics.hungarian``).
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
from scipy import stats

from ..data.io import (
    cartesian_to_polar_dict,
    polar_to_cartesian_dict,
    read_label_csv,
)
from .hungarian import linear_sum_assignment

_EPS = np.finfo(np.float64).eps

__all__ = [
    "SELDMetrics",
    "SegmentScorer",
    "jackknife_estimation",
    "segment_labels",
    "early_stopping_metric",
]


# ---------------------------------------------------------------------------


def _cartesian_dist_deg(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise angular distance (deg) between row-sets of xyz vectors."""
    na = a / np.sqrt((a ** 2).sum(-1, keepdims=True) + 1e-10)
    nb = b / np.sqrt((b ** 2).sum(-1, keepdims=True) + 1e-10)
    cos = np.clip(na @ nb.T, -1.0, 1.0)
    return np.degrees(np.arccos(cos))


def _spherical_dist_deg(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise angular distance (deg); inputs (n,2)/(m,2) in radians."""
    az1, e1 = a[:, 0:1], a[:, 1:2]
    az2, e2 = b[None, :, 0], b[None, :, 1]
    cos = np.sin(e1) * np.sin(e2) + np.cos(e1) * np.cos(e2) * np.cos(np.abs(az1 - az2))
    return np.degrees(np.arccos(np.clip(cos, -1.0, 1.0)))


def least_distance_between_gt_pred(gt: np.ndarray, pred: np.ndarray):
    """Hungarian association of gt/pred DOA sets (seld_metrics.py:117-146).
    Inputs: (n, 2) radians or (n, 3) cartesian.  Returns (costs, rows, cols).
    """
    if len(gt) and len(pred):
        if gt.shape[-1] == 3:
            cost = _cartesian_dist_deg(gt, pred)
        else:
            cost = _spherical_dist_deg(gt, pred)
    else:
        cost = np.zeros((len(gt), len(pred)))
    rows, cols = linear_sum_assignment(cost)
    return cost[rows, cols], rows, cols


def early_stopping_metric(er, f, le, lr):
    """SELD = mean(ER, 1-F, LE/180, 1-LR) (seld_metrics.py:222-236)."""
    return np.mean([er, 1.0 - np.asarray(f), np.asarray(le) / 180.0, 1.0 - np.asarray(lr)], axis=0)


def jackknife_estimation(global_value, partial_estimates, significance_level=0.05):
    """Leave-one-out bias-corrected estimate + t-test confidence interval
    (seld_metrics.py:149-185)."""
    partial = np.asarray(partial_estimates, np.float64)
    n = len(partial)
    mean_jack = partial.mean()
    bias = (n - 1) * (mean_jack - global_value)
    std_err = np.sqrt((n - 1) * np.mean((partial - mean_jack) ** 2))
    estimate = global_value - bias
    if not (0 < significance_level < 1):
        raise ValueError("confidence level must be in (0, 1).")
    t_value = stats.t.ppf(1 - significance_level / 2, n - 1)
    conf = estimate + t_value * np.array([-std_err, std_err])
    return estimate, bias, std_err, conf


# ---------------------------------------------------------------------------


class SELDMetrics:
    """Streaming accumulator over segment blocks (seld_metrics.py:188-373)."""

    def __init__(self, doa_threshold: float = 20.0, nb_classes: int = 13,
                 average: str = "macro"):
        self.nb_classes = nb_classes
        self.doa_threshold = doa_threshold
        self.average = average
        K = nb_classes
        self.TP = np.zeros(K)
        self.FP = np.zeros(K)
        self.FP_spatial = np.zeros(K)
        self.FN = np.zeros(K)
        self.Nref = np.zeros(K)
        self.S = 0.0
        self.D = 0.0
        self.I = 0.0
        self.total_DE = np.zeros(K)
        self.DE_TP = np.zeros(K)
        self.DE_FP = np.zeros(K)
        self.DE_FN = np.zeros(K)

    # -- scoring ------------------------------------------------------------

    def compute_seld_scores(self):
        """Returns (ER, F, LE, LR, SELD, classwise) — classwise is a
        (5, K) array under macro averaging, [] under micro."""
        ER = (self.S + self.D + self.I) / (self.Nref.sum() + _EPS)
        classwise = []
        if self.average == "micro":
            F = self.TP.sum() / (_EPS + self.TP.sum() + self.FP_spatial.sum()
                                 + 0.5 * (self.FP.sum() + self.FN.sum()))
            LE = (self.total_DE.sum() / (self.DE_TP.sum() + _EPS)
                  if self.DE_TP.sum() else 180.0)
            LR = self.DE_TP.sum() / (_EPS + self.DE_TP.sum() + self.DE_FN.sum())
            SELD = early_stopping_metric(ER, F, LE, LR)
        else:
            F = self.TP / (_EPS + self.TP + self.FP_spatial + 0.5 * (self.FP + self.FN))
            LE = self.total_DE / (self.DE_TP + _EPS)
            LE[self.DE_TP == 0] = 180.0
            LR = self.DE_TP / (_EPS + self.DE_TP + self.DE_FN)
            ER_rep = np.repeat(ER, self.nb_classes)
            SELD = early_stopping_metric(ER_rep, F, LE, LR)
            classwise = np.array([ER_rep, F, LE, LR, SELD])
            F, LE, LR, SELD = F.mean(), LE.mean(), LR.mean(), SELD.mean()
        return ER, F, LE, LR, SELD, classwise

    # -- accumulation -------------------------------------------------------

    def update_seld_scores(self, pred: Dict, gt: Dict) -> None:
        """Accumulate one clip's segment dicts (both sides in the same
        coordinate convention: polar degrees or cartesian)."""
        for block in range(len(gt)):
            loc_FN = 0
            loc_FP = 0
            for cls in range(self.nb_classes):
                in_gt = cls in gt[block]
                in_pred = cls in pred[block]
                nb_gt = (max(len(v) for v in gt[block][cls][0][1]) if in_gt else None)
                nb_pred = (max(len(v) for v in pred[block][cls][0][1]) if in_pred else None)
                if nb_gt is not None:
                    self.Nref[cls] += nb_gt

                if in_gt and in_pred:
                    track_dist: Dict[int, List[float]] = {}
                    track_cnt: Dict[int, List[int]] = {}
                    gt_frames = gt[block][cls][0][0]
                    pred_frames = pred[block][cls][0][0]
                    for g_idx, frame in enumerate(gt_frames):
                        if frame not in pred_frames:
                            continue
                        gt_arr = np.array(gt[block][cls][0][1][g_idx])
                        gt_doas = gt_arr[:, 1:]
                        p_idx = pred_frames.index(frame)
                        pred_arr = np.array(pred[block][cls][0][1][p_idx])
                        pred_doas = pred_arr[:, 1:]
                        if gt_doas.shape[-1] == 2:  # degrees -> radians
                            gt_doas = gt_doas * np.pi / 180.0
                            pred_doas = pred_doas * np.pi / 180.0
                        dists, rows, cols = least_distance_between_gt_pred(gt_doas, pred_doas)
                        for d_idx, dist in enumerate(dists):
                            tid = rows[d_idx]  # per-frame row position == track id
                            track_dist.setdefault(tid, []).append(dist)
                            track_cnt.setdefault(tid, []).append(p_idx)

                    if len(track_dist) == 0:
                        # both present but no frame-aligned match: the
                        # reference charges nb_pred to FN here (":325-329")
                        loc_FN += nb_pred
                        self.FN[cls] += nb_pred
                        self.DE_FN[cls] += nb_pred
                    else:
                        for tid, dists in track_dist.items():
                            avg = sum(dists) / len(track_cnt[tid])
                            self.total_DE[cls] += avg
                            self.DE_TP[cls] += 1
                            if avg <= self.doa_threshold:
                                self.TP[cls] += 1
                            else:
                                loc_FP += 1
                                self.FP_spatial[cls] += 1
                        if nb_pred > nb_gt:
                            diff = nb_pred - nb_gt
                            loc_FP += diff
                            self.FP[cls] += diff
                            self.DE_FP[cls] += diff
                        elif nb_pred < nb_gt:
                            diff = nb_gt - nb_pred
                            loc_FN += diff
                            self.FN[cls] += diff
                            self.DE_FN[cls] += diff
                elif in_gt:
                    loc_FN += nb_gt
                    self.FN[cls] += nb_gt
                    self.DE_FN[cls] += nb_gt
                elif in_pred:
                    loc_FP += nb_pred
                    self.FP[cls] += nb_pred
                    self.DE_FP[cls] += nb_pred

            self.S += min(loc_FP, loc_FN)
            self.D += max(0, loc_FN - loc_FP)
            self.I += max(0, loc_FP - loc_FN)


# ---------------------------------------------------------------------------


def segment_labels(label_dict: Dict, max_frames: int, frames_per_block: int) -> Dict:
    """Group frame-wise events into 1-second blocks
    (seld_metrics.py:480-519): ``out[block][class] = [[frame_keys,
    doa_lists]]`` with per-block frame offsets; DOA rows keep
    [source, coord...] (class stripped)."""
    nb_blocks = int(np.ceil(max_frames / float(frames_per_block)))
    out: Dict[int, Dict] = {b: {} for b in range(nb_blocks)}
    for start in range(0, max_frames, frames_per_block):
        block = start // frames_per_block
        loc: Dict[int, Dict[int, List]] = {}
        for frame in range(start, start + frames_per_block):
            if frame not in label_dict:
                continue
            for value in label_dict[frame]:
                loc.setdefault(value[0], {}).setdefault(frame - start, []).append(value[1:])
        for cls, frames in loc.items():
            out[block].setdefault(cls, []).append(
                [list(frames.keys()), list(frames.values())]
            )
    return out


class SegmentScorer:
    """Directory-level scorer (reference ``ComputeSELDResults``
    seld_metrics.py:376-519 and ``ComputeSELDResultsFromEventOverlap``
    :522-716, unified via ``overlap``/``classwise_overlap`` switches).

    * ``overlap=None``: score everything.
    * ``overlap='any'``: restrict ref & pred to frames whose reference has
      >= 2 simultaneous events (class-independent polyphony).
    * ``overlap='classwise'``: >= 2 simultaneous events of the same class.
    """

    def __init__(
        self,
        ref_dir: str,
        nb_classes: int,
        doa_threshold: float = 20.0,
        nb_label_frames_1s: int = 10,
        use_polar_format: bool = True,
        overlap: Optional[str] = None,
        average: str = "macro",
    ):
        self.ref_dir = ref_dir
        self.nb_classes = nb_classes
        self.doa_threshold = doa_threshold
        self.frames_1s = nb_label_frames_1s
        self.use_polar = use_polar_format
        self.overlap = overlap
        self.average = average

        self.ref_labels: Dict[str, Tuple[Dict, int]] = {}
        self.ref_ov_frames: Dict[str, List[int]] = {}
        for fname in sorted(os.listdir(ref_dir)):
            gt = read_label_csv(os.path.join(ref_dir, fname))
            if not self.use_polar:
                gt = polar_to_cartesian_dict(gt)
            # an all-silent reference CSV has no rows; the reference scorer
            # crashes here (max of an empty dict) — treat it as 0 frames
            nb_ref_frames = max(gt.keys()) if gt else 0
            if overlap is not None:
                keep_frames = []
                filtered = {}
                for frame, events in gt.items():
                    if overlap == "classwise":
                        counts = np.zeros(nb_classes)
                        for ev in events:
                            counts[ev[0]] += 1
                        is_ov = counts.max() > 1
                    else:
                        is_ov = len(events) > 1
                    if is_ov:
                        keep_frames.append(frame)
                        filtered[frame] = events
                self.ref_ov_frames[fname] = keep_frames
                if not filtered:
                    continue  # reference skips files without overlap
                gt = filtered
            self.ref_labels[fname] = (
                segment_labels(gt, nb_ref_frames, self.frames_1s),
                nb_ref_frames,
            )
        self.nb_ref_files = len(self.ref_labels)

    # -- helpers ------------------------------------------------------------

    def _load_pred(self, path: str, fname: str) -> Optional[Dict]:
        pred = read_label_csv(os.path.join(path, fname))
        if self.use_polar:
            pred = cartesian_to_polar_dict(pred)
        if self.overlap is not None:
            pred = {f: pred[f] for f in self.ref_ov_frames[fname] if f in pred}
        return pred

    def _score_files(self, pred_dir: str, files: Sequence[str],
                     seg_cache: Optional[Dict] = None):
        ev = SELDMetrics(self.doa_threshold, self.nb_classes, self.average)
        for fname in files:
            if seg_cache is not None and fname in seg_cache:
                pred_seg = seg_cache[fname]
            else:
                pred = self._load_pred(pred_dir, fname)
                pred_seg = segment_labels(pred, self.ref_labels[fname][1],
                                          self.frames_1s)
                if seg_cache is not None:
                    seg_cache[fname] = pred_seg
            ev.update_seld_scores(pred_seg, self.ref_labels[fname][0])
        return ev.compute_seld_scores()

    # -- public API ---------------------------------------------------------

    @staticmethod
    def get_nb_files(file_list: Sequence[str], tag: str = "all") -> Dict:
        """Group prediction files by filename tag (reference
        seld_metrics.py:400-426: 'all' -> one group, 'room' -> group by the
        room digit at filename position 10)."""
        group_ind = {"room": 10}
        out: Dict = {}
        for fname in file_list:
            ind = 0 if tag == "all" else int(fname[group_ind[tag]])
            out.setdefault(ind, []).append(fname)
        return out

    def get_SELD_Results(self, pred_dir: str, is_jackknife: bool = False):
        files = [f for f in sorted(os.listdir(pred_dir)) if f in self.ref_labels]
        # segment each prediction file once; the leave-one-out pass reuses
        # the cache (the reference caches the same way, seld_metrics.py:442)
        seg_cache: Dict = {} if is_jackknife else None
        ER, F, LE, LR, SELD, classwise = self._score_files(pred_dir, files, seg_cache)
        if not is_jackknife:
            return ER, F, LE, LR, SELD, classwise

        global_values = [ER, F, LE, LR, SELD]
        if len(classwise):
            global_values.extend(np.asarray(classwise).reshape(-1).tolist())
        partial = []
        for leave in files:
            rest = [f for f in files if f != leave]
            res = self._score_files(pred_dir, rest, seg_cache)
            est = list(res[:5])
            if len(res[5]):
                est.extend(np.asarray(res[5]).reshape(-1).tolist())
            partial.append(est)
        partial = np.array(partial)
        conf = []
        for i, gv in enumerate(global_values):
            _, _, _, ci = jackknife_estimation(gv, partial[:, i])
            conf.append(ci)
        cw_conf = (np.array(conf)[5:].reshape(5, self.nb_classes, 2)
                   if len(classwise) else [])
        return (
            [ER, conf[0]], [F, conf[1]], [LE, conf[2]], [LR, conf[3]],
            [SELD, conf[4]], [classwise, cw_conf],
        )
