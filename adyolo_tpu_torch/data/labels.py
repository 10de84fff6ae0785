"""Label encoders for the five SELD output formats: the port's copy of
:mod:`adyolo_tpu.data.labels`.

Host-side (numpy) per-clip encoders mirroring ``src/datasets.py:296-482``:

* ``seddoa``  -> (T, 4K)  [activity ‖ X ‖ Y ‖ Z per class] (datasets.py:296-321)
* ``accdoa``  -> (T, 3K)  activity-gated XYZ               (datasets.py:323-348)
* ``adpit``   -> (T, 6, 4, K) six-slot track layout        (datasets.py:350-455)
* ``adyolo``  -> ragged (M, 6) ``[frame, Gi, Gj, cls, U, V]`` (datasets.py:457-482),
  plus :func:`pad_yolo_targets` turning a batch of ragged lists into the
  fixed-capacity (max_targets, 7) + mask tensor the AD-YOLO loss takes.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..ops.grid import GridGeometry
from .io import LabelDict, polar_to_cartesian_dict

__all__ = ["encode_seddoa", "encode_accdoa", "encode_adpit", "encode_adyolo",
           "pad_yolo_targets"]


def _dense_sexyz(label: LabelDict, nb_label_frames: int, nb_classes: int):
    """Per (frame, class) activity and XYZ for seddoa / accdoa (the last
    event of a class in a frame wins, as in the reference's loops)."""
    cart = polar_to_cartesian_dict(label)
    se, x, y, z = (np.zeros((nb_label_frames, nb_classes), np.float32)
                   for _ in range(4))
    for frame, events in cart.items():
        if frame >= nb_label_frames:
            continue
        for ev in events:
            c = int(ev[0])
            se[frame, c] = 1.0
            x[frame, c] = ev[2]
            y[frame, c] = ev[3]
            z[frame, c] = ev[4]
    return se, x, y, z


def encode_seddoa(label: LabelDict, nb_label_frames: int, nb_classes: int) -> np.ndarray:
    se, x, y, z = _dense_sexyz(label, nb_label_frames, nb_classes)
    return np.concatenate([se, x, y, z], axis=1)


def encode_accdoa(label: LabelDict, nb_label_frames: int, nb_classes: int) -> np.ndarray:
    se, x, y, z = _dense_sexyz(label, nb_label_frames, nb_classes)
    return np.tile(se, 3) * np.concatenate([x, y, z], axis=1)


def encode_adpit(label: LabelDict, nb_label_frames: int, nb_classes: int) -> np.ndarray:
    """Six-slot ADPIT layout (T, 6, 4, K): slot 0 a single source (a0),
    slots 1-2 two same-class sources (b0, b1), slots 3-5 three or more
    (c0, c1, c2: the first three); axis 2 is [act, X, Y, Z]."""
    cart = polar_to_cartesian_dict(label)
    out = np.zeros((nb_label_frames, 6, 4, nb_classes), np.float32)
    for frame, events in cart.items():
        if frame >= nb_label_frames:
            continue
        groups: Dict[int, List] = {}
        for ev in sorted(events, key=lambda e: e[0]):  # stable sort by class
            groups.setdefault(int(ev[0]), []).append(ev)
        for cls, grp in groups.items():
            if len(grp) == 1:
                slots = [(0, grp[0])]
            elif len(grp) == 2:
                slots = [(1, grp[0]), (2, grp[1])]
            else:  # datasets.py:393-411
                slots = [(3, grp[0]), (4, grp[1]), (5, grp[2])]
            for slot, ev in slots:
                out[frame, slot, 0, cls] = 1.0
                out[frame, slot, 1, cls] = ev[2]
                out[frame, slot, 2, cls] = ev[3]
                out[frame, slot, 3, cls] = ev[4]
    return out


def encode_adyolo(label: LabelDict, nb_label_frames: int, geom: GridGeometry) -> np.ndarray:
    """Ragged AD-YOLO targets: one row per (event, responsible grid cell):
    ``[frame, Gi, Gj, class, U, V]`` (datasets.py:457-482).  Azimuth +180 is
    folded to -180 before the responsibility test (datasets.py:470)."""
    rows: List[List[float]] = []
    for frame, events in label.items():
        if frame >= nb_label_frames:
            continue
        for ev in events:
            azi, ele = float(ev[2]), float(ev[3])
            if azi == 180.0:
                azi = -180.0
            resp = geom.responsible_cells(azi, ele)
            gi, gj = np.where(resp)
            for i, j in zip(gi, gj):
                rows.append([frame, int(i), int(j), int(ev[0]), azi, ele])
    if not rows:
        return np.zeros((0, 6), np.float32)
    return np.asarray(rows, np.float32)


def pad_yolo_targets(
    per_clip: Sequence[np.ndarray], max_targets: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Batch ragged per-clip (M_i, 6) target arrays into
    ``targets (max_targets, 7)`` = [batch, frame, Gi, Gj, cls, U, V] plus a
    boolean validity mask — the static-shape replacement for the reference's
    ragged collate (datasets.py:164-184).

    Overflow beyond ``max_targets`` is dropped deterministically from the
    end, with a stderr warning — capacity is configured well above the
    observed maximum (train: per-chunk, eval: scaled by clip length).
    """
    rows = []
    for b, t in enumerate(per_clip):
        if len(t) == 0:
            continue
        rows.append(np.concatenate([np.full((len(t), 1), b, np.float32), t], axis=1))
    if rows:
        cat = np.concatenate(rows, axis=0)
    else:
        cat = np.zeros((0, 7), np.float32)
    n = min(len(cat), max_targets)
    if len(cat) > max_targets:
        import sys

        print(f"[adyolo_tpu_torch] WARNING: dropping {len(cat) - max_targets} of "
              f"{len(cat)} AD-YOLO target rows (capacity {max_targets}); "
              "raise train.max_targets_per_clip", file=sys.stderr)
    out = np.zeros((max_targets, 7), np.float32)
    mask = np.zeros((max_targets,), bool)
    out[:n] = cat[:n]
    mask[:n] = True
    return out, mask
