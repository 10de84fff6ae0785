"""AD-YOLO label encoding: the port's copy of the AD-YOLO part of
:mod:`adyolo_tpu.data.labels` (the other formats' encoders wait for their
heads and losses).

Host-side (numpy) per-clip encoder mirroring ``src/datasets.py:457-482``:
ragged (M, 6) ``[frame, Gi, Gj, cls, U, V]`` rows, plus
:func:`pad_yolo_targets` turning a batch of ragged lists into the
fixed-capacity (max_targets, 7) + mask tensor the AD-YOLO loss takes.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from ..ops.grid import GridGeometry
from .io import LabelDict

__all__ = ["encode_adyolo", "pad_yolo_targets"]


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
