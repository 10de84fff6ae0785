"""AD-YOLO spherical grid geometry (the port's copy of
:mod:`adyolo_tpu.ops.grid`).

One shared implementation of the grid constants that the reference
rebuilds in three places (label encoder ``src/datasets.py:219-238``, loss
``src/models/loss.py:163-174``, decoder ``src/datasets.py:505-524``):

* ``nb_grids = (ceil(360/gs_azi), ceil(180/gs_ele))`` → (8, 4) for 45°,
* cell centers ``offset[i,j] = (i,j)*gs - (180,90) + gs/2``,
* overlap-expanded bounds ``lb/ub = offset ∓ gs*(0.5+g_overlap)`` with the
  elevation bound clipped to ±90,
* responsible-cell test with azimuth wrap-around at ±180
  (``src/datasets.py:472-476``).

Everything is precomputed on the host as numpy constants; the loss/decoder
close over them as device constants.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np

__all__ = ["GridGeometry"]


@dataclass(frozen=True)
class GridGeometry:
    grid_size: Tuple[float, float]
    g_overlap: float
    nb_anchors: int

    def __post_init__(self):
        gs = np.asarray(self.grid_size, np.float32)
        n_azi = math.ceil(360.0 / gs[0])
        n_ele = math.ceil(180.0 / gs[1])
        object.__setattr__(self, "nb_grids", (int(n_azi), int(n_ele)))

        offset = np.stack(
            np.meshgrid(np.arange(n_azi), np.arange(n_ele), indexing="ij"), axis=-1
        ).astype(np.float32)
        offset = offset * gs - np.array([180.0, 90.0], np.float32) + gs * 0.5
        object.__setattr__(self, "offset", offset)  # (n_azi, n_ele, 2)

        half = gs * (0.5 + self.g_overlap)
        lb = offset - half
        ub = offset + half
        lb[..., 1] = np.clip(lb[..., 1], -90.0, 90.0)
        ub[..., 1] = np.clip(ub[..., 1], -90.0, 90.0)
        object.__setattr__(self, "lb", lb)
        object.__setattr__(self, "ub", ub)

    @property
    def nb_cells(self) -> int:
        return self.nb_grids[0] * self.nb_grids[1]

    @property
    def nb_predicts(self) -> int:
        # reference: loss.py:170, datasets.py:515
        return self.nb_cells * self.nb_anchors

    def responsible_cells(self, azi: float, ele: float) -> np.ndarray:
        """Boolean (n_azi, n_ele) mask of cells responsible for an event at
        (azi, ele) degrees — overlap-expanded containment with azimuth
        wrap-around (src/datasets.py:472-476).  Azimuth exactly +180 must be
        folded to -180 by the caller (src/datasets.py:470)."""
        ele_ok = (self.lb[..., 1] <= ele) & (ele < self.ub[..., 1])
        azi_ok = (self.lb[..., 0] <= azi) & (azi < self.ub[..., 0])
        resp = azi_ok & ele_ok
        resp |= (azi + 360.0 < self.ub[..., 0]) & ele_ok
        resp |= (self.lb[..., 0] < azi - 360.0) & ele_ok
        return resp

    def uv_to_degrees_scale(self) -> np.ndarray:
        """Per-axis scale turning a tanh (u, v) into degrees relative to the
        cell center: ``uv * (0.5 + g_overlap) * grid_size``
        (src/datasets.py:760-762, loss.py:204-206)."""
        return (np.asarray(self.grid_size, np.float32) * (0.5 + self.g_overlap))
