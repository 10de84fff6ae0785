"""Native per-frame NMS binding (``native/nms.cpp``): the port's copy of
:mod:`adyolo_tpu.ops.nms_native`, built by the port's own loader
(:mod:`adyolo_tpu_torch.utils.native`) into ``build/adyolo_tpu_torch/``.

One ctypes call per active frame replaces ~50 numpy dispatches per
(frame, class); the JAX package's numpy NMS is its oracle in the tests.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from ..utils.native import load_or_build

_MODES = {"conn-merge": 0, "soft-merge": 1, "default": 2}

_lib: Optional[ctypes.CDLL] = None
_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    lib = load_or_build("nms")
    if lib is not None:
        lib.nms_frame.restype = ctypes.c_int
        lib.nms_frame.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_int,
            ctypes.c_double, ctypes.c_double, ctypes.POINTER(ctypes.c_double),
        ]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def nms_frame(rows: np.ndarray, mode: str, unify: float,
              temp: float) -> Optional[np.ndarray]:
    """rows: (n, 4) float64 [class, conf, U, V] sorted by descending conf.
    Returns (m, 4) [class, x, y, z] detections, or None when the native
    library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    rows = np.ascontiguousarray(rows, dtype=np.float64)
    n = rows.shape[0]
    out = np.empty((n, 4), np.float64)
    m = lib.nms_frame(
        rows.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n,
        _MODES.get(mode, _MODES["default"]),  # unknown -> greedy default,
        # matching the reference's else-branch (datasets.py:837)
        float(unify), float(temp),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    return out[:m]
