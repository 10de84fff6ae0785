"""Linear sum assignment: native C++ solver with scipy fallback (the
port's copy of :mod:`adyolo_tpu.metrics.hungarian`; host code).

The reference calls scipy's C++ ``linear_sum_assignment``
(``src/utils/seld_metrics.py:144``); this framework ships its own native
solver (``native/hungarian.cpp``, Hungarian method with potentials) bound
via ctypes, compiled on first use by the port's g++ loader
(:mod:`adyolo_tpu_torch.utils.native`).  scipy
remains the fallback when no C++ toolchain is available.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np

from ..utils.native import load_or_build

_lib: Optional[ctypes.CDLL] = None
_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    lib = load_or_build("hungarian")
    if lib is not None:
        lib.lsa.restype = ctypes.c_int
        lib.lsa.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ]
    _lib = lib
    return _lib


def linear_sum_assignment(cost: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """scipy-compatible rectangular assignment (minimize total cost)."""
    cost = np.ascontiguousarray(cost, dtype=np.float64)
    n, m = cost.shape
    lib = _load()
    if lib is None:
        from scipy.optimize import linear_sum_assignment as _scipy_lsa

        return _scipy_lsa(cost)
    k = min(n, m)
    rows = np.empty(k, np.int32)
    cols = np.empty(k, np.int32)
    lib.lsa(
        cost.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n, m,
        rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        cols.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
    )
    return rows.astype(np.int64), cols.astype(np.int64)
