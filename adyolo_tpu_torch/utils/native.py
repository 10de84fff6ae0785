"""Loader of the repository's C++ host helpers (``native/nms.cpp``,
``native/wavload.cpp``, ``native/hungarian.cpp``), the port's counterpart of
:mod:`adyolo_tpu.utils.native`.

``load_or_build("nms")`` compiles ``native/nms.cpp`` with ``g++`` into
``build/adyolo_tpu_torch/lib<name>_<hash>.so`` (named by a hash of the
source, rebuilt when it changes) and loads it with ctypes.  The build
writes a process-unique temporary file and renames it into place, so
concurrent processes never load a half-written library.  A failed build
returns None; the callers say what they do then.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import Dict, Optional

from .build import BUILD_DIR

__all__ = ["load_or_build"]

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(BUILD_DIR)), "native")
_FLAGS = ("-O2", "-shared", "-fPIC")

_cache: Dict[str, Optional[ctypes.CDLL]] = {}


def load_or_build(name: str) -> Optional[ctypes.CDLL]:
    """The CDLL of ``native/<name>.cpp``, built on first use; None when g++
    is missing or refuses the source."""
    if name in _cache:
        return _cache[name]
    src = os.path.join(_NATIVE_DIR, f"{name}.cpp")
    handle: Optional[ctypes.CDLL] = None
    try:
        with open(src, "rb") as f:
            digest = hashlib.sha256(f.read() + " ".join(_FLAGS).encode()).hexdigest()
        lib = os.path.join(BUILD_DIR, f"lib{name}_{digest[:16]}.so")
        if not os.path.exists(lib):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{lib}.{os.getpid()}.tmp"
            subprocess.run(["g++", *_FLAGS, "-o", tmp, src], check=True,
                           capture_output=True)
            os.replace(tmp, lib)  # atomic against concurrent builds
        handle = ctypes.CDLL(lib)
    except (OSError, subprocess.CalledProcessError):
        handle = None
    _cache[name] = handle
    return handle
