"""Build the port's CUDA kernels and load them with ctypes.

Every ``adyolo_tpu_torch/csrc/*.cu`` file is compiled by its own ``nvcc``,
all started together, and the objects are linked into one shared library
with a plain C interface (no PyTorch headers, so a build takes seconds)::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \\
         -Xcompiler -fPIC -Xptxas=-v -c -o <name>.o adyolo_tpu_torch/csrc/<name>.cu
    nvcc -gencode arch=compute_90a,code=sm_90a -shared \\
         -o build/adyolo_tpu_torch/libadyolo_kernels_<hash>.so *.o

The library is named by a hash of the sources and the flags, built on
first use, and reused while neither changes.  A failed build raises
:class:`KernelBuildError` carrying nvcc's stderr; there is no fallback.
An entry point that returns an error has recorded where it failed
(``csrc/errors.cuh``); :func:`launch_error` turns that record into a
:class:`KernelLaunchError` naming the entry point, the site and the CUDA
error.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Optional

__all__ = ["KernelBuildError", "KernelLaunchError", "BUILD_DIR", "NVCC_FLAGS",
           "LINK_FLAGS", "sources", "nvcc_path", "library_path", "build", "load_library",
           "launch_error"]

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "adyolo_tpu_torch")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas=-v")
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused the sources."""


class KernelLaunchError(RuntimeError):
    """An entry point of the kernel library returned an error: ``entry``,
    ``site`` (what failed, with its values), ``code`` and ``name`` (the
    CUDA error's, or the CUDA driver's for a ``CUresult``)."""

    def __init__(self, what, entry, site, code, name):
        super().__init__(f"{what}: {entry}: {site}: {name} ({code})")
        self.entry, self.site, self.code, self.name = entry, site, code, name


def sources() -> list:
    """The kernel sources (``csrc/*.cu``), sorted."""
    return sorted(glob.glob(os.path.join(_CSRC_DIR, "*.cu")))


def nvcc_path() -> str:
    """The nvcc executable ($CUDA_HOME/bin, /usr/local/cuda/bin, PATH)."""
    cands = [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                          "bin", "nvcc"), shutil.which("nvcc")]
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise KernelBuildError("nvcc not found (looked in $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin and PATH)")


def library_path() -> str:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for src in sources() + sorted(glob.glob(os.path.join(_CSRC_DIR, "*.cuh"))):
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libadyolo_kernels_{h.hexdigest()[:16]}.so")


def build(force: bool = False) -> dict:
    """Compile the kernels unless the hashed library exists (or ``force``).

    Returns ``{"path", "built", "seconds", "ptxas"}``; ``ptxas`` is nvcc's
    ``-Xptxas=-v`` report (registers, shared memory, spills per kernel).
    """
    path = library_path()
    log = path[:-3] + ".log"
    if os.path.isfile(path) and not force:
        ptxas = ""
        if os.path.isfile(log):
            with open(log) as f:
                ptxas = f.read()
        return {"path": path, "built": False, "seconds": 0.0, "ptxas": ptxas}
    srcs = sources()
    if not srcs:
        raise KernelBuildError(f"no CUDA sources under {_CSRC_DIR}")
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    tmp = f"{path}.{os.getpid()}.tmp"
    objs = [f"{tmp}.{os.path.basename(src)}.o" for src in srcs]
    t0 = time.perf_counter()
    try:
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj, src],
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                  text=True)
                 for src, obj in zip(srcs, objs)]
        logs = []
        for proc in procs:  # all compile at once; read every one's output
            _, err = proc.communicate()
            logs.append((proc, err))
        for proc, err in logs:
            if proc.returncode != 0:
                raise KernelBuildError(
                    f"nvcc failed ({proc.returncode}): {' '.join(proc.args)}\n{err}")
        cmd = [nvcc, *LINK_FLAGS, "-o", tmp, *objs]
        link = subprocess.run(cmd, capture_output=True, text=True)
        if link.returncode != 0:
            raise KernelBuildError(
                f"nvcc failed ({link.returncode}): {' '.join(cmd)}\n{link.stderr}")
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    seconds = time.perf_counter() - t0
    os.replace(tmp, path)  # atomic against concurrent builds
    ptxas = "".join(err for _, err in logs)
    with open(log, "w") as f:
        f.write(ptxas)
    return {"path": path, "built": True, "seconds": seconds, "ptxas": ptxas}


def load_library() -> ctypes.CDLL:
    """The kernel library, built on first use and loaded once per process."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = ctypes.CDLL(build()["path"])
        return _lib


def launch_error(what: str, rc: int) -> KernelLaunchError:
    """The error to raise for an entry point call of this thread that
    returned ``rc`` (not 0): the library's record of the failure
    (``adyolo_last_error``), read on the thread that made the call."""
    fn = load_library().adyolo_last_error
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.POINTER(ctypes.c_char_p)] * 2 + [
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_char_p)]
    entry, site, name = ctypes.c_char_p(), ctypes.c_char_p(), ctypes.c_char_p()
    code = ctypes.c_int()
    if not fn(ctypes.pointer(entry), ctypes.pointer(site), ctypes.pointer(code),
              ctypes.pointer(name)):
        return KernelLaunchError(what, "(unknown entry point)", "no failure recorded",
                                 abs(rc), f"return code {rc}")
    return KernelLaunchError(what, entry.value.decode(), site.value.decode(), code.value,
                             name.value.decode())
