"""Wrapper of the hand-written Hopper STFT kernel (``csrc/stft.cu``).

The kernel replaces the Pallas fused framed STFT
(``adyolo_tpu/ops/pallas_stft.py::_pallas_stft_impl``) and, on the serving
path, XLA's ``framed_dft_chunked``.  It is a mixed-radix FFT that reads
its twiddles and window from the table of an :class:`FFTPlan`, built once
on the host in float64 by :func:`fft_plan`.  :func:`stft_hop_blocks`
checks its inputs and calls the custom op ``adyolo::stft``
(:mod:`adyolo_tpu_torch.ops.library`), one op in an exported graph, which
dispatches by the tensor's device: a CPU tensor goes to the plain
:func:`adyolo_tpu_torch.ops.stft.stft` (a contraction against the
window-folded DFT matrices of the table's window,
:func:`adyolo_tpu_torch.ops.stft.window_dft`); a CUDA tensor goes to the
kernel (:func:`launch`), or the call raises.  There is no fallback from
one to the other.

``LAUNCHES`` counts kernel launches; it is bumped right after a launch is
accepted, and nowhere else.  ``KERNELS`` counts the same launches by
device kernel name, one a launch, as ``hopper_attention.KERNELS`` does.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..utils.build import load_library

__all__ = ["FFTPlan", "fft_plan", "radix_plan", "stft_hop_blocks", "launch",
           "LAUNCHES", "KERNELS"]

LAUNCHES = 0
KERNELS = {"stft_hop_blocks_fft_kernel": 0}

_C = 4  # channels the kernel carries together (one float4)
_MAX_N = 2400  # frame slots of a kernel buffer (stft.cu CAP): the largest n_fft

_bound = None


def _entry():
    global _bound
    if _bound is None:
        fn = load_library().adyolo_stft_fft
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p]
        _bound = fn
    return _bound


def radix_plan(n_fft: int) -> tuple:
    """The kernel's pass radices for ``n_fft``: 4s, then a 2, then 3s, then
    5s (``(4, 4, 3, 5, 5)`` at 1200)."""
    radices, n = [], n_fft
    for r in (4, 2, 3, 5):  # after the 4s at most one 2 is left
        while n > 1 and n % r == 0:
            radices.append(r)
            n //= r
    if n != 1:
        raise ValueError(f"n_fft must factor into 2, 3 and 5, got {n_fft}")
    return tuple(radices)


@functools.lru_cache(maxsize=None)
def _radices_c(n_fft: int):
    radices = radix_plan(n_fft)
    return (ctypes.c_int * len(radices))(*radices), len(radices)


class FFTPlan:
    """What the kernel reads besides the audio (built by :func:`fft_plan`).

    ``table``: ``(3 * n_fft,)`` float32 on the device, the twiddles
    ``e^{-2 pi i m / n_fft}`` (``m < n_fft``) as (re, im) pairs, then the
    window.  ``radices``: the pass order (:func:`radix_plan` of ``n_fft``).
    """

    def __init__(self, table):
        self.n_fft = table.shape[0] // 3
        self.radices = radix_plan(self.n_fft)
        self.table = table


def fft_plan(window, device="cuda") -> FFTPlan:
    """The :class:`FFTPlan` of an analysis ``window`` of length ``n_fft``:
    twiddles and window computed in float64 and rounded once to float32."""
    window = np.asarray(window, np.float32)
    n = window.shape[0]
    if window.ndim != 1 or n < 2 or n % 2:
        raise ValueError(f"the window must be 1-D of even length n_fft, got "
                         f"{window.shape}")
    if n > _MAX_N:
        raise ValueError(f"the kernel takes n_fft <= {_MAX_N}, got {n}")
    radix_plan(n)  # raises for an n_fft the kernel cannot take
    tw = np.exp(-2j * np.pi * np.arange(n, dtype=np.float64) / n)
    table = np.concatenate([np.stack([tw.real, tw.imag], -1).ravel(),
                            window.astype(np.float64)])
    return FFTPlan(torch.as_tensor(table.astype(np.float32), device=device))


def _check(x: torch.Tensor, plan: FFTPlan):
    if x.dtype != torch.float32:
        raise TypeError(f"audio must be float32, got {x.dtype}")
    if x.ndim not in (3, 4):
        raise ValueError(f"audio must be (B, T, hop, C) or (B, N, C), got "
                         f"{tuple(x.shape)}")
    if x.shape[-1] != _C:
        raise ValueError(f"the kernel carries C == {_C} channels, got "
                         f"{x.shape[-1]}")
    if not x.is_contiguous():
        raise ValueError("audio must be contiguous")
    if plan.table.device != x.device:
        raise ValueError(f"the plan's table must be on the audio's device, got "
                         f"{plan.table.device} for {x.device}")
    n_fft = plan.n_fft
    hop = n_fft // 2
    if x.ndim == 4 and x.shape[2] != hop:
        raise ValueError(f"the kernel needs n_fft == 2*hop, got n_fft={n_fft}, "
                         f"hop={x.shape[2]}")
    T = x.shape[1] if x.ndim == 4 else x.shape[1] // hop
    if T < 2:
        raise ValueError(f"need at least 2 hop-blocks, got T={T}")
    return hop, T


def stft_hop_blocks(x: torch.Tensor, plan: FFTPlan):
    """``(re, im)``, each ``(B, T, K, 4)`` float32 (``K = 1 + n_fft // 2``),
    of hop-block audio ``(B, T, hop, 4)`` or flat audio ``(B, N, 4)``
    (``T = N // hop``; the kernel reads the hop-block view of the first
    ``T*hop`` samples), with ``hop = plan.n_fft // 2``: the op
    ``adyolo::stft``."""
    _check(x, plan)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    return torch.ops.adyolo.stft(x, plan.table)


def launch(x: torch.Tensor, table: torch.Tensor):
    """The kernel on CUDA audio ``x`` and a plan's ``table`` (the CUDA
    kernel of ``adyolo::stft``); the radix plan follows from the table's
    length."""
    if table.device != x.device:
        raise ValueError(f"the plan's table must be on the audio's device, got "
                         f"{table.device} for {x.device}")
    global LAUNCHES
    n_fft = table.shape[0] // 3
    hop = n_fft // 2
    B = x.shape[0]
    T = x.shape[1] if x.ndim == 4 else x.shape[1] // hop
    clip_stride = T * hop if x.ndim == 4 else x.shape[1]  # in float4 units
    radices, n_passes = _radices_c(n_fft)
    fn = _entry()
    with torch.cuda.device(x.device):
        re = torch.empty((B, T, hop + 1, _C), device=x.device, dtype=torch.float32)
        im = torch.empty_like(re)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), clip_stride, B, T, hop, table.data_ptr(),
                radices, n_passes, re.data_ptr(), im.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"STFT kernel launch refused: cudaError {rc}")
    LAUNCHES += 1
    KERNELS["stft_hop_blocks_fft_kernel"] += 1
    return re, im
