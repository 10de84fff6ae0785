"""Wrapper of the hand-written Hopper STFT kernels (``csrc/stft.cu``).

The kernels replace the Pallas fused framed STFT
(``adyolo_tpu/ops/pallas_stft.py::_pallas_stft_impl``) and, on the serving
path, XLA's ``framed_dft_chunked`` and ``framed_dft``.  Each is a
mixed-radix FFT that reads its twiddles and window from the table of an
:class:`FFTPlan`, built once on the host in float64 by :func:`fft_plan`:

* ``stft_hop_blocks_fft_kernel`` at ``n_fft == 2 * hop <= 2400`` (the
  DCASE geometry, 1200 / 600), on hop-block ``(B, T, hop, 4)`` audio or
  the hop-block view of flat ``(B, N, 4)`` audio;
* ``stft_frames_fft_kernel`` on flat audio at any other hop (or hop-block
  audio at ``n_fft == 2 * hop`` above 2400, read flat), for every even
  ``n_fft <= 4096`` whose factors are 2, 3 and 5: each frame's ``n_fft``
  samples read from the flat clip, reflected at the left edge, zeros past
  its end (:func:`adyolo_tpu_torch.ops.stft.framed_dft_flat`).

:func:`stft_hop_blocks` checks its inputs and calls the custom op
``adyolo::stft``
(:mod:`adyolo_tpu_torch.ops.library`), one op in an exported graph, which
dispatches by the tensor's device: a CPU tensor goes to the plain
:func:`adyolo_tpu_torch.ops.stft.stft` (a contraction against the
window-folded DFT matrices of the table's window,
:func:`adyolo_tpu_torch.ops.stft.window_dft`); a CUDA tensor goes to the
kernel (:func:`launch`), or the call raises.  There is no fallback from
one to the other.

``LAUNCHES`` counts kernel launches of both kernels; it is bumped right
after a launch is accepted, and nowhere else.  ``KERNELS`` counts the same
launches by device kernel name, one a launch, as
``hopper_attention.KERNELS`` does.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from ..utils.build import launch_error, load_library

__all__ = ["FFTPlan", "fft_plan", "radix_plan", "check_n_fft", "kernel_of",
           "stft_hop_blocks", "launch", "LAUNCHES", "KERNELS", "MAX_N_FFT"]

LAUNCHES = 0
KERNELS = {"stft_hop_blocks_fft_kernel": 0, "stft_frames_fft_kernel": 0}

_C = 4  # channels the kernels carry together (one float4)
_HOP_BLOCK_MAX_N = 2400  # frame slots of a hop-block kernel buffer (stft.cu CAP)
MAX_N_FFT = 4096  # the frames kernel's largest n_fft (stft.cu MAX_N)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "adyolo_stft_fft": [_P, _L, _I, _I, _I, _P, _P, _I, _P, _P, _P],
    "adyolo_stft_frames_fft": [_P, _L, _L, _I, _I, _I, _I, _P, _P, _I, _P, _P, _P],
}
_bound = {}


def _entry(name):
    if name not in _bound:
        fn = getattr(load_library(), name)
        fn.restype = ctypes.c_int
        fn.argtypes = _SIGNATURES[name]
        _bound[name] = fn
    return _bound[name]


def radix_plan(n_fft: int) -> tuple:
    """The kernels' pass radices for ``n_fft``: 4s, then a 2, then 3s, then
    5s (``(4, 4, 3, 5, 5)`` at 1200, ``(4, 4, 4, 4, 4, 2)`` at 2048)."""
    radices, n = [], n_fft
    for r in (4, 2, 3, 5):  # after the 4s at most one 2 is left
        while n > 1 and n % r == 0:
            radices.append(r)
            n //= r
    if n != 1:
        raise ValueError(f"n_fft must factor into 2, 3 and 5, got {n_fft}")
    return tuple(radices)


def check_n_fft(n_fft: int):
    """Raises ``ValueError`` for an ``n_fft`` the kernels cannot take: odd,
    above :data:`MAX_N_FFT`, or with a prime factor above 5."""
    if n_fft < 2 or n_fft % 2:
        raise ValueError(f"the STFT kernels take an even n_fft, got {n_fft}")
    if n_fft > MAX_N_FFT:
        raise ValueError(f"the STFT kernels take n_fft <= {MAX_N_FFT}, got {n_fft}")
    radix_plan(n_fft)


def kernel_of(n_fft: int, hop: int) -> str:
    """The device kernel that frames at ``(n_fft, hop)``."""
    if n_fft == 2 * hop and n_fft <= _HOP_BLOCK_MAX_N:
        return "stft_hop_blocks_fft_kernel"
    return "stft_frames_fft_kernel"


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
    if window.ndim != 1:
        raise ValueError(f"the window must be 1-D of length n_fft, got {window.shape}")
    n = window.shape[0]
    check_n_fft(n)
    tw = np.exp(-2j * np.pi * np.arange(n, dtype=np.float64) / n)
    table = np.concatenate([np.stack([tw.real, tw.imag], -1).ravel(),
                            window.astype(np.float64)])
    return FFTPlan(torch.as_tensor(table.astype(np.float32), device=device))


def _check(x: torch.Tensor, plan: FFTPlan, hop: int):
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
    if hop < 1:
        raise ValueError(f"hop must be >= 1, got {hop}")
    if x.ndim == 4:
        if x.shape[2] != hop:
            raise ValueError(f"hop-block width {x.shape[2]} != hop {hop}")
        if n_fft != 2 * hop:  # as JAX's framed_dft_chunked
            raise ValueError(f"hop-block audio needs n_fft == 2*hop, got n_fft={n_fft}, "
                             f"hop={hop}: pass flat (B, N, 4) audio")
        if x.shape[1] < 2:
            raise ValueError(f"need at least 2 hop-blocks, got T={x.shape[1]}")
    elif kernel_of(n_fft, hop) == "stft_hop_blocks_fft_kernel":
        if x.shape[1] // hop < 2:
            raise ValueError(f"need at least 2 hop-blocks, got N={x.shape[1]}, hop={hop}")
    elif x.shape[1] < hop or x.shape[1] <= n_fft // 2:
        raise ValueError(f"flat audio of {x.shape[1]} samples is too short for one frame "
                         f"of n_fft {n_fft} at hop {hop} (its reflection needs N > "
                         f"n_fft // 2)")


def stft_hop_blocks(x: torch.Tensor, plan: FFTPlan, hop: Optional[int] = None):
    """``(re, im)``, each ``(B, T, K, 4)`` float32 (``K = 1 + n_fft // 2``),
    of hop-block audio ``(B, T, hop, 4)`` (``n_fft == 2 * hop``) or flat
    audio ``(B, N, 4)`` (``T = N // hop`` librosa ``center=True`` frames;
    at ``n_fft == 2 * hop`` the hop-block kernel reads the hop-block view
    of the first ``T*hop`` samples); ``hop`` None: the hop-block width, or
    ``plan.n_fft // 2`` for flat audio.  The op ``adyolo::stft``."""
    if hop is None:
        hop = x.shape[2] if x.ndim == 4 else plan.n_fft // 2
    hop = int(hop)
    _check(x, plan, hop)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    return torch.ops.adyolo.stft(x, plan.table, hop)


def launch(x: torch.Tensor, table: torch.Tensor, hop: int):
    """The kernel of ``(n_fft, hop)`` (:func:`kernel_of`) on CUDA audio
    ``x`` and a plan's ``table`` (the CUDA kernel of ``adyolo::stft``); the
    radix plan follows from the table's length."""
    if table.device != x.device:
        raise ValueError(f"the plan's table must be on the audio's device, got "
                         f"{table.device} for {x.device}")
    global LAUNCHES
    n_fft = table.shape[0] // 3
    kernel = kernel_of(n_fft, hop)
    B = x.shape[0]
    N = x.shape[1] * hop if x.ndim == 4 else x.shape[1]  # samples a clip
    T = N // hop
    radices, n_passes = _radices_c(n_fft)
    with torch.cuda.device(x.device):
        re = torch.empty((B, T, n_fft // 2 + 1, _C), device=x.device, dtype=torch.float32)
        im = torch.empty_like(re)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if kernel == "stft_hop_blocks_fft_kernel":
            rc = _entry("adyolo_stft_fft")(x.data_ptr(), N, B, T, hop, table.data_ptr(),
                                           radices, n_passes, re.data_ptr(), im.data_ptr(),
                                           stream)
        else:
            rc = _entry("adyolo_stft_frames_fft")(
                x.data_ptr(), N, N, B, T, hop, n_fft, table.data_ptr(), radices, n_passes,
                re.data_ptr(), im.data_ptr(), stream)
    if rc != 0:
        raise launch_error("STFT kernel launch refused", rc)
    LAUNCHES += 1
    KERNELS[kernel] += 1
    return re, im
