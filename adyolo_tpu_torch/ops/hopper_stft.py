"""Wrapper of the hand-written Hopper STFT kernel (``csrc/stft.cu``).

The kernel replaces the Pallas fused framed STFT
(``adyolo_tpu/ops/pallas_stft.py::_pallas_stft_impl``) and, on the serving
path, XLA's ``framed_dft_chunked``.  Dispatch is by the tensor's device:
a CPU tensor goes to the plain :func:`adyolo_tpu_torch.ops.stft.stft`; a
CUDA tensor goes to the kernel, or the call raises.  There is no fallback
from one to the other.

``LAUNCHES`` counts kernel launches; it is bumped right after a launch is
accepted, and nowhere else.
"""
from __future__ import annotations

import ctypes

import torch

from ..utils.build import load_library
from . import stft as plain_stft

__all__ = ["stft_hop_blocks", "pack_dft", "LAUNCHES"]

LAUNCHES = 0

_BN = 64  # bin tile of the kernel; W is zero-padded to a multiple of it
_BK = 16  # depth tile; n_fft must be a multiple of it
_C = 4  # channels the kernel carries together (one float4)

_bound = None


def _entry():
    global _bound
    if _bound is None:
        fn = load_library().adyolo_stft_hop_blocks
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p]
        _bound = fn
    return _bound


def pack_dft(w_re: torch.Tensor, w_im: torch.Tensor) -> torch.Tensor:
    """``[W_re | W_im]`` as ``(n_fft, 2*KP)``, each half zero-padded from
    ``K`` to ``KP``, the next multiple of the kernel's bin tile."""
    n_fft, K = w_re.shape
    kp = -(-K // _BN) * _BN
    w = w_re.new_zeros((n_fft, 2 * kp))
    w[:, :K] = w_re
    w[:, kp:kp + K] = w_im
    return w


def _check(x: torch.Tensor, w_re: torch.Tensor, w_im: torch.Tensor):
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
    if w_re.shape != w_im.shape or w_re.ndim != 2:
        raise ValueError(f"DFT matrices must be (n_fft, K), got "
                         f"{tuple(w_re.shape)} / {tuple(w_im.shape)}")
    for w in (w_re, w_im):
        if w.device != x.device or w.dtype != torch.float32:
            raise ValueError("DFT matrices must be float32 on the audio's device")
    n_fft = w_re.shape[0]
    hop = n_fft // 2
    if n_fft != 2 * hop or (x.ndim == 4 and x.shape[2] != hop):
        raise ValueError(f"the kernel needs n_fft == 2*hop, got n_fft={n_fft}"
                         + (f", hop={x.shape[2]}" if x.ndim == 4 else ""))
    if n_fft % _BK:
        raise ValueError(f"n_fft must be a multiple of {_BK}, got {n_fft}")
    T = x.shape[1] if x.ndim == 4 else x.shape[1] // hop
    if T < 2:
        raise ValueError(f"need at least 2 hop-blocks, got T={T}")
    return hop, T


def stft_hop_blocks(x: torch.Tensor, w_re: torch.Tensor, w_im: torch.Tensor):
    """``(re, im)``, each ``(B, T, K, 4)`` float32, of hop-block audio
    ``(B, T, hop, 4)`` or flat audio ``(B, N, 4)`` (``T = N // hop``; the
    kernel reads the hop-block view of the first ``T*hop`` samples)."""
    hop, T = _check(x, w_re, w_im)
    if x.device.type == "cpu":
        return plain_stft.stft(x, w_re, w_im, hop)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    global LAUNCHES
    B = x.shape[0]
    K = w_re.shape[1]
    clip_stride = T * hop if x.ndim == 4 else x.shape[1]  # in float4 units
    fn = _entry()
    with torch.cuda.device(x.device):
        w = pack_dft(w_re, w_im)
        re = torch.empty((B, T, K, _C), device=x.device, dtype=torch.float32)
        im = torch.empty_like(re)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), clip_stride, B, T, hop, w.data_ptr(),
                w.shape[1] // 2, K, re.data_ptr(), im.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"STFT kernel launch refused: cudaError {rc}")
    LAUNCHES += 1
    return re, im
