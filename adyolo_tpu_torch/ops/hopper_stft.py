"""Wrapper of the hand-written Hopper STFT kernels (``csrc/stft.cu``).

The kernels replace the Pallas fused framed STFT
(``adyolo_tpu/ops/pallas_stft.py::_pallas_stft_impl``) and, on the serving
path, XLA's ``framed_dft_chunked`` and ``framed_dft``.  Each is a
mixed-radix FFT that reads its twiddles and window from the table of an
:class:`FFTPlan`, built once on the host in float64 by :func:`fft_plan`:

* ``stft_hop_blocks_fft_kernel`` at ``n_fft == 2 * hop <= 2400`` with
  prime factors 2, 3 and 5 (the DCASE geometry, 1200 / 600), on hop-block
  ``(B, T, hop, 4)`` audio or the hop-block view of flat ``(B, N, 4)``
  audio (:func:`radix_plan`);
* ``stft_frames_fft_kernel`` at every other geometry, on flat audio or
  hop-block audio read as its flat view: any hop, odd ``n_fft``, any prime
  factor (:func:`frames_radix_plan`), each frame's ``n_fft`` samples read
  from the flat clip, reflected at the left edge, zeros past its end
  (:func:`adyolo_tpu_torch.ops.stft.framed_dft_flat`).  It runs in shared
  memory at every ``n_fft`` up to 5,642 and at most up to 8,192
  (:func:`frames_config`); elsewhere its passes go through a global
  scratch buffer, ``stft_frames_pass_kernel`` once a pass and
  ``stft_frames_split_kernel`` once.

The kernel of a geometry is decided when the plan is built, by the
geometry alone (:func:`kernels_of`); nothing is refused that the JAX
package computes.  :func:`stft_hop_blocks` checks its inputs and calls the
custom op ``adyolo::stft`` (:mod:`adyolo_tpu_torch.ops.library`), one op in
an exported graph, which dispatches by the tensor's device: a CPU tensor
goes to the plain :func:`adyolo_tpu_torch.ops.stft.stft` (a contraction
against the window-folded DFT matrices of the table's window,
:func:`adyolo_tpu_torch.ops.stft.window_dft`); a CUDA tensor goes to the
kernels (:func:`launch`), or the call raises.  There is no fallback from
one to the other.

``LAUNCHES`` counts calls that launched kernels; it is bumped right after
a call's launches are accepted, and nowhere else.  ``KERNELS`` counts the
launches by device kernel name, one a launch, as
``hopper_attention.KERNELS`` does.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from ..utils.build import launch_error, load_library

__all__ = ["FFTPlan", "FramesConfig", "fft_plan", "radix_plan", "frames_radix_plan",
           "frames_config", "kernel_of", "kernels_of", "stft_hop_blocks", "launch",
           "LAUNCHES", "KERNELS", "FRAME_ROUTES"]

LAUNCHES = 0
KERNELS = {"stft_hop_blocks_fft_kernel": 0, "stft_frames_fft_kernel": 0,
           "stft_frames_pass_kernel": 0, "stft_frames_split_kernel": 0}

_C = 4  # channels the kernels carry together (one float4)
_HOP_BLOCK_MAX_N = 2400  # frame slots of a hop-block kernel buffer (stft.cu CAP)
# The frames kernel's routes (stft.cu ROUTE_*): in shared memory, with 16
# or 32 values (float4, 16 B: the four channels of a sample) a thread
# through a pass; 256 threads a block; tiles of at most 8 frames; a
# block's largest dynamic shared memory on an H100.  Else the global route.
FRAME_ROUTES = ("shared", "shared_wide", "global")
_ROUTE_GLOBAL = 2
_FR_EPT = (16, 32)
_FR_THREADS = 256
_FR_MAX_FRAMES = 8
_SMEM_OPTIN = 232448
_REGISTER_RADICES = (2, 3, 4, 5, 8, 16)
_GEN_S = 8  # outputs of a generic pass's work item (stft.cu GEN_S)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "adyolo_stft_fft": [_P, _L, _I, _I, _I, _P, _P, _I, _P, _P, _P],
    "adyolo_stft_frames_fft": [_P, _L, _L, _I, _I, _I, _I, _P, _P, _I, _I, _I, _I, _P, _L,
                               _P, _P, _P],
}
_bound = {}


def _entry(name):
    if name not in _bound:
        fn = getattr(load_library(), name)
        fn.restype = ctypes.c_int
        fn.argtypes = _SIGNATURES[name]
        _bound[name] = fn
    return _bound[name]


def _smooth(n: int) -> bool:
    """Whether ``n`` factors into 2, 3 and 5."""
    for r in (2, 3, 5):
        while n > 1 and n % r == 0:
            n //= r
    return n == 1


def radix_plan(n_fft: int) -> tuple:
    """The hop-block kernel's pass radices for ``n_fft``: 4s, then a 2,
    then 3s, then 5s (``(4, 4, 3, 5, 5)`` at 1200, ``(4, 4, 4, 4, 4, 2)`` at
    2048); ``ValueError`` for an ``n_fft`` with another prime factor."""
    if n_fft < 2 or not _smooth(n_fft):
        raise ValueError(f"the hop-block kernel's n_fft factors into 2, 3 and 5, got {n_fft}")
    radices, n = [], n_fft
    for r in (4, 2, 3, 5):  # after the 4s at most one 2 is left
        while n > 1 and n % r == 0:
            radices.append(r)
            n //= r
    return tuple(radices)


def frames_radix_plan(n_fft: int) -> tuple:
    """The frames kernel's pass radices for any ``n_fft >= 2``: 16s, then
    the power of two left (8, 4 or 2), then 3s, 5s and the other primes in
    ascending order; 2, 3, 4, 5, 8 and 16 run as register butterflies, any
    other prime as a generic pass (``(16, 16, 8)`` at 2048, ``(4, 19, 29)``
    at 2204, ``(3, 3, 5, 7, 7)`` at 2205)."""
    if n_fft < 2:
        raise ValueError(f"n_fft must be >= 2, got {n_fft}")
    n, twos = n_fft, 0
    while n % 2 == 0:
        n //= 2
        twos += 1
    radices = [16] * (twos // 4) + ([1 << (twos % 4)] if twos % 4 else [])
    p = 3
    while n > 1:
        while n % p == 0:
            radices.append(p)
            n //= p
        p += 2
        if p * p > n and n > 1:  # what is left is a prime
            radices.append(n)
            break
    return tuple(radices)


def kernel_of(n_fft: int, hop: int) -> str:
    """The device kernel that frames at ``(n_fft, hop)``: the hop-block
    kernel, the frames kernel in shared memory, or the first of the global
    route's (:func:`kernels_of` gives all of a call's launches)."""
    return next(iter(kernels_of(n_fft, hop)))


class FramesConfig(NamedTuple):
    """How the frames kernel runs a geometry: ``route`` (an index of
    :data:`FRAME_ROUTES`), ``frames`` a tile, ``ring`` span slots, and the
    block's dynamic ``smem_bytes`` (0 on the global route)."""
    route: int
    frames: int
    ring: int
    smem_bytes: int


def _frames_smem(n: int, hop: int, frames: int, ring: int) -> int:
    # stft.cu frames_slot / frames_smem: ring slots of the tile's span or its
    # padded transforms, whichever is longer, and the n-entry twiddle table
    fn = frames * n
    slot = max((frames - 1) * hop + n, fn + (fn - 1) // 16 + 1)
    return ring * slot * 16 + 8 * n


def _frames_fit(radices, n: int, frames: int, ept: int) -> bool:
    # stft.cu frames_fit: every pass's values a thread within ept; a
    # generic pass works in chunks of _GEN_S outputs of a butterfly
    points = frames * n
    if points >= 1 << 21:
        return False
    for r in radices:
        if r in _REGISTER_RADICES:
            if -(-(points // r) // _FR_THREADS) > ept // r:
                return False
        elif -(-(points // r * -(-r // _GEN_S)) // _FR_THREADS) > ept // _GEN_S:
            return False
    return True


@functools.lru_cache(maxsize=None)
def frames_config(n_fft: int, hop: int) -> FramesConfig:
    """The frames kernel's route and tile at ``(n_fft, hop)``: the first of
    :data:`FRAME_ROUTES` in shared memory where a tile fits (16, then 32
    values a thread), with a ring of two span slots before one, and the
    most frames a tile (at most 8) that fit the registers (every pass's
    values over 256 threads) and 227 KB of shared memory; else the global
    route.  (2048, 600): ``shared``, 2 frames, 2 slots; (4800, 2400):
    ``shared_wide``, 1 frame, 2 slots; (8192, 2048): ``shared_wide``, 1
    frame, 1 slot.  Every ``n_fft`` up to 5,642 runs in shared memory, and
    every one up to 8,192 whose radix-3 and radix-5 passes and generic
    passes fit 32 values a thread.  A copy of
    ``csrc/stft.cu::frames_choose``, which a launch's checks follow;
    ``chip_smoke.py``'s phase build holds the two to each other."""
    radices = frames_radix_plan(n_fft)
    for route in (0, 1):
        for ring in (2, 1):
            for frames in range(_FR_MAX_FRAMES, 0, -1):
                smem = _frames_smem(n_fft, hop, frames, ring)
                if smem <= _SMEM_OPTIN and _frames_fit(radices, n_fft, frames, _FR_EPT[route]):
                    return FramesConfig(route, frames, ring, smem)
    return FramesConfig(_ROUTE_GLOBAL, 0, 0, 0)


def kernels_of(n_fft: int, hop: int) -> Dict[str, int]:
    """The device kernels one call at ``(n_fft, hop)`` launches, by name:
    the hop-block kernel at ``n_fft == 2 * hop <= 2400`` with factors 2, 3
    and 5; else the frames kernel once, or on its global route one pass
    kernel a radix of :func:`frames_radix_plan` and one split."""
    if n_fft == 2 * hop and n_fft <= _HOP_BLOCK_MAX_N and _smooth(n_fft):
        return {"stft_hop_blocks_fft_kernel": 1}
    if frames_config(n_fft, hop).route != _ROUTE_GLOBAL:
        return {"stft_frames_fft_kernel": 1}
    return {"stft_frames_pass_kernel": len(frames_radix_plan(n_fft)),
            "stft_frames_split_kernel": 1}


@functools.lru_cache(maxsize=None)
def _radices_c(radices: tuple):
    return (ctypes.c_int * len(radices))(*radices), len(radices)


class FFTPlan:
    """What the kernels read besides the audio (built by :func:`fft_plan`).

    ``table``: ``(3 * n_fft,)`` float32 on the device, the twiddles
    ``e^{-2 pi i m / n_fft}`` (``m < n_fft``) as (re, im) pairs, then the
    window.  ``radices``: the hop-block kernel's pass order
    (:func:`radix_plan`), None where ``n_fft`` has another prime factor than
    2, 3 and 5; ``frames_radices``: the frames kernel's
    (:func:`frames_radix_plan`).
    """

    def __init__(self, table):
        self.n_fft = table.shape[0] // 3
        self.radices = radix_plan(self.n_fft) if _smooth(self.n_fft) else None
        self.frames_radices = frames_radix_plan(self.n_fft)
        self.table = table


def fft_plan(window, device="cuda") -> FFTPlan:
    """The :class:`FFTPlan` of an analysis ``window`` of length ``n_fft >=
    2``: twiddles and window computed in float64 and rounded once to
    float32."""
    window = np.asarray(window, np.float32)
    if window.ndim != 1 or window.shape[0] < 2:
        raise ValueError(f"the window must be 1-D of length n_fft >= 2, got {window.shape}")
    n = window.shape[0]
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
    where the hop-block kernel runs (:func:`kernels_of`) it reads the
    hop-block view of the first ``T*hop`` samples, and the frames kernel
    reads hop-block audio as its flat view); ``hop`` None: the hop-block
    width, or ``plan.n_fft // 2`` for flat audio.  The op ``adyolo::stft``."""
    if hop is None:
        hop = x.shape[2] if x.ndim == 4 else plan.n_fft // 2
    hop = int(hop)
    _check(x, plan, hop)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    return torch.ops.adyolo.stft(x, plan.table, hop)


def launch(x: torch.Tensor, table: torch.Tensor, hop: int):
    """The kernels of ``(n_fft, hop)`` (:func:`kernels_of`) on CUDA audio
    ``x`` and a plan's ``table`` (the CUDA kernel of ``adyolo::stft``); the
    radix plans follow from the table's length, the frames kernel's route
    and tile from :func:`frames_config`."""
    if table.device != x.device:
        raise ValueError(f"the plan's table must be on the audio's device, got "
                         f"{table.device} for {x.device}")
    global LAUNCHES
    n_fft = table.shape[0] // 3
    kernels = kernels_of(n_fft, hop)
    B = x.shape[0]
    N = x.shape[1] * hop if x.ndim == 4 else x.shape[1]  # samples a clip
    T = N // hop
    with torch.cuda.device(x.device):
        re = torch.empty((B, T, n_fft // 2 + 1, _C), device=x.device, dtype=torch.float32)
        im = torch.empty_like(re)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if "stft_hop_blocks_fft_kernel" in kernels:
            radices, n_passes = _radices_c(radix_plan(n_fft))
            rc = _entry("adyolo_stft_fft")(x.data_ptr(), N, B, T, hop, table.data_ptr(),
                                           radices, n_passes, re.data_ptr(), im.data_ptr(),
                                           stream)
        else:
            cfg = frames_config(n_fft, hop)
            scratch = (torch.empty(2 * B * T * n_fft * _C, device=x.device, dtype=torch.float32)
                       if cfg.route == _ROUTE_GLOBAL else None)
            radices, n_passes = _radices_c(frames_radix_plan(n_fft))
            rc = _entry("adyolo_stft_frames_fft")(
                x.data_ptr(), N, N, B, T, hop, n_fft, table.data_ptr(), radices, n_passes,
                cfg.route, cfg.frames, cfg.ring,
                None if scratch is None else scratch.data_ptr(),
                0 if scratch is None else scratch.numel() * 4, re.data_ptr(), im.data_ptr(),
                stream)
    if rc != 0:
        raise launch_error("STFT kernel launch refused", rc)
    LAUNCHES += 1
    for name, n in kernels.items():
        KERNELS[name] += n
    return re, im
