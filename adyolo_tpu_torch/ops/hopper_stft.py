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
  hop-block audio read as its flat view: any hop, odd ``n_fft``
  (:func:`frames_radix_plan`), each frame's ``n_fft`` samples read from
  the flat clip, reflected at the left edge, zeros past its end
  (:func:`adyolo_tpu_torch.ops.stft.framed_dft_flat`).  It runs in shared
  memory at every ``n_fft`` up to 5,543 whose primes are at most 31, and
  at most up to 8,192 (:func:`frames_config`);
* elsewhere (a prime above 31, or no tile that fits) the global route, a
  four-step FFT in two launches through one scratch buffer:
  ``stft_frames_cols_kernel`` and ``stft_frames_rows_kernel``
  (:func:`global_config`); a column whose length has primes above 31 runs
  Bluestein's chirp-z from :func:`chirp_table`.  Where no split fits the
  tiles (a product of primes above 31 past 12,703, as the prime 14087),
  Bluestein over the whole frame in blocks, also two launches:
  ``stft_frames_chirp_in_kernel`` and ``stft_frames_chirp_out_kernel``.

The kernels of a geometry are decided when the plan is built, by the
geometry alone (:func:`kernels_of`).  Every ``n_fft >= 2`` has a route.
:func:`stft_hop_blocks` checks its inputs and calls the
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

__all__ = ["FFTPlan", "FramesConfig", "FourStepConfig", "GlobalConfig", "fft_plan",
           "radix_plan", "frames_radix_plan", "frames_config", "four_step_config",
           "global_config", "chirp_table", "kernel_of", "kernels_of", "stft_hop_blocks",
           "launch", "LAUNCHES", "KERNELS", "FRAME_ROUTES"]

LAUNCHES = 0
KERNELS = {"stft_hop_blocks_fft_kernel": 0, "stft_frames_fft_kernel": 0,
           "stft_frames_4step_kernel": 0, "stft_frames_cols_kernel": 0,
           "stft_frames_rows_kernel": 0, "stft_frames_chirp_in_kernel": 0,
           "stft_frames_chirp_out_kernel": 0}

_C = 4  # channels the kernels carry together (one float4)
_HOP_BLOCK_MAX_N = 2400  # frame slots of a hop-block kernel buffer (stft.cu CAP)
# The frames kernel's routes (stft.cu ROUTE_*): in shared memory, with 16
# or 32 values (float4, 16 B: the four channels of a sample) a thread
# through a pass; 256 threads a block; tiles of at most 8 frames; a
# block's largest dynamic shared memory on an H100.  Else route four_step,
# a four-step FFT of one frame a block (four_step_config), else the global
# route, a four-step FFT in two launches (global_config).
FRAME_ROUTES = ("shared", "shared_wide", "global", "four_step")
_ROUTE_GLOBAL = 2
_ROUTE_FOUR_STEP = 3
_FR_EPT = (16, 32)
_WIDE = 16  # values a thread on the global route's tiles
_FR_THREADS = 256
_FR_MAX_FRAMES = 8
_SMEM_OPTIN = 232448
_REGISTER_RADICES = (2, 3, 4, 5, 8, 16)
# primes with a prime pass (stft.cu prime_pass): the p-point DFT in one
# thread's registers; a prime above _PRIME_MAX goes through Bluestein
_PRIME_RADICES = (7, 11, 13, 17, 19, 23, 29, 31)
_PRIME_MAX = 31
_MAX_BLUESTEIN_BLOCKS = 16
_TW_SPLIT = 128  # W_n^e = W_n^(128 floor(e / 128)) W_n^(e mod 128) on the global route
_CHIRP_M = 8192  # the whole-frame Bluestein's transform length (stft.cu CHIRP_M)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "adyolo_stft_fft": [_P, _L, _I, _I, _I, _P, _P, _I, _P, _P, _P],
    "adyolo_stft_frames_fft": [_P, _L, _L, _I, _I, _I, _I, _P, _L, _P, _L, _P, _I, _I, _I, _I,
                               _P, _L, _P, _P, _P],
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


def _radix_rule(n: int) -> tuple:
    # stft.cu radix_rule: 16s, the power of two left, then the odd primes
    # ascending; () for n = 1
    twos = 0
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


def frames_radix_plan(n_fft: int) -> tuple:
    """The frames kernel's pass radices for any ``n_fft >= 2``: 16s, then
    the power of two left (8, 4 or 2), then the odd primes in ascending
    order (``(16, 16, 8)`` at 2048, ``(4, 19, 29)`` at 2204, ``(3, 3, 5, 7,
    7)`` at 2205, ``(2, 3, 1879)`` at 11274).  2, 3, 4, 5, 8 and 16 run as
    register butterflies, the primes 7 to 31 as prime passes; the product
    of the primes above 31 is a transform by Bluestein's chirp-z on the
    global route, or the whole frame is where that product fits no tile
    (:func:`global_config`)."""
    if n_fft < 2:
        raise ValueError(f"n_fft must be >= 2, got {n_fft}")
    return _radix_rule(n_fft)


def kernel_of(n_fft: int, hop: int) -> str:
    """The device kernel that frames at ``(n_fft, hop)``: the hop-block
    kernel, the frames kernel in shared memory, or the first of the global
    route's two (:func:`kernels_of` gives all of a call's launches)."""
    return next(iter(kernels_of(n_fft, hop)))


class FramesConfig(NamedTuple):
    """How the frames kernel runs a geometry: ``route`` (an index of
    :data:`FRAME_ROUTES`), ``frames`` a tile, ``ring`` span slots, and the
    block's dynamic ``smem_bytes`` (on the global route
    ``stft_frames_cols_kernel``'s); on the global route also
    :class:`GlobalConfig`'s ``n1``, ``n2``, ``cols``, ``rows``, ``blocks``
    (Bluestein's J, 0 without), ``m_len`` (its M), ``rows_smem_bytes``
    (``stft_frames_rows_kernel``'s), ``ring_cols`` and ``ring_rows``, all 0
    on the shared routes.  On the whole-frame Bluestein ``rows`` is its
    lower output blocks, ``blocks`` its input blocks P, and the two
    kernels' shared memory that of ``stft_frames_chirp_in_kernel`` and
    ``stft_frames_chirp_out_kernel``."""
    route: int
    frames: int
    ring: int
    smem_bytes: int
    n1: int = 0
    n2: int = 0
    cols: int = 0
    rows: int = 0
    blocks: int = 0
    m_len: int = 0
    rows_smem_bytes: int = 0
    ring_cols: int = 0
    ring_rows: int = 0


class GlobalConfig(NamedTuple):
    """The global route at ``n = n1 * n2`` (stft.cu ``GlobalPlan``): launch
    A (``stft_frames_cols_kernel``) transforms ``cols`` columns of ``n1``
    points a unit, ``col_groups`` units a frame (times ``blocks``); launch B
    (``stft_frames_rows_kernel``) ``rows`` lower rows and their mirrors of
    ``n2`` points a unit, ``row_groups`` units a frame.  ``q``: 0, or
    ``n1`` (the product of ``n``'s primes above 31) by Bluestein, a cyclic
    convolution of ``m_len`` points in ``blocks`` output blocks of ``outs``
    bins; ``m_radices`` its FFT's radices.  ``smem_cols`` and ``smem_rows``:
    the two kernels' dynamic shared memory; ``ring_cols`` and ``ring_rows``
    their input slots (2, or 1 where two do not fit).  ``segments`` > 0:
    the whole frame by Bluestein (:func:`_chirp_config`), ``blocks`` input
    blocks and ``segments`` lower output blocks of ``outs`` points."""
    n1: int
    n2: int
    cols: int
    col_groups: int
    rows: int
    row_groups: int
    q: int
    m_len: int
    blocks: int
    outs: int
    m_radices: tuple
    smem_cols: int
    smem_rows: int
    ring_cols: int
    ring_rows: int
    segments: int = 0


def _padded_len(length: int) -> int:
    # stft.cu padded_len: a spare float4 every 16
    return length + (length - 1) // 16 + 1


def _entries(radices, length: int) -> int:
    # stft.cu layout_plan: each pass's (r - 1) ns twiddles (length - 1 in
    # all), then (p - 1) / 2 roots a prime pass
    return length - 1 + sum((r - 1) // 2 for r in radices if r in _PRIME_RADICES)


def _has_prime(radices) -> bool:
    return any(r in _PRIME_RADICES for r in radices)


def _frames_smem(n: int, hop: int, frames: int, ring: int, radices=()) -> int:
    # stft.cu frames_slot / frames_smem: ring slots of the tile's span or its
    # padded transforms, whichever is longer, a prime pass's other buffer,
    # and the n-entry twiddle table with the prime passes' roots
    slot = max((frames - 1) * hop + n, _padded_len(frames * n))
    alt = _padded_len(frames * n) if _has_prime(radices) else 0
    return (ring * slot + alt) * 16 + 8 * (n + _entries(radices, n) - (n - 1))


def _frames_fit(radices, n: int, frames: int, ept: int) -> bool:
    # stft.cu frames_fit: every register pass's values a thread within ept
    # (a prime pass holds one work item at a time); no other radix runs in
    # a tile
    points = frames * n
    if points >= 1 << 21:
        return False
    for r in radices:
        if r in _PRIME_RADICES:
            continue
        if r not in _REGISTER_RADICES or -(-(points // r) // _FR_THREADS) > ept // r:
            return False
    return True


class FourStepConfig(NamedTuple):
    """Route four_step at ``n = n1 * n2`` (stft.cu ``FourStepPlan``): one
    frame a block, its ``n2`` columns transformed ``cols`` at a time, its
    ``n1`` rows ``rows`` at a time; the block's ``smem_bytes``."""
    n1: int
    n2: int
    cols: int
    rows: int
    smem_bytes: int


def _four_step_split(n: int) -> int:
    # stft.cu four_step_split: of the divisors within 2x of the square root,
    # the fewest passes, then the nearest at or above the root; else the
    # least divisor above the root
    root = 1
    while root * root < n:
        root += 1
    near = [d for d in range(max(1, root // 2), 2 * root + 1) if n % d == 0]
    if not near:
        return next(d for d in range(root, n + 1) if n % d == 0)
    return min(near, key=lambda d: (len(_radix_rule(d)) + len(_radix_rule(n // d)),
                                    d - root if d >= root else root - d + n))


@functools.lru_cache(maxsize=None)
def four_step_config(n_fft: int) -> Optional[FourStepConfig]:
    """Route four_step's plan at ``n_fft`` (a copy of ``csrc/stft.cu::
    four_step_choose``), or None where it has none: every radix a register
    radix; the split of :func:`_four_step_split`; the most columns (rows) a
    group that fit 16 values a thread, spread evenly; the padded frame, the
    two-level W table and both plans' tables within 227 KB.  (9600: 120 x 80,
    27 columns and 40 rows a group.)"""
    if n_fft >= 1 << 21 or any(r not in _REGISTER_RADICES for r in frames_radix_plan(n_fft)):
        return None
    n1 = _four_step_split(n_fft)
    n2 = n_fft // n1
    r1, r2 = _radix_rule(n1), _radix_rule(n2)
    cols = next((c for c in range(n2, 0, -1) if _frames_fit(r1, n1, c, _FR_EPT[0])), 0)
    rows = next((c for c in range(n1, 0, -1) if _frames_fit(r2, n2, c, _FR_EPT[0])), 0)
    if cols == 0 or rows == 0:
        return None
    cols = -(-n2 // -(-n2 // cols))
    rows = -(-n1 // -(-n1 // rows))
    smem = _padded_len(n_fft) * 16 + 8 * (_four_step_entries(n_fft) + _entries(r1, n1)
                                          + _entries(r2, n2))
    return FourStepConfig(n1, n2, cols, rows, smem) if smem <= _SMEM_OPTIN else None


def _four_step_entries(n: int) -> int:
    # stft.cu four_step_entries: the global route's two-level W_n table
    return _TW_SPLIT + -(-n // _TW_SPLIT)


def _bluestein_length(need: int, ring: int, extra: int = 0) -> int:
    """Bluestein's FFT length for a cyclic convolution of at least
    ``need`` points (stft.cu bluestein_length): of the 2^a 3^b 5^c in
    [need, 2 need) whose transform fits a ring of ``ring`` slots beside
    ``extra`` float2, the one of the fewest passes x points (ties: the
    shorter); 0 for none."""
    best = (0, 0)
    a = 1
    while a < 2 * need:
        b = a
        while b < 2 * need:
            c = b
            while c < 2 * need:
                if c >= need and ring * _padded_len(c) * 16 + 8 * extra <= _SMEM_OPTIN:
                    cost = (c * len(_radix_rule(c)), c)
                    if best == (0, 0) or cost < best:
                        best = cost
                c *= 5
            b *= 3
        a *= 2
    return best[1]


@functools.lru_cache(maxsize=None)
def global_config(n_fft: int) -> GlobalConfig:
    """The global route's plan at ``n_fft`` (a copy of ``csrc/stft.cu::
    global_choose``): the four-step split (:func:`_split_config`) where it
    fits, else the whole-frame Bluestein (:func:`_chirp_config`, 14087)."""
    g = _split_config(n_fft)
    return _chirp_config(n_fft) if g is None else g


def _chirp_config(n_fft: int, m_len: int = _CHIRP_M) -> GlobalConfig:
    """The whole-frame Bluestein at ``n_fft`` (stft.cu ``chirp_choose``):
    the frame's samples in P = ceil(n / S) input blocks of S = M / 2, bins
    0..n/2 in ceil((n/2 + 1) / S) lower output blocks, each with its mirror
    block; launch A's block holds one slot of M, launch B's that and S
    bins.  ``m_len``: M (another only in the tests' model)."""
    S = m_len // 2
    P = -(-n_fft // S)
    O = (n_fft // 2 + S) // S
    return GlobalConfig(n_fft, 1, 1, 1, O, O, n_fft, m_len, P, S, _radix_rule(m_len),
                        _padded_len(m_len) * 16, (_padded_len(m_len) + S) * 16, 1, 1, O)


def _split_config(n_fft: int) -> Optional[GlobalConfig]:
    """The global route's four-step plan at ``n_fft`` (stft.cu
    ``split_choose``), or None where it has none: ``n1`` the product of the
    primes above 31 (by Bluestein), else the divisor of ``n_fft`` within 2x
    of its square root whose split takes the fewest passes, the nearest at
    or above the root among those; the most columns (rows) a unit that fit
    a tile of 16 values a thread and 227 KB in two input slots, else one, spread
    evenly over the units; Bluestein's M (:func:`_bluestein_length`) for q
    + ceil(q / J) - 1 points in one input slot at the fewest output blocks
    J.  (9600: 120 x 80; 16384: 128 x
    128; 11274: 1879 x 6, M 4096; 7919: 7919 x 1, M 12288 in 2 blocks, one
    slot.)"""
    q = 1
    for r in frames_radix_plan(n_fft):
        if r not in _REGISTER_RADICES and r not in _PRIME_RADICES:
            q *= r
    n1 = q if q > 1 else _four_step_split(n_fft)
    n2 = n_fft // n1
    r2 = _radix_rule(n2)
    lower = n1 // 2 + 1
    w4 = _four_step_entries(n_fft)

    def most(limit, fits):
        # (units' count, ring): two slots where one fits, else one
        for ring in (2, 1):
            c = next((c for c in range(limit, 0, -1) if fits(c, ring)), 0)
            if c:
                return c, ring
        return 0, 0

    alt2 = int(_has_prime(r2))  # a prime pass's other buffer
    rows, ring_rows = most(lower, lambda c, ring: (
        _frames_fit(r2, n2, 2 * c, _WIDE)
        and (ring + alt2) * _padded_len(2 * c * n2) * 16 + 8 * _entries(r2, n2) <= _SMEM_OPTIN))
    if rows == 0:
        return None
    row_groups = -(-lower // rows)
    rows = -(-lower // row_groups)
    smem_rows = (ring_rows + alt2) * _padded_len(2 * rows * n2) * 16 + 8 * _entries(r2, n2)
    m_len = blocks = outs = 0
    m_radices = ()
    if q == 1:
        r1 = _radix_rule(n1)
        alt1 = int(_has_prime(r1))
        cols, ring_cols = most(n2, lambda c, ring: (
            _frames_fit(r1, n1, c, _WIDE)
            and (ring + alt1) * _padded_len(c * n1) * 16 + 8 * (_entries(r1, n1) + w4)
            <= _SMEM_OPTIN))
        if cols == 0:
            return None
        blocks = 1
        tile, table = n1, 8 * _entries(r1, n1)
    else:  # one input slot, the fewest output blocks
        ring_cols = 1
        for J in range(1, _MAX_BLUESTEIN_BLOCKS + 1):
            o = -(-q // J)
            M = _bluestein_length(q + o - 1, 1, w4)
            if M:
                m_len, blocks, outs = M, J, o
                break
        if m_len == 0:
            return None
        m_radices = _radix_rule(m_len)
        cols = next(c for c in range(n2, 0, -1)
                    if ring_cols * _padded_len(c * m_len) * 16 + 8 * w4 <= _SMEM_OPTIN
                    and c * m_len < 1 << 21)
        tile, table, alt1 = m_len, 0, 0
    col_groups = -(-n2 // cols)
    cols = -(-n2 // col_groups)
    smem_cols = (ring_cols + alt1) * _padded_len(cols * tile) * 16 + 8 * w4 + table
    return GlobalConfig(n1, n2, cols, col_groups, rows, row_groups, q if q > 1 else 0, m_len,
                        blocks, outs, m_radices, smem_cols, smem_rows, ring_cols, ring_rows)


@functools.lru_cache(maxsize=None)
def frames_config(n_fft: int, hop: int) -> FramesConfig:
    """The frames kernel's route and tile at ``(n_fft, hop)``: where every
    prime of ``n_fft`` is at most 31, the first of :data:`FRAME_ROUTES` in
    shared memory where a tile fits (16, then 32 values a thread), with a
    ring of two span slots before one, and the most frames a tile (at most
    8) that fit the registers (every pass's values over 256 threads) and
    227 KB of shared memory; else the global route (:func:`global_config`).
    (2048, 600): ``shared``, 2 frames, 2 slots; (4800, 2400):
    ``shared_wide``, 1 frame, 2 slots; (8192, 2048): ``shared_wide``, 1
    frame, 1 slot; 9600: four_step; 11274, 2402, 7919 and 14087: global.
    Every ``n_fft >= 2`` has a route.  A copy of ``csrc/stft.cu::frames_choose``,
    which a launch's checks follow; ``chip_smoke.py``'s phase build holds
    the two to each other."""
    radices = frames_radix_plan(n_fft)
    for route in (0, 1):
        for ring in (2, 1):
            for frames in range(_FR_MAX_FRAMES, 0, -1):
                smem = _frames_smem(n_fft, hop, frames, ring, radices)
                if smem <= _SMEM_OPTIN and _frames_fit(radices, n_fft, frames, _FR_EPT[route]):
                    return FramesConfig(route, frames, ring, smem)
    fs = four_step_config(n_fft)
    if fs is not None:
        return FramesConfig(_ROUTE_FOUR_STEP, 1, 1, fs.smem_bytes, fs.n1, fs.n2, fs.cols,
                            fs.rows)
    g = global_config(n_fft)
    return FramesConfig(_ROUTE_GLOBAL, 0, 0, g.smem_cols, g.n1, g.n2, g.cols, g.rows,
                        g.blocks if g.q else 0, g.m_len, g.smem_rows, g.ring_cols, g.ring_rows)


def _scratch_points(n_fft: int) -> int:
    # the global route's scratch a frame, in float4: n, or P M on the
    # whole-frame Bluestein
    g = global_config(n_fft)
    return g.blocks * g.m_len if g.segments else n_fft


def _hop_block_geometry(n_fft: int, hop: int) -> bool:
    return n_fft == 2 * hop and n_fft <= _HOP_BLOCK_MAX_N and _smooth(n_fft)


def kernels_of(n_fft: int, hop: int) -> Dict[str, int]:
    """The device kernels one call at ``(n_fft, hop)`` launches, by name:
    the hop-block kernel at ``n_fft == 2 * hop <= 2400`` with factors 2, 3
    and 5; else the frames kernel once, or on its global route
    ``stft_frames_cols_kernel`` and ``stft_frames_rows_kernel`` once each
    (``stft_frames_chirp_in_kernel`` and ``stft_frames_chirp_out_kernel``
    on the whole-frame Bluestein)."""
    if _hop_block_geometry(n_fft, hop):
        return {"stft_hop_blocks_fft_kernel": 1}
    route = frames_config(n_fft, hop).route
    if route == _ROUTE_FOUR_STEP:
        return {"stft_frames_4step_kernel": 1}
    if route != _ROUTE_GLOBAL:
        return {"stft_frames_fft_kernel": 1}
    if global_config(n_fft).segments:
        return {"stft_frames_chirp_in_kernel": 1, "stft_frames_chirp_out_kernel": 1}
    return {"stft_frames_cols_kernel": 1, "stft_frames_rows_kernel": 1}


def _dif_order(m_len: int, radices) -> np.ndarray:
    """The natural index of the element that an in-place decimation-in-
    frequency FFT of ``radices`` (stft.cu chirp_pass) leaves at each place:
    place sum_i s_i M / (R_0 .. R_i) holds bin sum_i s_i R_0 .. R_{i-1}."""
    pos = np.arange(m_len)
    k = np.zeros(m_len, np.int64)
    span, mult = m_len, 1
    for r in radices:
        span //= r
        k += (pos // span) * mult
        pos = pos % span
        mult *= r
    return k


@functools.lru_cache(maxsize=None)
def chirp_table(n_fft: int, device: str):
    """Bluestein's table of the global route at ``n_fft`` on ``device``
    (:func:`_chirp_values`), built once a geometry and device in float64
    and rounded once to float32, as (re, im) pairs; None where the route's
    plan has no Bluestein part (:func:`global_config`)."""
    g = global_config(n_fft)
    if g.q == 0:
        return None
    flat = _chirp_values(g)
    pairs = np.stack([flat.real, flat.imag], -1).ravel().astype(np.float32)
    return torch.as_tensor(pairs, device=device)


def _chirp_values(g: GlobalConfig) -> np.ndarray:
    """The chirp table of plan ``g`` in complex128, in order: ``cc`` the
    chirp conj(b_r) = e^{-i pi (r^2 mod 2q) / q}, the index exact in int64,
    for r < q (r <= q on the whole-frame Bluestein, whose bins reach q);
    ``twm`` (M,) e^{-2 pi i e / M}; the filters (M points each) over M,
    in the places of the in-place FFT's output (:func:`_dif_order`).  A
    column's Bluestein: output block j's filter g_t = b_{t + j S}, t in
    (-q, S), at t mod M.  The whole-frame Bluestein: the filter g_d = b_{D
    + d}, d in (-S, S), at d mod M, of each offset D = K - iS between an
    output block's first bin K and an input block's first sample iS: (a -
    P + 1) S for the lower blocks, a < P + O - 1 (a = s - i + P - 1), then
    q + 1 - (m + 1) S for the mirror blocks (m = s + i)."""
    q, M, S = g.q, g.m_len, g.outs
    whole = g.segments > 0
    r = np.arange(q + whole, dtype=np.int64)
    cc = np.exp(-1j * np.pi * ((r * r) % (2 * q)) / q)
    twm = np.exp(-2j * np.pi * np.arange(M, dtype=np.float64) / M)
    order = _dif_order(M, g.m_radices)
    if whole:
        d = np.arange(-(S - 1), S, dtype=np.int64)
        ab = g.blocks + g.segments - 1
        starts = [(a - g.blocks + 1) * S for a in range(ab)] + [q + 1 - (m + 1) * S
                                                                 for m in range(ab)]
    else:
        d = np.arange(-(q - 1), S, dtype=np.int64)
        starts = [j * S for j in range(g.blocks)]
    h = np.empty((len(starts), M), np.complex128)
    for f, start in enumerate(starts):
        u = d + start
        filt = np.zeros(M, np.complex128)
        filt[d % M] = np.exp(1j * np.pi * ((u * u) % (2 * q)) / q)
        h[f] = (np.fft.fft(filt) / M)[order]
    return np.concatenate([cc, twm, h.ravel()])


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
    elif _hop_block_geometry(n_fft, hop):
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
            glob = cfg.route == _ROUTE_GLOBAL
            scratch = (torch.empty(B * T * _scratch_points(n_fft) * _C, device=x.device,
                                   dtype=torch.float32) if glob else None)
            chirps = chirp_table(n_fft, str(x.device)) if glob else None
            radices, n_passes = _radices_c(frames_radix_plan(n_fft))
            rc = _entry("adyolo_stft_frames_fft")(
                x.data_ptr(), N, N, B, T, hop, n_fft, table.data_ptr(), table.numel(),
                None if chirps is None else chirps.data_ptr(),
                0 if chirps is None else chirps.numel(), radices, n_passes,
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
