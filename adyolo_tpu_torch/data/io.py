"""DCASE-format file IO (wav + metadata CSV): the port's copy of
:mod:`adyolo_tpu.data.io`, the wav reader on the port's native loader.

Mirrors the reference IO helpers (``src/utils/utility.py:219-261``,
``src/utils/seld_metrics.py:13-49``) using scipy (no soundfile/librosa dependency):

* wav files are int16 multichannel; the reference normalizes with
  ``audio / 32768.0 + 1e-8`` (``src/datasets.py:147``),
* metadata CSV rows are ``frame,class,source,azi,ele`` (polar, 5 cols) or
  ``frame,class,source,x,y,z`` (cartesian, 6 cols),
* SELD output CSV rows are ``frame,class,0,x,y,z``
  (``src/test.py:26-30``).
"""
from __future__ import annotations

import ctypes
import math
import os
from typing import Dict, List, Optional

import numpy as np
import scipy.io.wavfile as _wav

LabelDict = Dict[int, List[List[float]]]

_wavlib = None
_wavlib_tried = False


def _native_wav() -> Optional[ctypes.CDLL]:
    """The bundled C++ PCM16 reader (native/wavload.cpp); ctypes drops the
    GIL around the call.  None (no g++) -> scipy, which is also the
    oracle."""
    global _wavlib, _wavlib_tried
    if not _wavlib_tried:
        _wavlib_tried = True
        from ..utils.native import load_or_build

        lib = load_or_build("wavload")
        if lib is not None:
            lib.wav_info_i16.restype = ctypes.c_long
            lib.wav_info_i16.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int)]
            lib.wav_read_i16.restype = ctypes.c_int
            lib.wav_read_i16.argtypes = [
                ctypes.c_char_p, ctypes.c_void_p, ctypes.c_long,
                ctypes.c_int]
        _wavlib = lib
    return _wavlib


def read_wav(path: str) -> np.ndarray:
    """Returns raw audio as stored, shape (N, C).  int16 files stay int16
    (normalization is the caller's job, matching src/datasets.py:140-147)."""
    lib = _native_wav()
    if lib is not None:
        p = path.encode()
        n_ch = ctypes.c_int(0)
        sr = ctypes.c_int(0)
        frames = lib.wav_info_i16(p, ctypes.byref(n_ch), ctypes.byref(sr))
        if frames >= 0:
            out = np.empty((frames, n_ch.value), np.int16)
            if lib.wav_read_i16(p, out.ctypes.data_as(ctypes.c_void_p),
                                frames, n_ch.value) == 0:
                return out
        # negative codes (non-PCM16/malformed) fall through to scipy
    _, audio = _wav.read(path)
    if audio.ndim == 1:
        audio = audio[:, None]
    return audio


def write_wav(path: str, audio: np.ndarray, sr: int) -> None:
    _wav.write(path, sr, audio)


NORMALIZE_BLOCK = 1 << 15
"""Elements a block of :func:`normalize_audio` (256 KB of float64 scratch:
the pass stays in cache)."""


def normalize_audio(audio: np.ndarray) -> np.ndarray:
    """int16 -> [-1, 1] float with the reference's epsilon offset
    (src/datasets.py:147: ``audio / 32768.0 + 1e-8``).

    Bit-equal to ``(audio / 32768.0 + 1e-8).astype(np.float32)`` for every
    dtype: the same arithmetic in the dtype NumPy picks for it, over blocks
    of rows along axis 0 through one reused scratch block, so a clip costs
    its float32 output and no clip-sized temporaries."""
    out = np.empty(audio.shape, np.float32)
    rows = max(1, NORMALIZE_BLOCK // (math.prod(audio.shape[1:]) or 1))
    scratch = np.empty((rows,) + audio.shape[1:], np.result_type(audio, 32768.0))
    for start in range(0, len(audio), rows):
        block = audio[start:start + rows]
        s = scratch[:len(block)]
        np.divide(block, 32768.0, out=s)
        np.add(s, 1e-8, out=s)
        out[start:start + rows] = s
    return out


def read_label_csv(path: str) -> LabelDict:
    """Load a DCASE metadata/output CSV into {frame: [[cls, src, ...]]}
    (reference: utility.py:234-247 / seld_metrics.py:13-33)."""
    label: LabelDict = {}
    with open(path, "r") as f:
        for line in f:
            words = line.strip().split(",")
            if not words or words[0] == "":
                continue
            frame = int(words[0])
            row = [int(words[1]), int(words[2])] + [float(w) for w in words[3:]]
            label.setdefault(frame, []).append(row)
    return label


def write_label_csv(path: str, label: LabelDict) -> None:
    """Write metadata CSV (reference: utility.py:250-261)."""
    with open(path, "w") as f:
        for frame, events in label.items():
            for ev in events:
                cols = [int(frame), int(ev[0]), int(ev[1])] + list(ev[2:])
                f.write(",".join(str(c) for c in cols) + "\n")


def write_seld_output_csv(path: str, output: Dict[int, List[List[float]]]) -> None:
    """Write predictions as ``frame,class,0,x,y,z`` (src/test.py:26-30)."""
    with open(path, "w") as f:
        for frame, rows in output.items():
            for row in rows:
                cls, x, y, z = row[0], row[1], row[2], row[3]
                f.write(f"{int(frame)},{int(cls)},0,{float(x)},{float(y)},{float(z)}\n")


def polar_to_cartesian_dict(label: LabelDict) -> LabelDict:
    """{frame: [[cls, src, azi, ele]]} -> {frame: [[cls, src, x, y, z]]}
    (seld_metrics.py:51-66)."""
    out: LabelDict = {}
    for frame, events in label.items():
        rows = []
        for ev in events:
            azi = np.radians(ev[2])
            ele = np.radians(ev[3])
            ce = np.cos(ele)
            rows.append([ev[0], ev[1], float(np.cos(azi) * ce), float(np.sin(azi) * ce), float(np.sin(ele))])
        out[frame] = rows
    return out


def cartesian_to_polar_dict(label: LabelDict) -> LabelDict:
    """Inverse conversion (seld_metrics.py:68-81)."""
    out: LabelDict = {}
    for frame, events in label.items():
        rows = []
        for ev in events:
            x, y, z = ev[2], ev[3], ev[4]
            azi = np.degrees(np.arctan2(y, x))
            ele = np.degrees(np.arctan2(z, np.sqrt(x * x + y * y)))
            rows.append([ev[0], ev[1], float(azi), float(ele)])
        out[frame] = rows
    return out


def list_clips(directory: str, ext: str = ".wav") -> List[str]:
    """Sorted clip basenames (without extension) in a directory."""
    return sorted(os.path.splitext(f)[0] for f in os.listdir(directory) if f.endswith(ext))
