"""Offline chunking of the training split (counterpart of
:mod:`adyolo_tpu.data.chunking`, reference ``src/preprocess.py:13-84``).

Each ``dev-train`` wav is zero-padded so that its last window is full,
sliced into ``chunk_window_s``-second windows every ``chunk_stride_s``
seconds, with the 10-Hz label stream cut in lockstep (event frames
re-based into each chunk), and written as ``<name>_chunkNNN.wav/.csv``
into the ``dev-train-chunked_<W>s_<S>s`` directories that the training
dataset reads, under ``foa_dev`` or ``mic_dev``.
"""
from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

from ..config import DataConfig
from . import io

__all__ = ["chunk_clip", "preprocess_chunking"]


def chunk_clip(audio: np.ndarray, label: io.LabelDict, cfg: DataConfig
               ) -> List[Tuple[np.ndarray, io.LabelDict]]:
    """Slice one (N, C) clip and its label dict into padded sliding
    windows (``preprocess.py:13-48``): ``(N' - W) // S + 1`` chunks, with
    N' the length padded up to the next stride past the first window."""
    wav_window = cfg.sr * cfg.chunk_window_s
    wav_stride = cfg.sr * cfg.chunk_stride_s
    csv_window = int(cfg.chunk_window_s / cfg.label_hop_len_s)
    csv_stride = int(cfg.chunk_stride_s / cfg.label_hop_len_s)

    overhang = (len(audio) - wav_window) % wav_stride
    pad = wav_stride - overhang if overhang != 0 else 0
    audio = np.pad(audio, [(0, pad), (0, 0)], "constant")

    n_chunks = (len(audio) - wav_window) // wav_stride + 1
    chunks = []
    for c in range(n_chunks):
        a = audio[c * wav_stride: c * wav_stride + wav_window]
        base = c * csv_stride
        label_slice: io.LabelDict = {}
        for local in range(csv_window):
            events = label.get(base + local)
            if events is not None:
                label_slice[local] = events
        chunks.append((a, label_slice))
    return chunks


def preprocess_chunking(cfg: DataConfig, verbose: bool = True) -> int:
    """Chunk the dataset's ``dev-train`` split (``preprocess.py:51-84``).
    Returns the number of chunks written."""
    sub = f"dev-train-chunked_{cfg.chunk_window_s}s_{cfg.chunk_stride_s}s"
    fmt_dev = f"{cfg.audio_format}_dev"
    wav_dir = os.path.join(cfg.data_pth, fmt_dev, "dev-train")
    csv_dir = os.path.join(cfg.data_pth, "metadata_dev", "dev-train")
    wav_out = os.path.join(cfg.data_pth, fmt_dev, sub)
    csv_out = os.path.join(cfg.data_pth, "metadata_dev", sub)
    os.makedirs(wav_out, exist_ok=True)
    os.makedirs(csv_out, exist_ok=True)

    names = io.list_clips(wav_dir)
    if len(names) != len(io.list_clips(csv_dir, ".csv")):
        raise ValueError(f"{wav_dir} and {csv_dir} hold different clip counts")
    total = 0
    for name in names:
        audio = io.read_wav(os.path.join(wav_dir, name + ".wav"))
        label = io.read_label_csv(os.path.join(csv_dir, name + ".csv"))
        for i, (a, lab) in enumerate(chunk_clip(audio, label, cfg)):
            io.write_wav(os.path.join(wav_out, f"{name}_chunk{i + 1:03d}.wav"), a, cfg.sr)
            io.write_label_csv(os.path.join(csv_out, f"{name}_chunk{i + 1:03d}.csv"), lab)
            total += 1
        if verbose:
            print(f"chunked {name}")
    return total
