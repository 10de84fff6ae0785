"""Feature scaler statistics over the training split (counterpart of
:mod:`adyolo_tpu.data.scaler`, reference ``src/preprocess.py:87-130``).

Every train wav goes through the front-end's unnormalised log-mel and
intensity-vector (FOA) or GCC-PHAT (MIC) features, and the per-(mel-bin,
channel) mean, std, max and min are pickled to
``<data_pth>/scaler_wts.pkl``, in the dict layout the reference ships and
:class:`adyolo_tpu_torch.ops.features.Scaler` loads.

The front-end runs on the given device, one clip at a time, on flat
``(1, N, 4)`` audio (on a card the STFT is the Hopper kernel's flat path;
clip lengths are arbitrary).  The moments are streamed (sum, sum of
squares, extrema) in float64 on the host; they equal the reference's
``np.mean`` / ``np.std`` (ddof 0) to float64 rounding.
"""
from __future__ import annotations

import os
import pickle
from typing import Dict, Optional

import numpy as np
import torch

from ..config import DataConfig
from ..ops.features import FeatureFrontend
from . import io

__all__ = ["compute_scaler_stats", "preprocess_scaler"]


class _Moments:
    def __init__(self, shape):
        self.n = 0
        self.s = np.zeros(shape, np.float64)
        self.sq = np.zeros(shape, np.float64)
        self.mx = np.full(shape, -np.inf)
        self.mn = np.full(shape, np.inf)

    def update(self, x: np.ndarray) -> None:  # x: (T, mel, C)
        self.n += x.shape[0]
        self.s += x.sum(axis=0, dtype=np.float64)
        self.sq += (x.astype(np.float64) ** 2).sum(axis=0)
        self.mx = np.maximum(self.mx, x.max(axis=0))
        self.mn = np.minimum(self.mn, x.min(axis=0))

    def finalize(self) -> Dict[str, np.ndarray]:
        mean = self.s / self.n
        var = np.maximum(self.sq / self.n - mean ** 2, 0.0)
        return {"mean": mean[None], "std": np.sqrt(var)[None],
                "max": self.mx[None], "min": self.mn[None]}


def compute_scaler_stats(cfg: DataConfig, wav_dir: Optional[str] = None,
                         device="cuda", verbose: bool = True) -> Dict:
    """``{'MEL': {...}, 'IV': {...}}`` (FOA) or ``{'MEL': {...}, 'GCC':
    {...}}`` (MIC), each stat shaped ``(1, mel_bins, C)``, over the wavs of
    ``wav_dir`` (default: the ``dev-train`` split of the config's format)."""
    wav_dir = wav_dir or os.path.join(cfg.data_pth, f"{cfg.audio_format}_dev",
                                      "dev-train")
    fe = FeatureFrontend(cfg, device=device)
    mel_m = _Moments((cfg.mel_bins, 4))
    aux_m = _Moments((cfg.mel_bins, fe.n_aux_channels))
    for name in io.list_clips(wav_dir):
        audio = io.normalize_audio(io.read_wav(os.path.join(wav_dir, name + ".wav")))
        with torch.inference_mode():
            mel_db, aux = fe.raw_mel_aux(
                torch.as_tensor(np.ascontiguousarray(audio[None]), device=fe.device))
            mel_db, aux = mel_db[0].cpu().numpy(), aux[0].cpu().numpy()
        mel_m.update(mel_db)
        aux_m.update(aux)
        if verbose:
            print(f"scaler: accumulated {name}")
    aux_key = "IV" if cfg.audio_format == "foa" else "GCC"
    return {"MEL": mel_m.finalize(), aux_key: aux_m.finalize()}


def preprocess_scaler(cfg: DataConfig, device="cuda", verbose: bool = True) -> str:
    """Write :func:`compute_scaler_stats` to ``<data_pth>/scaler_wts.pkl``."""
    scaler = compute_scaler_stats(cfg, device=device, verbose=verbose)
    out = os.path.join(cfg.data_pth, "scaler_wts.pkl")
    with open(out, "wb") as f:
        pickle.dump(scaler, f)
    return out
