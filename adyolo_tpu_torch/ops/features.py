"""Acoustic feature front-end: STFT -> log-mel + FOA intensity vectors.

Counterpart of :mod:`adyolo_tpu.ops.features` for FOA audio:

* log-mel: ``power_to_db`` (librosa defaults ``ref=1.0, amin=1e-10,
  top_db=80``) with the 80 dB floor taken below the per-(clip, channel)
  peak over *valid* frames only;
* FOA intensity vectors ``Re(conj(W) * [X, Y, Z])`` normalised by
  ``eps + |W|^2 + mean(|XYZ|^2)``, then mel-projected;
* scaler standardisation ``(f - mean) / std``.

On a CUDA device the STFT is the hand-written Hopper kernel
(:func:`adyolo_tpu_torch.ops.hopper_stft.stft_hop_blocks`); on the CPU it
is the plain PyTorch version.  The mel projections are fp32
``torch.matmul``: JAX computes them outside any Pallas kernel too.
MIC input (GCC-PHAT features) is not ported yet.
"""
from __future__ import annotations

import pickle
from typing import Dict, Optional

import numpy as np
import torch

from ..config import DataConfig
from . import hopper_stft
from .dsp import analysis_window, mel_filterbank

__all__ = ["power_to_db", "FeatureFrontend", "Scaler", "identity_scaler"]

_EPS = 1e-8  # reference: src/datasets.py:204 self.eps
_AMIN = 1e-10  # librosa power_to_db default
_TOP_DB = 80.0


def power_to_db(power: torch.Tensor,
                frame_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``10*log10(max(p, amin))`` floored 80 dB below the per-(clip,
    channel) peak.  power: (B, T, F, C); frame_mask: optional (B, T) bool,
    padded frames are left out of the peak."""
    db = 10.0 * torch.log10(torch.clamp(power, min=_AMIN))
    masked = db
    if frame_mask is not None:
        masked = db.masked_fill(~frame_mask[:, :, None, None], float("-inf"))
    peak = masked.amax(dim=(1, 2), keepdim=True)  # (B, 1, 1, C)
    return torch.maximum(db, peak - _TOP_DB)


class Scaler:
    """Per-(mel-bin, channel) standardisation stats, in the layout of the
    reference's ``scaler_wts.pkl``: ``{'MEL': {'mean', 'std', ...},
    'IV': {...}}`` with arrays shaped ``(1, mel_bins, C)``."""

    def __init__(self, mel_mean, mel_std, aux_mean, aux_std):
        def prep(a):
            a = np.asarray(a, np.float32)
            return a.reshape(a.shape[-2], a.shape[-1])  # (mel_bins, C)

        self.mel_mean = prep(mel_mean)
        self.mel_std = prep(mel_std)
        self.aux_mean = prep(aux_mean)
        self.aux_std = prep(aux_std)

    @classmethod
    def from_dict(cls, d: Dict) -> "Scaler":
        if "IV" not in d:
            raise NotImplementedError(
                "only FOA scaler stats ('IV') are ported; MIC/GCC-PHAT waits "
                "for its ROADMAP item")
        return cls(d["MEL"]["mean"], d["MEL"]["std"], d["IV"]["mean"],
                   d["IV"]["std"])

    @classmethod
    def from_pickle(cls, path: str) -> "Scaler":
        with open(path, "rb") as f:
            return cls.from_dict(pickle.load(f))


def identity_scaler(mel_bins: int, n_mel_ch: int = 4, n_aux_ch: int = 3) -> Scaler:
    return Scaler(np.zeros((1, mel_bins, n_mel_ch), np.float32),
                  np.ones((1, mel_bins, n_mel_ch), np.float32),
                  np.zeros((1, mel_bins, n_aux_ch), np.float32),
                  np.ones((1, mel_bins, n_aux_ch), np.float32))


def _logmel(re, im, mel_t, frame_mask):
    power = re * re + im * im  # (B, T, K, C)
    mel_power = torch.matmul(power.transpose(2, 3), mel_t).transpose(2, 3)
    return power_to_db(mel_power, frame_mask)


def _foa_iv(re, im, mel_t):
    # W = channel 0, XYZ = channels 1:4 (src/datasets.py:270-275)
    w_re, w_im = re[..., 0:1], im[..., 0:1]
    x_re, x_im = re[..., 1:4], im[..., 1:4]
    iv = w_re * x_re + w_im * x_im  # Re(conj(W) X)
    energy = _EPS + (w_re[..., 0] ** 2 + w_im[..., 0] ** 2
                     + (x_re ** 2 + x_im ** 2).sum(-1) / 3.0)
    iv = iv / energy[..., None]
    return torch.matmul(iv.transpose(2, 3), mel_t).transpose(2, 3)


class FeatureFrontend:
    """``__call__(audio, valid_frames=None) -> (B, T, mel_bins, 7)``.

    ``audio``: float32 in [-1, 1], hop-block ``(B, T, hop, 4)`` (the
    loaders' layout) or flat ``(B, N, 4)``, on ``device``.
    ``valid_frames``: optional (B,) count of valid STFT frames of bucketed
    clips; padded frames are zeroed and left out of the dB peak.
    """

    def __init__(self, data_cfg: DataConfig, scaler: Optional[Scaler] = None,
                 device="cuda"):
        if data_cfg.audio_format != "foa":
            raise NotImplementedError(
                f"audio_format={data_cfg.audio_format!r}: MIC/GCC-PHAT "
                "features are not yet ported (ROADMAP.md, port queue: 'the "
                "other formats, MIC/GCC-PHAT, DDP and export')")
        if 2 * data_cfg.hop_length != data_cfg.n_fft:
            raise NotImplementedError(
                f"hop_length={data_cfg.hop_length} with n_fft={data_cfg.n_fft}: "
                "the STFT frames at n_fft // 2, so it needs n_fft == "
                "2 * hop_length (the DCASE geometry, 1200 / 600)")
        self.cfg = data_cfg
        self.device = torch.device(device)
        w = analysis_window(data_cfg.window, data_cfg.win_length, data_cfg.n_fft)
        self.fft = hopper_stft.fft_plan(w, self.device)  # twiddles + window
        mel = mel_filterbank(data_cfg.sr, data_cfg.n_fft, data_cfg.mel_bins)
        self.mel_t = torch.as_tensor(np.ascontiguousarray(mel.T),
                                     device=self.device)  # (K, mel_bins)
        if scaler is None:
            scaler = identity_scaler(data_cfg.mel_bins)
        if scaler.aux_mean.shape[-1] != 3:
            raise ValueError(f"FOA needs 3 IV scaler channels, got "
                             f"{scaler.aux_mean.shape[-1]}")
        self.mel_mean, self.mel_std, self.aux_mean, self.aux_std = (
            torch.as_tensor(a, device=self.device)
            for a in (scaler.mel_mean, scaler.mel_std, scaler.aux_mean,
                      scaler.aux_std))

    def stft(self, audio: torch.Tensor):
        return hopper_stft.stft_hop_blocks(audio, self.fft)

    def features_from_stft(self, re, im, valid_frames=None) -> torch.Tensor:
        """Log-mel + IV + scaler from an STFT ``(re, im)`` (B, T, K, 4)."""
        frame_mask = None
        if valid_frames is not None:
            t = torch.arange(re.shape[1], device=re.device)
            frame_mask = t[None, :] < valid_frames.to(re.device)[:, None]
        mel_db = (_logmel(re, im, self.mel_t, frame_mask)
                  - self.mel_mean) / self.mel_std
        aux = (_foa_iv(re, im, self.mel_t) - self.aux_mean) / self.aux_std
        feat = torch.cat([mel_db, aux], dim=-1)
        if frame_mask is not None:
            feat = feat * frame_mask[:, :, None, None]
        return feat

    def __call__(self, audio: torch.Tensor, valid_frames=None) -> torch.Tensor:
        re, im = self.stft(audio)
        return self.features_from_stft(re, im, valid_frames)
