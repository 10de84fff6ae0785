"""Acoustic feature front-end: STFT -> log-mel + FOA intensity vectors
(or, for MIC input, GCC-PHAT lags).

Counterpart of :mod:`adyolo_tpu.ops.features`:

* log-mel: ``power_to_db`` (librosa defaults ``ref=1.0, amin=1e-10,
  top_db=80``) with the 80 dB floor taken below the per-(clip, channel)
  peak over *valid* frames only;
* FOA intensity vectors ``Re(conj(W) * [X, Y, Z])`` normalised by
  ``eps + |W|^2 + mean(|XYZ|^2)``, then mel-projected;
* MIC GCC-PHAT: for each of the 6 mic pairs the phase-transformed cross
  spectrum onto ``mel_bins`` centred lags (:func:`_gcc_phat_mel`);
* scaler standardisation ``(f - mean) / std``.

On a CUDA device the STFT is a hand-written Hopper kernel
(:func:`adyolo_tpu_torch.ops.hopper_stft.stft_hop_blocks`: the hop-block
kernel at ``n_fft == 2 * hop <= 2400`` with prime factors 2, 3 and 5, the
frames kernel at every other geometry, odd ``n_fft``, any prime factor and
any size included); on the CPU it is the plain PyTorch version.  Every
geometry the JAX package takes runs.  The mel projections and GCC-PHAT's
two lag products are fp32 ``torch.matmul``: JAX computes them with
``einsum``, outside any Pallas kernel, too.
"""
from __future__ import annotations

import pickle
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from ..config import DataConfig
from . import hopper_stft
from .dsp import analysis_window, irfft_lag_matrices, mel_filterbank

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
    'IV': {...}}`` with arrays shaped ``(1, mel_bins, C)``; a MIC set's
    auxiliary block is ``'GCC'``, C = 6 lag channels."""

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
        aux = d["IV"] if "IV" in d else d["GCC"]
        return cls(d["MEL"]["mean"], d["MEL"]["std"], aux["mean"], aux["std"])

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


def _gcc_phat_mel(re, im, lag_c, lag_s):
    """GCC-PHAT lag features of every unordered mic pair
    (``adyolo_tpu/ops/features.py:162-187``): ``R = X_i conj(X_j)``, the
    phase transform ``R / (|R| + eps)``, then the partial inverse rDFT
    onto the centred lags, ``Re @ C - Im @ S``
    (:func:`adyolo_tpu_torch.ops.dsp.irfft_lag_matrices`).  Exact silence
    (R = 0) gives a zero row.  re, im: (B, T, K, C) -> (B, T, n_lags,
    C(C-1)/2).

    The pair spectra are formed in (B, T, pair, K) order so that both
    products read them in place; each temporary is freed as soon as it
    is used (at B = 16 x 800 frames one is 185 MB)."""
    C = re.shape[-1]
    pairs = [(i, j) for i in range(C) for j in range(i + 1, C)]
    ii = torch.tensor([p[0] for p in pairs], device=re.device)
    jj = torch.tensor([p[1] for p in pairs], device=re.device)
    re_t, im_t = re.transpose(2, 3), im.transpose(2, 3)  # (B, T, C, K)
    re_i, re_j = re_t[:, :, ii], re_t[:, :, jj]  # (B, T, P, K)
    im_i, im_j = im_t[:, :, ii], im_t[:, :, jj]
    r_re = re_i * re_j + im_i * im_j
    r_im = im_i * re_j - re_i * im_j
    del re_i, re_j, im_i, im_j
    inv_mag = 1.0 / (torch.sqrt(r_re * r_re + r_im * r_im) + _EPS)
    r_re = r_re * inv_mag
    r_im = r_im * inv_mag
    del inv_mag
    out = torch.matmul(r_re, lag_c)  # (B, T, P, n_lags)
    del r_re
    out = out - torch.matmul(r_im, lag_s)
    return out.transpose(2, 3)  # (B, T, n_lags, P)


class FeatureFrontend(nn.Module):
    """``forward(audio, valid_frames=None) -> (B, T, mel_bins, C_feat)``:
    C_feat = 7 for FOA (4 log-mel + 3 IV), 10 for MIC (4 log-mel + 6
    GCC-PHAT pairs).

    ``audio``: float32 in [-1, 1], hop-block ``(B, T, hop, 4)`` (the
    loaders' layout at ``n_fft == 2 * hop``) or flat ``(B, N, 4)`` (any
    hop), on ``device``.
    ``valid_frames``: optional (B,) count of valid STFT frames of bucketed
    clips; padded frames are zeroed and left out of the dB peak.

    A module without parameters: its constants (K1's twiddle-and-window
    table ``fft_table``, the mel matrix ``mel_t``, the scaler stats and,
    for MIC, the lag matrices ``lag_c`` / ``lag_s``) are buffers, so a
    traced serving program (:mod:`adyolo_tpu_torch.engine.export`) carries
    them.  ``device`` is where they are built.
    """

    def __init__(self, data_cfg: DataConfig, scaler: Optional[Scaler] = None,
                 device="cuda"):
        super().__init__()
        if data_cfg.audio_format not in ("foa", "mic"):
            raise ValueError(f"audio_format={data_cfg.audio_format!r}: 'foa' or 'mic'")
        self.cfg = data_cfg
        self.device = torch.device(device)
        w = analysis_window(data_cfg.window, data_cfg.win_length, data_cfg.n_fft)
        self.register_buffer("fft_table",  # twiddles + window
                             hopper_stft.fft_plan(w, self.device).table)
        mel = mel_filterbank(data_cfg.sr, data_cfg.n_fft, data_cfg.mel_bins)
        self.register_buffer("mel_t", torch.as_tensor(
            np.ascontiguousarray(mel.T), device=self.device))  # (K, mel_bins)
        self.n_aux_channels = data_cfg.nb_feature_channels - 4  # IV 3 / GCC 6
        if data_cfg.audio_format == "mic":
            for name, a in zip(("lag_c", "lag_s"),
                               irfft_lag_matrices(data_cfg.n_fft, data_cfg.mel_bins)):
                self.register_buffer(name, torch.as_tensor(a, device=self.device))
        if scaler is None:
            scaler = identity_scaler(data_cfg.mel_bins, n_aux_ch=self.n_aux_channels)
        if scaler.aux_mean.shape[-1] != self.n_aux_channels:
            raise ValueError(
                f"the scaler's auxiliary stats have {scaler.aux_mean.shape[-1]} "
                f"channels but audio_format={data_cfg.audio_format!r} needs "
                f"{self.n_aux_channels} (IV 3 / GCC 6): wrong scaler_wts.pkl?")
        for name in ("mel_mean", "mel_std", "aux_mean", "aux_std"):
            self.register_buffer(name, torch.as_tensor(  # pickled stats may be strided
                np.ascontiguousarray(getattr(scaler, name)), device=self.device))

    @property
    def fft(self) -> hopper_stft.FFTPlan:
        """The :class:`~adyolo_tpu_torch.ops.hopper_stft.FFTPlan` over the
        ``fft_table`` buffer."""
        return hopper_stft.FFTPlan(self.fft_table)

    def stft(self, audio: torch.Tensor):
        return hopper_stft.stft_hop_blocks(audio, self.fft, self.cfg.hop_length)

    def _aux(self, re, im) -> torch.Tensor:
        if self.cfg.audio_format == "foa":
            return _foa_iv(re, im, self.mel_t)  # (B, T, mel, 3)
        return _gcc_phat_mel(re, im, self.lag_c, self.lag_s)  # (B, T, mel, 6)

    def features_from_stft(self, re, im, valid_frames=None) -> torch.Tensor:
        """Log-mel + IV (or GCC-PHAT) + scaler from an STFT ``(re, im)``
        (B, T, K, 4)."""
        frame_mask = None
        if valid_frames is not None:
            t = torch.arange(re.shape[1], device=re.device)
            frame_mask = t[None, :] < valid_frames.to(re.device)[:, None]
        mel_db = (_logmel(re, im, self.mel_t, frame_mask)
                  - self.mel_mean) / self.mel_std
        aux = (self._aux(re, im) - self.aux_mean) / self.aux_std
        feat = torch.cat([mel_db, aux], dim=-1)
        if frame_mask is not None:
            feat = feat * frame_mask[:, :, None, None]
        return feat

    def forward(self, audio: torch.Tensor, valid_frames=None) -> torch.Tensor:
        re, im = self.stft(audio)
        return self.features_from_stft(re, im, valid_frames)

    def raw_mel_aux(self, audio: torch.Tensor):
        """The unnormalised ``(mel_db, aux)``, aux the FOA intensity vectors
        or the MIC GCC-PHAT block: what the scaler pass accumulates
        (``adyolo_tpu/ops/features.py:271-281``)."""
        re, im = self.stft(audio)
        return _logmel(re, im, self.mel_t, None), self._aux(re, im)
