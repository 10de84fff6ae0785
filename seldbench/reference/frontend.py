"""The reference front-end: int16 FOA audio -> STFT (``torch.stft``,
periodic Hann, librosa's ``center=True`` reflect padding, ``N // hop``
frames kept) -> log-mel power (Slaney mel, ``power_to_db`` with an 80-dB
floor under each clip and channel's peak) and the FOA intensity vectors
``Re(conj(W) [X, Y, Z])`` over ``eps + |W|^2 + mean |XYZ|^2``, projected on
the mel bank -> ``(f - mean) / std`` with the configuration's scaler stats.
Output ``(B, T, mel_bins, 7)`` float32.  Reference: sadPororo/AD-YOLO
``src/datasets.py:195-292``."""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["mel_bank", "Frontend"]

_EPS = 1e-8
_AMIN = 1e-10
_TOP_DB = 80.0


def _hz_to_mel(f):
    f = np.asarray(f, np.float64)
    lin = f / (200.0 / 3.0)
    log = 15.0 + np.log(np.maximum(f, 1e-12) / 1000.0) / (np.log(6.4) / 27.0)
    return np.where(f >= 1000.0, log, lin)


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    lin = m * (200.0 / 3.0)
    log = 1000.0 * np.exp((np.log(6.4) / 27.0) * (m - 15.0))
    return np.where(m >= 15.0, log, lin)


def mel_bank(sr: int, n_fft: int, n_mels: int) -> np.ndarray:
    """Slaney-scale, area-normalised triangular mel filters ``(n_mels, 1 +
    n_fft // 2)``, float32: ``librosa.filters.mel`` defaults."""
    freqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    hz = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(sr / 2.0), n_mels + 2))
    ramps = hz[:, None] - freqs[None, :]
    fd = np.diff(hz)
    w = np.maximum(0.0, np.minimum(-ramps[:-2] / fd[:-1, None], ramps[2:] / fd[1:, None]))
    return (w * (2.0 / (hz[2:] - hz[:-2]))[:, None]).astype(np.float32)


class Frontend:
    """``features(audio_int16 (B, N, 4)) -> (B, N // hop, mel_bins, 7)``."""

    def __init__(self, data: dict, scaler: dict, device):
        self.hop, self.n_fft = data["hop_length"], data["n_fft"]
        self.device = torch.device(device)
        k = np.arange(data["win_length"], dtype=np.float64)
        win = 0.5 - 0.5 * np.cos(2.0 * np.pi * k / data["win_length"])
        lpad = (self.n_fft - data["win_length"]) // 2
        win = np.pad(win, (lpad, self.n_fft - data["win_length"] - lpad))
        self.window = torch.as_tensor(win.astype(np.float32), device=self.device)
        self.mel = torch.as_tensor(mel_bank(data["sr"], self.n_fft, data["mel_bins"]).T.copy(),
                                   device=self.device)  # (K, mel)
        st = {k: torch.as_tensor(np.asarray(v, np.float64).astype(np.float32).reshape(
            data["mel_bins"], -1), device=self.device)
              for k, v in scaler.items() if k != "source"}
        self.mel_mean, self.mel_std = st["mel_mean"], st["mel_std"]
        self.iv_mean, self.iv_std = st["iv_mean"], st["iv_std"]

    @torch.no_grad()
    def __call__(self, audio) -> torch.Tensor:
        x = torch.as_tensor(audio, device=self.device)
        x = x.to(torch.float32) / 32768.0 + 1e-8
        B, N, C = x.shape
        T = N // self.hop
        spec = torch.stft(x.permute(0, 2, 1).reshape(B * C, N), self.n_fft, self.hop,
                          window=self.window, center=True, pad_mode="reflect",
                          return_complex=True)[..., :T]  # (B*C, K, T)
        spec = spec.reshape(B, C, -1, T).permute(0, 3, 2, 1)  # (B, T, K, C)
        re, im = spec.real.contiguous(), spec.imag.contiguous()
        power = re * re + im * im
        mel = torch.einsum("btkc,km->btmc", power, self.mel)
        db = 10.0 * torch.log10(torch.clamp(mel, min=_AMIN))
        db = torch.maximum(db, db.amax(dim=(1, 2), keepdim=True) - _TOP_DB)
        w_re, w_im, x_re, x_im = re[..., :1], im[..., :1], re[..., 1:], im[..., 1:]
        energy = (_EPS + w_re[..., 0] ** 2 + w_im[..., 0] ** 2
                  + (x_re ** 2 + x_im ** 2).sum(-1) / 3.0)
        iv = (w_re * x_re + w_im * x_im) / energy[..., None]
        iv = torch.einsum("btkc,km->btmc", iv, self.mel)
        return torch.cat([(db - self.mel_mean) / self.mel_std,
                          (iv - self.iv_mean) / self.iv_std], dim=-1)
