"""Host-side (numpy) DSP constants: analysis window, mel filterbank,
the windowed rDFT matrices and the GCC-PHAT lag matrices (the port's copy
of :mod:`adyolo_tpu.ops.dsp`).

These reproduce the numerical conventions of the reference's front-end
(librosa 0.8.1, pinned in the reference's ``requirements.txt``):

* ``window('han', N)``  == ``scipy.signal.get_window('hann', N, fftbins=True)``
  (periodic Hann) as used by ``librosa.core.stft`` at
  ``src/utils/utility.py:161`` / ``src/datasets.py:255``.
* ``mel_filterbank(sr, n_fft, n_mels)`` == ``librosa.filters.mel(...)`` with
  librosa defaults (Slaney mel scale, ``norm='slaney'``, fmin=0,
  fmax=sr/2), used at ``src/datasets.py:203`` and
  ``src/utils/utility.py:183,204``.

Both are re-derived from the published Slaney Auditory-Toolbox formulas, not
copied: the mel scale is linear below 1 kHz (step 200/3 Hz per mel) and
logarithmic above (step ``ln(6.4)/27`` per mel), and each triangular filter
is area-normalized by ``2 / (f_upper - f_lower)``.

These run once when the front-end is built, on the host; the matrices then
live on the device.
"""
from __future__ import annotations

import numpy as np

__all__ = ["hann_window", "analysis_window", "mel_filterbank", "dft_matrices",
           "irfft_lag_matrices"]


def hann_window(n: int) -> np.ndarray:
    """Periodic (fftbins) Hann window of length ``n``, float32."""
    k = np.arange(n, dtype=np.float64)
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * k / n)
    return w.astype(np.float32)


def analysis_window(name: str, win_length: int, n_fft: int) -> np.ndarray:
    """Window padded (centered) to ``n_fft`` as librosa does when
    ``win_length < n_fft``.  Only 'han'/'hann' is used by the reference
    configs (``hyp_data_*.yaml: window: 'han'``)."""
    if name not in ("han", "hann", "hanning"):
        raise NotImplementedError(f"window: {name}")
    w = hann_window(win_length)
    if win_length < n_fft:
        lpad = (n_fft - win_length) // 2
        w = np.pad(w, (lpad, n_fft - win_length - lpad))
    elif win_length > n_fft:
        raise ValueError("win_length > n_fft")
    return w.astype(np.float32)


def _hz_to_mel_slaney(f: np.ndarray) -> np.ndarray:
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3.0
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    mel = f / f_sp
    above = f >= min_log_hz
    mel = np.where(above, min_log_mel + np.log(np.maximum(f, 1e-12) / min_log_hz) / logstep, mel)
    return mel


def _mel_to_hz_slaney(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3.0
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    f = m * f_sp
    above = m >= min_log_mel
    f = np.where(above, min_log_hz * np.exp(logstep * (m - min_log_mel)), f)
    return f


def mel_filterbank(sr: int, n_fft: int, n_mels: int,
                   fmin: float = 0.0, fmax: float | None = None) -> np.ndarray:
    """Slaney-normalized triangular mel filterbank, shape ``(n_mels, 1 + n_fft//2)``.

    Matches ``librosa.filters.mel(sr, n_fft, n_mels)`` defaults
    (htk=False, norm='slaney').  The reference stores its transpose
    (``.T``) and right-multiplies power spectra by it
    (``src/datasets.py:203,264``).
    """
    if fmax is None:
        fmax = sr / 2.0
    n_bins = 1 + n_fft // 2
    fftfreqs = np.linspace(0.0, sr / 2.0, n_bins)

    mel_pts = np.linspace(_hz_to_mel_slaney(fmin), _hz_to_mel_slaney(fmax), n_mels + 2)
    hz_pts = _mel_to_hz_slaney(mel_pts)  # (n_mels + 2,)

    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fftfreqs[None, :]  # (n_mels+2, n_bins)

    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))

    enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
    weights = weights * enorm[:, None]
    return weights.astype(np.float32)


def dft_matrices(n_fft: int, window: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Real/imag rDFT matrices with the analysis window folded in.

    Returns ``(W_re, W_im)`` of shape ``(n_fft, 1 + n_fft//2)`` such that for
    a frame ``x`` (length ``n_fft``), ``x @ W_re + 1j * (x @ W_im)`` equals
    ``rfft(window * x)``: the whole STFT is one matrix product per frame
    (the plain version ``ops/stft.py`` takes them).
    """
    k = np.arange(n_fft, dtype=np.float64)[:, None]  # sample index
    f = np.arange(1 + n_fft // 2, dtype=np.float64)[None, :]  # bin index
    ang = -2.0 * np.pi * k * f / n_fft
    w = window.astype(np.float64)[:, None]
    w_re = (np.cos(ang) * w).astype(np.float32)
    w_im = (np.sin(ang) * w).astype(np.float32)
    return w_re, w_im


def irfft_lag_matrices(n_fft: int, n_lags: int) -> tuple[np.ndarray, np.ndarray]:
    """Partial inverse-rDFT matrices onto GCC-PHAT's centred lags.

    Returns ``(C, S)``, each ``(1 + n_fft//2, n_lags)``, such that for an
    rfft half-spectrum ``re + 1j*im``, ``re @ C - im @ S`` equals the
    centred-lag slice ``concat(cc[-n_lags//2:], cc[:n_lags - n_lags//2])``
    of ``np.fft.irfft(re + 1j*im, n=n_fft)`` (the DCASE SELD baseline's
    convention).  Hermitian reconstruction for even ``n_fft``:
    ``x[n] = (1/N)[X_0 + 2 sum_{k=1}^{K-2} (re_k cos th_kn - im_k sin th_kn)
    + (-1)^n X_{K-1}]``; the sine rows at DC and Nyquist are zero, as irfft
    ignores the imaginary part there.
    """
    n_bins = 1 + n_fft // 2
    half = n_lags // 2
    lags = np.concatenate([np.arange(n_fft - half, n_fft),
                           np.arange(0, n_lags - half)]).astype(np.float64)
    k = np.arange(n_bins, dtype=np.float64)[:, None]
    ang = 2.0 * np.pi * k * lags[None, :] / n_fft
    alpha = np.full((n_bins, 1), 2.0)
    alpha[0, 0] = 1.0
    if n_fft % 2 == 0:
        alpha[-1, 0] = 1.0
    lag_c = (alpha * np.cos(ang) / n_fft).astype(np.float32)
    lag_s = (alpha * np.sin(ang) / n_fft).astype(np.float32)
    lag_s[0, :] = 0.0
    if n_fft % 2 == 0:
        lag_s[-1, :] = 0.0
    return lag_c, lag_s
