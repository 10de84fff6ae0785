"""Port FeatureFrontend vs ``adyolo_tpu.ops.features.FeatureFrontend``.

FOA, non-identity scaler, hop-block and flat audio, with and without
``valid_frames``.  Budgets (COMPONENTS.md C4): log-mel <= 2e-3 dB and
IV <= 2e-4; the asserted bounds are tightened to what the port measures
on the CPU (float32 both sides; measured 9.9e-6 dB and 2.7e-8): log-mel
<= 5e-5 dB, IV <= 2e-7 (errors are scaled back to dB / IV units by the
scaler std).
"""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch
import yaml

from adyolo_tpu.config import DataConfig
from adyolo_tpu.ops.features import FeatureFrontend as JaxFrontend
from adyolo_tpu.ops.features import Scaler as JaxScaler
from adyolo_tpu_torch.config import DataConfig as PortDataConfig
from adyolo_tpu_torch.ops import hopper_stft
from adyolo_tpu_torch.ops.features import FeatureFrontend, Scaler, power_to_db

MEL_DB_TOL = 5e-5
IV_TOL = 2e-7
HOP = 600


def _scaler_dict(seed=0, mel=64):
    rng = np.random.default_rng(seed)
    return {"MEL": {"mean": rng.uniform(-60, -20, (1, mel, 4)).astype(np.float32),
                    "std": rng.uniform(5, 15, (1, mel, 4)).astype(np.float32)},
            "IV": {"mean": rng.uniform(-0.1, 0.1, (1, mel, 3)).astype(np.float32),
                   "std": rng.uniform(0.1, 0.5, (1, mel, 3)).astype(np.float32)}}


def _audio(B, T, seed):
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal((B, T, HOP, 4)) * 1500).astype(np.int16)
    a = (a / 32768.0 + 1e-8).astype(np.float32)
    a[:, 0] *= 3.0  # first hop-block unlike the rest (t=0 reflect block)
    return a


def _compare(got, want, d):
    got = got.numpy()
    want = np.asarray(want)
    assert got.shape == want.shape
    mel_err = np.abs(got[..., :4] - want[..., :4]) * d["MEL"]["std"][0]
    iv_err = np.abs(got[..., 4:] - want[..., 4:]) * d["IV"]["std"][0]
    assert float(mel_err.max()) <= MEL_DB_TOL, float(mel_err.max())
    assert float(iv_err.max()) <= IV_TOL, float(iv_err.max())


@pytest.fixture(scope="module")
def frontends():
    d = _scaler_dict()
    return (JaxFrontend(DataConfig(), JaxScaler.from_dict(d)),
            FeatureFrontend(PortDataConfig(), Scaler.from_dict(d), device="cpu"), d)


@pytest.mark.parametrize("layout", ["hop_block", "flat"])
def test_features_match_jax(frontends, layout):
    jf, tf, d = frontends
    a = _audio(2, 41, seed=1)
    if layout == "flat":
        a = np.ascontiguousarray(a.reshape(2, -1, 4)[:, : 41 * HOP - 17])
    want = jf(jnp.asarray(a))
    got = tf(torch.tensor(a))
    assert got.shape[-1] == 7
    _compare(got, want, d)


def test_features_match_jax_with_valid_frames(frontends):
    """Bucketed clips: loud padding past the valid frames must not move
    the dB peak, and padded frames come out zero."""
    jf, tf, d = frontends
    a = _audio(2, 48, seed=2)
    valid = np.array([48, 29], np.int32)
    a[1, 29:] = 0.9  # padding far louder than the clip
    want = jf(jnp.asarray(a), jnp.asarray(valid))
    got = tf(torch.tensor(a), torch.tensor(valid))
    _compare(got, want, d)
    assert float(got[1, 29:].abs().max()) == 0.0


def test_power_to_db_peak_over_valid_frames():
    p = torch.full((1, 4, 2, 1), 1e-3)
    p[0, 3] = 1e6  # a padded frame far above the rest
    mask = torch.tensor([[True, True, True, False]])
    db = power_to_db(p, mask)
    assert torch.allclose(db[0, :3], torch.full((3, 2, 1), -30.0))
    assert float(power_to_db(p)[0, 0, 0, 0]) == pytest.approx(60.0 - 80.0)


def test_mic_not_ported():
    """MIC is ported now (``tests/test_torch_mic.py`` holds it against JAX):
    its front-end builds with 6 GCC-PHAT channels, refuses FOA scaler stats
    naming both counts, and an unknown audio format raises."""
    mic = dataclasses.replace(PortDataConfig(), audio_format="mic")
    fe = FeatureFrontend(mic, device="cpu")
    assert fe.n_aux_channels == 6
    assert fe(torch.zeros(1, 4, HOP, 4)).shape == (1, 4, 64, 10)
    with pytest.raises(ValueError, match="3 channels .* needs 6"):
        FeatureFrontend(mic, Scaler.from_dict(_scaler_dict()), device="cpu")
    with pytest.raises(ValueError, match="audio_format"):
        FeatureFrontend(dataclasses.replace(PortDataConfig(), audio_format="stereo"),
                        device="cpu")


def test_geometries_the_kernels_do_not_take_raise():
    """Any hop frames flat audio (``tests/test_torch_geometry.py`` holds it
    against JAX), but hop-block audio needs n_fft == 2 * hop, as JAX's
    ``framed_dft_chunked``: that input still raises.  Every n_fft the JAX
    package computes builds: 1400 (a prime factor 7) and 4800 (above the
    first frames kernel's 4096) match JAX's front-end on flat audio and run
    on the frames kernel; the shipped DCASE geometries construct."""
    other = dataclasses.replace(PortDataConfig(), n_fft=2048, win_length=1200)
    fe = FeatureFrontend(other, device="cpu")
    assert fe(torch.zeros(1, 4 * HOP + 5, 4)).shape == (1, 4, 64, 7)
    with pytest.raises(ValueError, match="n_fft == 2\\*hop"):
        fe(torch.zeros(1, 4, HOP, 4))
    d = _scaler_dict(seed=4)
    rng = np.random.default_rng(11)
    a = ((rng.standard_normal((2, 8 * HOP + 5, 4)) * 1500).astype(np.int16) / 32768.0
         + 1e-8).astype(np.float32)
    for n_fft in (1400, 4800):  # 1400 = 8 * 7 * 25
        cfg = dataclasses.replace(PortDataConfig(), n_fft=n_fft, win_length=1200)
        jcfg = dataclasses.replace(DataConfig(), n_fft=n_fft, win_length=1200)
        got = FeatureFrontend(cfg, Scaler.from_dict(d), device="cpu")(torch.tensor(a))
        want = JaxFrontend(jcfg, JaxScaler.from_dict(d))(jnp.asarray(a))
        assert got.shape == (2, 8, 64, 7)
        _compare(got, want, d)
        assert hopper_stft.kernels_of(n_fft, HOP) == {"stft_frames_fft_kernel": 1}
    for year in (2020, 2021, 2022):
        with open(f"configs/hyp_data_DCASE{year}.yaml") as f:
            shipped = yaml.safe_load(f)
        names = {fl.name for fl in dataclasses.fields(PortDataConfig)}
        data = PortDataConfig(**{k: v for k, v in shipped.items() if k in names})
        assert 2 * data.hop_length == data.n_fft
        FeatureFrontend(data, device="cpu")
