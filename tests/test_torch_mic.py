"""MIC input (GCC-PHAT features) in the port vs the JAX package, on the CPU.

* ``_gcc_phat_mel`` on STFT spectra with an exactly silent frame: within
  1e-4 x max|feature| of JAX's; the silent frame's pairs are 0 in both.
* The MIC ``FeatureFrontend`` (4 log-mel + 6 GCC-PHAT channels) with a
  non-identity ``{'MEL', 'GCC'}`` scaler, on hop-block and flat audio, with
  and without ``valid_frames``, and ``raw_mel_aux``: within
  1e-4 x max|feature| of JAX's.  A FOA scaler on a MIC front-end raises,
  naming both channel counts.
* The train step's MIC input with SpecAugment on blocks (4, 6), its draws
  replaced by those of the JAX step's key: the zeros on the same elements
  exactly, the rest within 1e-4 x max.
* The MIC dataset: ``mic_dev`` paths, rotation gated off with a warning,
  and the train loader's batches over two epochs equal to JAX's.
* ``cli train --quick_test`` on a MIC set (SE-ResNet34 + AD-YOLO), then
  ``val``, ``test`` and ``infer``, as
  ``tests/test_torch_formats_engine.py`` runs each dense format.
"""
import dataclasses
import os
import random

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import yaml

from adyolo_tpu import config as jax_config
from adyolo_tpu.data import dataset as jax_dataset
from adyolo_tpu.ops import features as jax_features
from adyolo_tpu.ops import specaug as jax_specaug
from adyolo_tpu.ops.dsp import irfft_lag_matrices as jax_lag_matrices
from adyolo_tpu_torch.data import dataset as port_dataset
from adyolo_tpu_torch.ops import features as port_features
from adyolo_tpu_torch.ops import specaug as port_specaug
from adyolo_tpu_torch.ops.dsp import irfft_lag_matrices
from adyolo_tpu_torch.parallel.train_step import build_step_features

from tests.synth_data import make_synth_dataset
from tests.test_torch_config import one_torch_thread, port_config, scratch_path  # noqa: F401
from tests.test_torch_formats_engine import run_cli_formats, short_buckets  # noqa: F401
from tests.test_torch_specaug import _jax_draws

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REL = 1e-4  # x max|feature|
HOP = 600


def _mic_scaler(seed=0, mel=64):
    rng = np.random.default_rng(seed)
    return {"MEL": {"mean": rng.uniform(-60, -20, (1, mel, 4)).astype(np.float32),
                    "std": rng.uniform(5, 15, (1, mel, 4)).astype(np.float32)},
            "GCC": {"mean": rng.uniform(-0.02, 0.02, (1, mel, 6)).astype(np.float32),
                    "std": rng.uniform(0.02, 0.1, (1, mel, 6)).astype(np.float32)}}


def _mic_cfgs(**data):
    jcfg = jax_config.Config()
    jcfg = dataclasses.replace(jcfg, data=dataclasses.replace(
        jcfg.data, audio_format="mic", **data))
    return jcfg, port_config(jcfg)


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= REL * float(np.abs(want).max()), err


def test_lag_matrices_equal_jax():
    for a, b in zip(irfft_lag_matrices(1200, 64), jax_lag_matrices(1200, 64)):
        assert np.array_equal(a, b)


def test_gcc_phat_matches_jax_and_silence_is_zero():
    rng = np.random.default_rng(1)
    re = rng.normal(0, 1, (2, 6, 601, 4)).astype(np.float32)
    im = rng.normal(0, 1, (2, 6, 601, 4)).astype(np.float32)
    re[1, 3], im[1, 3] = 0.0, 0.0  # exact digital silence: R = 0
    lag_c, lag_s = irfft_lag_matrices(1200, 64)
    want = np.asarray(jax_features._gcc_phat_mel(jnp.asarray(re), jnp.asarray(im),
                                                 jnp.asarray(lag_c), jnp.asarray(lag_s)))
    got = port_features._gcc_phat_mel(torch.tensor(re), torch.tensor(im),
                                      torch.tensor(lag_c), torch.tensor(lag_s)).numpy()
    assert got.shape == (2, 6, 64, 6)
    _close(got, want)
    assert not got[1, 3].any() and not want[1, 3].any()


def _audio(shape, seed):
    a = (np.random.default_rng(seed).standard_normal(shape) * 1500).astype(np.int16)
    return (a / 32768.0 + 1e-8).astype(np.float32)


@pytest.fixture(scope="module")
def frontends():
    jcfg, cfg = _mic_cfgs()
    d = _mic_scaler()
    return (jax_features.FeatureFrontend(jcfg.data, jax_features.Scaler.from_dict(d)),
            port_features.FeatureFrontend(cfg.data, port_features.Scaler.from_dict(d),
                                          device="cpu"))


@pytest.mark.parametrize("layout", ["hop_blocks", "flat"])
@pytest.mark.parametrize("valid", [None, (30, 17)])
def test_mic_frontend_matches_jax(frontends, layout, valid):
    jf, pf = frontends
    audio = _audio((2, 30 * HOP + (0 if layout == "hop_blocks" else 123), 4), 2)
    if layout == "hop_blocks":
        audio = audio.reshape(2, 30, HOP, 4)
    v = None if valid is None else np.asarray(valid, np.int32)
    want = jf(jnp.asarray(audio), None if v is None else jnp.asarray(v))
    got = pf(torch.tensor(audio), None if v is None else torch.tensor(v))
    assert got.shape == (2, 30, 64, 10)
    _close(got.numpy(), want)
    for g, w in zip(pf.raw_mel_aux(torch.tensor(audio)), jf.raw_mel_aux(jnp.asarray(audio))):
        _close(g.numpy(), w)


def test_mic_scaler_channels_are_checked():
    _, cfg = _mic_cfgs()
    foa = port_features.Scaler.from_dict({"MEL": _mic_scaler()["MEL"],
                                          "IV": {"mean": np.zeros((1, 64, 3)),
                                                 "std": np.ones((1, 64, 3))}})
    with pytest.raises(ValueError, match=r"have 3 channels .* needs 6"):
        port_features.FeatureFrontend(cfg.data, foa, device="cpu")
    fe = port_features.FeatureFrontend(cfg.data, device="cpu")  # identity stats
    assert fe.n_aux_channels == 6 and fe.aux_mean.shape == (64, 6)
    s = port_features.Scaler.from_dict(_mic_scaler())
    assert s.aux_std.shape == (64, 6)


def test_mic_train_step_features_match_the_jax_step(monkeypatch):
    jcfg, _ = _mic_cfgs()
    jcfg = dataclasses.replace(jcfg, aug=dataclasses.replace(jcfg.aug, spec_augment=True))
    cfg = port_config(jcfg)
    d = _mic_scaler(3)
    jf = jax_features.FeatureFrontend(jcfg.data, jax_features.Scaler.from_dict(d))
    audio = (np.random.default_rng(4).standard_normal((2, 60, HOP, 4)) * 1500
             ).astype(np.int16)
    k_aug, _ = jax.random.split(jax.random.PRNGKey(11))
    a = jnp.asarray(audio).astype(jnp.float32) / 32768.0 + 1e-8
    feat = jf._forward(a, None, jf._mel_mean, jf._mel_std, jf._aux_mean, jf._aux_std)
    aug = jcfg.aug
    want = np.asarray(jax_specaug.spec_augment(
        feat, k_aug, (4, 6), aug.spec_augment_time_mask_param,
        aug.spec_augment_freq_mask_param, aug.spec_augment_thresh))
    monkeypatch.setattr(port_specaug, "draw_uniforms",
                        lambda B, n, g, dev: torch.tensor(_jax_draws(k_aug, B, n)))
    got = build_step_features(cfg, port_features.FeatureFrontend(
        cfg.data, port_features.Scaler.from_dict(d), device="cpu"))(audio).numpy()
    zeros = want == 0
    assert zeros.any() and not zeros.all()
    np.testing.assert_array_equal(got == 0, zeros)
    _close(got, want)


@pytest.fixture(scope="module")
def mic_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("micdata")
    return make_synth_dataset(str(root), n_train=5, n_val=2, n_test=1, train_secs=1,
                              eval_secs=2, chunk_window_s=1, audio_format="mic", seed=3)


def test_mic_dataset_paths_rotation_and_batches_match_jax(mic_root, capsys):
    jcfg, _ = _mic_cfgs(data_pth=mic_root, chunk_window_s=1)
    jcfg = dataclasses.replace(
        jcfg, aug=dataclasses.replace(jcfg.aug, rotation_augment=True),
        train=dataclasses.replace(jcfg.train, batch_size=2, nb_iters=2,
                                  max_targets_per_clip=64))
    cfg = port_config(jcfg)

    def epochs(pkg, c):
        random.seed(5)
        ds = pkg.SELDDataset(c, "train")
        assert "mic_dev" in ds.wav_pth and not ds.rotation.active
        loader = pkg.TrainLoader(ds, c)
        out = []
        for _ in range(2):
            out.append(list(loader))
            ds.resample_epoch()
        return out

    want = epochs(jax_dataset, jcfg)
    capsys.readouterr()
    got = epochs(port_dataset, cfg)
    assert "rotation augmentation is FOA-only" in capsys.readouterr().err
    for ge, we in zip(got, want):
        assert len(ge) == len(we) == 2
        for g, w in zip(ge, we):
            assert set(g) == set(w)
            for k in w:
                assert np.array_equal(g[k], w[k]), k
    for split in ("val", "test"):
        ds = port_dataset.SELDDataset(cfg, split, is_valid=True)
        assert os.path.join("mic_dev", f"dev-{split}") in ds.wav_pth


def test_cli_quick_test_on_mic(mic_root, short_buckets, scratch_path, monkeypatch):  # noqa: F811
    configs = str(scratch_path / "configs")
    os.makedirs(configs)
    with open(os.path.join(configs, "hyp_data_DCASE2022.yaml"), "w") as f:
        yaml.safe_dump({"data_pth": mic_root, "name_pth": os.path.join(mic_root, "classes.txt"),
                        "chunk_window_s": 1, "audio_format": "mic"}, f)
    setup = {"data": mic_root, "configs": configs, "results": str(scratch_path / "results")}
    printed = run_cli_formats(setup, "adyolo", monkeypatch, fmt="mic")
    assert len(printed["test"]) == 9
