"""STFT geometries other than n_fft = 2 * hop in the port vs the JAX package,
on the CPU (the plain flat framing behind ``adyolo::stft``; on the card the
frames kernel of ``csrc/stft.cu``).

JAX frames flat audio at any hop (``adyolo_tpu/ops/features.py:124-139``):
reflect-padded n_fft // 2 on the left, zeros on the right, T = N // hop.
The geometries are those a 24-kHz DCASE set can take at the repository's
600-sample hop: the DCASE SELD baseline's (``seld-dcase2022``,
``cls_feature_class.py``: a window of 2 hops in the next power of two),
n_fft 1024 with its own window, and a 2400-sample window in n_fft 2400.

* ``FeatureFrontend``, FOA and MIC, with and without ``valid_frames``, on
  flat audio, with non-identity scaler stats: FOA within 5e-5 dB (log-mel)
  and 2e-7 (IV), ``tests/test_torch_features.py``'s bounds; MIC within
  1e-4 x max|feature|, ``tests/test_torch_mic.py``'s.
* SE-ResNet34 + AD-YOLO from flat audio to logits at (2048, 600, 1200), on
  seeded variables of JAX's init shapes carried over by
  ``convert.state_dict_from_flax``: within 1e-4 abs.
* ``cli train --quick_test`` (SE-ResNet34 + AD-YOLO) on a preset dir at n_fft
  2048, then ``cli export``: the artifact takes flat audio and serves the
  live eval forward of the trained experiment within 1e-6.
"""
import dataclasses
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import yaml

from adyolo_tpu import config as jax_config
from adyolo_tpu.ops import features as jax_features
from adyolo_tpu.models.wrapper import build_model as jax_build_model
from adyolo_tpu_torch import cli
from adyolo_tpu_torch.config import load_config
from adyolo_tpu_torch.convert import state_dict_from_flax
from adyolo_tpu_torch.engine.evaluate import (build_eval_forward, load_best_model,
                                              make_frontend)
from adyolo_tpu_torch.engine.export import load_exported
from adyolo_tpu_torch.models import wrapper as port_wrapper
from adyolo_tpu_torch.ops import features as port_features

from tests.synth_data import make_synth_dataset
from tests.test_torch_config import one_torch_thread, port_config, scratch_path  # noqa: F401
from tests.test_torch_features import IV_TOL, MEL_DB_TOL, _scaler_dict
from tests.test_torch_mic import REL as MIC_REL
from tests.test_torch_mic import _mic_scaler
from tests.test_torch_presets import LOGIT_TOL, _seeded_tree

pytestmark = pytest.mark.usefixtures("one_torch_thread")

HOP = 600
# (n_fft, win_length) at the 600-sample hop
GEOMETRIES = [(2048, 1200), (1024, 1024), (2400, 2400)]
FRAMES = 30
LIVE_TOL = 1e-6  # served vs live, as tests/test_torch_export.py


def _cfgs(n_fft, win, fmt="foa"):
    jcfg = jax_config.Config()
    jcfg = dataclasses.replace(jcfg, data=dataclasses.replace(
        jcfg.data, n_fft=n_fft, win_length=win, audio_format=fmt))
    return jcfg, port_config(jcfg)


def _flat_audio(seed, frames=FRAMES, extra=123):
    """int16-range noise as the loaders normalise it, (2, frames hops +
    extra, 4), its first samples louder (the reflected left edge)."""
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal((2, frames * HOP + extra, 4)) * 1500).astype(np.int16)
    a = (a / 32768.0 + 1e-8).astype(np.float32)
    a[:, :2 * HOP] *= 3.0
    return a


def _frontends(n_fft, win, fmt):
    jcfg, cfg = _cfgs(n_fft, win, fmt)
    d = _scaler_dict() if fmt == "foa" else _mic_scaler()
    return (jax_features.FeatureFrontend(jcfg.data, jax_features.Scaler.from_dict(d)),
            port_features.FeatureFrontend(cfg.data, port_features.Scaler.from_dict(d),
                                          device="cpu"), d)


def _compare(got, want, d, fmt):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape
    if fmt == "foa":  # errors in dB / IV units: scaled back by the scaler std
        mel_err = np.abs(got[..., :4] - want[..., :4]) * d["MEL"]["std"][0]
        iv_err = np.abs(got[..., 4:] - want[..., 4:]) * d["IV"]["std"][0]
        assert float(mel_err.max()) <= MEL_DB_TOL, float(mel_err.max())
        assert float(iv_err.max()) <= IV_TOL, float(iv_err.max())
    else:
        err = float(np.abs(got - want).max())
        assert err <= MIC_REL * float(np.abs(want).max()), err


@pytest.mark.parametrize("fmt", ["foa", "mic"])
@pytest.mark.parametrize("valid", [None, (FRAMES, 17)])
@pytest.mark.parametrize("n_fft,win", GEOMETRIES)
def test_frontend_matches_jax_at_other_geometries(n_fft, win, valid, fmt):
    """Flat audio: loud samples past a clip's valid frames must not move its
    dB peak, and its padded frames come out zero."""
    jf, pf, d = _frontends(n_fft, win, fmt)
    a = _flat_audio(seed=n_fft)
    v = None
    if valid is not None:
        v = np.asarray(valid, np.int32)
        a[1, valid[1] * HOP:] = 0.9  # padding far louder than the clip
    want = jf(jnp.asarray(a), None if v is None else jnp.asarray(v))
    got = pf(torch.tensor(a), None if v is None else torch.tensor(v))
    assert got.shape == (2, FRAMES, 64, 7 if fmt == "foa" else 10)
    _compare(got, want, d, fmt)
    if v is not None:
        assert float(got[1, valid[1]:].abs().max()) == 0.0


def test_se_resnet34_logits_match_jax_at_n_fft_2048():
    """Flat audio -> features -> SE-ResNet34 + AD-YOLO at (2048, 600, 1200),
    on seeded variables carried across."""
    jcfg, cfg = _cfgs(2048, 1200)
    d = _scaler_dict(seed=3)
    jf = jax_features.FeatureFrontend(jcfg.data, jax_features.Scaler.from_dict(d))
    pf = port_features.FeatureFrontend(cfg.data, port_features.Scaler.from_dict(d),
                                       device="cpu")
    jm = jax_build_model(jcfg, "float32")
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                            jnp.zeros((1, 32, 64, 7)), False))
    variables = _seeded_tree(shapes, np.random.default_rng(7))
    a = _flat_audio(seed=5, frames=32, extra=77)
    want = np.asarray(jax.jit(lambda v, x: jm.apply(v, jf(x), False))(
        variables, jnp.asarray(a)))
    tm = port_wrapper.build_model(cfg, device="cpu")
    tm.load_state_dict(state_dict_from_flax(variables), strict=True)
    with torch.no_grad():
        got = tm(pf(torch.tensor(a))).numpy()
    assert got.shape == want.shape == (2, 8, 8 * 4 * 5 * 16)
    assert np.isfinite(want).all() and float(np.abs(want).max()) > 0.1
    assert float(np.abs(got - want).max()) <= LOGIT_TOL


def test_cli_train_and_export_at_n_fft_2048(scratch_path):
    """The engine at the DCASE baseline's geometry: the loaders' flat audio
    through ``cli train --quick_test``, then ``cli export``, whose artifact
    takes flat audio and serves the live forward."""
    data = make_synth_dataset(str(scratch_path / "data"), n_train=2, n_val=1, n_test=1,
                              train_secs=1, eval_secs=2, chunk_window_s=1, seed=17)
    configs = scratch_path / "configs"
    configs.mkdir()
    with open(configs / "hyp_data_DCASE2022.yaml", "w") as f:
        yaml.safe_dump({"data_pth": data, "name_pth": os.path.join(data, "classes.txt"),
                        "chunk_window_s": 1, "n_fft": 2048, "win_length": 1200}, f)
    with open(configs / "hyp_train.yaml", "w") as f:
        yaml.safe_dump({"max_targets_per_clip": 64}, f)
    results = str(scratch_path / "results")
    exp_id = "geometry"
    assert cli.main(["train", "--quick_test", "--batch_size", "2", "--nb_iters", "1",
                     "--config_dir", str(configs), "--results_dir", results,
                     "--exp_id", exp_id, "--device", "cpu"]) == 0
    exp = os.path.join(results, exp_id)
    cfg = load_config(os.path.join(exp, "hyp_exp.yaml"))
    assert (cfg.data.n_fft, cfg.data.win_length, cfg.data.hop_length) == (2048, 1200, HOP)
    assert sorted(os.listdir(os.path.join(exp, "output_test"))) == ["test000.csv"]
    assert cli.main(["export", "--eval_pth", exp_id, "--results_dir", results,
                     "--device", "cpu"]) == 0
    call, meta = load_exported(os.path.join(exp, "export"), device="cpu")
    assert meta["input_layout"] == "flat" and meta["input_shape"] == [1, cfg.data.sr, 4]
    x = torch.tensor(_flat_audio(seed=9, frames=40, extra=0)[:1])
    served = call(x)
    model, _ = load_best_model(cfg, exp, "cpu")
    live = build_eval_forward(model, make_frontend(cfg, "cpu"))(x)
    assert served.shape == live.shape == tuple(meta["output_shape"])
    assert float((served - live).abs().max()) <= LIVE_TOL
