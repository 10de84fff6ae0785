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

The geometries only the frames kernel takes, at 44.1 kHz with the DCASE
preset's 25-ms hop (1102 samples): G3, n_fft = 2 hop = 2204 = 2^2 19 29
(the loaders' hop-block layout where a clip is a hop multiple, flat where
it is not), and G5, the exact 50-ms window, an odd 2205 = 3^2 5 7^2:

* ``FeatureFrontend``, FOA and MIC, with and without ``valid_frames``, at
  G3 and G5 on flat audio, and at G3 on hop-block audio, within the bounds
  above;
* SE-ResNet34 + AD-YOLO logits at G3, and at G6 (96 kHz, n_fft = win =
  9600, hop 2400: the frames kernel's route four_step on the card), on
  seeded variables, 32 frames, within 1e-4 abs;
* ``cli train --quick_test`` + ``cli export`` at G3 (flat 1-s artifact),
  served within 1e-6 of the live forward; ``export_model`` at G5, whose
  traced STFT op gives n_fft // 2 + 1 = 1103 bins, served within 1e-6 of
  the live forward.
"""
import dataclasses
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import yaml
from torch._subclasses.fake_tensor import FakeTensorMode

from adyolo_tpu import config as jax_config
from adyolo_tpu.ops import features as jax_features
from adyolo_tpu.models.wrapper import build_model as jax_build_model
from adyolo_tpu_torch import cli
from adyolo_tpu_torch.config import load_config
from adyolo_tpu_torch.convert import state_dict_from_flax
from adyolo_tpu_torch.engine.evaluate import (build_eval_forward, load_best_model,
                                              make_frontend)
from adyolo_tpu_torch.engine.export import export_model, load_exported
from adyolo_tpu_torch.models import wrapper as port_wrapper
from adyolo_tpu_torch.ops import features as port_features
from adyolo_tpu_torch.ops import hopper_stft

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
# (sr, hop, n_fft, win_length) of G3, G5 and G6 (96 kHz, a 100-ms window:
# the frames kernel's route four_step)
G3 = (44100, 1102, 2204, 2204)
G5 = (44100, 1102, 2205, 2205)
G6 = (96000, 2400, 9600, 9600)
FRAMES = 30
LIVE_TOL = 1e-6  # served vs live, as tests/test_torch_export.py


def _cfgs(n_fft, win, fmt="foa", sr=24000, hop=HOP):
    jcfg = jax_config.Config()
    jcfg = dataclasses.replace(jcfg, data=dataclasses.replace(
        jcfg.data, n_fft=n_fft, win_length=win, audio_format=fmt, sr=sr, hop_length=hop))
    return jcfg, port_config(jcfg)


def _flat_audio(seed, frames=FRAMES, extra=123, hop=HOP):
    """int16-range noise as the loaders normalise it, (2, frames hops +
    extra, 4), its first samples louder (the reflected left edge)."""
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal((2, frames * hop + extra, 4)) * 1500).astype(np.int16)
    a = (a / 32768.0 + 1e-8).astype(np.float32)
    a[:, :2 * hop] *= 3.0
    return a


def _frontends(n_fft, win, fmt, sr=24000, hop=HOP):
    jcfg, cfg = _cfgs(n_fft, win, fmt, sr, hop)
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


@pytest.mark.parametrize("fmt", ["foa", "mic"])
@pytest.mark.parametrize("valid", [None, (FRAMES, 17)])
@pytest.mark.parametrize("sr,hop,n_fft,win", [G3, G5])
def test_frontend_matches_jax_at_44k(sr, hop, n_fft, win, valid, fmt):
    """G3 and G5 on flat audio, as at the 24-kHz geometries above."""
    jf, pf, d = _frontends(n_fft, win, fmt, sr, hop)
    a = _flat_audio(seed=n_fft, hop=hop)
    v = None
    if valid is not None:
        v = np.asarray(valid, np.int32)
        a[1, valid[1] * hop:] = 0.9
    want = jf(jnp.asarray(a), None if v is None else jnp.asarray(v))
    got = pf(torch.tensor(a), None if v is None else torch.tensor(v))
    assert got.shape == (2, FRAMES, 64, 7 if fmt == "foa" else 10)
    if fmt == "foa":
        _compare(got, want, d, fmt)
    else:
        _compare_mic_frame0_apart(jf, pf, d, a, got, want)
    if v is not None:
        assert float(got[1, valid[1]:].abs().max()) == 0.0


def _compare_mic_frame0_apart(jf, pf, d, a, got, want):
    """MIC features, frame 0's GCC-PHAT block apart.  Frame 0 of a
    center=True STFT is the clip's start reflected, nearly even about its
    centre, so its spectra are nearly real and cross zero from bin to bin;
    PHAT divides by |R|, and at a bin where |X| ~ 5e-6 (G3, channel 3,
    bin 48 of this audio) float32's ~5e-7 rounding of the STFT, in either
    package, turns the phase by 0.035.  So every other value is held to
    JAX end to end within 1e-4 x max; frame 0's GCC-PHAT block to JAX's
    GCC-PHAT (``_gcc_phat_mel``) of the port's own STFT, normalised alike;
    and the port's STFT to JAX's within 2e-5 x max."""
    got, want = got.numpy(), np.asarray(want)
    scale = float(np.abs(want).max())
    keep = np.ones(got.shape, bool)
    keep[:, 0, :, 4:] = False
    assert float(np.abs(got - want)[keep].max()) <= MIC_REL * scale
    re, im = pf.stft(torch.tensor(a))
    jre, jim = jf.stft(jnp.asarray(a))
    stft_scale = float(np.abs(np.asarray(jre)).max())
    assert float(np.abs(re.numpy() - np.asarray(jre)).max()) <= 2e-5 * stft_scale
    assert float(np.abs(im.numpy() - np.asarray(jim)).max()) <= 2e-5 * stft_scale
    gcc = np.asarray(jax_features._gcc_phat_mel(jnp.asarray(re.numpy()), jnp.asarray(im.numpy()),
                                                jf._lag_c, jf._lag_s))
    gcc = (gcc - d["GCC"]["mean"][0]) / d["GCC"]["std"][0]
    assert float(np.abs(got[:, 0, :, 4:] - gcc[:, 0]).max()) <= MIC_REL * scale


def test_frontend_hop_blocks_match_jax_at_g3():
    """At G3 the loaders hand hop-block audio (B, T, 1102, 4) to the
    front-end: JAX frames it by ``framed_dft_chunked``, the port by the
    same plain contraction on the CPU and by the frames kernel reading its
    flat view on the card (``hopper_stft.kernels_of``)."""
    sr, hop, n_fft, win = G3
    jf, pf, d = _frontends(n_fft, win, "foa", sr, hop)
    a = _flat_audio(seed=31, extra=0, hop=hop).reshape(2, FRAMES, hop, 4)
    _compare(pf(torch.tensor(a)), jf(jnp.asarray(a)), d, "foa")
    assert hopper_stft.kernels_of(n_fft, hop) == {"stft_frames_fft_kernel": 1}


def _logits_at(geometry, var_seed, audio_seed):
    """JAX's and the port's SE-ResNet34 + AD-YOLO logits from flat audio
    of 32 frames at ``geometry`` (sr, hop, n_fft, win), on seeded variables
    carried across."""
    sr, hop, n_fft, win = geometry
    jcfg, cfg = _cfgs(n_fft, win, sr=sr, hop=hop)
    d = _scaler_dict(seed=3)
    jf = jax_features.FeatureFrontend(jcfg.data, jax_features.Scaler.from_dict(d))
    pf = port_features.FeatureFrontend(cfg.data, port_features.Scaler.from_dict(d),
                                       device="cpu")
    jm = jax_build_model(jcfg, "float32")
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                            jnp.zeros((1, 32, 64, 7)), False))
    variables = _seeded_tree(shapes, np.random.default_rng(var_seed))
    a = _flat_audio(seed=audio_seed, frames=32, extra=77, hop=hop)
    want = np.asarray(jax.jit(lambda v, x: jm.apply(v, jf(x), False))(
        variables, jnp.asarray(a)))
    tm = port_wrapper.build_model(cfg, device="cpu")
    tm.load_state_dict(state_dict_from_flax(variables), strict=True)
    with torch.no_grad():
        got = tm(pf(torch.tensor(a))).numpy()
    return got, want


def _check_logits(got, want):
    assert got.shape == want.shape == (2, 8, 8 * 4 * 5 * 16)
    assert np.isfinite(want).all() and float(np.abs(want).max()) > 0.1
    assert float(np.abs(got - want).max()) <= LOGIT_TOL


def test_se_resnet34_logits_match_jax_at_g6():
    """Flat audio -> features -> SE-ResNet34 + AD-YOLO at G6 (96 kHz, n_fft
    = win = 9600, hop 2400, 32 frames), on seeded variables carried across,
    within G3's bound; on the card the frames kernel's route four_step (one
    frame a block, one launch) frames it."""
    _check_logits(*_logits_at(G6, var_seed=9, audio_seed=16))
    assert hopper_stft.kernels_of(G6[2], G6[1]) == {"stft_frames_4step_kernel": 1}


def test_se_resnet34_logits_match_jax_at_g3():
    """Flat audio -> features -> SE-ResNet34 + AD-YOLO at G3, on seeded
    variables carried across."""
    _check_logits(*_logits_at(G3, var_seed=8, audio_seed=6))


def test_se_resnet34_logits_match_jax_at_n_fft_2048():
    """Flat audio -> features -> SE-ResNet34 + AD-YOLO at (2048, 600, 1200),
    on seeded variables carried across."""
    _check_logits(*_logits_at((24000, HOP, 2048, 1200), var_seed=7, audio_seed=5))


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


def test_cli_train_and_export_at_g3(scratch_path):
    """The engine at G3: 44.1-kHz clips through ``cli train --quick_test``
    (20-s chunks are not hop multiples at hop 1102, so training takes flat
    audio; eval clips are padded to hop multiples, hop-block audio), then
    ``cli export``, whose 1-s artifact takes flat audio (44100 samples)
    and serves the live forward."""
    sr, hop, n_fft, win = G3
    data = make_synth_dataset(str(scratch_path / "data"), sr=sr, n_train=2, n_val=1,
                              n_test=1, train_secs=1, eval_secs=2, chunk_window_s=1, seed=18)
    configs = scratch_path / "configs"
    configs.mkdir()
    with open(configs / "hyp_data_DCASE2022.yaml", "w") as f:
        yaml.safe_dump({"data_pth": data, "name_pth": os.path.join(data, "classes.txt"),
                        "chunk_window_s": 1, "sr": sr, "hop_length": hop, "n_fft": n_fft,
                        "win_length": win}, f)
    with open(configs / "hyp_train.yaml", "w") as f:
        yaml.safe_dump({"max_targets_per_clip": 64}, f)
    results = str(scratch_path / "results")
    exp_id = "g3"
    assert cli.main(["train", "--quick_test", "--batch_size", "2", "--nb_iters", "1",
                     "--config_dir", str(configs), "--results_dir", results,
                     "--exp_id", exp_id, "--device", "cpu"]) == 0
    exp = os.path.join(results, exp_id)
    cfg = load_config(os.path.join(exp, "hyp_exp.yaml"))
    assert (cfg.data.sr, cfg.data.hop_length, cfg.data.n_fft, cfg.data.win_length) == G3
    assert cfg.data.feat_frames_per_label_frame == 4
    assert sorted(os.listdir(os.path.join(exp, "output_test"))) == ["test000.csv"]
    assert cli.main(["export", "--eval_pth", exp_id, "--results_dir", results,
                     "--device", "cpu"]) == 0
    call, meta = load_exported(os.path.join(exp, "export"), device="cpu")
    assert meta["input_layout"] == "flat" and meta["input_shape"] == [1, sr, 4]
    x = torch.tensor(_flat_audio(seed=10, frames=40, extra=20, hop=hop)[:1])
    assert x.shape[1] == sr
    served = call(x)
    model, _ = load_best_model(cfg, exp, "cpu")
    live = build_eval_forward(model, make_frontend(cfg, "cpu"))(x)
    assert served.shape == live.shape == tuple(meta["output_shape"])
    assert float((served - live).abs().max()) <= LIVE_TOL


def test_export_at_an_odd_n_fft(scratch_path):
    """``export_model`` at G5 (n_fft 2205): the traced ``adyolo::stft``
    op's fake kernel gives 1103 bins, the artifact's meta names its flat
    input and the output the live forward gives, and it serves that forward
    within 1e-6."""
    sr, hop, n_fft, win = G5
    _, cfg = _cfgs(n_fft, win, sr=sr, hop=hop)
    torch.manual_seed(0)
    model = port_wrapper.build_model(cfg, device="cpu").eval()
    fe = make_frontend(cfg, "cpu")
    with FakeTensorMode():
        re, _ = torch.ops.adyolo.stft(torch.empty(1, sr, 4), torch.empty(3 * n_fft), hop)
    assert tuple(re.shape) == (1, sr // hop, n_fft // 2 + 1, 4) == (1, 40, 1103, 4)
    out = export_model(cfg, model, fe, str(scratch_path / "g5"), seconds=1.0)
    call, meta = load_exported(out, device="cpu")
    assert meta["input_layout"] == "flat" and meta["input_shape"] == [1, sr, 4]
    x = torch.tensor(_flat_audio(seed=12, frames=40, extra=20, hop=hop)[:1])
    with torch.no_grad():
        live = model(fe(x))
    served = call(x)
    assert served.shape == live.shape == tuple(meta["output_shape"])
    assert float((served - live).abs().max()) <= LIVE_TOL
