"""The port's serving export (``adyolo_tpu_torch.engine.export``) vs the
JAX package's (``adyolo_tpu.engine.export``), on the same weights.

Per encoder (SE-ResNet34, and ResNet-Conformer cut to 2 blocks on both
sides), one experiment directory is written by the JAX package's own
``init_state`` / ``save_config`` / ``save_checkpoint`` (seeded init, a
non-identity ``scaler_wts.pkl`` beside it, 2-s clips); the port reads the
checkpoint with its ``load_best_model`` (``convert.py``).  Both packages
export and serve 2-s clips of the same seeded audio: JAX's artifact
lowered for its CPU platform only (its TPU lowering is not run here), the
port's served on the CPU (the plain versions of its ops).  The counterparts of
``tests/test_export.py``:

* f32 round trip (``:18``, ``:134``): the port's served output equals its
  live eval forward within 1e-6 (B=2), and JAX's served output within
  1e-4 x max; ``meta.json`` holds JAX's keys and values but ``platforms``.
* the CLI parses ``export --serve_dtype bfloat16`` (``:53``); without it
  ``ADYOLO_SERVE_DTYPE`` picks the dtype in both packages.
* bf16 (``:66``): ``serve_dtype`` and ``output_dtype`` in meta; the
  port's served output no farther from a float64 forward (JAX's model in
  float64 on the same features) than 2x JAX's bf16 artifact is, plus
  2^-9 x max; and JAX's own gates against the f32 live forward.
* the conformer above ``BLOCK_THRESHOLD`` (lowered on both sides), the
  long eval route (``k4`` on the card, the query-blocked attention here).
* the decode loop (``:174``): the artifact's output through the
  ``PostProcessor`` of its bundled config gives the live decode's events.
* ``cli.main(["export", ...])`` on the JAX-written experiment.
"""
import dataclasses
import functools
import json
import os
import pickle

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from adyolo_tpu.config import Config, save_config, with_conf_thresh
from adyolo_tpu.engine import evaluate as jax_evaluate
from adyolo_tpu.engine.checkpoint import save_checkpoint
from adyolo_tpu.engine.export import export_model as jax_export_model
from adyolo_tpu.engine.export import load_exported as jax_load_exported
from adyolo_tpu.models import resnet_conformer as jax_rc
from adyolo_tpu.models import wrapper as jax_wrapper
from adyolo_tpu.parallel.train_step import init_state
from adyolo_tpu_torch import cli
from adyolo_tpu_torch.config import load_config
from adyolo_tpu_torch.engine.evaluate import (build_eval_forward, load_best_model,
                                              make_frontend)
from adyolo_tpu_torch.engine.export import export_model, load_exported
from adyolo_tpu_torch.models import resnet_conformer as port_rc
from adyolo_tpu_torch.models import wrapper as port_wrapper
from adyolo_tpu_torch.ops import attention
from adyolo_tpu_torch.ops.decode import PostProcessor

from tests.test_torch_config import (  # noqa: F401
    one_torch_thread, port_config, module_tmp, scratch_path)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

BLOCKS = 2
SECS = 2
EXP = "exp-export"
LIVE_TOL = 1e-6  # served vs live, as tests/test_export.py:62
JAX_TOL = 1e-4  # served vs JAX's served, x max|JAX| (the front-end's tolerance)
RATIO = 2.0  # the port's bf16 error at most this x JAX's
HALF_STEP = 2.0 ** -9
ENCODERS = ["se-resnet34", "resnet-conformer"]


@pytest.fixture(scope="module")
def two_blocks():
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_rc, "ResNetConformer",
               functools.partial(jax_rc.ResNetConformer, num_layers=BLOCKS))
    mp.setitem(port_wrapper.ENCODERS, "resnet-conformer",
               functools.partial(port_rc.ResNetConformer, num_layers=BLOCKS))
    yield
    mp.undo()


@pytest.fixture(scope="module")
def exps(two_blocks, module_tmp):
    """Per encoder: the JAX-written experiment and both packages' models."""
    out = {}
    for encoder in ENCODERS:
        root = str(module_tmp(encoder))
        data = os.path.join(root, "data")
        os.makedirs(data)
        rng = np.random.default_rng(4)
        scaler = {"MEL": {"mean": rng.uniform(-50, -20, (1, 64, 4)).astype(np.float32),
                          "std": rng.uniform(5, 15, (1, 64, 4)).astype(np.float32)},
                  "IV": {"mean": rng.uniform(-0.05, 0.05, (1, 64, 3)).astype(np.float32),
                         "std": rng.uniform(0.1, 0.4, (1, 64, 3)).astype(np.float32)}}
        with open(os.path.join(data, "scaler_wts.pkl"), "wb") as f:
            pickle.dump(scaler, f)
        jcfg = Config()
        jcfg = dataclasses.replace(
            jcfg, args=dataclasses.replace(jcfg.args, exp_id=EXP, encoder=encoder),
            data=dataclasses.replace(jcfg.data, data_pth=data, chunk_window_s=SECS))
        jfront = jax_evaluate.make_frontend(jcfg)
        jm = jax_wrapper.build_model(jcfg, "float32")
        state = jax.jit(lambda key: init_state(jcfg, jm, jfront, key))(jax.random.PRNGKey(7))
        results = os.path.join(root, "results")
        exp_dir = os.path.join(results, EXP)
        tau = 0.3
        save_config(with_conf_thresh(jcfg, tau), os.path.join(exp_dir, "hyp_exp.yaml"))
        save_checkpoint(os.path.join(exp_dir, "model_best.ckpt"), state,
                        {"epoch_nb": 0, "confidence_thresh": tau})
        cfg = port_config(jcfg)
        model, host = load_best_model(cfg, exp_dir, device="cpu")
        out[encoder] = {
            "jcfg": jcfg, "jfront": jfront, "root": root, "results": results,
            "exp_dir": exp_dir, "tau": tau,
            "variables": {"params": state.params, "batch_stats": state.batch_stats},
            "cfg": cfg, "model": model, "frontend": make_frontend(cfg, device="cpu")}
    return out


def _audio(B, seed=0, secs=SECS):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, secs * 24000, 4)) * 0.1).astype(np.float32)


def _live(e, audio):
    B = audio.shape[0]
    return build_eval_forward(e["model"], e["frontend"])(
        torch.tensor(audio).reshape(B, -1, 600, 4)).numpy()


def _both(e, tmp, B, serve_dtype="float32", seed=0, secs=SECS):
    """Each package's artifact of ``e`` served on the same audio."""
    audio = _audio(B, seed, secs)
    jdir = jax_export_model(e["jcfg"], e["variables"], e["jfront"], os.path.join(tmp, "jax"),
                            batch_size=B, seconds=secs, conf_thresh=e["tau"],
                            platforms=("cpu",), serve_dtype=serve_dtype)
    jcall, jmeta = jax_load_exported(jdir)
    pdir = export_model(e["cfg"], e["model"], e["frontend"], os.path.join(tmp, "port"),
                        batch_size=B, seconds=secs, conf_thresh=e["tau"],
                        serve_dtype=serve_dtype)
    call, meta = load_exported(pdir, device="cpu")
    return {"audio": audio, "jax": np.asarray(jcall(audio)), "jmeta": jmeta,
            "port": call(audio), "meta": meta, "dir": pdir}


@pytest.fixture(scope="module", params=ENCODERS)
def f32(request, exps, module_tmp):
    e = exps[request.param]
    return e, _both(e, str(module_tmp("f32")), B=2)


@pytest.fixture(scope="module", params=ENCODERS)
def bf16(request, exps, module_tmp):
    e = exps[request.param]
    res = _both(e, str(module_tmp("bf16")), B=1, serve_dtype="bfloat16",
                seed=1)
    # the truth: JAX's model in float64 on the port's features
    feat = e["frontend"](torch.tensor(res["audio"]).reshape(1, -1, 600, 4))
    with jax.enable_x64():
        jm = jax_wrapper.build_model(e["jcfg"]).clone(compute_dtype=jnp.float64)
        v = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), e["variables"])
        res["truth"] = np.asarray(jax.jit(lambda v, f: jm.apply(v, f, False))(
            v, jnp.asarray(feat.double().numpy())))
    return e, res


def test_f32_served_equals_live(f32):
    e, r = f32
    assert r["port"].dtype == torch.float32
    assert tuple(r["port"].shape) == tuple(r["meta"]["output_shape"]) == (2, 20, 2560)
    np.testing.assert_allclose(r["port"].numpy(), _live(e, r["audio"]),
                               atol=LIVE_TOL, rtol=LIVE_TOL)


def test_f32_served_matches_jax_served(f32):
    _, r = f32
    err = float(np.abs(r["port"].numpy() - r["jax"]).max())
    assert err <= JAX_TOL * float(np.abs(r["jax"]).max()), err


def test_meta_matches_jax(f32):
    _, r = f32
    assert r["meta"]["platforms"] == ["cuda", "cpu"]
    assert {k: v for k, v in r["meta"].items() if k != "platforms"} == \
        {k: v for k, v in r["jmeta"].items() if k != "platforms"}
    with open(os.path.join(r["dir"], "meta.json")) as f:
        assert json.load(f) == r["meta"]
    assert r["meta"]["input_layout"] == "hop_blocks"
    assert r["meta"]["input_shape"] == [2, SECS * 24000, 4]
    assert r["meta"]["confidence_thresh"] == 0.3 and r["meta"]["serve_dtype"] == "float32"


def test_export_cli_action_parses():
    args = cli.build_parser().parse_args(["export", "--eval_pth", "some-exp"])
    assert args.action == "export" and args.eval_pth == "some-exp"
    assert args.serve_dtype is None  # default float32
    args = cli.build_parser().parse_args(
        ["export", "--eval_pth", "e", "--serve_dtype", "bfloat16"])
    assert args.serve_dtype == "bfloat16"
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(["export", "--eval_pth", "e", "--serve_dtype",
                                       "float16"])


def test_bf16_meta(bf16):
    _, r = bf16
    assert r["meta"]["serve_dtype"] == r["jmeta"]["serve_dtype"] == "bfloat16"
    # the encoders' tails and the head run in f32: float32 output
    assert r["meta"]["output_dtype"] == r["jmeta"]["output_dtype"] == "float32"
    assert r["port"].dtype == torch.float32


def test_bf16_as_close_to_float64_as_jax(bf16):
    _, r = bf16
    truth = r["truth"]
    err = float(np.abs(r["port"].double().numpy() - truth).max())
    err_jax = float(np.abs(r["jax"].astype(np.float64) - truth).max())
    floor = HALF_STEP * float(np.abs(truth).max())
    assert err <= RATIO * err_jax + floor, (err, err_jax, floor)


def test_bf16_within_jax_gates_of_f32_live(bf16):
    e, r = bf16
    d = np.abs(r["port"].numpy() - _live(e, r["audio"]))
    assert d.max() < 0.1 and d.mean() < 0.01, (d.max(), d.mean())
    assert d.max() > 0  # the encoder did compute in bf16


def test_serve_dtype_from_the_environment(exps, scratch_path, monkeypatch):
    """Without ``serve_dtype``, ``ADYOLO_SERVE_DTYPE`` sets the artifact's
    dtype in both packages' ``export_model`` (``adyolo_tpu/engine/
    export.py:58-59``): bfloat16 in both metas, the served output within
    JAX's gates of the f32 live forward and not equal to it; a value
    outside float32 / bfloat16 is refused."""
    e = exps["se-resnet34"]
    monkeypatch.setenv("ADYOLO_SERVE_DTYPE", "bfloat16")
    r = _both(e, str(scratch_path), B=1, serve_dtype=None, seed=1)
    assert r["meta"]["serve_dtype"] == r["jmeta"]["serve_dtype"] == "bfloat16"
    d = np.abs(r["port"].numpy() - _live(e, r["audio"]))
    assert 0 < d.max() < 0.1 and d.mean() < 0.01, (d.max(), d.mean())
    monkeypatch.setenv("ADYOLO_SERVE_DTYPE", "float16")
    with pytest.raises(ValueError, match="serve_dtype 'float16'"):
        export_model(e["cfg"], e["model"], e["frontend"], str(scratch_path / "bad"))


def test_conformer_long_clip(exps, scratch_path, monkeypatch):
    """Above the block threshold: the long eval route of both packages."""
    monkeypatch.setattr(attention, "BLOCK_THRESHOLD", 40)
    monkeypatch.setattr(jax_rc.MHSA, "BLOCK_THRESHOLD", 40)
    e = exps["resnet-conformer"]
    r = _both(e, str(scratch_path), B=1, seed=2)
    assert r["port"].shape == (1, 20, 2560)
    np.testing.assert_allclose(r["port"].numpy(), _live(e, r["audio"]),
                               atol=LIVE_TOL, rtol=LIVE_TOL)
    err = float(np.abs(r["port"].numpy() - r["jax"]).max())
    assert err <= JAX_TOL * float(np.abs(r["jax"]).max()), err


@pytest.mark.parametrize("encoder", ENCODERS)
def test_cli_export_and_decode_loop(exps, encoder):
    """``cli export`` on the JAX-written experiment, then the artifact's
    output through the PostProcessor of its bundled config: the live
    decode's events."""
    e = exps[encoder]
    assert cli.main(["export", "--eval_pth", EXP, "--results_dir", e["results"],
                     "--device", "cpu"]) == 0
    out_dir = os.path.join(e["exp_dir"], "export")
    assert sorted(os.listdir(out_dir)) == ["hyp_exp.yaml", "meta.json", "model.pt2"]
    call, meta = load_exported(out_dir, device="cpu")
    assert meta["input_shape"] == [1, SECS * 24000, 4] and meta["serve_dtype"] == "float32"
    assert meta["confidence_thresh"] == e["tau"]
    audio = _audio(1, seed=3) * 3.0
    served = call(audio)
    live = _live(e, audio)
    np.testing.assert_allclose(served.numpy(), live, atol=LIVE_TOL, rtol=LIVE_TOL)

    pp = PostProcessor(load_config(os.path.join(out_dir, "hyp_exp.yaml")))
    pp.set_conf_thresh(meta["confidence_thresh"])
    events = pp.postprocess(served)
    pp_live = PostProcessor(e["cfg"])
    pp_live.set_conf_thresh(meta["confidence_thresh"])
    events_live = pp_live.postprocess(torch.tensor(live))
    assert events and set(events) == set(events_live)
    for fr in events:
        a, b = np.asarray(events[fr]), np.asarray(events_live[fr])
        assert a.shape == b.shape, fr
        np.testing.assert_allclose(a, b, atol=1e-4)


def test_export_refuses_a_missing_experiment(tmp_path):
    with pytest.raises(SystemExit, match="no experiment"):
        cli.main(["export", "--eval_pth", "nope", "--results_dir", str(tmp_path),
                  "--device", "cpu"])
    with pytest.raises(SystemExit, match="--eval_pth"):
        cli.main(["export", "--results_dir", str(tmp_path), "--device", "cpu"])
