"""bf16 and SE-ResNet34 training through the port's CLI (``cli.main([...,
"--device", "cpu"])``), on a synthetic DCASE-layout set (1-s training
chunks, 2-s val/test clips), B = 2, 1 step an epoch.

* ``train --encoder se-resnet34 --compute_dtype bfloat16 --remat``, the
  system's default encoder in bf16 (``--remat`` does nothing to it, as in
  JAX): an epoch with val and test runs; ``hyp_exp.yaml`` keeps the
  dtype; both checkpoints hold float32 parameters and running stats
  (``model_best.ckpt`` in the JAX file format, which refuses bfloat16
  arrays, and the resumable ``model_ckpt.ckpt`` with its float32 Adam
  moments); the trained model is in bf16 (``compute_dtype``) and in
  training mode computed a bfloat16 stack, yet the engine's eval forward
  of it equals (``torch.equal``) the float32 model's eval forward of the
  same weights: val, test and the tau scan run in float32.
* ``train --encoder resnet-conformer --compute_dtype bfloat16 --remat``
  (Conformer cut to 2 blocks): an epoch runs, with finite losses.
* ``val`` of the bf16 SE-ResNet34 experiment prints five finite scores.
* ``train`` with the defaults (no ``--encoder``, no dtype flag): the
  system's default training command trains SE-ResNet34 in float32.
"""
import functools
import json
import os

import numpy as np
import pytest
import torch
import yaml

from adyolo_tpu_torch import cli
from adyolo_tpu_torch.config import load_config
from adyolo_tpu_torch.engine import evaluate
from adyolo_tpu_torch.engine import train as port_train
from adyolo_tpu_torch.engine.checkpoint import load_jax_checkpoint
from adyolo_tpu_torch.models import resnet_conformer as port_rc
from adyolo_tpu_torch.models import wrapper as port_wrapper

from tests.synth_data import make_synth_dataset
from tests.test_torch_config import one_torch_thread, module_tmp  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def setup(module_tmp):
    root = str(module_tmp("engine_bf16"))
    data = make_synth_dataset(os.path.join(root, "data"), n_train=2, n_val=2, n_test=1,
                              train_secs=1, eval_secs=2, chunk_window_s=1, seed=5)
    configs = os.path.join(root, "configs")
    os.makedirs(configs)
    with open(os.path.join(configs, "hyp_data_DCASE2022.yaml"), "w") as f:
        yaml.safe_dump({"data_pth": data, "name_pth": os.path.join(data, "classes.txt"),
                        "chunk_window_s": 1}, f)
    with open(os.path.join(configs, "hyp_train.yaml"), "w") as f:
        yaml.safe_dump({"max_targets_per_clip": 64}, f)
    return {"root": root, "configs": configs, "results": os.path.join(root, "results")}


def _argv(setup, exp_id, encoder, *extra):
    return ["train", "--encoder", encoder, "--compute_dtype", "bfloat16", "--remat",
            "--logger", "--batch_size", "2", "--nb_iters", "1", "--nb_epochs", "1",
            "--config_dir", setup["configs"], "--results_dir", setup["results"],
            "--exp_id", exp_id, "--device", "cpu", *extra]


def _losses(exp):
    with open(os.path.join(exp, "logs.jsonl")) as f:
        logs = [json.loads(ln) for ln in f]
    return {r["channel"]: r["value"] for r in logs if r["channel"].endswith("/loss")}


@pytest.fixture(scope="module")
def se_bf16(setup):
    rec = {}
    mp = pytest.MonkeyPatch()
    try:
        orig = port_train.build_model

        def build_model(*a, **kw):
            rec["model"] = orig(*a, **kw)
            return rec["model"]

        mp.setattr(port_train, "build_model", build_model)
        assert cli.main(_argv(setup, "se_bf16", "se-resnet34")) == 0
    finally:
        mp.undo()
    rec["exp"] = os.path.join(setup["results"], "se_bf16")
    return rec


def test_se_resnet34_bf16_trains_an_epoch(se_bf16):
    exp = se_bf16["exp"]
    cfg = load_config(os.path.join(exp, "hyp_exp.yaml"))
    assert cfg.args.encoder == "se-resnet34"
    assert cfg.train.compute_dtype == "bfloat16" and cfg.train.remat
    losses = _losses(exp)
    assert set(losses) == {"logs/train/loss", "logs/val/loss", "logs/test/loss"}
    assert all(np.isfinite(v) for v in losses.values())
    assert se_bf16["model"].compute_dtype == torch.bfloat16


def test_bf16_checkpoints_hold_float32(se_bf16):
    exp = se_bf16["exp"]
    variables, host = load_jax_checkpoint(os.path.join(exp, "model_best.ckpt"))
    leaves = []

    def walk(t):
        for v in t.values():
            walk(v) if isinstance(v, dict) else leaves.append(v)

    walk(variables)
    assert leaves and {a.dtype for a in leaves} == {np.dtype(np.float32)}
    payload = torch.load(os.path.join(exp, "model_ckpt.ckpt"), weights_only=False)
    assert {t.dtype for t in payload["model"].values()} == {torch.float32}
    moments = [t for s in payload["optimizer"]["state"].values() for n, t in s.items()
               if n in ("exp_avg", "exp_avg_sq")]
    assert moments and {t.dtype for t in moments} == {torch.float32}


def test_eval_after_bf16_training_is_the_float32_forward(se_bf16):
    """The engine's eval forward of the bf16-trained model equals the
    eval forward of a float32 model holding the same weights."""
    cfg = load_config(os.path.join(se_bf16["exp"], "hyp_exp.yaml"))
    model = se_bf16["model"]
    fe = evaluate.make_frontend(cfg, device="cpu")
    ref = port_wrapper.build_model(
        load_config(os.path.join(se_bf16["exp"], "hyp_exp.yaml")), device="cpu")
    ref.compute_dtype = None
    ref.load_state_dict(model.state_dict())
    audio = (np.random.default_rng(0).standard_normal((1, 2 * cfg.data.sr, 4)) * 0.1
             ).astype(np.float32)
    got = evaluate.build_eval_forward(model, fe)(audio)
    want = evaluate.build_eval_forward(ref, fe)(audio)
    assert got.dtype == torch.float32 and torch.equal(got, want)
    # training mode does compute in bfloat16: from the same dropout bits,
    # its forward differs from the float32 model's
    model.train()
    with torch.no_grad():
        feat = fe(torch.tensor(audio))
        got = model(feat, generator=torch.Generator().manual_seed(0))
        want = ref.train()(feat, generator=torch.Generator().manual_seed(0))
    assert not torch.equal(got, want)
    assert float((got - want).abs().max()) < 0.1 * float(want.abs().max())


def test_val_of_a_bf16_experiment(se_bf16, setup, capsys):
    assert cli.main(["val", "--eval_pth", "se_bf16", "--results_dir", setup["results"],
                     "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "SELD" in out


def test_conformer_bf16_remat_trains_an_epoch(setup):
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(port_wrapper.ENCODERS, "resnet-conformer",
                   functools.partial(port_rc.ResNetConformer, num_layers=2))
        assert cli.main(_argv(setup, "conf_bf16", "resnet-conformer")) == 0
    exp = os.path.join(setup["results"], "conf_bf16")
    cfg = load_config(os.path.join(exp, "hyp_exp.yaml"))
    assert cfg.train.compute_dtype == "bfloat16" and cfg.train.remat
    assert all(np.isfinite(v) for v in _losses(exp).values())


def test_default_train_command_trains_se_resnet34_f32(setup):
    argv = ["train", "--logger", "--batch_size", "2", "--nb_iters", "1", "--nb_epochs", "1",
            "--config_dir", setup["configs"], "--results_dir", setup["results"],
            "--exp_id", "default", "--device", "cpu"]
    assert cli.main(argv) == 0
    exp = os.path.join(setup["results"], "default")
    cfg = load_config(os.path.join(exp, "hyp_exp.yaml"))
    assert cfg.args.encoder == "se-resnet34"
    assert cfg.train.compute_dtype == "float32" and not cfg.train.remat
    assert all(np.isfinite(v) for v in _losses(exp).values())
