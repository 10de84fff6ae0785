"""The port's training engine through ``adyolo_tpu_torch.cli.main([...,
"--device", "cpu"])``, on a synthetic DCASE-layout set (1-s training
chunks, 2-s and 3-s val/test clips), ResNet-Conformer + AD-YOLO at full
width with its Conformer cut to 2 blocks, B = 2, ``--augment`` (rotation
and SpecAugment) and ``--logger``.

* ``train --quick_test``: the artifacts (``hyp_exp.yaml``, both
  checkpoints, ``logs.jsonl`` with epochs 1-3, one CSV per val and test
  clip), and epoch 1's per-step losses equal (``torch.equal``) to
  ``build_train_step`` run on the JAX package's ``TrainLoader`` batches, in
  order, from the same seeds.  The scan interval is cut to 3 epochs for
  this run, so epoch 3 runs the τ-arbitration: the frozen ``conf_thresh``
  becomes the τ the scan picked.
* The best checkpoint, read back by ``load_jax_checkpoint`` +
  ``state_dict_from_flax``, equals the weights the engine held when it
  wrote it; the JAX model applied to those variables gives the port's
  logits within 1e-4 * max|logit|.
* ``val`` / ``test`` of the trained experiment print five finite scores.
* Resume: 2 epochs straight and 1 epoch + ``--resume_pth`` for 1 more give
  equal (``torch.equal``) weights, BatchNorm stats and Adam state, the same
  logged losses and the same RNG state and sampler pool.
* ``train`` with a configuration the port does not train (a float16
  compute dtype, for either encoder) raises before it creates a
  directory, and the JAX arguments the port does not implement are
  refused, whatever their value.  SE-ResNet34 and bf16 training through the CLI are held in
  ``tests/test_torch_engine_bf16.py``.
"""
import copy
import functools
import json
import os
import random
import shutil

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import yaml

from adyolo_tpu import config as jax_config
from adyolo_tpu.data import dataset as jax_dataset
from adyolo_tpu.models import resnet_conformer as jax_rc
from adyolo_tpu.models import wrapper as jax_wrapper
from adyolo_tpu_torch import cli
from adyolo_tpu_torch.config import load_config
from adyolo_tpu_torch.convert import state_dict_from_flax
from adyolo_tpu_torch.engine import evaluate
from adyolo_tpu_torch.engine import train as port_train
from adyolo_tpu_torch.engine.checkpoint import load_jax_checkpoint
from adyolo_tpu_torch.models import resnet_conformer as port_rc
from adyolo_tpu_torch.models import wrapper as port_wrapper
from adyolo_tpu_torch.parallel.train_step import build_train_step

from tests.synth_data import make_synth_dataset
from tests.test_torch_config import one_torch_thread, module_tmp  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

BLOCKS = 2
LOGIT_REL = 1e-4
SEED = 100


@pytest.fixture(scope="module")
def shallow():
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_rc, "ResNetConformer",
               functools.partial(jax_rc.ResNetConformer, num_layers=BLOCKS))
    mp.setitem(port_wrapper.ENCODERS, "resnet-conformer",
               functools.partial(port_rc.ResNetConformer, num_layers=BLOCKS))
    yield
    mp.undo()


@pytest.fixture(scope="module")
def setup(shallow, module_tmp):
    root = str(module_tmp("engine"))
    data = make_synth_dataset(os.path.join(root, "data"), n_train=6, n_val=2, n_test=2,
                              train_secs=1, eval_secs=2, chunk_window_s=1, seed=4)
    configs = os.path.join(root, "configs")
    os.makedirs(configs)
    with open(os.path.join(configs, "hyp_data_DCASE2022.yaml"), "w") as f:
        yaml.safe_dump({"data_pth": data, "name_pth": os.path.join(data, "classes.txt"),
                        "chunk_window_s": 1}, f)
    with open(os.path.join(configs, "hyp_train.yaml"), "w") as f:
        yaml.safe_dump({"max_targets_per_clip": 64}, f)
    return {"root": root, "configs": configs, "results": os.path.join(root, "results")}


def _train_argv(setup, exp_id, *extra):
    return ["train", "--encoder", "resnet-conformer", "--augment", "--logger",
            "--batch_size", "2", "--nb_iters", "2", "--seed", str(SEED),
            "--config_dir", setup["configs"], "--results_dir", setup["results"],
            "--exp_id", exp_id, "--device", "cpu", *extra]


def _logs(exp_dir):
    with open(os.path.join(exp_dir, "logs.jsonl")) as f:
        return [json.loads(ln) for ln in f]


@pytest.fixture(scope="module")
def quick(setup):
    """One ``train --quick_test`` run, recording each step's loss, the model,
    its weights at each best-checkpoint write and the τ scan."""
    rec = {"losses": [], "best": [], "scan": []}
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(port_train, "SCAN_EVERY", 3)
        orig_step, orig_model = port_train.build_train_step, port_train.build_model
        orig_save, orig_scan = port_train.save_jax_checkpoint, port_train.scan_conf_thresh

        def build_model(*a, **kw):
            rec["model"] = orig_model(*a, **kw)
            return rec["model"]

        def build_step(*a, **kw):
            step = orig_step(*a, **kw)

            def recorded(batch, gen):
                loss = step(batch, gen)
                rec["losses"].append(loss.clone())
                return loss

            recorded.optimizer, recorded.plan = step.optimizer, step.plan
            return recorded

        def save_best(path, variables, host, *opt):
            rec["best"].append(copy.deepcopy(rec["model"].state_dict()))
            return orig_save(path, variables, host, *opt)

        def scan(*a, **kw):
            rec["scan"].append(orig_scan(*a, **kw))
            return rec["scan"][-1]

        mp.setattr(port_train, "build_model", build_model)
        mp.setattr(port_train, "build_train_step", build_step)
        mp.setattr(port_train, "save_jax_checkpoint", save_best)
        mp.setattr(port_train, "scan_conf_thresh", scan)
        assert cli.main(_train_argv(setup, "quick", "--quick_test")) == 0
    finally:
        mp.undo()
    rec["exp"] = os.path.join(setup["results"], "quick")
    return rec


def test_quick_test_artifacts_and_logs(quick):
    exp = quick["exp"]
    for name in ("hyp_exp.yaml", "model_best.ckpt", "model_ckpt.ckpt", "logs.jsonl"):
        assert os.path.isfile(os.path.join(exp, name)), name
    assert sorted(os.listdir(os.path.join(exp, "output_val"))) == ["val000.csv", "val001.csv"]
    assert sorted(os.listdir(os.path.join(exp, "output_test"))) == ["test000.csv", "test001.csv"]
    logs = _logs(exp)
    for split in ("train", "val", "test"):
        steps = [r["step"] for r in logs if r["channel"] == f"logs/{split}/loss"]
        assert steps == [1, 2, 3], split
    assert all(np.isfinite(r["value"]) for r in logs if r["channel"].endswith("/loss"))
    assert len(quick["losses"]) == 3 * 2  # 3 epochs x nb_iters 2 (< 5)
    for split in ("val", "test"):
        for m in ("ER", "F1", "LE", "LR", "SELD"):
            vals = [r["value"] for r in logs if r["channel"] == f"logs/{split}/{m}"]
            assert len(vals) == 3 and all(np.isfinite(vals))


def test_epoch1_losses_equal_the_step_on_jax_loader_batches(quick):
    exp = quick["exp"]
    jcfg = jax_config.load_config(os.path.join(exp, "hyp_exp.yaml"))
    cfg = load_config(os.path.join(exp, "hyp_exp.yaml"))
    assert cfg.aug.rotation_augment and cfg.aug.spec_augment
    random.seed(SEED)
    np.random.seed(SEED)
    batches = list(jax_dataset.TrainLoader(jax_dataset.SELDDataset(jcfg, "train"), jcfg))
    assert len(batches) == 2
    model = port_wrapper.build_model(cfg, device="cpu",
                                     generator=torch.Generator().manual_seed(SEED), train=True)
    step = build_train_step(cfg, model, evaluate.make_frontend(cfg, device="cpu"))
    gen = torch.Generator().manual_seed(SEED)
    for i, b in enumerate(batches):
        assert torch.equal(step(b, gen), quick["losses"][i]), i


def test_tau_scan_rewrites_the_frozen_threshold(quick):
    assert len(quick["scan"]) == 1  # epoch 3 of 3
    tau, scan = quick["scan"][0]
    assert [t for t, _ in scan["scores"]] == list(port_train.TAU_SCAN)
    assert tau == min(scan["scores"], key=lambda r: (r[1][4], r[0]))[0]
    cfg = load_config(os.path.join(quick["exp"], "hyp_exp.yaml"))
    assert cfg.train.conf_thresh == tau and cfg.train.clss_thresh == tau
    logged = [(r["value"], r.get("step")) for r in _logs(quick["exp"])
              if r["channel"] == "logs/train/conf_thresh"]
    assert logged == [(0.5, None), (tau, 3)]


def test_best_checkpoint_reads_back_and_runs_in_jax(quick):
    cfg = load_config(os.path.join(quick["exp"], "hyp_exp.yaml"))
    variables, host = load_jax_checkpoint(os.path.join(quick["exp"], "model_best.ckpt"))
    assert 1 <= host["epoch_nb"] <= 3
    best = quick["best"][-1]
    got = state_dict_from_flax(variables, "resnet-conformer")
    assert got.keys() == best.keys()
    for k, v in best.items():
        assert torch.equal(torch.as_tensor(got[k]), v), k

    model = port_wrapper.build_model(cfg, device="cpu")
    model.load_state_dict(got)
    feat = np.random.default_rng(0).standard_normal((1, 40, 64, 7)).astype(np.float32)
    with torch.no_grad():
        want_port = model(torch.tensor(feat)).numpy()
    jm = jax_wrapper.build_model(jax_config.load_config(
        os.path.join(quick["exp"], "hyp_exp.yaml")), "float32")
    jv = jax.tree_util.tree_map(jnp.asarray, variables)
    out = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, False))(jv, jnp.asarray(feat)))
    scale = float(np.abs(out).max())
    assert float(np.abs(want_port - out).max()) <= LOGIT_REL * scale


@pytest.mark.parametrize("action", ["val", "test"])
def test_val_and_test_of_the_trained_experiment(quick, setup, action, monkeypatch):
    printed = []
    monkeypatch.setattr(evaluate, "_print_scores",
                        lambda tag, s: printed.append([float(v) for v in s[:5]]))
    assert cli.main([action, "--eval_pth", "quick", "--results_dir", setup["results"],
                     "--device", "cpu"]) == 0
    assert len(printed) == 9  # (overall, any, classwise) x unify 15, 30, 45
    for er, f, le, lr, seld in printed:
        assert np.isfinite([er, f, le, lr, seld]).all()
        assert er >= 0 and 0 <= f <= 1 and 0 <= le <= 180 and 0 <= lr <= 1


def _ckpt(exp):
    return torch.load(os.path.join(exp, "model_ckpt.ckpt"), weights_only=False)


def test_resume_is_bit_identical(setup):
    straight = os.path.join(setup["results"], "straight")
    resumed = os.path.join(setup["results"], "resumed")
    assert cli.main(_train_argv(setup, "straight", "--nb_epochs", "2")) == 0
    assert cli.main(_train_argv(setup, "resumed", "--nb_epochs", "1")) == 0
    fp = os.path.join(resumed, "hyp_exp.yaml")
    with open(fp) as f:
        frozen = yaml.safe_load(f)
    frozen["train"]["nb_epochs"] = 2
    with open(fp, "w") as f:
        yaml.safe_dump(frozen, f, sort_keys=False)
    assert _ckpt(resumed)["host"]["start_epoch_nb"] == 2
    assert cli.main(["train", "--resume_pth", "resumed", "--results_dir", setup["results"],
                     "--device", "cpu"]) == 0

    a, b = _ckpt(straight), _ckpt(resumed)
    assert a["host"]["start_epoch_nb"] == b["host"]["start_epoch_nb"] == 3
    assert a["model"].keys() == b["model"].keys()
    for k, v in a["model"].items():  # weights and BatchNorm running stats
        assert torch.equal(v, b["model"][k]), k
    sa, sb = a["optimizer"]["state"], b["optimizer"]["state"]
    assert sa.keys() == sb.keys() and len(sa) > 0
    for i in sa:
        for k in sa[i]:
            assert torch.equal(sa[i][k], sb[i][k]), (i, k)
    ha, hb = a["host"], b["host"]
    assert ha["train_remaining_file"] == hb["train_remaining_file"]
    assert ha["train_file_list"] == hb["train_file_list"]
    assert ha["rng_state"]["rand_state"] == hb["rng_state"]["rand_state"]
    np.testing.assert_array_equal(ha["rng_state"]["torch_generator"],
                                  hb["rng_state"]["torch_generator"])

    def losses(exp):
        return sorted((r["channel"], r["step"], r["value"]) for r in _logs(exp)
                      if r["channel"].endswith("/loss"))

    assert losses(straight) == losses(resumed) and len(losses(straight)) == 6


def test_preemption_checkpoints_the_epoch_and_returns(setup, monkeypatch):
    """A stop request (what SIGTERM sets) during epoch 1 ends the epoch after
    its batch in flight, writes a checkpoint that resumes epoch 1, and
    skips val, test and the final test."""
    orig = port_train.train_one_epoch

    def preempted(loader, step, gen, max_batches, guard):
        guard.stop = True  # as the signal handler does
        return orig(loader, step, gen, max_batches, guard)

    monkeypatch.setattr(port_train, "train_one_epoch", preempted)
    assert cli.main(_train_argv(setup, "preempted", "--nb_epochs", "2")) == 0
    exp = os.path.join(setup["results"], "preempted")
    host = _ckpt(exp)["host"]
    assert host["start_epoch_nb"] == 1
    assert not os.path.exists(os.path.join(exp, "model_best.ckpt"))
    assert not os.path.exists(os.path.join(exp, "output_val"))


def test_train_se_resnet34_raises_before_creating_a_directory(setup, tmp_path):
    """SE-ResNet34 trains every loss now; with a configuration the port
    cannot train (a compute dtype other than float32 / bfloat16, from the
    preset directory) it raises before creating its directory, as the
    conformer does."""
    configs = str(tmp_path / "configs")
    shutil.copytree(setup["configs"], configs)
    with open(os.path.join(configs, "hyp_train.yaml"), "a") as f:
        f.write("compute_dtype: float16\n")
    argv = _train_argv(setup, "se", "--loss", "accdoa")
    argv[argv.index("resnet-conformer")] = "se-resnet34"
    argv[argv.index("--config_dir") + 1] = configs
    with pytest.raises(ValueError, match="float16"):
        cli.main(argv)
    assert not os.path.exists(os.path.join(setup["results"], "se"))
    argv = _train_argv(setup, "accdoa", "--loss", "accdoa")
    argv[argv.index("--config_dir") + 1] = configs
    with pytest.raises(ValueError, match="float16"):
        cli.main(argv)
    assert not os.path.exists(os.path.join(setup["results"], "accdoa"))


@pytest.mark.parametrize("extra", [["--model_parallel", "3"],
                                   ["--serve_dtype", "float32"],
                                   ["--model_parallel", "2"],
                                   ["--serve_dtype", "bfloat16"]])
def test_unported_arguments_are_refused(setup, extra):
    """``train`` refuses what it cannot run, before it writes anything:
    ``--serve_dtype`` (export only), and a ``--model_parallel`` that the
    ranks do not divide (one process here; tensor parallelism itself is
    ``tests/test_torch_tp.py``)."""
    with pytest.raises((SystemExit, ValueError), match="error: --|model_parallel"):
        cli.main(_train_argv(setup, "refused", *extra))
    assert not os.path.exists(os.path.join(setup["results"], "refused"))


@pytest.mark.parametrize("argv", [["export", "--eval_pth", "x"], ["export"]],
                         ids=["export", "export-bare"])
def test_unported_actions_are_refused(argv, tmp_path):
    """Every action is ported (``export``: ``tests/test_torch_export.py``;
    ``preprocess``: ``tests/test_torch_preprocess.py``); ``export`` without
    an experiment exits with a message and writes nothing."""
    with pytest.raises(SystemExit, match="error: (no experiment|--eval_pth)"):
        cli.main(argv + ["--results_dir", str(tmp_path), "--device", "cpu"])
    assert os.listdir(tmp_path) == []
