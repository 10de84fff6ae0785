"""The dense output formats through the port's engine, on the CPU.

* ``test_model`` through both engines for ACCDOA and ADPIT: one experiment
  directory written by the JAX package (``save_config`` /
  ``save_checkpoint`` of a seeded SE-ResNet34 init), with its confidence
  threshold in a wide gap of the activities (ACCDOA: the classes' vector
  norms; ADPIT: the tracks' norms) so that ~1e-6 float differences between
  the frameworks move no detection; both packages' eval loaders bucket the
  3-s clips to 160 frames.  JAX ``test_model({"action": "test"})``
  and the port's ``cli.main(["test", ..., "--device", "cpu"])``: one
  evaluation block for ACCDOA and one per unify threshold {15, 30, 45} for
  ADPIT, each with the same CSV rows (xyz within 1e-4), the five SELD
  metrics of the overall and both polyphony re-scorings within 1e-3 and
  the eval loss within 1e-4 rel.
* ``cli train --quick_test`` for each dense format (SE-ResNet34, B = 2,
  1-s chunks, the τ scan in epoch 3; the eval loader's length buckets cut
  to 80 and 160 frames, which hold the 2-s clips), then ``val``, ``test`` and ``infer``
  through ``cli.main(..., "--device", "cpu")``: the artifacts, finite
  logged losses and in-range metrics, one CSV per clip, and one
  evaluation block per loss (three for ADPIT).
* Resume of a dense format: ADPIT for 1 epoch, then ``--resume_pth`` for
  epoch 2 (its τ scan): finite losses logged for both epochs.
"""
import dataclasses
import json
import os

import numpy as np
import jax
import pytest
import yaml

from adyolo_tpu import config as jax_config
from adyolo_tpu.data import dataset as jax_dataset
from adyolo_tpu.engine import evaluate as jax_evaluate
from adyolo_tpu.engine.checkpoint import save_checkpoint
from adyolo_tpu.models import wrapper as jax_wrapper
from adyolo_tpu.parallel import train_step as jax_train_step
from adyolo_tpu_torch import cli
from adyolo_tpu_torch.convert import state_dict_from_flax
from adyolo_tpu_torch.data import dataset as port_dataset
from adyolo_tpu_torch.data.dataset import EvalLoader, SELDDataset
from adyolo_tpu_torch.engine import evaluate
from adyolo_tpu_torch.engine import train as port_train
from adyolo_tpu_torch.models import wrapper as port_wrapper

from tests.synth_data import make_synth_dataset
from tests.test_torch_config import one_torch_thread, port_config, module_tmp  # noqa: F401
from tests.test_torch_evaluate import _record
from tests.test_torch_serving import _gap_threshold

pytestmark = pytest.mark.usefixtures("one_torch_thread")

XYZ_TOL = 1e-4
SELD_TOL = 1e-3
LOSS_REL = 1e-4
K = 13


def _activity(loss, out):
    """The values the decoder thresholds: ACCDOA's class norms, ADPIT's
    track norms."""
    x = out[0].numpy()
    if loss == "accdoa":
        return np.linalg.norm(x.reshape(-1, 3, K), axis=1)
    return np.linalg.norm(x.reshape(-1, 3, 3, K), axis=2)


@pytest.fixture(scope="module")
def short_buckets():
    """Both packages' eval length buckets cut to 80 and 160 frames."""
    with pytest.MonkeyPatch.context() as mp:
        for pkg in (jax_dataset, port_dataset):
            mp.setattr(pkg.EvalLoader.__init__, "__defaults__", ((80, 160),))
        yield


@pytest.fixture(scope="module", params=["accdoa", "adpit"])
def experiment(request, short_buckets, module_tmp):
    loss = request.param
    exp = f"exp-{loss}"
    root = str(module_tmp(f"eval_{loss}"))
    data = make_synth_dataset(os.path.join(root, "data"), n_train=1, n_val=1,
                              n_test=2, eval_secs=3, seed=8)
    cfg = jax_config.Config()
    cfg = dataclasses.replace(
        cfg, args=dataclasses.replace(cfg.args, exp_id=exp, loss=loss),
        data=dataclasses.replace(cfg.data, data_pth=data,
                                 name_pth=os.path.join(data, "classes.txt")))
    model = jax_wrapper.build_model(cfg, "float32")
    state = jax_train_step.init_state(cfg, model, jax_evaluate.make_frontend(cfg),
                                      jax.random.PRNGKey(12))
    variables = {"params": jax.tree_util.tree_map(np.asarray, state.params),
                 "batch_stats": jax.tree_util.tree_map(np.asarray, state.batch_stats)}

    pcfg = port_config(cfg)
    tm = port_wrapper.build_model(pcfg, device="cpu")
    tm.load_state_dict(state_dict_from_flax(variables, "se-resnet34", loss))
    fwd = evaluate.build_eval_forward(tm, evaluate.make_frontend(pcfg, device="cpu"))
    acts = []
    for item in EvalLoader(SELDDataset(pcfg, "test", is_valid=True), pcfg):
        out = fwd(item["audio"], item["valid_feat_frames"])
        acts.append(_activity(loss, out[:, :item["nb_label_frames"]]).ravel())
    tau, gap = _gap_threshold(np.concatenate(acts))
    assert gap > 1e-5, gap

    results = os.path.join(root, "results")
    exp_dir = os.path.join(results, exp)
    jax_config.save_config(jax_config.with_conf_thresh(cfg, tau),
                           os.path.join(exp_dir, "hyp_exp.yaml"))
    save_checkpoint(os.path.join(exp_dir, "model_best.ckpt"), state,
                    {"epoch_nb": 0, "confidence_thresh": tau})
    return {"loss": loss, "exp": exp, "results": results}


def test_test_model_matches_jax(experiment):
    results, exp = experiment["results"], experiment["exp"]
    port, ref = {"sweeps": [], "scores": []}, {"sweeps": [], "scores": []}
    with pytest.MonkeyPatch.context() as mp:
        _record(mp, jax_evaluate, ref)
        jax_evaluate.test_model({"action": "test", "eval_pth": exp}, results_dir=results)
    with pytest.MonkeyPatch.context() as mp:
        _record(mp, evaluate, port)
        assert cli.main(["test", "--eval_pth", exp, "--results_dir", results,
                         "--device", "cpu"]) == 0
    blocks = 3 if experiment["loss"] == "adpit" else 1  # the unify sweep
    assert len(port["sweeps"]) == len(ref["sweeps"]) == blocks
    assert len(port["scores"]) == len(ref["scores"]) == 3 * blocks
    n_rows = 0
    for (loss, csvs), (jloss, jcsvs) in zip(port["sweeps"], ref["sweeps"]):
        assert np.isfinite(loss) and abs(loss - jloss) <= LOSS_REL * abs(jloss)
        assert sorted(csvs) == sorted(jcsvs) and len(csvs) == 2
        for name, want in jcsvs.items():
            got = csvs[name]
            assert [r[:3] for r in got] == [r[:3] for r in want], name
            if want:
                np.testing.assert_allclose(np.asarray(got)[:, 3:],
                                           np.asarray(want)[:, 3:], atol=XYZ_TOL)
            n_rows += len(want)
    assert n_rows > 0
    np.testing.assert_allclose(port["scores"], ref["scores"], atol=SELD_TOL, rtol=0)


@pytest.fixture(scope="module")
def synth_setup(module_tmp):
    root = str(module_tmp("formats_cli"))
    data = make_synth_dataset(os.path.join(root, "data"), n_train=4, n_val=2, n_test=1,
                              train_secs=1, eval_secs=2, chunk_window_s=1, seed=9)
    configs = os.path.join(root, "configs")
    os.makedirs(configs)
    with open(os.path.join(configs, "hyp_data_DCASE2022.yaml"), "w") as f:
        yaml.safe_dump({"data_pth": data, "name_pth": os.path.join(data, "classes.txt"),
                        "chunk_window_s": 1}, f)
    return {"data": data, "configs": configs, "results": os.path.join(root, "results")}


def run_cli_formats(setup, loss, monkeypatch, fmt="foa"):
    """``train --quick_test`` (τ scan in epoch 3), ``val``, ``test``,
    ``infer`` of one loss; returns the printed score blocks of val and test."""
    monkeypatch.setattr(port_train, "SCAN_EVERY", 3)
    scans = []
    orig_scan = port_train.scan_conf_thresh
    monkeypatch.setattr(port_train, "scan_conf_thresh",
                        lambda *a, **kw: scans.append(orig_scan(*a, **kw)) or scans[-1])
    exp = f"quick-{loss}"
    res = setup["results"]
    assert cli.main(["train", "--loss", loss, "--quick_test", "--logger", "--augment",
                     "--batch_size", "2", "--nb_iters", "1", "--config_dir", setup["configs"],
                     "--results_dir", res, "--exp_id", exp, "--device", "cpu"]) == 0
    exp_dir = os.path.join(res, exp)
    for name in ("hyp_exp.yaml", "model_best.ckpt", "model_ckpt.ckpt", "logs.jsonl"):
        assert os.path.isfile(os.path.join(exp_dir, name)), name
    with open(os.path.join(exp_dir, "logs.jsonl")) as f:
        logs = [json.loads(ln) for ln in f]
    for split in ("train", "val", "test"):
        vals = [r["value"] for r in logs if r["channel"] == f"logs/{split}/loss"]
        assert len(vals) == 3 and np.isfinite(vals).all(), split
    assert len(scans) == 1 and [t for t, _ in scans[0][1]["scores"]] == list(port_train.TAU_SCAN)
    clips = {s: sorted(os.listdir(os.path.join(setup["data"], f"{fmt}_dev", f"dev-{s}")))
             for s in ("val", "test")}
    for split in ("val", "test"):
        assert sorted(os.listdir(os.path.join(exp_dir, f"output_{split}"))) == \
            [c.replace(".wav", ".csv") for c in clips[split]]
    printed = {}
    for action in ("val", "test"):
        printed[action] = []
        monkeypatch.setattr(evaluate, "_print_scores",
                            lambda tag, s: printed[action].append([float(v) for v in s[:5]]))
        assert cli.main([action, "--eval_pth", exp, "--results_dir", res,
                         "--device", "cpu"]) == 0
        assert sorted(os.listdir(os.path.join(exp_dir, "output_eval"))) == \
            [c.replace(".wav", ".csv") for c in clips[action]]
        blocks = 3 if loss in ("adpit", "adyolo") else 1
        assert len(printed[action]) == 3 * blocks  # (overall, any, classwise) per block
        for er, f, le, lr, seld in printed[action]:
            assert np.isfinite([er, f, le, lr, seld]).all()
            assert er >= 0 and 0 <= f <= 1 and 0 <= le <= 180 and 0 <= lr <= 1
    infer_dir = os.path.join(setup["data"], f"{fmt}_dev", "dev-val")
    assert cli.main(["infer", "--eval_pth", exp, "--infer_pth", infer_dir,
                     "--results_dir", res, "--device", "cpu"]) == 0
    assert sorted(os.listdir(os.path.join(exp_dir, "output_infer"))) == \
        [c.replace(".wav", ".csv") for c in clips["val"]]
    return printed


@pytest.mark.parametrize("loss", ["seddoa", "masked-seddoa", "accdoa", "adpit"])
def test_cli_quick_test_of_each_dense_format(synth_setup, short_buckets, loss, monkeypatch):
    run_cli_formats(synth_setup, loss, monkeypatch)


def test_resume_of_a_dense_format(synth_setup, short_buckets):
    """ADPIT trained for 1 epoch, then resumed for epoch 2 (its τ scan):
    the resume starts at epoch 2 from the stored best threshold, and the
    logs hold finite losses for both epochs."""
    res = synth_setup["results"]
    argv = ["train", "--loss", "adpit", "--logger", "--batch_size", "2", "--nb_iters", "1",
            "--config_dir", synth_setup["configs"], "--results_dir", res,
            "--exp_id", "resume-adpit", "--device", "cpu"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_train, "SCAN_EVERY", 2)
        assert cli.main(argv + ["--nb_epochs", "1"]) == 0
        exp_dir = os.path.join(res, "resume-adpit")
        with open(os.path.join(exp_dir, "hyp_exp.yaml")) as f:
            y = yaml.safe_load(f)
        y["train"]["nb_epochs"] = 2
        with open(os.path.join(exp_dir, "hyp_exp.yaml"), "w") as f:
            yaml.safe_dump(y, f, sort_keys=False)
        assert cli.main(["train", "--resume_pth", "resume-adpit", "--results_dir", res,
                         "--device", "cpu"]) == 0
    with open(os.path.join(exp_dir, "logs.jsonl")) as f:
        logs = [json.loads(ln) for ln in f]
    for split in ("train", "val", "test"):
        steps = [r["step"] for r in logs if r["channel"] == f"logs/{split}/loss"]
        vals = [r["value"] for r in logs if r["channel"] == f"logs/{split}/loss"]
        assert steps == [1, 2] and np.isfinite(vals).all(), split
    assert [r["step"] for r in logs if r["channel"] == "logs/train/conf_thresh"
            and "step" in r] == [2]
