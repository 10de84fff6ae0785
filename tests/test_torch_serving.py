"""The ported serving slice as a whole vs the JAX package's ``infer``, for
each ported encoder (SE-ResNet34 and ResNet-Conformer, AD-YOLO head).

One experiment directory per encoder is written by the JAX package's own
``save_config`` / ``save_checkpoint`` from a seeded (untrained) init, with
a non-identity ``scaler_wts.pkl`` beside the data.  The JAX
``test_model({"action": "infer", ...})`` and the port's
``adyolo_tpu_torch.cli.main(["infer", ...])`` then run on the same wav
folder (odd-length clips, padded into a length bucket).  The CSVs must
hold the same (frame, class) rows, with xyz within 1e-4.

The confidence threshold is put in a wide gap of the class-confidence
values, so float32 differences between the two frameworks (~1e-6) cannot
move a detection across it.

The port's ``infer`` also reports its decode's work: the candidates over
τ a label frame, from the decode's counters over the run, the label
frames being every clip's.
"""
import dataclasses
import os
import pickle
import shutil

import numpy as np
import jax
import pytest
from flax import serialization
import torch

from adyolo_tpu.config import Config, save_config, with_conf_thresh
from adyolo_tpu.engine.checkpoint import save_checkpoint
from adyolo_tpu.engine import evaluate as jax_evaluate
from adyolo_tpu.models.wrapper import build_model as jax_build_model
from adyolo_tpu.parallel.train_step import init_state
from adyolo_tpu_torch import cli
from adyolo_tpu_torch.config import load_config
from adyolo_tpu_torch.convert import state_dict_from_flax
from adyolo_tpu_torch.data.dataset import EvalLoader, SELDDataset
from adyolo_tpu_torch.engine.checkpoint import (load_jax_checkpoint,
                                                save_jax_checkpoint)
from adyolo_tpu_torch.engine.evaluate import make_frontend
from adyolo_tpu_torch.models.wrapper import build_model, make_grid_geometry
from adyolo_tpu_torch.ops.decode import _device_decode
from adyolo_tpu_torch.utils import profiling

from tests.synth_data import make_synth_dataset
from tests.test_torch_config import (  # noqa: F401
    one_torch_thread, port_config, module_tmp, scratch_path)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

XYZ_TOL = 1e-4
EXP = "exp-serve"


def _read_csv(path):
    rows = []
    with open(path) as f:
        for line in f:
            w = line.strip().split(",")
            rows.append((int(w[0]), int(w[1]), int(w[2]),
                         float(w[3]), float(w[4]), float(w[5])))
    return sorted(rows)


def _gap_threshold(cls_conf):
    """Midpoint of the widest gap among the top 0.1-1 % of the values."""
    v = np.sort(cls_conf.ravel())[::-1]
    n = len(v)
    lo, hi = max(1, n // 1000), max(2, n // 100)
    gaps = v[lo:hi] - v[lo + 1:hi + 1]
    i = lo + int(np.argmax(gaps))
    return float((v[i] + v[i + 1]) / 2), float(gaps.max())


@pytest.fixture(scope="module", params=["se-resnet34", "resnet-conformer"])
def experiment(request, module_tmp):
    encoder = request.param
    root = str(module_tmp("serve"))
    data = make_synth_dataset(os.path.join(root, "data"), n_train=1, n_val=2,
                              n_test=1, eval_secs=7, seed=3)
    rng = np.random.default_rng(4)
    scaler = {"MEL": {"mean": rng.uniform(-50, -20, (1, 64, 4)).astype(np.float32),
                      "std": rng.uniform(5, 15, (1, 64, 4)).astype(np.float32)},
              "IV": {"mean": rng.uniform(-0.05, 0.05, (1, 64, 3)).astype(np.float32),
                     "std": rng.uniform(0.1, 0.4, (1, 64, 3)).astype(np.float32)}}
    with open(os.path.join(data, "scaler_wts.pkl"), "wb") as f:
        pickle.dump(scaler, f)
    cfg = Config()
    cfg = dataclasses.replace(
        cfg, args=dataclasses.replace(cfg.args, exp_id=EXP, encoder=encoder),
        data=dataclasses.replace(cfg.data, data_pth=data,
                                 name_pth=os.path.join(data, "classes.txt")))
    model = jax_build_model(cfg, "float32")
    state = init_state(cfg, model, jax_evaluate.make_frontend(cfg), jax.random.PRNGKey(7))
    wav_dir = os.path.join(data, "foa_dev", "dev-val")

    # threshold from the port's own logits on every clip
    pcfg = port_config(cfg)
    geom = make_grid_geometry(pcfg)
    tm = build_model(pcfg, device="cpu")
    tm.load_state_dict(state_dict_from_flax(
        {"params": jax.tree_util.tree_map(np.asarray, state.params),
         "batch_stats": jax.tree_util.tree_map(np.asarray, state.batch_stats)},
        encoder))
    frontend = make_frontend(pcfg, device="cpu")
    c_inf = dataclasses.replace(pcfg, args=dataclasses.replace(pcfg.args, infer_pth=wav_dir))
    confs = []
    for item in EvalLoader(SELDDataset(c_inf, "infer", is_valid=True), c_inf):
        valid = torch.tensor(item["valid_feat_frames"])
        with torch.no_grad():
            out = tm(frontend(torch.tensor(item["audio"]), valid), valid)
            cls, _, _ = _device_decode(out[:, : item["nb_label_frames"]], geom,
                                       cfg.data.nb_classes)
        confs.append(cls.numpy().ravel())
    tau, gap = _gap_threshold(np.concatenate(confs))
    assert gap > 1e-5, gap

    results = os.path.join(root, "results")
    exp_dir = os.path.join(results, EXP)
    save_config(with_conf_thresh(cfg, tau), os.path.join(exp_dir, "hyp_exp.yaml"))
    save_checkpoint(os.path.join(exp_dir, "model_best.ckpt"), state,
                    {"epoch_nb": 0, "confidence_thresh": tau})
    return results, exp_dir, wav_dir, state


def test_port_infer_matches_jax_infer(experiment):
    results, exp_dir, wav_dir, _ = experiment
    jax_evaluate.test_model({"action": "infer", "eval_pth": EXP, "infer_pth": wav_dir},
               results_dir=results)
    jax_out = os.path.join(exp_dir, "output_infer_jax")
    shutil.move(os.path.join(exp_dir, "output_infer"), jax_out)

    assert cli.main(["infer", "--eval_pth", EXP, "--infer_pth", wav_dir,
                     "--results_dir", results, "--device", "cpu"]) == 0
    port_out = os.path.join(exp_dir, "output_infer")
    names = sorted(os.listdir(jax_out))
    assert names == sorted(os.listdir(port_out)) and len(names) == 2
    n_rows = 0
    for name in names:
        want = _read_csv(os.path.join(jax_out, name))
        got = _read_csv(os.path.join(port_out, name))
        assert [r[:3] for r in got] == [r[:3] for r in want], name
        if want:
            np.testing.assert_allclose(np.asarray(got)[:, 3:],
                                       np.asarray(want)[:, 3:], atol=XYZ_TOL)
        n_rows += len(want)
    assert n_rows > 0  # the threshold lets some detections through


def test_port_infer_reports_its_decodes_candidates_a_label_frame(experiment, capsys):
    results, exp_dir, wav_dir, _ = experiment
    cfg = load_config(os.path.join(exp_dir, "hyp_exp.yaml"))
    c_inf = dataclasses.replace(cfg, args=dataclasses.replace(cfg.args, infer_pth=wav_dir))
    frames = sum(item["nb_label_frames"]
                 for item in EvalLoader(SELDDataset(c_inf, "infer", is_valid=True), c_inf))
    before = dict(profiling.COUNTERS)
    capsys.readouterr()
    assert cli.main(["infer", "--eval_pth", EXP, "--infer_pth", wav_dir,
                     "--results_dir", results, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    got = {k: profiling.COUNTERS.get(k, 0) - before.get(k, 0)
           for k in ("decode.label_frames", "decode.candidates")}
    rows = got["decode.candidates"]
    assert got["decode.label_frames"] == frames > 0 and rows > 0
    assert (f"decode: {rows / frames:0.4f} candidates over tau a label frame "
            f"({rows} over {frames} label frames)") in out


def test_checkpoint_reader_and_writer(experiment, scratch_path):
    _, exp_dir, _, state = experiment
    variables, host = load_jax_checkpoint(os.path.join(exp_dir, "model_best.ckpt"))
    assert host["epoch_nb"] == 0 and 0.0 < host["confidence_thresh"] < 1.0
    for coll, ref in (("params", state.params), ("batch_stats", state.batch_stats)):
        got = dict(jax.tree_util.tree_leaves_with_path(variables[coll]))
        for path, a in jax.tree_util.tree_leaves_with_path(ref):
            np.testing.assert_array_equal(got[path], np.asarray(a))
    path = str(scratch_path / "again.ckpt")
    opt_state = jax.tree_util.tree_map(np.asarray, serialization.to_state_dict(state.opt_state))
    save_jax_checkpoint(path, variables, host, opt_state, np.asarray(state.step))
    again, host2 = load_jax_checkpoint(path)
    assert host2 == host
    for (p1, a), (p2, b) in zip(jax.tree_util.tree_leaves_with_path(variables),
                                jax.tree_util.tree_leaves_with_path(again)):
        assert p1 == p2
        np.testing.assert_array_equal(a, b)
