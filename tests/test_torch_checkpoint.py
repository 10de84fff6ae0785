"""The port's ``model_best.ckpt`` in the JAX package's hands.

* (optimizers) For ``Adam``, ``Adam`` with weight decay, ``AdamW`` and
  ``SGD``: one port train step on the CPU (SE-ResNet34 + AD-YOLO at full
  width, B = 2 x 1 s), then ``save_jax_checkpoint`` with
  :func:`~adyolo_tpu_torch.engine.checkpoint.optax_state`.  JAX's
  ``load_checkpoint`` reads the file into its full ``init_state`` template:
  the parameters and BatchNorm stats come back bit for bit, the optimizer
  state has the template's structure, shapes and dtypes, Adam's ``mu`` /
  ``nu`` are the port's ``exp_avg`` / ``exp_avg_sq`` (bit for bit, read
  back through the weight bridge), and ``count`` and ``step`` are 1.
* (engine) ``cli train --quick_test`` of the port on a synthetic
  DCASE-layout set; JAX's ``test_model`` runs ``val`` on that experiment
  (it loads ``model_best.ckpt`` into the full template) and scores it.
"""
import dataclasses
import math
import os

import jax
import numpy as np
import pytest
import torch
import yaml

from adyolo_tpu import config as jax_config
from adyolo_tpu.engine import checkpoint as jax_checkpoint
from adyolo_tpu.engine import evaluate as jax_evaluate
from adyolo_tpu.models.wrapper import build_model as jax_build_model
from adyolo_tpu.parallel.train_step import init_state
from adyolo_tpu_torch import cli
from adyolo_tpu_torch.convert import flax_from_state_dict, module_state_dict
from adyolo_tpu_torch.data.labels import encode_adyolo, pad_yolo_targets
from adyolo_tpu_torch.engine.checkpoint import (load_jax_checkpoint, optax_state,
                                                save_jax_checkpoint)
from adyolo_tpu_torch.engine.evaluate import make_frontend
from adyolo_tpu_torch.models.wrapper import build_model, make_grid_geometry
from adyolo_tpu_torch.parallel.train_step import build_train_step

from tests.synth_data import make_synth_dataset
from tests.test_torch_config import (  # noqa: F401
    one_torch_thread, port_config, module_tmp, scratch_path)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

OPTIMIZERS = {"adam": ("Adam", 0.0), "adam_wd": ("Adam", 1e-4),
              "adamw": ("AdamW", 1e-2), "sgd": ("SGD", 0.0)}


def _jax_config(optim, weight_decay):
    cfg = jax_config.Config()
    return dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, chunk_window_s=1,
                                      data_pth="no-such-dir"),
        train=dataclasses.replace(cfg.train, optim=optim, weight_decay=weight_decay,
                                  max_targets_per_clip=64))


def _batch(cfg, rng, B=2):
    geom = make_grid_geometry(cfg)
    frames = cfg.data.chunk_label_frames
    per_clip = [encode_adyolo({int(rng.integers(frames)): [[int(rng.integers(13)), 0,
                                                           float(rng.uniform(-180, 180)),
                                                           float(rng.uniform(-90, 90))]]},
                              frames, geom) for _ in range(B)]
    targets, mask = pad_yolo_targets(per_clip, 64 * B)
    audio = (rng.standard_normal((B, cfg.data.chunk_feat_frames, cfg.data.hop_length, 4))
             * 0.1).astype(np.float32)
    return {"audio": audio, "targets": targets, "target_mask": mask}


def _adam_state(opt_state):
    leaves = jax.tree_util.tree_leaves(opt_state, is_leaf=lambda x: hasattr(x, "mu"))
    return next(s for s in leaves if hasattr(s, "mu"))


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_jax_reads_port_checkpoint_with_full_template(name, scratch_path):
    optim, wd = OPTIMIZERS[name]
    jcfg = _jax_config(optim, wd)
    cfg = port_config(jcfg)
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(3),
                        train=True)
    step = build_train_step(cfg, model, make_frontend(cfg, device="cpu"))
    loss = step(_batch(cfg, np.random.default_rng(1)), torch.Generator().manual_seed(0))
    assert math.isfinite(float(loss))
    osd = step.optimizer.state_dict()
    params = dict(model.named_parameters())
    variables = flax_from_state_dict(model.state_dict())
    host = {"epoch_nb": 1, "confidence_thresh": 0.5}
    path = str(scratch_path / "model_best.ckpt")
    save_jax_checkpoint(path, variables, host,
                        *optax_state(optim, wd, osd, params))

    jm = jax_build_model(jcfg, "float32")
    template = jax.eval_shape(lambda: init_state(jcfg, jm, jax_evaluate.make_frontend(jcfg),
                                                 jax.random.PRNGKey(0)))
    state, jhost = jax_checkpoint.load_checkpoint(path, template)
    assert jhost == host and int(state.step) == 1
    for coll in ("params", "batch_stats"):
        jax.tree_util.tree_map(np.testing.assert_array_equal,
                               jax.tree_util.tree_map(np.asarray, getattr(state, coll)),
                               variables[coll])
    assert (jax.tree_util.tree_structure(state.opt_state)
            == jax.tree_util.tree_structure(template.opt_state))
    for got, want in zip(jax.tree_util.tree_leaves(state.opt_state),
                         jax.tree_util.tree_leaves(template.opt_state)):
        assert np.shape(got) == want.shape and np.asarray(got).dtype == want.dtype
    if optim == "SGD":
        assert jax.tree_util.tree_leaves(state.opt_state) == []
        return
    adam = _adam_state(state.opt_state)
    assert int(adam.count) == 1
    names = list(params)
    for field, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
        got = module_state_dict({"params": jax.tree_util.tree_map(
            np.asarray, getattr(adam, field))})
        assert set(got) == set(names)
        for idx, st in osd["state"].items():
            assert torch.equal(got[names[idx]], st[key]), (field, names[idx])
    # the reader of the port reads the same file
    _, port_host = load_jax_checkpoint(path)
    assert port_host == host


@pytest.fixture(scope="module")
def trained(module_tmp):
    root = str(module_tmp("ckpt_engine"))
    data = make_synth_dataset(os.path.join(root, "data"), n_train=2, n_val=1, n_test=1,
                              train_secs=1, eval_secs=2, chunk_window_s=1, seed=7)
    configs = os.path.join(root, "configs")
    os.makedirs(configs)
    with open(os.path.join(configs, "hyp_data_DCASE2022.yaml"), "w") as f:
        yaml.safe_dump({"data_pth": data, "name_pth": os.path.join(data, "classes.txt"),
                        "chunk_window_s": 1}, f)
    with open(os.path.join(configs, "hyp_train.yaml"), "w") as f:
        yaml.safe_dump({"max_targets_per_clip": 64}, f)
    results = os.path.join(root, "results")
    assert cli.main(["train", "--quick_test", "--batch_size", "2", "--nb_iters", "1",
                     "--config_dir", configs, "--results_dir", results,
                     "--exp_id", "quick", "--device", "cpu"]) == 0
    return results


def test_jax_val_runs_on_port_trained_experiment(trained):
    scores = jax_evaluate.test_model({"action": "val", "eval_pth": "quick"},
                                     results_dir=trained)
    assert scores and all(np.isfinite(float(v)) for v in np.ravel(list(scores.values())))
    assert os.path.isdir(os.path.join(trained, "quick", "output_val"))


def test_optax_state_refuses_a_mismatched_parameter_list():
    """Moments are matched to names by position: a list of another length,
    or a moment whose shape is not its parameter's, raises at write time
    (the tests above write the lists that match)."""
    net = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.Linear(4, 2))
    opt = torch.optim.Adam(net.parameters())
    net(torch.ones(1, 3)).sum().backward()
    opt.step()
    osd = opt.state_dict()
    params = {f"m.{n.replace('.', '_')}": p for n, p in net.named_parameters()}
    swapped = dict(zip(params, [params[k] for k in ("m.0_bias", "m.0_weight",
                                                    "m.1_weight", "m.1_bias")]))
    with pytest.raises(ValueError, match="shape"):
        optax_state("Adam", 0.0, osd, swapped)
    with pytest.raises(ValueError, match="parameters"):
        optax_state("Adam", 0.0, osd, dict(list(params.items())[:3]))
