"""The port's evaluation engine vs ``adyolo_tpu.engine.evaluate``.

ResNet-Conformer + AD-YOLO at full width with its Conformer cut to 2 blocks
on both sides (as ``tests/test_torch_train_step.py`` cuts it), on a
synthetic DCASE-layout set with 3-s and 4-s val/test clips (bucket 800).

* ``test_model`` through both engines: one experiment directory written by
  the JAX package (``save_config`` / ``save_checkpoint`` from a seeded
  init), with its confidence threshold in a wide gap of the class
  confidences, so that ~1e-6 float differences between the frameworks
  move no detection.  JAX ``test_model({"action": "test"})`` and the port's
  ``cli.main(["test", ..., "--device", "cpu"])``: for each unify threshold
  the same CSV rows with xyz within 1e-4, all five SELD metrics of the
  overall and both polyphony re-scorings within 1e-3, the eval loss
  within 1e-4 rel.
* The eval criterion vs JAX ``build_eval_criterion`` on the same logits and
  targets with a frame mask: within 1e-5 rel.
* The cached decode: one candidate cache from the port's forward, decoded
  by both packages' ``postprocess_cached`` at each τ in {0.1, ..., 0.9}:
  identical detections, so identical SELD per τ and the same τ picked.
* The ``min_conf`` guard: a cache built with ``min_conf`` 0.1 while the
  threshold is 0.5 decodes at τ = 0.1 exactly as the full grid does, and
  one built at 0.5 refuses τ = 0.1.
* The eval forward runs the model in eval mode after a train step (a
  trainer alternates the two on one module).
"""
import copy
import dataclasses
import functools
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from adyolo_tpu import config as jax_config
from adyolo_tpu.engine import evaluate as jax_evaluate
from adyolo_tpu.engine.checkpoint import save_checkpoint
from adyolo_tpu.models import resnet_conformer as jax_rc
from adyolo_tpu.models import wrapper as jax_wrapper
from adyolo_tpu.ops.decode import PostProcessor as JaxPostProcessor
from adyolo_tpu.parallel import train_step as jax_train_step
from adyolo_tpu_torch import cli
from adyolo_tpu_torch.convert import state_dict_from_flax
from adyolo_tpu_torch.data.dataset import EvalLoader, SELDDataset
from adyolo_tpu_torch.data.labels import encode_adyolo, pad_yolo_targets
from adyolo_tpu_torch.engine import evaluate
from adyolo_tpu_torch.engine import train as port_train
from adyolo_tpu_torch.metrics.seld import SegmentScorer
from adyolo_tpu_torch.models import resnet_conformer as port_rc
from adyolo_tpu_torch.models import wrapper as port_wrapper
from adyolo_tpu_torch.ops.decode import PostProcessor, _device_decode
from adyolo_tpu_torch.parallel.train_step import build_eval_criterion, build_train_step

from tests.synth_data import make_synth_dataset
from tests.test_torch_config import one_torch_thread, port_config, module_tmp  # noqa: F401
from tests.test_torch_serving import _gap_threshold, _read_csv

pytestmark = pytest.mark.usefixtures("one_torch_thread")

XYZ_TOL = 1e-4
SELD_TOL = 1e-3
LOSS_REL = 1e-4
CRIT_REL = 1e-5
BLOCKS = 2
EXP = "exp-eval"


@pytest.fixture(scope="module")
def shallow():
    """Both packages' ResNet-Conformer cut to ``BLOCKS`` blocks."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_rc, "ResNetConformer",
               functools.partial(jax_rc.ResNetConformer, num_layers=BLOCKS))
    mp.setitem(port_wrapper.ENCODERS, "resnet-conformer",
               functools.partial(port_rc.ResNetConformer, num_layers=BLOCKS))
    yield
    mp.undo()


@pytest.fixture(scope="module")
def experiment(shallow, module_tmp):
    root = str(module_tmp("eval"))
    data = make_synth_dataset(os.path.join(root, "data"), n_train=1, n_val=2,
                              n_test=2, eval_secs=3, seed=5)
    cfg = jax_config.Config()
    cfg = dataclasses.replace(
        cfg, args=dataclasses.replace(cfg.args, exp_id=EXP, encoder="resnet-conformer"),
        data=dataclasses.replace(cfg.data, data_pth=data,
                                 name_pth=os.path.join(data, "classes.txt")),
        train=dataclasses.replace(cfg.train, max_targets_per_clip=64))
    model = jax_wrapper.build_model(cfg, "float32")
    # eager, as JAX test_model's own init is: that one then finds its
    # per-op compilations done
    state = jax_train_step.init_state(cfg, model, jax_evaluate.make_frontend(cfg),
                                      jax.random.PRNGKey(11))
    variables = {"params": jax.tree_util.tree_map(np.asarray, state.params),
                 "batch_stats": jax.tree_util.tree_map(np.asarray, state.batch_stats)}

    pcfg = port_config(cfg)
    tm = port_wrapper.build_model(pcfg, device="cpu")
    tm.load_state_dict(state_dict_from_flax(variables, "resnet-conformer"))
    frontend = evaluate.make_frontend(pcfg, device="cpu")
    fwd = evaluate.build_eval_forward(tm, frontend)
    outs, confs = {}, []
    for split in ("val", "test"):
        for item in EvalLoader(SELDDataset(pcfg, split, is_valid=True), pcfg):
            out = fwd(item["audio"], item["valid_feat_frames"])
            outs[item["name"]] = (out, item["nb_label_frames"])
            cls, _, _ = _device_decode(out[:, :item["nb_label_frames"]],
                                       port_wrapper.make_grid_geometry(pcfg), 13)
            confs.append(cls.numpy().ravel())
    tau, gap = _gap_threshold(np.concatenate(confs))
    assert gap > 1e-5, gap

    results = os.path.join(root, "results")
    exp_dir = os.path.join(results, EXP)
    jax_config.save_config(jax_config.with_conf_thresh(cfg, tau),
                           os.path.join(exp_dir, "hyp_exp.yaml"))
    save_checkpoint(os.path.join(exp_dir, "model_best.ckpt"), state,
                    {"epoch_nb": 0, "confidence_thresh": tau})
    return {"cfg": cfg, "pcfg": pcfg, "results": results, "exp_dir": exp_dir,
            "outs": outs, "tau": tau}


def _record(mp, module, log):
    """Wrap ``module.test_epoch`` and ``module._print_scores`` to keep each
    sweep's loss, CSVs and printed scores."""
    orig = module.test_epoch

    def test_epoch(*a, **kw):
        res = orig(*a, **kw)
        out_dir = a[5] if module is jax_evaluate else a[3]
        csvs = {n: _read_csv(os.path.join(out_dir, n)) for n in sorted(os.listdir(out_dir))}
        log["sweeps"].append((res if module is jax_evaluate else res[0], csvs))
        return res

    mp.setattr(module, "test_epoch", test_epoch)
    mp.setattr(module, "_print_scores", lambda tag, s: log["scores"].append(
        [float(v) for v in s[:5]]))


def test_test_model_matches_jax(experiment):
    results = experiment["results"]
    port, ref = {"sweeps": [], "scores": []}, {"sweeps": [], "scores": []}
    with pytest.MonkeyPatch.context() as mp:
        _record(mp, jax_evaluate, ref)
        jax_evaluate.test_model({"action": "test", "eval_pth": EXP}, results_dir=results)
    with pytest.MonkeyPatch.context() as mp:
        _record(mp, evaluate, port)
        assert cli.main(["test", "--eval_pth", EXP, "--results_dir", results,
                         "--device", "cpu"]) == 0
    assert len(port["sweeps"]) == len(ref["sweeps"]) == 3  # unify 15, 30, 45
    assert len(port["scores"]) == len(ref["scores"]) == 9  # overall, any, classwise
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
    assert all(np.isfinite(s).all() for s in port["scores"])


def test_val_writes_one_csv_per_clip(experiment):
    assert cli.main(["val", "--eval_pth", EXP, "--results_dir", experiment["results"],
                     "--device", "cpu"]) == 0
    assert sorted(os.listdir(os.path.join(experiment["exp_dir"], "output_eval"))) == \
        ["val000.csv", "val001.csv"]


def test_eval_criterion_matches_jax(experiment):
    cfg, pcfg = experiment["cfg"], experiment["pcfg"]
    rng = np.random.default_rng(3)
    T, valid = 50, 37
    logits = rng.normal(0, 2, (1, T, 2560)).astype(np.float32)
    label = {int(f): [[int(rng.integers(13)), 0, float(rng.uniform(-180, 180)),
                       float(rng.uniform(-90, 90))] for _ in range(int(rng.integers(1, 3)))]
             for f in rng.choice(T, 30, replace=False)}
    # targets lie in the valid frames, as the eval loader encodes them
    targets, mask = pad_yolo_targets(
        [encode_adyolo(label, valid, port_wrapper.make_grid_geometry(pcfg))], 256)
    want = float(jax_train_step.build_eval_criterion(cfg, jax_wrapper.make_criterion(cfg))(
        jnp.asarray(logits), jnp.asarray(targets), jnp.asarray(mask),
        jnp.asarray([valid], jnp.int32)))
    got = float(build_eval_criterion(pcfg)(torch.tensor(logits), targets, mask, [valid]))
    assert np.isfinite(got) and abs(got - want) <= CRIT_REL * abs(want), (got, want)
    full = float(build_eval_criterion(pcfg)(torch.tensor(logits), targets, mask, [T]))
    assert full != got  # the mask takes frames out


def test_cached_decode_matches_jax_at_every_tau(experiment, tmp_path):
    cfg, pcfg = experiment["cfg"], experiment["pcfg"]
    port_pp, jax_pp = PostProcessor(pcfg), JaxPostProcessor(cfg)
    val = {n: v for n, v in experiment["outs"].items() if n.startswith("val")}
    cached = [(n, port_pp.candidates(out, min(port_train.TAU_SCAN)), t)
              for n, (out, t) in val.items()]
    for tau in port_train.TAU_SCAN:
        port_pp.set_conf_thresh(tau)
        jax_pp.set_conf_thresh(tau)
        for name, cache, t in cached:
            got = port_pp.postprocess_cached(cache, t)
            assert got == jax_pp.postprocess_cached(cache, t), (tau, name)
            if tau in (0.1, 0.5):  # and the cache decodes as the logits do
                assert got == port_pp.postprocess(val[name][0], t), (tau, name)

    # the engine's scan: each τ's SELD from the CSVs of those detections,
    # and the τ of the lowest
    ref_dir = os.path.join(pcfg.data.data_pth, "metadata_dev", "dev-val")
    scorer = SegmentScorer(ref_dir, nb_classes=13, nb_label_frames_1s=10)
    fwd = lambda audio, valid: val[audio][0]  # noqa: E731 - outputs by clip name
    loader = [{"name": n, "audio": n, "valid_feat_frames": None, "nb_label_frames": t}
              for n, (_, t) in val.items()]
    tau, scan = port_train.scan_conf_thresh(loader, fwd, PostProcessor(pcfg), scorer,
                                            str(tmp_path / "scan"))
    seld = {t: s[4] for t, s in scan["scores"]}
    assert [t for t, _ in scan["scores"]] == list(port_train.TAU_SCAN)
    assert tau == min(seld, key=lambda k: (seld[k], k))
    jax_pp.set_conf_thresh(tau)
    jax_evaluate.decode_cached_to_csv(cached, jax_pp, str(tmp_path / "jax"))
    assert scorer.get_SELD_Results(str(tmp_path / "jax"))[4] == seld[tau]


def test_min_conf_guard_keeps_the_cache_exact():
    """More than ``decode_topk`` anchors of a frame between 0.1 and 0.5: a
    cache built at threshold 0.5 must still hold them all for τ = 0.1."""
    cfg = port_config(jax_config.Config())
    pp = PostProcessor(cfg)  # threshold 0.5, top-k 16
    full = PostProcessor(dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, decode_topk=0)))
    rng = np.random.default_rng(9)
    T = 12
    x = rng.normal(0, 1, (1, T, 160, 16)).astype(np.float32)
    x[..., 0] = -6.0  # objectness logits: low ...
    x[:, :, :40, 0] = rng.uniform(-2.0, -0.1, (1, T, 40))  # ... 40 anchors in (0.12, 0.48)
    x[..., 1:14] = rng.uniform(0.0, 4.0, (1, T, 160, 13))
    logits = torch.tensor(x.reshape(1, T, -1))
    cache = pp.candidates(logits, 0.1)
    pp.set_conf_thresh(0.1)
    full.set_conf_thresh(0.1)
    want = full.postprocess(logits)
    assert sum(len(v) for v in want.values()) > 0
    assert pp.postprocess_cached(cache) == want
    # a set built at 0.5 refuses a lower threshold rather than miss candidates
    pp.set_conf_thresh(0.5)
    coarse = pp.candidates(logits)
    pp.set_conf_thresh(0.1)
    with pytest.raises(ValueError, match="min_conf"):
        pp.postprocess_cached(coarse)
    # the top-k alone, guarded at 0.5, would have lost candidates at 0.1
    pp.set_conf_thresh(0.5)
    cls, obj, _ = pp.adyolo_candidates(logits)
    assert obj.shape[1] == 16 and int((obj > 0.1).sum()) < int(
        (torch.sigmoid(logits.reshape(1, T, 160, 16)[..., 0]) > 0.1).sum())


def test_eval_forward_runs_the_model_in_eval_mode(shallow):
    """A train step leaves the module in training mode; the eval forward must
    still give the eval-mode logits (BatchNorm on running stats, no
    dropout), after each of two train steps."""
    jcfg = jax_config.Config()
    jcfg = dataclasses.replace(
        jcfg, args=dataclasses.replace(jcfg.args, encoder="resnet-conformer"),
        train=dataclasses.replace(jcfg.train, max_targets_per_clip=32))
    cfg = port_config(jcfg)
    model = port_wrapper.build_model(cfg, device="cpu",
                                     generator=torch.Generator().manual_seed(0), train=True)
    frontend = evaluate.make_frontend(cfg, device="cpu")
    step = build_train_step(cfg, model, frontend)
    fwd = evaluate.build_eval_forward(model, frontend)
    rng = np.random.default_rng(2)
    geom = port_wrapper.make_grid_geometry(cfg)
    targets, mask = pad_yolo_targets(
        [encode_adyolo({3: [[1, 0, 30.0, 10.0]]}, 10, geom)] * 2, 64)
    gen = torch.Generator().manual_seed(1)
    audio = rng.standard_normal((1, 40, 600, 4)).astype(np.float32) * 0.05
    for _ in range(2):
        batch = {"audio": (rng.standard_normal((2, 40, 600, 4)) * 1500).astype(np.int16),
                 "targets": targets, "target_mask": mask}
        assert np.isfinite(float(step(batch, gen)))
        assert model.training
        got = fwd(audio)
        ref = copy.deepcopy(model).eval()
        with torch.inference_mode():
            want = ref(frontend(torch.tensor(audio)))
        assert torch.equal(got, want)
