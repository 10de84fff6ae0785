"""The dense output formats (SED-DOA, masked SED-DOA, ACCDOA, ADPIT) in the
port vs the JAX package, on the CPU.

* Heads: each flax head (``SEDDOAHead``, ``ACCDOAHead``, ``ADPITHead``)
  initialised by JAX, carried into the port's ``SELDModel`` by
  ``convert.state_dict_from_flax`` inside a whole-model tree: outputs within
  1e-4 abs (the AD-YOLO head's tolerance in ``tests/test_torch_models.py``).
  Every loss's model converts both ways: the port's state dict ->
  ``flax_from_state_dict`` has the leaves (paths and shapes) of the JAX
  model's ``init`` and comes back equal; a tree with another head raises.
  ``init_params`` draws every head's Linears xavier-uniform, biases 0.
* Losses: ``seddoa_loss`` (plain and masked), ``accdoa_loss`` and
  ``adpit_loss`` with and without a frame mask, on SED probabilities that
  include exact 0 and 1 and ADPIT frames holding 1, 2 and 3 same-class
  events: in float64 the loss within 1e-10 rel and the gradient within
  1e-8 x max|grad|; in float32 the loss within 1e-5 rel.
  ``_log_clamped`` at p = 0, 1, 1e-39 and 1e-30: value and gradient equal.
* Labels: ``encode_seddoa`` / ``encode_accdoa`` / ``encode_adpit`` equal
  (``np.array_equal``); the train loader's dense batches over two epochs
  (rotation on) and the eval loader's bucket-padded items equal, with no
  ``target_mask``.
* Decoders: ``PostProcessor`` of each dense format, ADPIT at unify 15, 30
  and 45 on tracks built to agree in pairs and all three: equal frames and
  classes, xyz within 1e-6; the cached decode equals the direct one.
* Train step: three port steps of SE-ResNet34 with each dense head from its
  seeded init (dropout off on both sides), the JAX step taking the same
  batch from the port's state before each: the loss within 1e-4 rel.

``test_model`` on JAX-format experiments and ``cli train --quick_test`` of
each format are in ``tests/test_torch_formats_engine.py``.
"""
import dataclasses
import os
import random

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from adyolo_tpu import config as jax_config
from adyolo_tpu.data import dataset as jax_dataset
from adyolo_tpu.data import labels as jax_labels
from adyolo_tpu.models import heads as jax_heads
from adyolo_tpu.models import layers as jax_layers
from adyolo_tpu.models import losses as jax_losses
from adyolo_tpu.models.wrapper import build_model as jax_build_model
from adyolo_tpu.ops.decode import PostProcessor as JaxPostProcessor
from adyolo_tpu.ops.features import FeatureFrontend as JaxFrontend
from adyolo_tpu.ops.features import Scaler as JaxScaler
from adyolo_tpu.parallel import train_step as jax_train_step
from adyolo_tpu_torch.convert import flax_from_state_dict, state_dict_from_flax
from adyolo_tpu_torch.data import dataset as port_dataset
from adyolo_tpu_torch.data import labels as port_labels
from adyolo_tpu_torch.models import losses as port_losses
from adyolo_tpu_torch.models.layers import U8Dropout
from adyolo_tpu_torch.models.wrapper import build_model
from adyolo_tpu_torch.ops.decode import PostProcessor
from adyolo_tpu_torch.ops.features import FeatureFrontend, Scaler
from adyolo_tpu_torch.parallel.train_step import build_train_step

from tests.synth_data import make_synth_dataset
from tests.test_torch_config import one_torch_thread, port_config  # noqa: F401
from tests.test_torch_features import _scaler_dict

pytestmark = pytest.mark.usefixtures("one_torch_thread")

DENSE = ("seddoa", "masked-seddoa", "accdoa", "adpit")
K = 13
HEAD_TOL = 1e-4
LOSS_REL_F64, GRAD_TOL_F64 = 1e-10, 1e-8
LOSS_REL_F32 = 1e-5
XYZ_TOL = 1e-6
STEP_LOSS_REL = 1e-4
JAX_HEADS = {"seddoa": jax_heads.SEDDOAHead, "masked-seddoa": jax_heads.SEDDOAHead,
             "accdoa": jax_heads.ACCDOAHead, "adpit": jax_heads.ADPITHead}
OUT_DIM = {"seddoa": 4 * K, "masked-seddoa": 4 * K, "accdoa": 3 * K, "adpit": 9 * K}


def _cfgs(loss, **data):
    jcfg = jax_config.Config()
    jcfg = dataclasses.replace(
        jcfg, args=dataclasses.replace(jcfg.args, loss=loss),
        data=dataclasses.replace(jcfg.data, **data),
        train=dataclasses.replace(jcfg.train, dropout_rng="threefry"))
    return jcfg, port_config(jcfg)


# ---- heads and conversion ---------------------------------------------------


@pytest.mark.parametrize("loss", DENSE)
def test_head_carried_by_convert_matches_jax(loss):
    _, cfg = _cfgs(loss)
    x = np.random.default_rng(0).standard_normal((2, 5, 256)).astype(np.float32)
    jhead = JAX_HEADS[loss](K, 256)
    hv = jax.tree_util.tree_map(
        np.asarray, jhead.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"])
    want = np.asarray(jhead.apply({"params": hv}, jnp.asarray(x)))
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    tree = flax_from_state_dict(model.state_dict())
    tree["params"]["head"] = hv
    model.load_state_dict(state_dict_from_flax(tree, "se-resnet34", loss), strict=True)
    with torch.no_grad():
        got = model.head(torch.tensor(x)).numpy()
    assert got.shape == want.shape == (2, 5, OUT_DIM[loss])
    assert float(np.abs(got - want).max()) <= HEAD_TOL
    if loss.endswith("seddoa"):  # sigmoid activities, tanh(3K) doa
        assert (got[..., :K] > 0).all() and (got[..., :K] < 1).all()


@pytest.mark.parametrize("encoder,loss", [("se-resnet34", l) for l in DENSE]
                         + [("resnet-conformer", "adpit")])
def test_conversion_round_trip_and_strictness(encoder, loss):
    jcfg, cfg = _cfgs(loss)
    jcfg = dataclasses.replace(jcfg, args=dataclasses.replace(jcfg.args, encoder=encoder))
    cfg = dataclasses.replace(cfg, args=dataclasses.replace(cfg.args, encoder=encoder))
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    tree = flax_from_state_dict(model.state_dict())
    shapes = jax.eval_shape(lambda: jax_build_model(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 64, 7)), False))
    want = {jax.tree_util.keystr(p): s.shape
            for p, s in jax.tree_util.tree_leaves_with_path(dict(shapes))}
    got = {jax.tree_util.keystr(p): a.shape
           for p, a in jax.tree_util.tree_leaves_with_path(tree)}
    assert got == want
    back = state_dict_from_flax(tree, encoder, loss)
    sd = model.state_dict()
    assert back.keys() == sd.keys()
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
    # the head is that loss's: every head name is in the keys, no other
    for name, head_loss in (("sed_fc1", "seddoa"), ("accdoa_fc1", "accdoa"),
                            ("adpit_fc1", "adpit"), ("yolo_fc1", "adyolo")):
        assert (f"head.{name}.weight" in sd) == (head_loss == loss.replace("masked-", ""))
    other = "adyolo" if loss != "adyolo" else "accdoa"
    with pytest.raises(KeyError, match="unused|missing"):
        state_dict_from_flax(tree, encoder, other)
    # init_params: xavier-uniform head Linears, zero biases
    for name, mod in model.head.named_children():
        bound = np.sqrt(6.0 / (mod.in_features + mod.out_features))
        w = mod.weight.detach()
        assert float(w.abs().max()) <= bound and float(w.abs().max()) > 0.9 * bound, name
        assert float(mod.bias.detach().abs().max()) == 0.0


# ---- losses -----------------------------------------------------------------


def _adpit_labels(rng, T):
    """Frames with 1, 2, 3 and 4 events of one class, beside other classes."""
    label = {}
    for t in range(T):
        n = int(rng.integers(0, 5))
        c = int(rng.integers(K))
        evs = [[c, i, float(rng.uniform(-180, 180)), float(rng.uniform(-90, 90))]
               for i in range(n)]
        if rng.random() < 0.5:
            evs.append([(c + 1) % K, 0, float(rng.uniform(-180, 180)),
                        float(rng.uniform(-90, 90))])
        if evs:
            label[t] = evs
    return label


def _loss_inputs(loss, rng, B=2, T=12):
    labels = [_adpit_labels(rng, T) for _ in range(B)]
    enc = {"seddoa": port_labels.encode_seddoa, "masked-seddoa": port_labels.encode_seddoa,
           "accdoa": port_labels.encode_accdoa, "adpit": port_labels.encode_adpit}[loss]
    target = np.stack([enc(lab, T, K) for lab in labels])
    out = np.tanh(rng.normal(0, 1, (B, T, OUT_DIM[loss])))
    if loss.endswith("seddoa"):
        sed = 1.0 / (1.0 + np.exp(-rng.normal(0, 3, (B, T, K))))
        sed[0, 0, :4] = [0.0, 1.0, 0.0, 1.0]  # saturated sigmoids
        out[..., :K] = sed
    fm = np.ones((B, T), bool)
    fm[1, 8:] = False
    if loss == "adpit":
        counts = target[:, :, :, 0].sum(axis=(2, 3))
        assert {1, 2, 3} <= set(np.unique(target[:, :, :, 0].sum(axis=2)).astype(int))
        assert counts.max() >= 3
    return out, target, fm


def _jax_loss(loss, o, t, fm):
    if loss in ("seddoa", "masked-seddoa"):
        return jax_losses.seddoa_loss(o, t, K, masked_mse=loss == "masked-seddoa",
                                      frame_mask=fm)
    if loss == "accdoa":
        return jax_losses.accdoa_loss(o, t, frame_mask=fm)
    return jax_losses.adpit_loss(o, t, K, frame_mask=fm)


def _port_loss(loss, o, t, fm):
    if loss in ("seddoa", "masked-seddoa"):
        return port_losses.seddoa_loss(o, t, K, masked_mse=loss == "masked-seddoa",
                                       frame_mask=fm)
    if loss == "accdoa":
        return port_losses.accdoa_loss(o, t, frame_mask=fm)
    return port_losses.adpit_loss(o, t, K, frame_mask=fm)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("loss", DENSE)
def test_dense_loss_matches_jax_float64(loss, masked):
    out, target, fm = _loss_inputs(loss, np.random.default_rng(3 + masked))
    fm = fm if masked else None
    with jax.enable_x64():
        def f(o):
            return _jax_loss(loss, o, jnp.asarray(target, jnp.float64),
                             None if fm is None else jnp.asarray(fm))

        want, want_g = jax.value_and_grad(f)(jnp.asarray(out, jnp.float64))
        want, want_g = float(want), np.asarray(want_g)
    x = torch.tensor(out, dtype=torch.float64, requires_grad=True)
    got = _port_loss(loss, x, torch.tensor(target, dtype=torch.float64),
                     None if fm is None else torch.tensor(fm))
    got.backward()
    assert got.dtype == torch.float64
    got = float(got.detach())
    assert abs(got - want) <= LOSS_REL_F64 * abs(want), (got, want)
    err = float(np.abs(x.grad.numpy() - want_g).max())
    assert err <= GRAD_TOL_F64 * float(np.abs(want_g).max()), err


@pytest.mark.parametrize("loss", DENSE)
def test_dense_loss_matches_jax_float32(loss):
    out, target, fm = _loss_inputs(loss, np.random.default_rng(7))
    out, target = out.astype(np.float32), target.astype(np.float32)
    for mask in (None, fm):
        want = float(jax.jit(lambda o, t: _jax_loss(
            loss, o, t, None if mask is None else jnp.asarray(mask)))(
            jnp.asarray(out), jnp.asarray(target)))
        got = float(_port_loss(loss, torch.tensor(out), torch.tensor(target),
                               None if mask is None else torch.tensor(mask)))
        assert np.isfinite(got) and abs(got - want) <= LOSS_REL_F32 * abs(want), (got, want)


def test_log_clamped_matches_jax_at_saturation():
    p = np.asarray([0.0, 1.0, 1e-39, 1e-30, 0.5], np.float32)
    want, want_g = jax.value_and_grad(lambda q: jnp.sum(jax_losses._log_clamped(q)))(
        jnp.asarray(p))
    want_v = np.asarray(jax_losses._log_clamped(jnp.asarray(p)))
    x = torch.tensor(p, requires_grad=True)
    got = port_losses._log_clamped(x)
    got.sum().backward()
    np.testing.assert_array_equal(got.detach().numpy(), want_v)
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(want_g))
    assert got[0] == -100.0 and got[2] == -100.0  # not F.binary_cross_entropy's
    y = np.asarray([1.0, 0.0, 1.0, 1.0, 0.0], np.float32)
    np.testing.assert_array_equal(
        port_losses.bce_probs(torch.tensor(p), torch.tensor(y)).numpy(),
        np.asarray(jax_losses.bce_probs(jnp.asarray(p), jnp.asarray(y))))


# ---- labels, batches and eval items -----------------------------------------


def test_dense_label_encoders_match_jax():
    rng = np.random.default_rng(11)
    for T in (7, 20):
        label = _adpit_labels(rng, T + 3)  # frames past T are dropped
        for name in ("encode_seddoa", "encode_accdoa", "encode_adpit"):
            want = getattr(jax_labels, name)(label, T, K)
            got = getattr(port_labels, name)(label, T, K)
            assert got.dtype == want.dtype and np.array_equal(got, want), name
    assert port_labels.encode_adpit({}, 4, K).shape == (4, 6, 4, K)


@pytest.fixture(scope="module")
def synth_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("synth_formats")
    return make_synth_dataset(str(root), n_train=5, n_val=1, n_test=1,
                              train_secs=1, eval_secs=3, chunk_window_s=1, seed=6)


@pytest.mark.parametrize("loss", DENSE)
def test_dense_batches_and_eval_items_match_jax(synth_root, loss):
    jcfg, _ = _cfgs(loss, data_pth=synth_root, chunk_window_s=1)
    jcfg = dataclasses.replace(
        jcfg, aug=dataclasses.replace(jcfg.aug, rotation_augment=True),
        train=dataclasses.replace(jcfg.train, batch_size=2, nb_iters=2))
    cfg = port_config(jcfg)

    def epochs(pkg, c):
        random.seed(99)
        ds = pkg.SELDDataset(c, "train")
        loader = pkg.TrainLoader(ds, c)
        out = []
        for _ in range(2):
            out.append(list(loader))
            ds.resample_epoch()
        return out

    want, got = epochs(jax_dataset, jcfg), epochs(port_dataset, cfg)
    assert len(got) == len(want) == 2
    for ge, we in zip(got, want):
        assert len(ge) == len(we) == 2
        for g, w in zip(ge, we):
            assert set(g) == set(w) == {"audio", "targets"}
            assert g["targets"].dtype == np.float32
            assert np.array_equal(g["audio"], w["audio"])
            assert np.array_equal(g["targets"], w["targets"])
    for split in ("val", "test"):
        ws = list(jax_dataset.EvalLoader(jax_dataset.SELDDataset(jcfg, split, True), jcfg))
        gs = list(port_dataset.EvalLoader(port_dataset.SELDDataset(cfg, split, True), cfg))
        for g, w in zip(gs, ws):
            assert set(g) == set(w) and "target_mask" not in g
            assert g["nb_label_frames"] == w["nb_label_frames"]
            assert g["targets"].shape[1] * cfg.data.label_hop_len == \
                g["audio"].shape[1] * g["audio"].shape[2]  # the bucket's frames
            assert np.array_equal(g["targets"], w["targets"])
            assert np.array_equal(g["audio"], w["audio"])


# ---- decoders ---------------------------------------------------------------


def _adpit_output(rng, T):
    """(1, T, 9K) tanh tracks: per (frame, class) the tracks agree in no
    pair, in one pair (each of the three) or all three, at angles spread
    over 0-60 degrees so that every unify threshold splits them."""
    tr = rng.normal(0, 1, (T, 3, 3, K))
    base = rng.normal(0, 1, (T, 3, K))
    for t in range(T):
        for c in range(K):
            mode = int(rng.integers(5))
            for i in range(3):
                joined = mode == 4 or (mode < 3 and i != mode)
                if joined:
                    tr[t, i, :, c] = base[t, :, c] + rng.normal(0, 0.5) * rng.normal(
                        0, 1, 3)
    scale = rng.uniform(0.1, 0.9, (T, 3, 1, K)) / np.linalg.norm(tr, axis=2, keepdims=True)
    return (tr * scale).astype(np.float32).reshape(1, T, 9 * K)


def _dense_output(loss, rng, T):
    if loss == "adpit":
        return _adpit_output(rng, T)
    out = rng.uniform(-0.7, 0.7, (1, T, OUT_DIM[loss])).astype(np.float32)
    if loss.endswith("seddoa"):
        out[..., :K] = rng.uniform(0, 1, (1, T, K))
    return out


def _same(got, want):
    assert got.keys() == want.keys()
    for t in want:
        assert [r[0] for r in got[t]] == [r[0] for r in want[t]], t
        np.testing.assert_allclose(np.asarray(got[t])[:, 1:], np.asarray(want[t])[:, 1:],
                                   atol=XYZ_TOL, rtol=0)


@pytest.mark.parametrize("loss", DENSE)
def test_dense_decoders_match_jax(loss):
    jcfg, cfg = _cfgs(loss)
    rng = np.random.default_rng(21)
    x = _dense_output(loss, rng, T=40)
    jp, tp = JaxPostProcessor(jcfg), PostProcessor(cfg)
    n_dets, n_rows = set(), 0
    for tau in (0.3, 0.5):
        for unify in ((15.0, 30.0, 45.0) if loss == "adpit" else (jp.unify_thresh,)):
            for p in (jp, tp):
                p.set_conf_thresh(tau)
                p.unify_thresh = unify
            want = jp.postprocess(x, valid_label_frames=33)
            got = tp.postprocess(torch.tensor(x), valid_label_frames=33)
            _same(got, want)
            assert max(want) < 33
            _same(tp.postprocess_cached(tp.candidates(torch.tensor(x)), 33), want)
            rows = sum(len(r) for r in want.values())
            n_dets.add(rows)
            n_rows += rows
    assert n_rows > 0
    if loss == "adpit":  # the unify threshold merges tracks
        assert len(n_dets) > 2, n_dets


# ---- train step -------------------------------------------------------------

STEPS = 3


def _dense_batches(loss, cfg, rng, B=2, T=40):
    enc = {"seddoa": port_labels.encode_seddoa, "masked-seddoa": port_labels.encode_seddoa,
           "accdoa": port_labels.encode_accdoa, "adpit": port_labels.encode_adpit}[loss]
    out = []
    for _ in range(STEPS):
        labels = [_adpit_labels(rng, T // 4) for _ in range(B)]
        out.append({"audio": (rng.standard_normal((B, T, 600, 4)) * 1500).astype(np.int16),
                    "targets": np.stack([enc(lab, T // 4, K) for lab in labels]
                                        ).astype(np.float32)})
    return out


@pytest.mark.parametrize("loss", DENSE)
def test_three_train_steps_match_jax(loss):
    jcfg, cfg = _cfgs(loss)
    batches = _dense_batches(loss, cfg, np.random.default_rng(5))
    d = _scaler_dict()
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0),
                        train=True)
    for m in model.modules():
        if isinstance(m, U8Dropout):
            m.rate = 0.0
    step = build_train_step(cfg, model, FeatureFrontend(cfg.data, Scaler.from_dict(d),
                                                        device="cpu"))
    named = dict(model.named_parameters())
    before, losses = [], []
    for i, b in enumerate(batches):
        moments = {k: flax_from_state_dict(
            {n: step.optimizer.state[p][k] for n, p in named.items()})["params"]
            for k in ("exp_avg", "exp_avg_sq")} if i else None
        before.append((flax_from_state_dict(model.state_dict()), moments))
        losses.append(float(step(b)))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_layers.U8Dropout, "__call__", lambda self, x: x)
        jstep = jax_train_step.build_train_step(
            jcfg, jax_build_model(jcfg), JaxFrontend(jcfg.data, JaxScaler.from_dict(d)))
        tx = jax_train_step.make_optimizer(jcfg)
        for i, (b, (v, moments)) in enumerate(zip(batches, before)):
            params = jax.tree_util.tree_map(jnp.asarray, v["params"])
            adam, rest = tx.init(params)
            if moments is not None:
                adam = adam._replace(count=jnp.asarray(i, jnp.int32),
                                     mu=moments["exp_avg"], nu=moments["exp_avg_sq"])
            state = jax_train_step.TrainState(
                params, jax.tree_util.tree_map(jnp.asarray, v["batch_stats"]),
                (adam, rest), jnp.asarray(i, jnp.int32))
            _, want = jstep(state, b, jax.random.PRNGKey(i))
            want = float(want)
            assert np.isfinite(losses[i])
            assert abs(losses[i] - want) <= STEP_LOSS_REL * abs(want), (i, losses[i], want)
    assert losses[-1] != losses[0]
