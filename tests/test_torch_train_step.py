"""The port's train step vs ``adyolo_tpu.parallel.train_step.build_train_step``.

ResNet-Conformer + AD-YOLO at full width (13 classes, 8 x 4 grid, 5
anchors) with its Conformer cut to 2 blocks on both sides (dilations 1
and 2; the JAX compile of 8 takes twice as long), B=2 one-second chunks
(40 feature frames) of int16 FOA audio, a non-identity scaler, AD-YOLO
targets from the port's ``encode_adyolo`` / ``pad_yolo_targets``, Adam at
lr 1e-3, float32, dropout off on both sides (the JAX ``U8Dropout`` patched
to the identity, the port's rates set to 0).  The port takes three steps
from its seeded init on three batches; before each, its whole state
(weights, BatchNorm running stats, Adam's moments and count) is carried to
a JAX ``TrainState`` (``flax_from_state_dict``) and the JAX step takes the
same batch from it.  Held, at every step: the loss within 1e-4 rel and
the BatchNorm running stats after the step within 1e-4 abs (after step 3
too).

The step-1 gradients are held against the JAX package's own function in
float64: ``model.apply(..., True, mutable=["batch_stats"])`` and
``make_criterion``, the loss that ``build_train_step`` differentiates,
under ``jax.enable_x64`` with ``compute_dtype=float64``, from the state
the port's step 1 starts from and at its features.  The port's float32
step must come within 1e-4 of each tensor's own max|grad|, and the port's
model in float64 (``.double()``, plain attention) within 1e-6.  A tensor
whose true gradient is zero (the key biases under the softmax, the biases
and LayerNorm shift in front of a BatchNorm: below 1e-8 of the largest
gradient in float64) is held against the largest gradient instead.

Why not the JAX float32 step's own gradients: on the CPU, XLA's float32
gradients of the ResNet lie up to 1.3e-2 * max|grad| from its own float64
ones on this batch (1.8e-1 of one tensor's max), while the port's float32
gradients lie within 6e-5 of each tensor's max from both frameworks'
float64 ones, which agree within 4e-7 (measured).  Above the ResNet all
four agree within 5e-6 * max|grad|.

Why each JAX step starts from the port's state rather than its own: two
float32 trajectories part after one step.  Adam's first step is ~lr *
sign(g), so gradient noise of 1e-7 on the parameters whose true gradient
is 0 (the key biases, the biases before a BatchNorm) moves them by up to
lr: one step later the two losses differ by ~1e-3 rel (measured).  The
optimizers themselves are held against optax below.

The JAX step uses its default (sorted) AD-YOLO loss, the port the scatter
form: the two are the same function (``tests/test_torch_losses.py``).
"""
import copy
import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from adyolo_tpu import config as jax_config
from adyolo_tpu.models import layers as jax_layers
from adyolo_tpu.models import resnet_conformer as jax_rc
from adyolo_tpu.models import wrapper as jax_wrapper
from adyolo_tpu.models.wrapper import build_model as jax_build_model
from adyolo_tpu.ops.features import FeatureFrontend as JaxFrontend
from adyolo_tpu.ops.features import Scaler as JaxScaler
from adyolo_tpu.parallel import train_step as jax_train_step
from adyolo_tpu_torch.convert import flax_from_state_dict
from adyolo_tpu_torch.data.labels import encode_adyolo, pad_yolo_targets
from adyolo_tpu_torch.models.layers import U8Dropout
from adyolo_tpu_torch.models import resnet_conformer as port_rc
from adyolo_tpu_torch.models import wrapper as port_wrapper
from adyolo_tpu_torch.models.resnet_conformer import MHSA
from adyolo_tpu_torch.ops import attention
from adyolo_tpu_torch.models.wrapper import build_model, make_grid_geometry
from adyolo_tpu_torch.ops.features import FeatureFrontend, Scaler
from adyolo_tpu_torch.parallel.train_step import build_train_step, make_optimizer

from tests.test_torch_config import one_torch_thread, port_config  # noqa: F401
from tests.test_torch_features import _scaler_dict

pytestmark = pytest.mark.usefixtures("one_torch_thread")

LOSS_REL = 1e-4
GRAD_TOL = 1e-4  # the float32 step, relative to each tensor's max|grad|
GRAD_TOL_F64 = 1e-6  # the port's model in float64, the same
ZERO_GRAD = 1e-8  # a true gradient below this share of the largest is 0
STATS_TOL = 1e-4
B, T, STEPS = 2, 40, 3
BLOCKS = 2  # Conformer blocks on both sides (8 at full depth)


def _batches(cfg, rng):
    geom = make_grid_geometry(cfg)
    frames = T // 4
    out = []
    for _ in range(STEPS):
        labels = [{int(f): [[int(rng.integers(13)), 0, float(rng.uniform(-180, 180)),
                             float(rng.uniform(-90, 90))]]
                   for f in rng.choice(frames, 4, replace=False)} for _ in range(B)]
        targets, mask = pad_yolo_targets(
            [encode_adyolo(lab, frames, geom) for lab in labels],
            cfg.train.max_targets_per_clip * B)
        audio = (rng.standard_normal((B, T, 600, 4)) * 1500).astype(np.int16)
        out.append({"audio": audio, "targets": targets, "target_mask": mask})
    return out


def _tree(t):
    return dict(jax.tree_util.tree_leaves_with_path(t))


@pytest.fixture(scope="module")
def runs():
    jcfg = jax_config.Config()
    jcfg = dataclasses.replace(
        jcfg, args=dataclasses.replace(jcfg.args, encoder="resnet-conformer"),
        train=dataclasses.replace(jcfg.train, max_targets_per_clip=32,
                                  dropout_rng="threefry"))
    cfg = port_config(jcfg)
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_layers.U8Dropout, "__call__", lambda self, x: x)
    mp.setattr(jax_rc, "ResNetConformer", functools.partial(jax_rc.ResNetConformer,
                                                            num_layers=BLOCKS))
    mp.setitem(port_wrapper.ENCODERS, "resnet-conformer",
               functools.partial(port_rc.ResNetConformer, num_layers=BLOCKS))
    try:
        return _runs(jcfg, cfg)
    finally:
        mp.undo()


def _runs(jcfg, cfg):
    batches = _batches(cfg, np.random.default_rng(0))
    d = _scaler_dict()

    # the port: seeded init, dropout off, three steps; its state before each
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0),
                        train=True)
    for m in model.modules():
        if isinstance(m, U8Dropout):
            m.rate = 0.0
        elif isinstance(m, MHSA):
            m.dropout = 0.0
    frontend = FeatureFrontend(cfg.data, Scaler.from_dict(d), device="cpu")
    step = build_train_step(cfg, model, frontend)
    model64 = copy.deepcopy(model).double()
    named = dict(model.named_parameters())
    before, losses, stats, grads = [], [], [], None
    for i, b in enumerate(batches):
        moments = {k: flax_from_state_dict(
            {n: step.optimizer.state[p][k] for n, p in named.items()})["params"]
            for k in ("exp_avg", "exp_avg_sq")} if i else None
        before.append((flax_from_state_dict(model.state_dict()), moments))
        losses.append(float(step(b)))
        stats.append(flax_from_state_dict(model.state_dict())["batch_stats"])
        if i == 0:
            grads = _params_tree({n: p.grad for n, p in named.items()})
    # step 1's features, as the step computes them
    with torch.no_grad():
        feat = frontend(torch.as_tensor(batches[0]["audio"]).float() / 32768.0 + 1e-8)
    port = {"losses": losses, "grads": grads, "stats": stats, "state0": before[0][0],
            "feat": feat.numpy(), "batch0": batches[0]}

    # the port's model in float64 at step 1, on the plain attention
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_rc, "flash_attention", attention.mhsa_attention)
        loss = port_wrapper.make_criterion(cfg)(
            model64(feat.double()), torch.as_tensor(batches[0]["targets"]),
            torch.as_tensor(batches[0]["target_mask"]))
        loss.backward()
    port["grads_f64"] = _params_tree({n: p.grad for n, p in model64.named_parameters()})

    # JAX: one step from each of those states, on the same batch
    jm = jax_build_model(jcfg)
    jstep = jax_train_step.build_train_step(
        jcfg, jm, JaxFrontend(jcfg.data, JaxScaler.from_dict(d)))
    tx = jax_train_step.make_optimizer(jcfg)
    ref = {"losses": [], "stats": []}
    for i, (b, (v, moments)) in enumerate(zip(batches, before)):
        params = jax.tree_util.tree_map(jnp.asarray, v["params"])
        adam, rest = tx.init(params)
        if moments is not None:
            adam = adam._replace(count=jnp.asarray(i, jnp.int32),
                                 mu=moments["exp_avg"], nu=moments["exp_avg_sq"])
        state = jax_train_step.TrainState(
            params, jax.tree_util.tree_map(jnp.asarray, v["batch_stats"]),
            (adam, rest), jnp.asarray(i, jnp.int32))
        state, loss = jstep(state, b, jax.random.PRNGKey(i))
        ref["losses"].append(float(loss))
        ref["stats"].append(jax.tree_util.tree_map(np.asarray, state.batch_stats))

    # JAX in float64: the gradient of step 1's loss, from the same state
    with jax.enable_x64():
        jm64 = jm.clone(compute_dtype=jnp.float64)
        criterion = jax_wrapper.make_criterion(jcfg)
        v = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), before[0][0])
        x = jnp.asarray(feat.numpy(), jnp.float64)

        def loss_fn(params):
            out, _ = jm64.apply({"params": params, "batch_stats": v["batch_stats"]},
                                x, True, mutable=["batch_stats"])
            return jnp.squeeze(criterion(out, jnp.asarray(batches[0]["targets"]),
                                         jnp.asarray(batches[0]["target_mask"])))

        ref["grads"] = jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float64), jax.jit(jax.grad(loss_fn))(v["params"]))
    return port, ref


def _params_tree(grads):
    return flax_from_state_dict({n: g.detach().double() for n, g in grads.items()}
                                )["params"]


def _hold_gradients(got, want, tol):
    """Each tensor within ``tol`` of its own max|grad|, or of the largest
    max|grad| where its true gradient is zero."""
    got, want = _tree(got), _tree(want)
    assert got.keys() == want.keys()
    top = max(float(np.abs(w).max()) for w in want.values())
    for path, w in want.items():
        scale = float(np.abs(w).max())
        if scale <= ZERO_GRAD * top:
            scale = top
        err = float(np.abs(np.asarray(got[path], np.float64) - w).max())
        assert err <= tol * scale, (jax.tree_util.keystr(path), err, scale)


def test_losses_match_jax(runs):
    port, ref = runs
    for got, want in zip(port["losses"], ref["losses"]):
        assert np.isfinite(got)
        assert abs(got - want) <= LOSS_REL * abs(want), (port["losses"], ref["losses"])
    assert port["losses"][-1] != port["losses"][0]


def test_step1_gradients_match_jax(runs):
    port, ref = runs
    _hold_gradients(port["grads"], ref["grads"], GRAD_TOL)


def test_step1_gradients_match_jax_float64(runs):
    port, ref = runs
    _hold_gradients(port["grads_f64"], ref["grads"], GRAD_TOL_F64)


def test_batch_stats_after_three_steps_match_jax(runs):
    port, ref = runs
    for i in range(STEPS):
        got, want = _tree(port["stats"][i]), _tree(ref["stats"][i])
        assert got.keys() == want.keys() and len(want) > 0
        for path, w in want.items():
            np.testing.assert_allclose(got[path], w, atol=STATS_TOL, rtol=0,
                                       err_msg=f"step {i + 1} {jax.tree_util.keystr(path)}")


@pytest.mark.parametrize("name,wd", [("Adam", 0.0), ("Adam", 0.1), ("AdamW", 0.1),
                                     ("SGD", 0.1)])
def test_make_optimizer_matches_optax(name, wd):
    """Two updates of one parameter vector from the same gradients."""
    import optax

    jcfg = jax_config.Config()
    jcfg = dataclasses.replace(jcfg, train=dataclasses.replace(
        jcfg.train, optim=name, weight_decay=wd, lr=0.01))
    rng = np.random.default_rng(1)
    w0 = rng.standard_normal(16).astype(np.float32)
    gs = [rng.standard_normal(16).astype(np.float32) for _ in range(2)]
    tx = jax_train_step.make_optimizer(jcfg)
    w, st = jnp.asarray(w0), tx.init(jnp.asarray(w0))
    for g in gs:
        upd, st = tx.update(jnp.asarray(g), st, w)
        w = optax.apply_updates(w, upd)
    p = torch.nn.Parameter(torch.tensor(w0))
    opt = make_optimizer(port_config(jcfg), [p])
    for g in gs:
        p.grad = torch.tensor(g)
        opt.step()
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(w), atol=1e-6, rtol=0)
