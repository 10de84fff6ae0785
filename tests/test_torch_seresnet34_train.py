"""SE-ResNet34 training in the port vs ``adyolo_tpu.parallel.train_step``.

The f32 train step, held as ``tests/test_torch_train_step.py`` holds the
conformer's (its ``_runs`` drives both frameworks): SE-ResNet34 + AD-YOLO
at full width (13 classes, 8 x 4 grid, 5 anchors), B=2 one-second chunks
(40 feature frames) of int16 FOA audio, a non-identity scaler, Adam at lr
1e-3, float32, dropout off on both sides (the JAX ``U8Dropout`` patched to
the identity, the port's BiGRU dropout rate set to 0).  Three port steps
from its seeded init; before each, the port's whole state is carried to a
JAX ``TrainState`` and the JAX step takes the same batch from it.  Held:
the loss within 1e-4 rel at every step, the BatchNorm running stats after
each step within 1e-4 abs, and the port's model in float64 within 1e-6 of
each tensor's max|grad| of the JAX loss in float64 (measured: 6e-8).

The port's float32 step-1 gradients are held against the same float64
gradients: each tensor within 1e-4 of its max|grad|, or, where float32
cannot get that close, no farther than 2x the JAX package's own float32
gradient from the same state and features.  On this batch both float32
gradients of 25 tensors of the SE stack lie 1e-4 to 6.7e-3 of their max
from float64 (worst: ``layer4_block2.conv1``, whose BatchNorm sees 320
values a channel), and the port's within 1.02x of JAX's (measured): the
distance is float32's, not either framework's.

The BiGRU's inter-layer dropout (rate 0.3): ``t = round(0.3 * 256) = 77``
and keep-scale 256/179 on both sides; on the port's train step the same
generator seed gives the same loss and another seed another one, and
eval mode drops nothing.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from adyolo_tpu import config as jax_config
from adyolo_tpu.models import layers as jax_layers
from adyolo_tpu.models import wrapper as jax_wrapper
from adyolo_tpu.models.wrapper import build_model as jax_build_model
from adyolo_tpu_torch.models.layers import BiGRU, U8Dropout
from adyolo_tpu_torch.models.wrapper import build_model
from adyolo_tpu_torch.ops.features import FeatureFrontend, Scaler
from adyolo_tpu_torch.parallel.train_step import build_train_step

from tests import test_torch_train_step as conformer_step
from tests.test_torch_config import one_torch_thread, port_config  # noqa: F401
from tests.test_torch_features import _scaler_dict

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _configs():
    jcfg = jax_config.Config()
    assert jcfg.args.encoder == "se-resnet34"
    jcfg = dataclasses.replace(
        jcfg, train=dataclasses.replace(jcfg.train, max_targets_per_clip=32,
                                        dropout_rng="threefry"))
    return jcfg, port_config(jcfg)


GRAD_JAX_RATIO = 2.0  # the float32 gradients: at most this x JAX's own error


@pytest.fixture(scope="module")
def runs():
    jcfg, cfg = _configs()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_layers.U8Dropout, "__call__", lambda self, x: x)
        port, ref = conformer_step._runs(jcfg, cfg)
        # JAX's float32 gradient of step 1's loss, from the same state
        jm = jax_build_model(jcfg)
        criterion = jax_wrapper.make_criterion(jcfg)
        v = jax.tree_util.tree_map(jnp.asarray, port["state0"])
        b = port["batch0"]

        def loss_fn(params):
            out, _ = jm.apply({"params": params, "batch_stats": v["batch_stats"]},
                              jnp.asarray(port["feat"]), True, mutable=["batch_stats"])
            return jnp.squeeze(criterion(out, jnp.asarray(b["targets"]),
                                         jnp.asarray(b["target_mask"])))

        ref["grads_f32"] = jax.jit(jax.grad(loss_fn))(v["params"])
    return port, ref


def test_losses_match_jax(runs):
    port, ref = runs
    for got, want in zip(port["losses"], ref["losses"]):
        assert np.isfinite(got)
        assert abs(got - want) <= conformer_step.LOSS_REL * abs(want), (port["losses"],
                                                                         ref["losses"])
    assert port["losses"][-1] != port["losses"][0]


def test_step1_gradients_match_jax(runs):
    port, ref = runs
    got, want = conformer_step._tree(port["grads"]), conformer_step._tree(ref["grads"])
    jax32 = conformer_step._tree(ref["grads_f32"])
    assert got.keys() == want.keys() == jax32.keys()
    top = max(float(np.abs(w).max()) for w in want.values())
    for path, w in want.items():
        scale = float(np.abs(w).max())
        if scale <= conformer_step.ZERO_GRAD * top:
            scale = top
        err = float(np.abs(np.asarray(got[path], np.float64) - w).max())
        err_jax = float(np.abs(np.asarray(jax32[path], np.float64) - w).max())
        assert err <= max(conformer_step.GRAD_TOL * scale, GRAD_JAX_RATIO * err_jax), (
            jax.tree_util.keystr(path), err, err_jax, scale)
    assert "gru" in ref["grads"]["encoder"]  # the BiGRU trains


def test_step1_gradients_match_jax_float64(runs):
    port, ref = runs
    conformer_step._hold_gradients(port["grads_f64"], ref["grads"],
                                   conformer_step.GRAD_TOL_F64)


def test_batch_stats_after_three_steps_match_jax(runs):
    port, ref = runs
    for i in range(conformer_step.STEPS):
        got, want = conformer_step._tree(port["stats"][i]), conformer_step._tree(ref["stats"][i])
        assert got.keys() == want.keys() and len(want) > 0
        for path, w in want.items():
            np.testing.assert_allclose(got[path], w, atol=conformer_step.STATS_TOL, rtol=0,
                                       err_msg=f"step {i + 1} {jax.tree_util.keystr(path)}")


def test_gru_dropout_quantizes_as_jax():
    """Rate 0.3 -> t = 77 and keep-scale 256/179 (float32) on both sides;
    the port keeps 179/256 of a large tensor (+- 0.005)."""
    x = np.ones((64, 50, 256), np.float32)
    jd = jax_layers.U8Dropout(0.3)
    want = np.asarray(jd.apply({}, jnp.asarray(x), rngs={"dropout": jax.random.PRNGKey(0)}))
    drop = U8Dropout(0.3).train()
    got = drop(torch.tensor(x), torch.Generator().manual_seed(0)).numpy()
    scale = np.float32(256.0 / 179.0)
    for out in (got, want):
        assert set(np.unique(out)) == {np.float32(0.0), scale}
    assert abs(float((got != 0).mean()) - 179 / 256) < 0.005
    assert BiGRU(8, 4).drop.rate == 0.3


def test_gru_dropout_follows_the_generator():
    """The port's SE-ResNet34 train step with its BiGRU dropout on: two
    runs from the same weights and the same generator seed give equal
    losses; another seed gives another loss; in eval mode the forward is
    the same whatever the generator."""
    _, cfg = _configs()
    batch = conformer_step._batches(cfg, np.random.default_rng(3))[0]
    fe = FeatureFrontend(cfg.data, Scaler.from_dict(_scaler_dict()), device="cpu")

    def loss(seed):
        model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0),
                            train=True)
        assert model.encoder.gru.drop.rate == 0.3 and model.encoder.gru.training
        return float(build_train_step(cfg, model, fe)(batch, torch.Generator().manual_seed(seed)))

    first = loss(5)
    assert loss(5) == first
    assert loss(6) != first
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    feat = torch.randn(2, 40, 64, 7, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        a = model(feat, generator=torch.Generator().manual_seed(1))
        b = model(feat, generator=torch.Generator().manual_seed(2))
    assert torch.equal(a, b)
