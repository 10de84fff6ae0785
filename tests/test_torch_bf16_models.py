"""bf16 training forward and gradients of both encoders vs the JAX package's.

SE-ResNet34 and ResNet-Conformer (cut to 2 blocks on both sides) +
AD-YOLO at full width, training mode (BatchNorm on batch stats), dropout
off on both sides, B=2 x 40 feature frames of seeded normal features and
AD-YOLO targets.  From the same float32 weights, the port's model with
``compute_dtype=bfloat16``, the JAX model with ``compute_dtype=bfloat16``
and the JAX model in float64 (the truth, ``jax.enable_x64``) each give the
logits and the gradient of the loss.  Both bf16 paths are measured against
the truth:

* the logits' max|error|: the port's at most 2x JAX's, plus a floor of
  2^-9 * max|logit| (half a bfloat16 step);
* the gradients: the largest of each tensor's max|error| / max|true
  gradient| (the largest max|grad| where the true gradient is zero), and
  the relative L2 error of all gradients together: the port's at most 2x
  JAX's each.  At this size both frameworks' bf16 gradients are dominated
  by rounding (measured: the worst tensor 1.1 and 1.4 of its max in
  SE-ResNet34, 1.38 and 1.35 in the conformer, for the port and JAX), so a
  tensor-by-tensor ratio compares two draws of noise; the aggregates do
  not.

Also, as ``tests/test_bf16.py`` holds JAX's bf16: the parameters and their
gradients stay float32, the logits are float32, and the SE-ResNet34 bf16
logits correlate with the float32 ones above 0.999.  The conformer's do
less in both frameworks (0.992, measured; its time pooling feeds a
LayerNorm over a (2, 10) output): the port's correlation is held to at
least JAX's minus 1e-3.
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
from adyolo_tpu_torch.convert import flax_from_state_dict
from adyolo_tpu_torch.models import resnet_conformer as port_rc
from adyolo_tpu_torch.models import wrapper as port_wrapper
from adyolo_tpu_torch.models.layers import U8Dropout
from adyolo_tpu_torch.models.resnet_conformer import MHSA

from tests import test_torch_train_step as train_step_test
from tests.test_torch_config import one_torch_thread, port_config  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

BLOCKS = 2
RATIO = 2.0  # the port's bf16 error at most this x JAX's
ZERO_GRAD = 1e-8  # a true gradient below this share of the largest is 0
CORR = 0.999


def _jax_run(jcfg, variables, feat, batch, dtype):
    """JAX logits and loss gradient from ``variables`` in training mode."""
    jm = jax_wrapper.build_model(jcfg).clone(compute_dtype=dtype)
    wide = jnp.float64 if dtype == jnp.float64 else jnp.float32
    v = jax.tree_util.tree_map(lambda a: jnp.asarray(a, wide), variables)
    criterion = jax_wrapper.make_criterion(jcfg)

    def loss_fn(params):
        out, _ = jm.apply({"params": params, "batch_stats": v["batch_stats"]},
                          jnp.asarray(feat, wide), True, mutable=["batch_stats"])
        return jnp.squeeze(criterion(out, jnp.asarray(batch["targets"]),
                                     jnp.asarray(batch["target_mask"]))), out

    (_, out), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(v["params"])
    return {"out": np.asarray(out, np.float64), "out_dtype": out.dtype,
            "grads": train_step_test._tree(
                jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), grads))}


@pytest.fixture(scope="module", params=["se-resnet34", "resnet-conformer"])
def runs(request):
    enc = request.param
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jax_layers.U8Dropout, "__call__", lambda self, x: x)
        mp.setattr(jax_rc, "ResNetConformer",
                   functools.partial(jax_rc.ResNetConformer, num_layers=BLOCKS))
        mp.setitem(port_wrapper.ENCODERS, "resnet-conformer",
                   functools.partial(port_rc.ResNetConformer, num_layers=BLOCKS))
        jcfg = jax_config.Config()
        jcfg = dataclasses.replace(
            jcfg, args=dataclasses.replace(jcfg.args, encoder=enc),
            train=dataclasses.replace(jcfg.train, max_targets_per_clip=32))
        cfg = port_config(jcfg)
        batch = train_step_test._batches(cfg, np.random.default_rng(0))[0]
        feat = np.random.default_rng(1).standard_normal((2, 40, 64, 7)).astype(np.float32)
        model = port_wrapper.build_model(cfg, device="cpu",
                                         generator=torch.Generator().manual_seed(0), train=True)
        for m in model.modules():
            if isinstance(m, U8Dropout):
                m.rate = 0.0
            elif isinstance(m, MHSA):
                m.dropout = 0.0
        variables = flax_from_state_dict(model.state_dict())
        criterion = port_wrapper.make_criterion(cfg)

        def port_run(dtype):
            m = copy.deepcopy(model)
            m.compute_dtype = dtype
            out = m(torch.tensor(feat))
            criterion(out, torch.as_tensor(batch["targets"]),
                      torch.as_tensor(batch["target_mask"])).backward()
            params = dict(m.named_parameters())
            return {"out": out.detach().double().numpy(), "out_dtype": out.dtype,
                    "param_dtypes": {p.dtype for p in params.values()},
                    "grad_dtypes": {p.grad.dtype for p in params.values()},
                    "grads": train_step_test._tree(train_step_test._params_tree(
                        {n: p.grad for n, p in params.items()}))}

        res = {"port16": port_run(torch.bfloat16), "port32": port_run(None),
               "jax16": _jax_run(jcfg, variables, feat, batch, jnp.bfloat16)}
        with jax.enable_x64():
            res["truth"] = _jax_run(jcfg, variables, feat, batch, jnp.float64)
        res["encoder"] = enc
        return res
    finally:
        mp.undo()


def _grad_errors(got, want):
    """(max over tensors of max|error| / scale, relative L2 error of all)."""
    top = max(float(np.abs(w).max()) for w in want.values())
    worst, sq, norm = 0.0, 0.0, 0.0
    for path, w in want.items():
        scale = float(np.abs(w).max())
        if scale <= ZERO_GRAD * top:
            scale = top
        d = np.asarray(got[path], np.float64) - w
        worst = max(worst, float(np.abs(d).max()) / scale)
        sq += float((d ** 2).sum())
        norm += float((w ** 2).sum())
    return worst, (sq / norm) ** 0.5


def test_bf16_params_stay_f32_and_logits_are_f32(runs):
    p16 = runs["port16"]
    assert p16["param_dtypes"] == {torch.float32} and p16["grad_dtypes"] == {torch.float32}
    assert p16["out_dtype"] == torch.float32 and runs["jax16"]["out_dtype"] == jnp.float32
    assert np.isfinite(p16["out"]).all()
    assert all(np.isfinite(g).all() for g in p16["grads"].values())
    corr = np.corrcoef(p16["out"].ravel(), runs["port32"]["out"].ravel())[0, 1]
    if runs["encoder"] == "se-resnet34":
        assert corr > CORR, corr
    else:
        corr_jax = np.corrcoef(runs["jax16"]["out"].ravel(), runs["port32"]["out"].ravel())[0, 1]
        assert corr >= corr_jax - 1e-3, (corr, corr_jax)


def test_bf16_logits_as_close_to_float64_as_jax(runs):
    truth = runs["truth"]["out"]
    err = float(np.abs(runs["port16"]["out"] - truth).max())
    err_jax = float(np.abs(runs["jax16"]["out"] - truth).max())
    floor = 2.0 ** -9 * float(np.abs(truth).max())
    assert err <= RATIO * err_jax + floor, (err, err_jax, floor)
    # bf16 is not float32: the port's bf16 logits are farther than its f32 ones
    assert err > float(np.abs(runs["port32"]["out"] - truth).max())


def test_bf16_gradients_as_close_to_float64_as_jax(runs):
    want = runs["truth"]["grads"]
    assert runs["port16"]["grads"].keys() == want.keys() == runs["jax16"]["grads"].keys()
    worst, l2 = _grad_errors(runs["port16"]["grads"], want)
    worst_jax, l2_jax = _grad_errors(runs["jax16"]["grads"], want)
    assert worst <= RATIO * worst_jax, (worst, worst_jax)
    assert l2 <= RATIO * l2_jax, (l2, l2_jax)
