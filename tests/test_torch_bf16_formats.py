"""bf16 training forward and gradients of the dense formats vs the JAX
package's: SED-DOA, ACCDOA and ADPIT heads on both encoders (the conformer
cut to 2 blocks on both sides), in the form of
``tests/test_torch_bf16_models.py`` (which holds AD-YOLO).

Training mode, dropout off on both sides, B=2 x 40 feature frames of seeded
normal features with dense targets of 1 to 4 events a frame.  From the
same float32 weights, the port's model with ``compute_dtype=bfloat16``,
the JAX model with ``compute_dtype=bfloat16`` and the JAX model in float64
(the truth) each give the logits and the gradient of the loss:

* the logits' max|error|: the port's at most 2x JAX's, plus 2^-9 x
  max|logit| (half a bfloat16 step);
* the gradients: the worst tensor's max|error| / max|true gradient| and
  the relative L2 error of all gradients together, the port's at most 2x
  JAX's each;
* the parameters and their gradients stay float32, the logits are float32.
"""
import copy
import dataclasses
import functools

import numpy as np
import jax.numpy as jnp
import jax
import pytest
import torch

from adyolo_tpu import config as jax_config
from adyolo_tpu.models import layers as jax_layers
from adyolo_tpu.models import resnet_conformer as jax_rc
from adyolo_tpu_torch.convert import flax_from_state_dict
from adyolo_tpu_torch.models import resnet_conformer as port_rc
from adyolo_tpu_torch.models import wrapper as port_wrapper
from adyolo_tpu_torch.models.layers import U8Dropout
from adyolo_tpu_torch.models.resnet_conformer import MHSA

from tests import test_torch_train_step as train_step_test
from tests.test_torch_bf16_models import BLOCKS, RATIO, _grad_errors, _jax_run
from tests.test_torch_config import one_torch_thread, port_config  # noqa: F401
from tests.test_torch_formats import _dense_batches

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CASES = [(enc, loss) for enc in ("se-resnet34", "resnet-conformer")
         for loss in ("seddoa", "accdoa", "adpit")]


@pytest.fixture(scope="module", params=CASES, ids=["/".join(c) for c in CASES])
def runs(request):
    enc, loss = request.param
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jax_layers.U8Dropout, "__call__", lambda self, x: x)
        mp.setattr(jax_rc, "ResNetConformer",
                   functools.partial(jax_rc.ResNetConformer, num_layers=BLOCKS))
        mp.setitem(port_wrapper.ENCODERS, "resnet-conformer",
                   functools.partial(port_rc.ResNetConformer, num_layers=BLOCKS))
        jcfg = jax_config.Config()
        jcfg = dataclasses.replace(jcfg, args=dataclasses.replace(jcfg.args, encoder=enc,
                                                                  loss=loss))
        cfg = port_config(jcfg)
        batch = _dense_batches(loss, cfg, np.random.default_rng(0))[0]
        batch["target_mask"] = np.zeros((1,), bool)  # the dense losses take none
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
            criterion(out, torch.as_tensor(batch["targets"])).backward()
            params = dict(m.named_parameters())
            return {"out": out.detach().double().numpy(), "out_dtype": out.dtype,
                    "param_dtypes": {p.dtype for p in params.values()},
                    "grad_dtypes": {p.grad.dtype for p in params.values()},
                    "grads": train_step_test._tree(train_step_test._params_tree(
                        {n: p.grad for n, p in params.items()}))}

        res = {"port16": port_run(torch.bfloat16),
               "jax16": _jax_run(jcfg, variables, feat, batch, jnp.bfloat16)}
        with jax.enable_x64():
            res["truth"] = _jax_run(jcfg, variables, feat, batch, jnp.float64)
        return res
    finally:
        mp.undo()


def test_bf16_dense_params_stay_f32_and_logits_are_f32(runs):
    p16 = runs["port16"]
    assert p16["param_dtypes"] == {torch.float32} and p16["grad_dtypes"] == {torch.float32}
    assert p16["out_dtype"] == torch.float32 and runs["jax16"]["out_dtype"] == jnp.float32
    assert np.isfinite(p16["out"]).all()
    assert all(np.isfinite(g).all() for g in p16["grads"].values())


def test_bf16_dense_logits_as_close_to_float64_as_jax(runs):
    truth = runs["truth"]["out"]
    err = float(np.abs(runs["port16"]["out"] - truth).max())
    err_jax = float(np.abs(runs["jax16"]["out"] - truth).max())
    floor = 2.0 ** -9 * float(np.abs(truth).max())
    assert err <= RATIO * err_jax + floor, (err, err_jax, floor)


def test_bf16_dense_gradients_as_close_to_float64_as_jax(runs):
    want = runs["truth"]["grads"]
    assert runs["port16"]["grads"].keys() == want.keys() == runs["jax16"]["grads"].keys()
    worst, l2 = _grad_errors(runs["port16"]["grads"], want)
    worst_jax, l2_jax = _grad_errors(runs["jax16"]["grads"], want)
    assert worst <= RATIO * worst_jax, (worst, worst_jax)
    assert l2 <= RATIO * l2_jax, (l2, l2_jax)
