"""Train-mode layers of the port vs the JAX package's.

* ``BatchNorm`` in training mode against ``adyolo_tpu.models.layers.
  BatchNorm`` applied with ``use_running_average=False`` and
  ``mutable=["batch_stats"]``: the output and the updated running
  ``mean``/``var`` (biased batch variance, momentum 0.9), NCHW (the JAX
  side channel-last) and channel-last ``(B, T, C)``; within 1e-5 abs.
* ``U8Dropout``: keep share ~205/256 at rate 0.2 (thresh 51), kept values
  scaled by 256/205, identity in eval, zeros at rate 1.0.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from adyolo_tpu.models.layers import BatchNorm as JaxBatchNorm
from adyolo_tpu_torch.models.layers import BatchNorm, U8Dropout

TOL = 1e-5


@pytest.mark.parametrize("channel_last", [False, True])
def test_train_batchnorm_matches_flax(channel_last):
    rng = np.random.default_rng(0)
    shape = (3, 10, 6) if channel_last else (2, 9, 5, 6)  # JAX layout, C last
    x = (rng.standard_normal(shape) * 2.0 + 0.7).astype(np.float32)
    C = shape[-1]
    jm = JaxBatchNorm()
    v = jax.tree_util.tree_map(np.asarray, dict(jm.init(jax.random.PRNGKey(0),
                                                        jnp.asarray(x), True)))
    v["params"] = {"scale": rng.uniform(0.5, 1.5, C).astype(np.float32),
                   "bias": rng.normal(0, 0.1, C).astype(np.float32)}
    v["batch_stats"] = {"mean": rng.normal(0, 0.2, C).astype(np.float32),
                        "var": rng.uniform(0.5, 2.0, C).astype(np.float32)}
    want, upd = jm.apply(v, jnp.asarray(x), False, mutable=["batch_stats"])

    bn = BatchNorm(C, channel_last=channel_last).train()
    with torch.no_grad():
        bn.weight.copy_(torch.tensor(v["params"]["scale"]))
        bn.bias.copy_(torch.tensor(v["params"]["bias"]))
        bn.running_mean.copy_(torch.tensor(v["batch_stats"]["mean"]))
        bn.running_var.copy_(torch.tensor(v["batch_stats"]["var"]))
    xt = torch.tensor(x) if channel_last else torch.tensor(x).permute(0, 3, 1, 2)
    got = bn(xt)
    if not channel_last:
        got = got.permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=TOL, rtol=0)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(upd["batch_stats"]["mean"]), atol=TOL, rtol=0)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(upd["batch_stats"]["var"]), atol=TOL, rtol=0)
    # eval normalises with the updated running stats, and updates nothing
    ra = bn.running_var.clone()
    bn.eval()(xt)
    assert torch.equal(bn.running_var, ra)


def test_u8_dropout_statistics():
    x = torch.full((1000, 1000), 2.0)
    d = U8Dropout(0.2)
    assert torch.equal(d.eval()(x), x)  # eval: identity
    y = d.train()(x, torch.Generator().manual_seed(0))
    kept = y != 0
    share = float(kept.double().mean())
    assert abs(share - 205 / 256) < 0.005, share
    assert torch.allclose(y[kept], torch.tensor(2.0 * 256 / 205))
    assert float(U8Dropout(1.0).train()(x).abs().max()) == 0.0
    assert torch.equal(U8Dropout(0.001).train()(x), x)  # thresh round(0.256) = 0
    # the same generator state gives the same mask
    y2 = d(x, torch.Generator().manual_seed(0))
    assert torch.equal(y, y2)
