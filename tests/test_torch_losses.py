"""Port AD-YOLO loss vs ``adyolo_tpu.models.losses.adyolo_loss``.

Value and gradient (w.r.t. the logits) against both JAX forms,
``impl="scatter"`` and ``impl="sorted"``, on random logits with random
targets, duplicate (cell, anchor) hits (a repeated target, and one that
differs only in its class), padded rows, and a ``frame_mask`` (targets kept
off the masked frames, the invariant the eval engine guarantees).  Value
within 1e-5 rel, gradient within 1e-5 * max|grad|.  With no target at all
(M = 0, or every row padded) the loss is finite and equals the JAX scatter
form's; an ``impl`` other than ``"scatter"`` raises.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from adyolo_tpu.models.losses import adyolo_loss as jax_adyolo_loss
from adyolo_tpu.ops.grid import GridGeometry as JaxGeometry
from adyolo_tpu_torch.models.losses import adyolo_loss
from adyolo_tpu_torch.ops.grid import GridGeometry

K = 13
B, T = 2, 6
REL = 1e-5
GEOM = ((45.0, 45.0), 0.5, 5)


def _targets(rng, n, M, frames):
    tg = np.zeros((M, 7), np.float32)
    for m in range(n):
        b = int(rng.integers(B))
        tg[m] = [b, rng.integers(frames[b]), rng.integers(8), rng.integers(4),
                 rng.integers(K), rng.uniform(-180, 180), rng.uniform(-90, 90)]
    tg[n] = tg[2]  # the same hit twice
    tg[n + 1] = tg[3]
    tg[n + 1, 4] = (tg[3, 4] + 1) % K  # same anchors, another class
    mask = np.zeros(M, bool)
    mask[:n + 2] = True
    return tg, mask


def _jax(logits, tg, mask, fm, impl):
    def f(x):
        return jax_adyolo_loss(x, jnp.asarray(tg), jnp.asarray(mask),
                               JaxGeometry(*GEOM), K,
                               frame_mask=None if fm is None else jnp.asarray(fm),
                               impl=impl)

    v, g = jax.jit(jax.value_and_grad(f))(jnp.asarray(logits))
    return float(v), np.asarray(g)


def _port(logits, tg, mask, fm):
    x = torch.tensor(logits, requires_grad=True)
    loss = adyolo_loss(x, torch.tensor(tg), torch.tensor(mask), GridGeometry(*GEOM), K,
                       frame_mask=None if fm is None else torch.tensor(fm))
    loss.backward()
    return float(loss.detach()), x.grad.numpy()


@pytest.mark.parametrize("impl", ["scatter", "sorted"])
@pytest.mark.parametrize("masked", [False, True])
def test_adyolo_loss_matches_jax(impl, masked):
    rng = np.random.default_rng(1 + masked)
    logits = rng.standard_normal((B, T, 8 * 4 * 5 * (K + 3))).astype(np.float32)
    fm = None
    frames = (T, T)
    if masked:
        fm = np.ones((B, T), bool)
        fm[1, 4:] = False
        frames = (T, 4)
    tg, mask = _targets(rng, 12, 24, frames)
    want_v, want_g = _jax(logits, tg, mask, fm, impl)
    got_v, got_g = _port(logits, tg, mask, fm)
    assert abs(got_v - want_v) <= REL * abs(want_v), (got_v, want_v)
    err = float(np.abs(got_g - want_g).max())
    assert err <= REL * float(np.abs(want_g).max()), err


def test_adyolo_loss_without_targets_and_unknown_impl():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((B, T, 8 * 4 * 5 * (K + 3))).astype(np.float32)
    for tg, mask in ((np.zeros((0, 7), np.float32), np.zeros((0,), bool)),
                     (np.zeros((8, 7), np.float32), np.zeros((8,), bool))):
        got_v, got_g = _port(logits, tg, mask, None)
        want_v, want_g = _jax(logits, tg, mask, None, "scatter")
        assert np.isfinite(got_v) and np.isfinite(got_g).all()
        assert abs(got_v - want_v) <= REL * abs(want_v)
        assert float(np.abs(got_g - want_g).max()) <= REL * float(np.abs(want_g).max())
    with pytest.raises(ValueError, match="impl"):
        adyolo_loss(torch.tensor(logits), torch.zeros(0, 7), torch.zeros(0, dtype=torch.bool),
                    GridGeometry(*GEOM), K, impl="sorted")
