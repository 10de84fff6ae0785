"""Ported ResNet-Conformer + AD-YOLO vs the JAX ``resnet_conformer``
(float32), in eval and in training mode.

Each module (``TVBasicBlock``, ``FeedForwardModule``, ``MHSA``,
``ConformerConvModule``, ``ConformerBlock``) is held against its flax
counterpart at small widths, and the whole ``SELDModel`` at full width (13
classes, 2560 logits) on B=2, T=32 feature frames (eval) and T=40, one
1-s chunk (training).  Weights cross through ``convert.py``; BN running
stats and BN/LN affine params are perturbed so that eval norms are not the
identity.  Logits must agree within 1e-4 abs (``ROADMAP.md`` port queue;
measured ~1.5e-6 on the CPU), modules within 2e-5 abs; with
``feat_lengths`` on valid frames only.

Training mode is compared with dropout off on both sides (the JAX
``U8Dropout`` patched to the identity, the port's rates set to 0; MHSA
takes the XLA path on the CPU): the outputs and the BatchNorm running
stats each side updates, the port's read back through
``flax_from_state_dict``.

The full model's flax tree comes from the port's seeded init through
``flax_from_state_dict``, after its paths and shapes are held equal to
``jax.eval_shape`` of the JAX ``init``: a faster start than the JAX init,
and the JAX forward then checks every leaf's layout.
"""
import copy
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from adyolo_tpu.config import Config
from adyolo_tpu.models import layers as jax_layers
from adyolo_tpu.models import resnet_conformer as jrc
from adyolo_tpu.models.wrapper import build_model as jax_build_model
from adyolo_tpu_torch.config import Config as PortConfig
from adyolo_tpu_torch.convert import (expected_keys, flax_from_state_dict,
                                      module_state_dict, state_dict_from_flax)
from adyolo_tpu_torch.models import resnet_conformer as trc
from adyolo_tpu_torch.models.layers import U8Dropout
from adyolo_tpu_torch.models.wrapper import build_model
from adyolo_tpu_torch.ops import attention

from tests.test_torch_config import one_torch_thread, port_config  # noqa: F401
from tests.test_torch_models import _perturb, _perturb_bn_affine

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = 1e-4
MOD_TOL = 2e-5
ENC = "resnet-conformer"


def _np_tree(v):
    return jax.tree_util.tree_map(np.asarray, dict(v))


def _perturbed(v, seed):
    rng = np.random.default_rng(seed)
    return {"params": _perturb_bn_affine(v["params"], rng),
            "batch_stats": _perturb(v.get("batch_stats", {}), rng)}


@pytest.fixture
def no_dropout(monkeypatch):
    """Dropout off on the JAX side; returns the port-side switch."""
    monkeypatch.setattr(jax_layers.U8Dropout, "__call__", lambda self, x: x)

    def off(tm):
        for m in tm.modules():
            if isinstance(m, U8Dropout):
                m.rate = 0.0
            elif isinstance(m, trc.MHSA):
                m.dropout = 0.0
        return tm.train()

    return off


def _stats_close(tm, upd, tol=MOD_TOL):
    """The port module's running stats vs flax's updated batch_stats."""
    got = flax_from_state_dict(tm.state_dict())["batch_stats"]
    want = jax.tree_util.tree_leaves_with_path(upd["batch_stats"])
    assert want
    got = dict(jax.tree_util.tree_leaves_with_path(got))
    for path, a in want:
        _close(got[path], a, tol)


def _pair(jmod, tmod, x, *args, seed=0):
    """Init ``jmod`` on ``x``, perturb its norms, load it into ``tmod``."""
    v = _perturbed(_np_tree(jmod.init(jax.random.PRNGKey(seed), jnp.asarray(x),
                                      False, *args)), seed + 1)
    tmod.load_state_dict(module_state_dict(v), strict=True)
    return v, tmod.eval()


def _mask(T, lens):
    return np.arange(T)[None, :] < np.asarray(lens)[:, None]


def _close(got, want, tol=MOD_TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= tol, err


@pytest.mark.parametrize("in_ch,planes,f_stride", [(8, 16, 2), (16, 16, 1)])
@pytest.mark.parametrize("lens", [None, (12, 7)])
def test_tv_basic_block(in_ch, planes, f_stride, lens):
    x = np.random.default_rng(3).standard_normal((2, 12, 8, in_ch)).astype(np.float32)
    jm = jrc.TVBasicBlock(planes, f_stride=f_stride, time_pack=False)
    v, tm = _pair(jm, trc.TVBasicBlock(in_ch, planes, f_stride), x)
    mask = None if lens is None else _mask(12, lens)
    want = jm.apply(v, jnp.asarray(x), False,
                    None if mask is None else jnp.asarray(mask))
    with torch.no_grad():
        got = tm(torch.tensor(x).permute(0, 3, 1, 2),
                 None if mask is None else torch.tensor(mask))
    _close(got.permute(0, 2, 3, 1), want)


@pytest.mark.parametrize("in_ch,planes,f_stride", [(8, 16, 2), (16, 16, 1)])
def test_tv_basic_block_train(in_ch, planes, f_stride):
    """Training mode: BN on batch statistics, running stats updated."""
    x = np.random.default_rng(8).standard_normal((2, 12, 8, in_ch)).astype(np.float32)
    jm = jrc.TVBasicBlock(planes, f_stride=f_stride, time_pack=False)
    v, tm = _pair(jm, trc.TVBasicBlock(in_ch, planes, f_stride), x)
    want, upd = jm.apply(v, jnp.asarray(x), True, mutable=["batch_stats"])
    with torch.no_grad():
        got = tm.train()(torch.tensor(x).permute(0, 3, 1, 2))
    _close(got.permute(0, 2, 3, 1), want)
    _stats_close(tm, upd)


def test_feed_forward_module():
    x = np.random.default_rng(4).standard_normal((2, 12, 16)).astype(np.float32)
    jm = jrc.FeedForwardModule(16)
    v, tm = _pair(jm, trc.FeedForwardModule(16), x)
    with torch.no_grad():
        _close(tm(torch.tensor(x)), jm.apply(v, jnp.asarray(x), False))


@pytest.mark.parametrize("threshold", [2400, 100])
def test_mhsa(monkeypatch, threshold):
    """Fused route, and the query-blocked one (T=160 > 100: bq=80) with the
    threshold set on both sides."""
    monkeypatch.setattr(jrc.MHSA, "BLOCK_THRESHOLD", threshold)
    monkeypatch.setattr(attention, "BLOCK_THRESHOLD", threshold)
    x = np.random.default_rng(5).standard_normal((2, 160, 32)).astype(np.float32)
    jm = jrc.MHSA(32, flash="0")
    v, tm = _pair(jm, trc.MHSA(32), x)
    for lens in (None, (160, 112)):
        mask = None if lens is None else jnp.asarray(_mask(160, lens))
        kv = None if lens is None else torch.tensor(lens, dtype=torch.int32)
        with torch.no_grad():
            _close(tm(torch.tensor(x), kv),
                   jm.apply(v, jnp.asarray(x), False, frame_mask=mask))


@pytest.mark.parametrize("lens", [None, (24, 13)])
def test_conv_module(lens):
    x = np.random.default_rng(6).standard_normal((2, 24, 16)).astype(np.float32)
    jm = jrc.ConformerConvModule(16, dilation=4)
    v, tm = _pair(jm, trc.ConformerConvModule(16, dilation=4), x)
    mask = None if lens is None else _mask(24, lens)
    want = jm.apply(v, jnp.asarray(x), False,
                    None if mask is None else jnp.asarray(mask))
    with torch.no_grad():
        got = tm(torch.tensor(x), None if mask is None else torch.tensor(mask))
    _close(got, want)


@pytest.mark.parametrize("lens", [None, (24, 13)])
@pytest.mark.parametrize("train", [False, True])
def test_conformer_block(lens, train, no_dropout):
    x = np.random.default_rng(7).standard_normal((2, 24, 32)).astype(np.float32)
    jm = jrc.ConformerBlock(32, dilation=2)
    v, tm = _pair(jm, trc.ConformerBlock(32, dilation=2), x)
    mask = kv = None
    if lens is not None:
        mask = torch.tensor(_mask(24, lens))
        kv = mask.sum(1, dtype=torch.int32)
    jmask = None if mask is None else jnp.asarray(mask.numpy())
    if train:
        want, upd = jm.apply(v, jnp.asarray(x), True, jmask, mutable=["batch_stats"])
        no_dropout(tm)
    else:
        want = jm.apply(v, jnp.asarray(x), False, jmask)
    with torch.no_grad():
        _close(tm(torch.tensor(x), mask, kv), want)
    if train:
        _stats_close(tm, upd)


def test_eval_block_on_a_long_clip_ignores_grad_mode():
    """An eval ConformerBlock at T = 4800 frames (3000 valid): with grad on
    (parameters that require grad) it gives the no-grad output and the JAX
    block's; a backward through it raises, as no kernel has a backward for
    the long route (K4); in training mode the forward raises."""
    T, n = 4800, 3000
    x = np.random.default_rng(11).standard_normal((1, T, 32)).astype(np.float32)
    jm = jrc.ConformerBlock(32, dilation=2)
    v, tm = _pair(jm, trc.ConformerBlock(32, dilation=2), x[:, :24])
    mask = torch.tensor(_mask(T, (n,)))
    kv = torch.tensor([n], dtype=torch.int32)
    with torch.no_grad():
        want = tm(torch.tensor(x), mask, kv)
    got = tm(torch.tensor(x), mask, kv)
    assert got.requires_grad
    torch.testing.assert_close(got.detach(), want, atol=0, rtol=0)
    _close(got[:, :n], np.asarray(jm.apply(v, jnp.asarray(x), False,
                                           jnp.asarray(mask.numpy())))[:, :n])
    with pytest.raises(NotImplementedError, match="no backward"):
        got.sum().backward()
    with pytest.raises(ValueError, match="training attention needs T <= 2400"):
        tm.train()(torch.tensor(x), mask, kv)


@pytest.fixture(scope="module")
def pair():
    cfg = Config()
    cfg = dataclasses.replace(cfg, args=dataclasses.replace(cfg.args, encoder=ENC))
    jm = jax_build_model(cfg, "float32")
    shapes = jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 64, 7)), False))
    tm = build_model(port_config(cfg), device="cpu",
                     generator=torch.Generator().manual_seed(0))
    v = flax_from_state_dict(tm.state_dict())
    want = {p: a.shape for p, a in jax.tree_util.tree_leaves_with_path(dict(shapes))}
    got = {p: a.shape for p, a in jax.tree_util.tree_leaves_with_path(v)}
    assert got == want
    v = _perturbed(v, 1)
    tm.load_state_dict(state_dict_from_flax(v, ENC), strict=True)
    x = np.random.default_rng(2).standard_normal((2, 32, 64, 7)).astype(np.float32)
    fwd = jax.jit(lambda v, x, L: jm.apply(v, x, False, feat_lengths=L))
    return fwd, v, tm, x, jm


def test_logits_match_jax(pair):
    fwd, v, tm, x, _ = pair
    want = np.asarray(fwd(v, jnp.asarray(x), None))
    with torch.no_grad():
        got = tm(torch.tensor(x)).numpy()
    assert got.shape == want.shape == (2, 8, 2560)
    _close(got, want, TOL)


@pytest.mark.parametrize("lengths", [(32, 20), (16, 8)])
def test_logits_match_jax_with_feat_lengths(pair, lengths):
    fwd, v, tm, x, _ = pair
    L = np.asarray(lengths, np.int32)
    want = np.asarray(fwd(v, jnp.asarray(x), jnp.asarray(L)))
    with torch.no_grad():
        got = tm(torch.tensor(x), torch.tensor(L)).numpy()
    for b, n in enumerate(L // 4):
        _close(got[b, :n], want[b, :n], TOL)


def test_train_logits_and_batch_stats_match_jax(pair, no_dropout):
    """Full width, one 1-s chunk (B=2, T=40), training mode, dropout off."""
    _, v, tm, _, jm = pair
    x = np.random.default_rng(9).standard_normal((2, 40, 64, 7)).astype(np.float32)
    want, upd = jax.jit(lambda v, x: jm.apply(v, x, True, mutable=["batch_stats"]))(
        v, jnp.asarray(x))
    model = no_dropout(copy.deepcopy(tm))
    with torch.no_grad():
        got = model(torch.tensor(x))
    assert got.shape == (2, 10, 2560)
    _close(got, want, TOL)
    _stats_close(model, upd, TOL)


def test_converter_round_trip_and_strictness(pair):
    _, v, tm, _, _ = pair
    back = flax_from_state_dict(tm.state_dict())
    flat_v = jax.tree_util.tree_leaves_with_path(v)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_v) == len(flat_b) == len(expected_keys(ENC))
    for path, a in flat_v:
        np.testing.assert_array_equal(flat_b[path], a)
    w = tm.state_dict()["encoder.conformer3.conv.dw_conv.weight"]
    k = v["params"]["encoder"]["conformer3"]["conv"]["dw_kernel"]
    assert w.shape == (256, 1, 3) and k.shape == (3, 256)
    np.testing.assert_array_equal(w[:, 0, :].numpy().T, k)

    with pytest.raises(KeyError, match="unused"):  # an SE-ResNet34 tree
        state_dict_from_flax(flax_from_state_dict(
            build_model(PortConfig(), device="cpu").state_dict()), ENC)
    with pytest.raises(KeyError, match="unused"):  # and the other way round
        state_dict_from_flax(v)
    enc = dict(v["params"]["encoder"])
    del enc["pool_norm"]
    with pytest.raises(KeyError, match="missing"):
        state_dict_from_flax({"params": dict(v["params"], encoder=enc),
                              "batch_stats": v["batch_stats"]}, ENC)
    blk = dict(enc["conformer0"], conv=dict(enc["conformer0"]["conv"],
                                            dw_kernel=np.zeros((3, 256, 1))))
    with pytest.raises(KeyError, match="dw_kernel of rank 3"):
        module_state_dict({"params": {"conformer0": blk}})
