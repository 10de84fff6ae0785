"""Ported SE-ResNet34 + AD-YOLO vs the JAX ``SELDModel`` (eval, float32).

Full width (13 classes, 2560 logits), small input: B=2, T=32 feature
frames, F=64, C=7.  Weights come from the JAX ``SELDModel.init`` through
``convert.state_dict_from_flax``, with BN running stats and affine params
perturbed so eval BN is not the identity.  Logits must agree within 1e-4
abs (measured ~1e-6 on the CPU); with ``feat_lengths`` on valid frames
only (JAX's forward GRU direction runs through padded frames).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from adyolo_tpu.config import Config
from adyolo_tpu.models.wrapper import build_model as jax_build_model
from adyolo_tpu_torch.config import Config as PortConfig
from adyolo_tpu_torch.convert import (expected_keys, flax_from_state_dict,
                                      state_dict_from_flax)
from adyolo_tpu_torch.models.layers import reverse_sequence
from adyolo_tpu_torch.models.wrapper import build_model
from adyolo_tpu_torch.parallel.train_step import build_train_step
from tests.test_torch_config import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = 1e-4


def _perturb(tree, rng):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturb(v, rng)
        elif k == "mean":
            out[k] = (v + rng.normal(0, 0.2, v.shape)).astype(np.float32)
        elif k == "var":
            out[k] = (v * rng.uniform(0.5, 2.0, v.shape)).astype(np.float32)
        else:
            out[k] = v
    return out


def _perturb_bn_affine(tree, rng):
    """BN/LayerNorm ``scale``/``bias`` start at 1/0; move them."""
    out = {k: _perturb_bn_affine(v, rng) if isinstance(v, dict) else v
           for k, v in tree.items()}
    if "scale" in out:
        out["scale"] = (out["scale"] * rng.uniform(0.5, 1.5, out["scale"].shape)
                        ).astype(np.float32)
        out["bias"] = (out["bias"] + rng.normal(0, 0.1, out["bias"].shape)
                       ).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def pair():
    cfg = Config()
    jm = jax_build_model(cfg, "float32")
    v = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 64, 7)), False)
    v = jax.tree_util.tree_map(np.asarray, dict(v))
    rng = np.random.default_rng(1)
    v = {"params": _perturb_bn_affine(v["params"], rng),
         "batch_stats": _perturb(v["batch_stats"], rng)}
    tm = build_model(PortConfig(), device="cpu")
    tm.load_state_dict(state_dict_from_flax(v), strict=True)
    x = np.random.default_rng(2).standard_normal((2, 32, 64, 7)).astype(np.float32)
    return jm, v, tm, x


def test_logits_match_jax(pair):
    jm, v, tm, x = pair
    want = np.asarray(jm.apply(v, jnp.asarray(x), False))
    with torch.no_grad():
        got = tm(torch.tensor(x)).numpy()
    assert got.shape == want.shape == (2, 8, 2560)
    assert float(np.abs(got - want).max()) <= TOL


@pytest.mark.parametrize("lengths", [(32, 20), (16, 8)])
def test_logits_match_jax_with_feat_lengths(pair, lengths):
    jm, v, tm, x = pair
    L = np.asarray(lengths, np.int32)
    want = np.asarray(jm.apply(v, jnp.asarray(x), False,
                               feat_lengths=jnp.asarray(L)))
    with torch.no_grad():
        got = tm(torch.tensor(x), torch.tensor(L)).numpy()
    for b, n in enumerate(L // 4):
        assert float(np.abs(got[b, :n] - want[b, :n]).max()) <= TOL


def test_reverse_sequence_is_length_aware():
    x = torch.arange(10.0).reshape(2, 5)
    got = reverse_sequence(x, torch.tensor([5, 3]))
    assert got.tolist() == [[4, 3, 2, 1, 0], [7, 6, 5, 8, 9]]
    assert reverse_sequence(got, torch.tensor([5, 3])).tolist() == x.tolist()


def test_converter_round_trip_and_strictness(pair):
    _, v, tm, _ = pair
    back = flax_from_state_dict(tm.state_dict())
    flat_v = jax.tree_util.tree_leaves_with_path(v)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_v) == len(flat_b) == len(expected_keys())
    for path, a in flat_v:
        np.testing.assert_array_equal(flat_b[path], a)

    extra = {"params": dict(v["params"], stray={"kernel": np.zeros((2, 2))}),
             "batch_stats": v["batch_stats"]}
    with pytest.raises(KeyError, match="unused"):
        state_dict_from_flax(extra)
    enc = dict(v["params"]["encoder"])
    del enc["norm"]
    missing = {"params": dict(v["params"], encoder=enc),
               "batch_stats": v["batch_stats"]}
    with pytest.raises(KeyError, match="missing"):
        state_dict_from_flax(missing)


def test_unported_configurations_raise():
    """An unknown loss and compute dtype raise (every format's head is
    ported: ``tests/test_torch_formats.py``); both encoders train, in
    float32 and bfloat16, with or without remat (``tests/
    test_torch_seresnet34_train.py``, ``tests/test_torch_train_step.py``,
    ``tests/test_torch_bf16*.py``), with SpecAugment, whose step input is
    held against the JAX step's (``tests/test_torch_specaug.py``)."""
    import dataclasses

    from adyolo_tpu_torch.ops.features import FeatureFrontend

    cfg = PortConfig()
    c = dataclasses.replace(cfg, args=dataclasses.replace(cfg.args, loss="yolov3"))
    with pytest.raises(NotImplementedError, match="loss: 'yolov3'"):
        build_model(c, device="cpu")
    c = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, compute_dtype="float16"))
    with pytest.raises(ValueError, match="compute_dtype"):
        build_model(c, device="cpu")
    se = build_model(cfg, device="cpu", train=True)
    assert se.encoder.gru.training and se.compute_dtype is None
    c = dataclasses.replace(cfg, args=dataclasses.replace(cfg.args,
                                                          encoder="resnet-conformer"))
    model = build_model(c, device="cpu", train=True)
    assert model.encoder.conformer0.mhsa.training
    fe = FeatureFrontend(c.data, device="cpu")
    for ok in (dataclasses.replace(c, train=dataclasses.replace(
                   c.train, compute_dtype="bfloat16")),
               dataclasses.replace(c, train=dataclasses.replace(c.train, remat=True))):
        m = build_model(ok, device="cpu", train=True)
        assert m.compute_dtype == (torch.bfloat16 if ok.train.compute_dtype == "bfloat16"
                                   else None)
        assert m.encoder.remat == ok.train.remat
        build_train_step(ok, m, fe)
