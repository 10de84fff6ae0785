"""The DCASE2020 (14 classes) and DCASE2021 (12 classes) presets in the port
vs the JAX package, on the CPU.  The class count sizes the AD-YOLO head
(8·4·5·(K+3) logits), the dense heads (3K, 9K) and the label encoders.

* Config: the port's ``build_config`` equals JAX's field by field, from
  the built-in presets and from the repository's ``configs/``.
* Logits: each encoder (SE-ResNet34 at full width; ResNet-Conformer at full
  width cut to 2 blocks, the head being what K sizes) with the adyolo,
  accdoa and adpit heads, on seeded variables of the shapes of JAX's
  ``init`` (drawn in numpy, so that no norm is the identity; JAX's own
  init run eagerly costs ~25 s here; the three heads of an encoder share
  its variables and one jitted JAX call) carried over by
  ``convert.state_dict_from_flax``: within 1e-4 abs at B=2, T=32 feature
  frames (measured <= 3.6e-6 on the CPU).
* Losses: the AD-YOLO and ACCDOA losses against JAX's on the same logits
  and targets, the targets from the port's encoders (``encode_adyolo``,
  ``encode_accdoa``) at K: in float64 the value within 1e-10 rel and the
  gradient within 1e-8 x max|grad| (``tests/test_torch_formats.py``'s
  tolerances), in float32 the value within 1e-5 rel.
* Engine: one ``cli train --quick_test`` a preset (SE-ResNet34 + adyolo)
  on a synthetic set of K classes writes both checkpoints and a test CSV a
  clip, with a head of K classes.
"""
import contextlib
import dataclasses
import functools
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import yaml

from adyolo_tpu import config as jax_config
from adyolo_tpu.models import losses as jax_losses
from adyolo_tpu.models import resnet_conformer as jax_rc
from adyolo_tpu.models.wrapper import build_model as jax_build_model
from adyolo_tpu.models.wrapper import make_grid_geometry as jax_make_grid_geometry
from adyolo_tpu_torch import cli
from adyolo_tpu_torch import config as port_config_mod
from adyolo_tpu_torch.convert import state_dict_from_flax
from adyolo_tpu_torch.data.labels import encode_accdoa, encode_adyolo, pad_yolo_targets
from adyolo_tpu_torch.engine.checkpoint import load_jax_checkpoint
from adyolo_tpu_torch.models import losses as port_losses
from adyolo_tpu_torch.models import resnet_conformer as port_rc
from adyolo_tpu_torch.models import wrapper as port_wrapper

from tests.synth_data import make_synth_dataset
from tests.test_torch_config import one_torch_thread, port_config, scratch_path  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

PRESETS = [("DCASE2020", 14), ("DCASE2021", 12)]
LOGIT_TOL = 1e-4
LOSS_REL = {"float64": 1e-10, "float32": 1e-5}
GRAD_TOL_F64 = 1e-8
BLOCKS = 2
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def shallow():
    """Both packages' conformer cut to BLOCKS blocks for this module."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_rc, "ResNetConformer",
               functools.partial(jax_rc.ResNetConformer, num_layers=BLOCKS))
    mp.setitem(port_wrapper.ENCODERS, "resnet-conformer",
               functools.partial(port_rc.ResNetConformer, num_layers=BLOCKS))
    yield
    mp.undo()


def _seeded_tree(tree, rng):
    """A JAX model's variables of the shapes of ``tree`` (its ``init``'s
    shapes), drawn from ``rng``: kernels N(0, 1/fan_in), biases and BN
    means N(0, 0.1), scales U(0.5, 1.5), variances U(0.5, 2), so that no
    BatchNorm or LayerNorm is the identity."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _seeded_tree(v, rng)
            continue
        if k == "var":
            a = rng.uniform(0.5, 2.0, v.shape)
        elif k in ("mean", "bias"):
            a = rng.normal(0, 0.1, v.shape)
        elif k == "scale":
            a = rng.uniform(0.5, 1.5, v.shape)
        else:
            a = rng.normal(0, 1.0 / np.sqrt(max(1, int(np.prod(v.shape[:-1])))), v.shape)
        out[k] = a.astype(np.float32)
    return out


def _preset(ds, encoder="se-resnet34", loss="adyolo"):
    jcfg = jax_config.build_config({"dataset": ds, "encoder": encoder, "loss": loss},
                                   config_dir=os.path.join(_REPO, "configs"))
    return jcfg, port_config(jcfg)


@pytest.mark.parametrize("ds,K", PRESETS)
@pytest.mark.parametrize("config_dir", [None, "configs"])
def test_build_config_equals_jax_field_by_field(ds, K, config_dir):
    cdir = None if config_dir is None else os.path.join(_REPO, config_dir)
    args = {"dataset": ds, "encoder": "resnet-conformer", "loss": "accdoa"}
    want = jax_config.build_config(args, config_dir=cdir)
    got = port_config_mod.build_config(args, config_dir=cdir)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.data.nb_classes == K and got.data.data_pth.endswith(f"{ds}_SELD/")


HEADS = {"adyolo": lambda K: 8 * 4 * 5 * (K + 3), "accdoa": lambda K: 3 * K,
         "adpit": lambda K: 9 * K}


def _jax_heads(ds, K, encoder):
    """JAX's logits of the three heads at ``K`` on one seeded input: one set
    of seeded encoder variables shared by the three models, each head's own
    drawn beside them (:func:`_seeded_tree`), and the three ``apply`` in one
    jitted call, which computes the shared encoder once.  Returns the
    input and, for each head, its variables and its logits."""
    rng = np.random.default_rng(K)
    x = rng.standard_normal((2, 32, 64, 7)).astype(np.float32)
    models = {loss: jax_build_model(_preset(ds, encoder, loss)[0], "float32") for loss in HEADS}
    body, heads = None, {}
    for loss, jm in models.items():
        shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                                jnp.zeros((1, 32, 64, 7)), False))
        if body is None:
            body = _seeded_tree({c: {k: t for k, t in tree.items() if k != "head"}
                                 for c, tree in shapes.items()}, rng)
        heads[loss] = _seeded_tree(dict(shapes["params"]["head"]), rng)

    def with_head(body, head):
        return {**body, "params": {**body["params"], "head": head}}

    logits = jax.jit(lambda body, heads, x: {
        loss: models[loss].apply(with_head(body, h), x, False) for loss, h in heads.items()})(
        body, heads, jnp.asarray(x))
    return x, {loss: (with_head(body, heads[loss]), np.asarray(logits[loss])) for loss in HEADS}


@pytest.fixture(scope="module")
def jax_heads(shallow):
    """:func:`_jax_heads` by (preset, K, encoder), each computed once."""
    return functools.lru_cache(maxsize=None)(_jax_heads)


@pytest.mark.parametrize("ds,K", PRESETS)
@pytest.mark.parametrize("encoder", ["se-resnet34", "resnet-conformer"])
@pytest.mark.parametrize("loss", list(HEADS))
def test_logits_match_jax(ds, K, encoder, loss, jax_heads):
    x, by_head = jax_heads(ds, K, encoder)
    v, want = by_head[loss]
    assert np.isfinite(want).all() and float(np.abs(want).max()) > 0.1
    tm = port_wrapper.build_model(_preset(ds, encoder, loss)[1], device="cpu")
    tm.load_state_dict(state_dict_from_flax(v, encoder=encoder, loss=loss), strict=True)
    with torch.no_grad():
        got = tm(torch.tensor(x)).numpy()
    assert got.shape == want.shape == (2, 8, HEADS[loss](K))
    assert float(np.abs(got - want).max()) <= LOGIT_TOL


def _labels(rng, T, K):
    """Per frame one to three events of random classes and tracks."""
    return {t: [[int(rng.integers(K)), int(i), float(rng.uniform(-180, 180)),
                 float(rng.uniform(-90, 90))] for i in range(int(rng.integers(1, 4)))]
            for t in range(T) if rng.random() < 0.7}


def _value_and_grad(jax_loss, port_loss, x, dtype):
    """Each package's loss of ``x`` and its gradient in ``dtype`` (JAX in
    64-bit mode for float64)."""
    with jax.enable_x64() if dtype == "float64" else contextlib.nullcontext():
        want, want_g = jax.jit(jax.value_and_grad(jax_loss))(jnp.asarray(x, dtype))
        want, want_g = float(want), np.asarray(want_g)
    z = torch.tensor(x, dtype=getattr(torch, dtype), requires_grad=True)
    got = port_loss(z)
    got.backward()
    assert got.dtype == z.dtype
    return (float(got.detach()), z.grad.numpy()), (want, want_g)


def _check_loss(got, want, dtype):
    """float64: value within 1e-10 rel, gradient within 1e-8 x max|grad|;
    float32: value within 1e-5 rel (float32's gradients differ by their
    rounding: both packages' lie ~9e-8 from the float64 one at K = 12)."""
    (v, g), (wv, wg) = got, want
    assert abs(v - wv) <= LOSS_REL[dtype] * abs(wv), (v, wv)
    if dtype == "float64":
        assert float(np.abs(g - wg).max()) <= GRAD_TOL_F64 * float(np.abs(wg).max())


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("ds,K", PRESETS)
def test_adyolo_loss_matches_jax(ds, K, dtype):
    jcfg, cfg = _preset(ds)
    rng = np.random.default_rng(K)
    B, T = 2, 6
    geom, jgeom = port_wrapper.make_grid_geometry(cfg), jax_make_grid_geometry(jcfg)
    rows = [encode_adyolo(_labels(rng, T, K), T, geom) for _ in range(B)]
    tg, mask = pad_yolo_targets(rows, 256)
    assert 0 < int(mask.sum()) < 256  # every row kept, padded rows beside them
    logits = rng.standard_normal((B, T, 8 * 4 * 5 * (K + 3)))
    got, want = _value_and_grad(
        lambda z: jax_losses.adyolo_loss(z, jnp.asarray(tg, dtype), jnp.asarray(mask), jgeom, K),
        lambda z: port_losses.adyolo_loss(z, torch.tensor(tg, dtype=z.dtype),
                                          torch.tensor(mask), geom, K),
        logits, dtype)
    _check_loss(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("ds,K", PRESETS)
def test_accdoa_loss_matches_jax(ds, K, dtype):
    rng = np.random.default_rng(K + 1)
    B, T = 2, 12
    target = np.stack([encode_accdoa(_labels(rng, T, K), T, K) for _ in range(B)])
    assert target.shape == (B, T, 3 * K) and target.any()
    out = np.tanh(rng.normal(0, 1, (B, T, 3 * K)))
    got, want = _value_and_grad(
        lambda o: jax_losses.accdoa_loss(o, jnp.asarray(target, dtype)),
        lambda o: port_losses.accdoa_loss(o, torch.tensor(target, dtype=o.dtype)),
        out, dtype)
    _check_loss(got, want, dtype)


@pytest.mark.parametrize("ds,K", PRESETS)
def test_cli_train_quick_test_on_the_preset(ds, K, scratch_path):
    data = make_synth_dataset(str(scratch_path / "data"), nb_classes=K, n_train=2, n_val=1,
                              n_test=1, train_secs=1, eval_secs=2, chunk_window_s=1, seed=K)
    configs = scratch_path / "configs"
    configs.mkdir()
    with open(configs / f"hyp_data_{ds}.yaml", "w") as f:
        yaml.safe_dump({"data_pth": data, "name_pth": os.path.join(data, "classes.txt"),
                        "nb_classes": K, "chunk_window_s": 1}, f)
    with open(configs / "hyp_train.yaml", "w") as f:
        yaml.safe_dump({"max_targets_per_clip": 64}, f)
    results = str(scratch_path / "results")
    assert cli.main(["train", "--quick_test", "--dataset", ds, "--batch_size", "2",
                     "--nb_iters", "1", "--config_dir", str(configs), "--results_dir",
                     results, "--exp_id", ds, "--device", "cpu"]) == 0
    exp = os.path.join(results, ds)
    for name in ("model_best.ckpt", "model_ckpt.ckpt", "hyp_exp.yaml"):
        assert os.path.isfile(os.path.join(exp, name)), name
    assert sorted(os.listdir(os.path.join(exp, "output_test"))) == ["test000.csv"]
    cfg = port_config_mod.load_config(os.path.join(exp, "hyp_exp.yaml"))
    assert cfg.data.nb_classes == K
    # the best checkpoint holds a head of K classes: it loads strictly into
    # a model of the preset
    variables, _ = load_jax_checkpoint(os.path.join(exp, "model_best.ckpt"))
    port_wrapper.build_model(cfg, device="cpu").load_state_dict(
        state_dict_from_flax(variables), strict=True)
