"""The port's SpecAugment vs ``adyolo_tpu.ops.specaug``.

The JAX package draws six uniforms per (clip, feature block) from its key:
``spec_augment`` splits the key into B x blocks keys (``specaug.py:66``)
and ``_one_block_mask`` splits each into six (``:31``).  Those same draws,
fed to the port's ``block_masks``, must give JAX's masks exactly, and
the features masked by the port's ``apply_block_masks`` must equal JAX's
``spec_augment`` output exactly (masks are 0 or 1).  The port's own :func:`spec_augment` draws
from a ``torch.Generator``: the same generator seed gives the same
output, and each block's masks stay within the parameter bounds.

The train step's input path is held against the JAX step's
(``adyolo_tpu/parallel/train_step.py:130-157``): the same int16 batch and
key, JAX's ``frontend._forward`` with the scaler and ``spec_augment`` on
the step's ``k_aug``, against the port's ``build_step_features`` with its
draws replaced by those of ``k_aug``.  The masks are applied after the
scaler to (B, T, F, C) features in blocks (4, C - 4): the zeros lie on
the same elements exactly, and the rest within the feature frontend's
tolerances (``tests/test_torch_features.py``).
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from adyolo_tpu import config as jax_config
from adyolo_tpu.ops import specaug as jax_specaug
from adyolo_tpu.ops.features import FeatureFrontend as JaxFrontend
from adyolo_tpu.ops.features import Scaler as JaxScaler
from adyolo_tpu_torch.ops import specaug as port_specaug
from adyolo_tpu_torch.ops.features import FeatureFrontend, Scaler
from adyolo_tpu_torch.ops.specaug import apply_block_masks, block_masks, spec_augment
from adyolo_tpu_torch.parallel.train_step import build_step_features

from tests.test_torch_config import port_config
from tests.test_torch_features import _compare, _scaler_dict

BLOCKS = (4, 3)


def _jax_draws(key, B, n_blocks):
    """(B, n_blocks, 6) uniforms in ``_one_block_mask``'s order."""
    keys = jax.random.split(key, B * n_blocks).reshape(B, n_blocks, 2)
    out = np.empty((B, n_blocks, 6), np.float32)
    for b in range(B):
        for i in range(n_blocks):
            for j, k in enumerate(jax.random.split(keys[b, i], 6)):
                out[b, i, j] = float(jax.random.uniform(k))
    return out


@pytest.mark.parametrize("seed,shape,params", [
    (0, (3, 100, 64, 7), (40, 40, 0.5)),
    (1, (4, 40, 64, 7), (40, 40, 0.5)),  # time axis shorter than a width can be
    (7, (2, 250, 64, 7), (20, 30, 0.8)),
])
def test_masks_and_output_match_jax_exactly(seed, shape, params):
    B, T, F, C = shape
    tp, fp, th = params
    key = jax.random.PRNGKey(seed)
    u = _jax_draws(key, B, len(BLOCKS))
    got = block_masks(torch.tensor(u), T, F, tp, fp, th).numpy()
    keys = jax.random.split(key, B * len(BLOCKS)).reshape(B, len(BLOCKS), 2)
    for b in range(B):
        for i in range(len(BLOCKS)):
            want = np.asarray(jax_specaug._one_block_mask(keys[b, i], T, F, tp, fp, th))
            np.testing.assert_array_equal(got[b, i], want, err_msg=f"clip {b} block {i}")
    assert (got == 0).any()  # the draws cut something

    feat = np.random.default_rng(seed).uniform(0.5, 1.0, shape).astype(np.float32)
    want = np.asarray(jax_specaug.spec_augment(jnp.asarray(feat), key, BLOCKS, tp, fp, th))
    port = apply_block_masks(torch.tensor(feat), torch.tensor(got), BLOCKS)
    np.testing.assert_array_equal(port.numpy(), want)


def test_generator_drives_the_draws_and_masks_stay_bounded():
    feat = torch.tensor(np.random.default_rng(3).uniform(0.5, 1.0, (16, 100, 64, 7)),
                        dtype=torch.float32)
    a = spec_augment(feat, torch.Generator().manual_seed(5), BLOCKS, 40, 40, 0.5)
    b = spec_augment(feat, torch.Generator().manual_seed(5), BLOCKS, 40, 40, 0.5)
    c = spec_augment(feat, torch.Generator().manual_seed(6), BLOCKS, 40, 40, 0.5)
    assert torch.equal(a, b) and not torch.equal(a, c)
    zeros = (a == 0).numpy()
    np.testing.assert_array_equal(a.numpy()[~zeros], feat.numpy()[~zeros])
    bound = 1 - (1 - 40 / 100) * (1 - 40 / 64)
    for i in range(16):
        for sl in (slice(0, 4), slice(4, 7)):
            assert zeros[i, :, :, sl].mean() <= bound + 1e-6
            # a block's channels share one mask
            z = zeros[i, :, :, sl]
            assert (z == z[..., :1]).all()


def test_block_sizes_must_cover_the_channels():
    with pytest.raises(ValueError):
        spec_augment(torch.zeros(1, 10, 64, 7), None, (4, 2))


def test_train_step_features_match_the_jax_step(monkeypatch):
    jcfg = jax_config.Config()
    jcfg = dataclasses.replace(jcfg, aug=dataclasses.replace(jcfg.aug, spec_augment=True))
    cfg = port_config(jcfg)
    d = _scaler_dict()
    jf = JaxFrontend(jcfg.data, JaxScaler.from_dict(d))
    audio = (np.random.default_rng(4).standard_normal((3, 120, 600, 4)) * 1500
             ).astype(np.int16)

    # the JAX step's features (train_step.py:139-157)
    k_aug, _ = jax.random.split(jax.random.PRNGKey(11))
    blocks = (4, d_iv) if (d_iv := jcfg.data.nb_feature_channels - 4) else (4,)
    a = jnp.asarray(audio).astype(jnp.float32) / 32768.0 + 1e-8
    feat = jf._forward(a, None, jf._mel_mean, jf._mel_std, jf._aux_mean, jf._aux_std)
    a_cfg = jcfg.aug
    want = np.asarray(jax_specaug.spec_augment(
        feat, k_aug, blocks, a_cfg.spec_augment_time_mask_param,
        a_cfg.spec_augment_freq_mask_param, a_cfg.spec_augment_thresh))

    # the port's, drawing k_aug's uniforms
    monkeypatch.setattr(port_specaug, "draw_uniforms",
                        lambda B, n, g, dev: torch.tensor(_jax_draws(k_aug, B, n)))
    features = build_step_features(cfg, FeatureFrontend(cfg.data, Scaler.from_dict(d),
                                                        device="cpu"))
    got = features(audio)
    zeros = want == 0
    assert zeros.any() and not zeros.all()
    np.testing.assert_array_equal(got.numpy() == 0, zeros)
    _compare(got, want, d)
