"""Port AD-YOLO PostProcessor vs ``adyolo_tpu.ops.decode.PostProcessor``.

Same logits through both, with the top-k compaction exact (few anchors
per frame clear the threshold) and with its guard taken (more than k do,
so both decode the full grid).  Per frame the (frame, class) sets must be
identical and xyz agree within 1e-5; ``torch.topk`` and ``lax.top_k`` may
order ties differently, so detections are compared as sets.
"""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from adyolo_tpu.config import Config
from adyolo_tpu.ops.decode import PostProcessor as JaxPostProcessor
from adyolo_tpu_torch.ops.decode import PostProcessor, adyolo_decode_grid
from adyolo_tpu_torch.ops.grid import GridGeometry
from adyolo_tpu.models.losses import adyolo_decode_grid as jax_decode_grid

from tests.test_torch_config import port_config

XYZ_TOL = 1e-5
G0, G1, A, K = 8, 4, 5, 13


def _logits(T, hot_per_frame, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (1, T, G0 * G1 * A, K + 3)).astype(np.float32)
    x[..., 0] -= 6.0  # objectness mostly off
    for t in range(T):
        hot = rng.choice(G0 * G1 * A, hot_per_frame, replace=False)
        x[0, t, hot, 0] = rng.uniform(1.0, 5.0, hot_per_frame)
        x[0, t, hot, 1:K + 1] += 2.0
    return x.reshape(1, T, -1)


def _as_set(dets):
    return {t: sorted(tuple(r) for r in rows) for t, rows in dets.items()}


def _assert_same(got, want):
    got, want = _as_set(got), _as_set(want)
    assert got.keys() == want.keys()
    for t in want:
        assert [r[0] for r in got[t]] == [r[0] for r in want[t]], t
        np.testing.assert_allclose(np.asarray(got[t])[:, 1:],
                                   np.asarray(want[t])[:, 1:], atol=XYZ_TOL)


@pytest.mark.parametrize("hot,guard_taken", [(3, False), (40, True)])
@pytest.mark.parametrize("nms", ["conn-merge", "soft-merge", "default"])
def test_postprocess_matches_jax(hot, guard_taken, nms):
    cfg = Config()
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, nms=nms))
    x = _logits(T=24, hot_per_frame=hot, seed=hot)
    jp, tp = JaxPostProcessor(cfg), PostProcessor(port_config(cfg))
    for p in (jp, tp):
        p.set_conf_thresh(0.6)
    # which decode the guard picks
    cand = tp.adyolo_candidates(torch.tensor(x))
    assert (cand[1].shape[1] == G0 * G1 * A) == guard_taken
    want = jp.postprocess(jnp.asarray(x), valid_label_frames=20)
    got = tp.postprocess(torch.tensor(x), valid_label_frames=20)
    assert want and max(want) < 20
    _assert_same(got, want)


def test_decode_grid_matches_jax():
    cfg = Config()
    geom = JaxPostProcessor(cfg).geom
    x = _logits(T=6, hot_per_frame=2, seed=9) * 3.0  # push tanh to the clamps
    jc, juv = jax_decode_grid(jnp.asarray(x), geom, K, clamp_ele=(-90.0, 90.0 - 1e-7))
    tgeom = GridGeometry(tuple(cfg.train.grid_size), cfg.train.g_overlap,
                         cfg.train.nb_anchors)
    for name in ("offset", "lb", "ub"):
        np.testing.assert_array_equal(getattr(tgeom, name), getattr(geom, name))
    tc, tuv = adyolo_decode_grid(torch.tensor(x), tgeom, K, clamp_ele=(-90.0, 90.0 - 1e-7))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(tuv.numpy(), np.asarray(juv), atol=1e-4)
    assert float(tuv[..., 0].max()) < 180.0 and float(tuv[..., 0].min()) >= -180.0
