"""The port's training input pipeline vs ``adyolo_tpu.data.dataset``.

* With the same python ``random`` seed, the port's ``SELDDataset("train")`` +
  ``TrainLoader`` yield bit-identical batches to the JAX package's over two
  epochs, rotation on: the same int16 hop-block audio, AD-YOLO targets and
  masks, the same remaining pool and the same host RNG state after, at
  ``num_workers`` 0 (no prefetch), 1 (a prefetch thread) and 2 (and a clip
  pool).
* ``EpochPoolSampler`` draws the same epochs and leaves the same pool as
  JAX's, through the pool's refill, its partial refill and the
  small-dataset wrap.
* ``rotate_foa`` equals JAX's for all 16 combinations, audio and labels.
* Leaving an epoch early reaps the loader's threads.
"""
import dataclasses
import random
import threading

import numpy as np
import pytest

from adyolo_tpu.config import Config as JaxConfig
from adyolo_tpu.data import dataset as jax_dataset
from adyolo_tpu.ops import rotation as jax_rotation
from adyolo_tpu_torch.data import dataset
from adyolo_tpu_torch.ops.rotation import ROTATION_COMBINATIONS, rotate_foa

from tests.synth_data import make_synth_dataset
from tests.test_torch_config import port_config


@pytest.fixture(scope="module")
def synth_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("synth_train")
    return make_synth_dataset(str(root), n_train=7, n_val=1, n_test=1,
                              train_secs=1, eval_secs=2, chunk_window_s=1, seed=2)


def _cfgs(root, num_workers, rotation=True):
    jcfg = JaxConfig()
    jcfg = dataclasses.replace(
        jcfg,
        data=dataclasses.replace(jcfg.data, data_pth=root, chunk_window_s=1),
        aug=dataclasses.replace(jcfg.aug, rotation_augment=rotation),
        train=dataclasses.replace(jcfg.train, batch_size=2, nb_iters=2,
                                  num_workers=num_workers, max_targets_per_clip=64))
    return jcfg, port_config(jcfg)


def _two_epochs(pkg, cfg):
    random.seed(1234)
    ds = pkg.SELDDataset(cfg, "train")
    loader = pkg.TrainLoader(ds, cfg)
    epochs = []
    for _ in range(2):
        epochs.append((list(ds.get_filelist()), list(loader)))
        ds.resample_epoch()
    return epochs, list(ds.sampler.get_remaining()), random.getstate()


@pytest.mark.parametrize("num_workers", [0, 1, 2])
def test_loader_matches_jax_over_two_epochs(synth_root, num_workers):
    jcfg, cfg = _cfgs(synth_root, num_workers)
    got, got_pool, got_rng = _two_epochs(dataset, cfg)
    want, want_pool, want_rng = _two_epochs(jax_dataset, jcfg)
    assert got_pool == want_pool and got_rng == want_rng
    for (files, batches), (jfiles, jbatches) in zip(got, want):
        assert files == jfiles
        assert len(batches) == len(jbatches) == 2
        for b, jb in zip(batches, jbatches):
            assert b.keys() == jb.keys() == {"audio", "targets", "target_mask"}
            assert b["audio"].dtype == np.int16 and b["audio"].shape == (2, 40, 600, 4)
            for k in b:
                assert b[k].dtype == jb[k].dtype, k
                np.testing.assert_array_equal(b[k], jb[k], err_msg=k)
    # rotation drew from the host RNG: the two epochs' audio differs from a
    # run without it
    _, cfg0 = _cfgs(synth_root, num_workers, rotation=False)
    plain, _, _ = _two_epochs(dataset, cfg0)
    assert any(not np.array_equal(b["audio"], p["audio"])
               for (_, bs), (_, ps) in zip(got, plain) for b, p in zip(bs, ps))


def test_epoch_pool_sampler_matches_jax():
    for total, nb in ((10, 4), (10, 3), (5, 7), (3, 3)):
        names = [f"f{i}" for i in range(total)]
        random.seed(total * 100 + nb)
        port = dataset.EpochPoolSampler(names, nb)
        got = [port.sample_epoch() for _ in range(6)] + [port.get_remaining()]
        random.seed(total * 100 + nb)
        ref = jax_dataset.EpochPoolSampler(names, nb)
        want = [ref.sample_epoch() for _ in range(6)] + [ref.get_remaining()]
        assert got == want, (total, nb)
        if nb <= total:
            assert len(set(got[0]) | set(got[1])) == min(total, 2 * nb)
    port.set_remaining(["f0"])
    assert port.get_remaining() == ["f0"]


@pytest.mark.parametrize("comb", range(len(ROTATION_COMBINATIONS)))
def test_rotate_foa_matches_jax(comb):
    rng = np.random.default_rng(comb)
    audio = (rng.standard_normal((50, 4)) * 3000).astype(np.int16)
    label = {f: [[int(rng.integers(13)), 0, float(rng.uniform(-180, 180)),
                  float(rng.uniform(-90, 90))]] for f in range(5)}
    label[7] = [[1, 0, 180.0, 0.0], [2, 1, -180.0, 45.0]]  # the wrap
    a, lab = rotate_foa(audio, label, comb)
    ja, jlab = jax_rotation.rotate_foa(audio, label, comb)
    assert a.dtype == np.int16
    np.testing.assert_array_equal(a, ja)
    assert lab == jlab
    for evs in lab.values():
        assert all(-180 <= ev[-2] <= 180 for ev in evs)


def test_loader_early_exit_reaps_threads(synth_root):
    """Leaving an epoch after its first batch: the loader's threads are gone
    when ``close`` returns, and the host RNG is where a full epoch leaves
    it, so the state a checkpoint stores does not depend on how far the
    prefetch thread had got."""
    _, cfg = _cfgs(synth_root, num_workers=2)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, batch_size=2, nb_iters=3, prefetch_factor=2))

    def live():
        return [t.name for t in threading.enumerate()
                if "clip-loader" in t.name and t.is_alive()]

    def epoch(early):
        random.seed(99)
        it = iter(dataset.TrainLoader(dataset.SELDDataset(cfg, "train"), cfg))
        if early:
            next(it)
            it.close()  # the generator's finally: cancel, join, shut the pool
            assert not live(), live()
        else:
            assert len(list(it)) == 3
        return random.getstate()

    full = epoch(early=False)
    assert epoch(early=True) == epoch(early=True) == full
