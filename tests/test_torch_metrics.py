"""The port's SELD metrics vs ``adyolo_tpu.metrics``.

One reference directory (polar metadata CSVs, one of them empty, several
frames with two or three events, some of one class) and one prediction
directory (cartesian output CSVs: the references with DOA noise, some
events dropped and some inserted, one clip with no prediction file) are
scored by both packages' ``SegmentScorer`` with ``overlap`` None / "any" /
"classwise", the jackknife on and off, micro and macro: ER, F, LE, LR,
SELD, the classwise table and every confidence interval within 1e-10
abs.  Both sides run the same float64 numpy code, so the tolerance only
admits a different summation order.

``linear_sum_assignment`` (the native Hungarian solver) must reach
scipy's total cost within 1e-9 on random rectangular costs, and the port's
label CSV writer and coordinate converters must give the JAX package's
results.
"""

import numpy as np
import pytest
from scipy.optimize import linear_sum_assignment as scipy_lsa

from adyolo_tpu.data import io as jax_io
from adyolo_tpu.metrics.seld import SegmentScorer as JaxScorer
from adyolo_tpu_torch.data import io
from adyolo_tpu_torch.metrics.hungarian import linear_sum_assignment
from adyolo_tpu_torch.metrics.seld import SegmentScorer

TOL = 1e-10
K = 13


def _reference(rng, n_frames):
    label = {}
    for _ in range(40):
        t0 = int(rng.integers(n_frames - 8))
        c, src = int(rng.integers(K)), int(rng.integers(3))
        azi, ele = float(rng.integers(-180, 180)), float(rng.integers(-60, 61))
        for t in range(t0, t0 + int(rng.integers(2, 8))):
            label.setdefault(t, []).append([c, src, azi, ele])
    return label


def _prediction(rng, ref):
    out = {}
    for t, evs in io.polar_to_cartesian_dict(ref).items():
        for ev in evs:
            if rng.random() < 0.15:
                continue  # a miss
            xyz = np.asarray(ev[2:]) + rng.normal(0, 0.2, 3)
            out.setdefault(t, []).append([ev[0]] + xyz.tolist())
        if rng.random() < 0.1:  # an insertion
            out.setdefault(t, []).append([int(rng.integers(K))]
                                         + rng.normal(0, 1, 3).tolist())
    return out


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("seld")
    ref_dir, pred_dir = root / "ref", root / "pred"
    ref_dir.mkdir()
    pred_dir.mkdir()
    rng = np.random.default_rng(0)
    for i in range(6):
        name = f"clip{i}.csv"
        ref = {} if i == 4 else _reference(rng, 300 + 37 * i)
        io.write_label_csv(str(ref_dir / name), ref)
        if i != 5:  # clip5 has no prediction
            io.write_seld_output_csv(str(pred_dir / name), _prediction(rng, ref))
    return str(ref_dir), str(pred_dir)


def _flat(x):
    """Every number of a scorer result, in order."""
    if isinstance(x, (list, tuple)):
        return [v for e in x for v in _flat(e)]
    return np.asarray(x, np.float64).ravel().tolist()


@pytest.mark.parametrize("average", ["macro", "micro"])
@pytest.mark.parametrize("jackknife", [False, True])
@pytest.mark.parametrize("overlap", [None, "any", "classwise"])
def test_scorer_matches_jax(dirs, overlap, jackknife, average):
    ref_dir, pred_dir = dirs
    kw = dict(nb_classes=K, nb_label_frames_1s=10, overlap=overlap, average=average)
    port = SegmentScorer(ref_dir, **kw)
    ref = JaxScorer(ref_dir, **kw)
    assert port.nb_ref_files == ref.nb_ref_files
    got = port.get_SELD_Results(pred_dir, is_jackknife=jackknife)
    want = ref.get_SELD_Results(pred_dir, is_jackknife=jackknife)
    g, w = _flat(got), _flat(want)
    assert len(g) == len(w) and len(w) >= 5
    np.testing.assert_allclose(g, w, atol=TOL, rtol=0)
    er, f, le, lr, seld = (v[0] if jackknife else v for v in got[:5])
    assert 0 <= f <= 1 and 0 <= lr <= 1 and 0 <= le <= 180 and er >= 0
    if overlap is None:
        assert 0 < f < 1 and 0 < seld < 1  # the predictions are partly right


@pytest.mark.parametrize("shape", [(1, 1), (2, 5), (5, 2), (4, 4), (7, 3), (3, 9)])
def test_linear_sum_assignment_matches_scipy(shape):
    rng = np.random.default_rng(sum(shape))
    for _ in range(20):
        cost = rng.uniform(0, 180, shape)
        rows, cols = linear_sum_assignment(cost)
        r, c = scipy_lsa(cost)
        assert len(rows) == len(r) == min(shape)
        assert len(set(rows.tolist())) == len(rows) and len(set(cols.tolist())) == len(cols)
        assert abs(cost[rows, cols].sum() - cost[r, c].sum()) <= 1e-9


def test_label_io_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    ref = _reference(rng, 200)
    io.write_label_csv(str(tmp_path / "port.csv"), ref)
    jax_io.write_label_csv(str(tmp_path / "jax.csv"), ref)
    assert (tmp_path / "port.csv").read_text() == (tmp_path / "jax.csv").read_text()
    cart = io.polar_to_cartesian_dict(ref)
    assert cart == jax_io.polar_to_cartesian_dict(ref)
    assert io.cartesian_to_polar_dict(cart) == jax_io.cartesian_to_polar_dict(cart)
