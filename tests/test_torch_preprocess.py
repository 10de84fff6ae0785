"""``cli preprocess`` in the port vs the JAX package's preprocessing, on the
CPU, on small synthetic DCASE-layout sets (``dev-train`` clips of 3.0 and
2.55 s, random labels, FOA and MIC).

* ``compute_scaler_stats``: the port's front-end on flat ``(1, N, 4)``
  audio, one clip at a time, against JAX's on the same wavs: ``mean`` and
  ``std`` within 1e-5 x max|stat|, the log-mel extrema within 1e-3 dB and
  the auxiliary (IV / GCC-PHAT) extrema within 1e-4 x max|extremum|, the
  front-end's own tolerance (``tests/test_torch_mic.py``); the
  layout ``{'MEL', 'IV'}`` (FOA) or ``{'MEL', 'GCC'}`` (MIC), each stat
  ``(1, 64, C)``.
* ``preprocess_chunking`` (2-s windows every 1 s): the port's wav and csv
  files byte-identical to JAX's, and ``chunk_clip``'s count
  ``(N' - W) // S + 1``.
* ``cli.main(["preprocess", ...])``: ``chunking`` over ``--dataset all``
  and ``scaler`` with ``--device cpu`` write what the functions write,
  and the pickle loads as the front-end's scaler.
"""
import filecmp
import os
import pickle
import shutil

import numpy as np
import pytest
import yaml

from adyolo_tpu.config import DataConfig as JaxDataConfig
from adyolo_tpu.data.chunking import preprocess_chunking as jax_chunking
from adyolo_tpu.data.scaler import compute_scaler_stats as jax_scaler_stats
from adyolo_tpu_torch import cli
from adyolo_tpu_torch.config import DataConfig
from adyolo_tpu_torch.data import io
from adyolo_tpu_torch.data.chunking import chunk_clip, preprocess_chunking
from adyolo_tpu_torch.data.scaler import compute_scaler_stats
from adyolo_tpu_torch.ops.features import FeatureFrontend, Scaler

from tests.synth_data import random_label
from tests.test_torch_config import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SR = 24000
CLIP_SECS = (3.0, 2.55)
STAT_REL = 1e-5
MEL_DB_TOL = 1e-3
AUX_EXTREMUM_REL = 1e-4


def _write_set(root, fmt, seed):
    rng = np.random.default_rng(seed)
    wav_dir = os.path.join(root, f"{fmt}_dev", "dev-train")
    csv_dir = os.path.join(root, "metadata_dev", "dev-train")
    os.makedirs(wav_dir)
    os.makedirs(csv_dir)
    for i, secs in enumerate(CLIP_SECS):
        n = int(SR * secs)
        audio = (rng.standard_normal((n, 4)) * 1500).astype(np.int16)
        audio[: SR // 10] = 0  # a silent start: GCC-PHAT's R = 0 rows
        io.write_wav(os.path.join(wav_dir, f"fold1_room1_mix{i:03d}.wav"), audio, SR)
        io.write_label_csv(os.path.join(csv_dir, f"fold1_room1_mix{i:03d}.csv"),
                           random_label(rng, n // (SR // 10), 13, n_events=12))
    return root


def _data_cfgs(root, fmt, **kw):
    kw = dict(data_pth=root, audio_format=fmt, chunk_window_s=2, chunk_stride_s=1, **kw)
    return JaxDataConfig(**kw), DataConfig(**kw)


@pytest.mark.parametrize("fmt", ["foa", "mic"])
def test_scaler_stats_match_jax(tmp_path, fmt):
    _check_scaler_stats(tmp_path, fmt)


@pytest.mark.parametrize("fmt", ["foa", "mic"])
def test_scaler_stats_match_jax_at_n_fft_2048(tmp_path, fmt):
    """The DCASE SELD baseline's STFT geometry (n_fft 2048, a 1200-sample
    window at the 600-sample hop): the pass frames flat clips at any hop."""
    _check_scaler_stats(tmp_path, fmt, n_fft=2048, win_length=1200)


def _check_scaler_stats(tmp_path, fmt, **geometry):
    root = _write_set(str(tmp_path / fmt), fmt, seed=1)
    jd, pd = _data_cfgs(root, fmt, **geometry)
    want = jax_scaler_stats(jd, verbose=False)
    got = compute_scaler_stats(pd, device="cpu", verbose=False)
    aux = "IV" if fmt == "foa" else "GCC"
    assert set(got) == set(want) == {"MEL", aux}
    for block, C in (("MEL", 4), (aux, 3 if fmt == "foa" else 6)):
        for stat in ("mean", "std", "max", "min"):
            g, w = np.asarray(got[block][stat]), np.asarray(want[block][stat])
            assert g.shape == w.shape == (1, 64, C), (block, stat)
            err = float(np.abs(g - w).max())
            if stat in ("mean", "std"):
                tol = STAT_REL * float(np.abs(w).max())
            elif block == "MEL":
                tol = MEL_DB_TOL
            else:
                tol = AUX_EXTREMUM_REL * float(np.abs(w).max())
            assert err <= tol, (block, stat, err, tol)
        assert np.all(np.asarray(got[block]["std"]) > 0)


def test_chunking_is_byte_identical_to_jax(tmp_path):
    mine = _write_set(str(tmp_path / "port"), "mic", seed=2)
    ref = str(tmp_path / "jax")
    shutil.copytree(mine, ref)
    jd, _ = _data_cfgs(ref, "mic")
    _, pd = _data_cfgs(mine, "mic")
    n_want = jax_chunking(jd, verbose=False)
    n_got = preprocess_chunking(pd, verbose=False)
    assert n_got == n_want == 4  # 2 windows of 2 s in 3.0 s and (padded) in 2.55 s
    sub = "dev-train-chunked_2s_1s"
    for d in (os.path.join("mic_dev", sub), os.path.join("metadata_dev", sub)):
        names = sorted(os.listdir(os.path.join(ref, d)))
        assert names == sorted(os.listdir(os.path.join(mine, d))) and len(names) == 4
        for n in names:
            assert filecmp.cmp(os.path.join(mine, d, n), os.path.join(ref, d, n),
                               shallow=False), n
    audio = io.read_wav(os.path.join(mine, "mic_dev", "dev-train", "fold1_room1_mix001.wav"))
    chunks = chunk_clip(audio, {}, pd)
    W, S = SR * 2, SR
    padded = len(audio) + (S - (len(audio) - W) % S) % S
    assert len(chunks) == (padded - W) // S + 1 == 2
    np.testing.assert_array_equal(chunks[1][0][:len(audio) - S], audio[S:])
    assert not chunks[1][0][len(audio) - S:].any()  # the zero pad


def test_cli_preprocess_writes_chunks_and_scaler(tmp_path, capsys):
    configs = str(tmp_path / "configs")
    os.makedirs(configs)
    roots = {}
    for year in (2020, 2021, 2022):
        roots[year] = _write_set(str(tmp_path / f"D{year}"), "foa", seed=year)
        with open(os.path.join(configs, f"hyp_data_DCASE{year}.yaml"), "w") as f:
            yaml.safe_dump({"data_pth": roots[year], "chunk_window_s": 2}, f)
    assert cli.main(["preprocess", "chunking", "--dataset", "all",
                     "--config_dir", configs]) == 0
    out = capsys.readouterr().out
    for year, root in roots.items():
        assert f"DCASE{year}: wrote 4 chunks" in out
        assert len(os.listdir(os.path.join(root, "foa_dev", "dev-train-chunked_2s_1s"))) == 4
    assert cli.main(["preprocess", "scaler", "--dataset", "DCASE2022",
                     "--config_dir", configs, "--device", "cpu"]) == 0
    pkl = os.path.join(roots[2022], "scaler_wts.pkl")
    assert f"DCASE2022: wrote {pkl}" in capsys.readouterr().out
    with open(pkl, "rb") as f:
        written = pickle.load(f)
    _, pd = _data_cfgs(roots[2022], "foa")
    want = compute_scaler_stats(pd, device="cpu", verbose=False)
    for block in ("MEL", "IV"):
        for stat in ("mean", "std", "max", "min"):
            np.testing.assert_array_equal(written[block][stat], want[block][stat])
    FeatureFrontend(pd, Scaler.from_pickle(pkl), device="cpu")
    assert not os.path.exists(os.path.join(roots[2020], "scaler_wts.pkl"))
