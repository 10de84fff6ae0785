"""The port's ``data/io.py::normalize_audio`` against the reference's
expression, ``(audio / 32768.0 + 1e-8).astype(np.float32)``
(``src/datasets.py:147``).

* Bit-equal, with the same dtype and shape: every int16 value; int16 clips
  of 0 and 1 rows, one row below, at and one above a block, several
  blocks and a remainder; 1-D input; views with negative and gathered
  strides; float32, float64 and int32 input.
* A 60-s FOA clip peaks at its float32 output plus the block's scratch
  under ``tracemalloc`` (the reference expression peaks at 4x the output:
  two clip-sized float64 temporaries).
"""
import tracemalloc

import numpy as np
import pytest

from adyolo_tpu_torch.data.io import NORMALIZE_BLOCK, normalize_audio

ROWS = NORMALIZE_BLOCK // 4  # a block's rows at 4 channels


def reference(audio):
    return (audio / 32768.0 + 1e-8).astype(np.float32)


def assert_same(audio):
    want, got = reference(audio), normalize_audio(audio)
    assert got.dtype == want.dtype
    assert got.shape == want.shape
    assert np.array_equal(got, want)


def int16_clip(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(-32768, 32768, (n, 4), dtype=np.int16)


def test_every_int16_value():
    assert_same(np.arange(-32768, 32768, dtype=np.int16).reshape(16384, 4))


@pytest.mark.parametrize("n", [0, 1, ROWS - 1, ROWS, ROWS + 1, 3 * ROWS + 17])
def test_int16_lengths_around_the_block(n):
    assert_same(int16_clip(n, seed=n))


def test_one_dimensional():
    assert_same(int16_clip(ROWS + 5)[:, 0].copy())
    assert_same(int16_clip(2 * ROWS + 3).reshape(-1))


@pytest.mark.parametrize("view", ["negated", "channels_swapped", "reversed",
                                  "every_other_row", "one_channel"])
def test_non_contiguous_views(view):
    audio = int16_clip(2 * ROWS + 9, seed=3)
    audio = {
        "negated": lambda a: -a[:, [1, 0, 3, 2]],
        "channels_swapped": lambda a: a[:, ::-1],
        "reversed": lambda a: a[::-1, 1:3],
        "every_other_row": lambda a: a[::2],
        "one_channel": lambda a: a[:, 2],
    }[view](audio)
    assert_same(audio)


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int32])
def test_other_dtypes(dtype):
    rng = np.random.default_rng(4)
    audio = (rng.standard_normal((2 * ROWS + 11, 4)) * 20000).astype(dtype)
    assert_same(audio)


def test_peak_memory_is_the_output_and_a_block():
    audio = int16_clip(1_440_000)  # 60 s at 24 kHz, FOA
    out_bytes = audio.size * 4
    tracemalloc.start()
    try:
        normalize_audio(audio)
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert peak <= out_bytes + (2 << 20), (peak, out_bytes)
