"""The control on the card: the plain reference in TF32, in the program's
place, has to come out as not correct, and the program as correct, at
the cells' own sizes (one seed each; ``seldbench.calibrate`` reads a
dozen).  Marked ``cuda``: it skips without a card."""
from __future__ import annotations

import pytest

from seldbench import calibrate, registry

TRAIN = ["train.se34.fp32.b16", "train.conformer.fp32.b16"]


def _fails(numbers, limits):
    return any(v > limits[k] for k, v in numbers.items() if k in limits)


@pytest.mark.cuda
@pytest.mark.parametrize("name", TRAIN)
def test_the_control_fails_a_train_cell(cuda_device, name):
    limits = registry.cell(name)["limits"]
    r = calibrate.train_readings(name, 2 ** 31 + 7)
    assert not _fails(r["program"], limits), r
    assert _fails(r["control"], limits), r
    assert _fails(r["half_batch"], limits), r


@pytest.mark.cuda
def test_the_control_fails_the_serve_cell(cuda_device):
    name = "serve.conformer.starss22"
    limits = registry.cell(name)["limits"]
    r = calibrate.serve_readings(name, 2 ** 31 + 7)
    assert not _fails(r["program"], limits), r
    assert _fails(r["control"], limits), r
