"""Small sizes for the benchmark's CPU tests: a cell's traffic cut to a few
short clips, so a driver's whole run takes seconds on the CPU."""
from __future__ import annotations

import pytest
import torch

from seldbench import registry


def small(name: str):
    """The cell ``name`` and its traffic at a CPU test's size."""
    cell = dict(registry.cell(name))
    mix = dict(registry.traffic(cell["traffic"]))
    if mix["kind"] == "train_chunks":
        mix.update(batch=2, clip_s=4)
    else:
        mix.update(clip_s=[4, 6])
    cell.update(batch=mix.get("batch", 1), trace_steps=1, warm_cycles=1, check_sample=2)
    if cell["driver"] == "train_step":
        # two 4-s clips on the CPU: BatchNorm over so few frames spreads the
        # sound runs' gaps wider than at the cell's size (CPU readings: loss
        # 2e-3 to 4e-3, gradients ~1e-2, change 0.05 to 0.1; half the batch
        # left out reads 0.06, 1.5 and 0.7)
        cell["limits"] = {"loss_gap": 0.02, "grad_gap": 0.1, "change_gap": 0.4}
    return cell, mix


@pytest.fixture
def small_cell(monkeypatch):
    """``use(name)``: the registry hands out that cell and its traffic at a
    CPU test's size."""
    torch.set_num_threads(4)

    def use(name):
        cell, mix = small(name)
        monkeypatch.setattr(registry, "cell", lambda n: cell)
        monkeypatch.setattr(registry, "traffic", lambda n: mix)
        return cell, mix

    return use


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided here, never while a module imports."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda:0"
