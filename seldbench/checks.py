"""The numbers that decide ``correct``, each a gap between the program and
the plain reference (:mod:`seldbench.reference`), and the context that
puts the reference in lower precision (the control).

Training (the first ``n`` steps of the program's own train step, on rows
that all differ, against the reference from the same weights, inputs and
dropout bits):

* ``loss_gap``: the first step's ``|loss_p - loss_r| / |loss_r|`` (the
  later steps' losses part by Adam's growth of round-off, and are printed
  beside it, not compared);
* ``grad_gap``: the first gradient as the optimizer got it (the program's:
  Adam's first moment after step 1 over ``1 - beta1``), by the worst leaf:
  ``| |g_p| - |g_r| | / max(|g_r|, median leaf |g_r|)``;
* ``change_gap``: the parameters' change after the ``n`` steps, by the
  worst leaf as above, over the leaves whose reference gradient is at
  least 1e-3 x the median leaf's (below it a leaf moves under Adam by
  round-off alone).

Serving (a sample of the clips the window finished, drawn from the seed,
the longest always in it):

* ``logit_gap``: ``max |logits_p - logits_r| / max |logits_r|`` of a clip,
  the worst clip; the reference runs each clip at its own length;
* ``det_mismatch``: label frames whose detections differ from the
  reference decode of the program's own logits (an exact comparison).
"""
from __future__ import annotations

import contextlib
from typing import Dict

import numpy as np
import torch

__all__ = ["train_numbers", "step_loss_gaps", "lower_precision", "leaf_gap"]


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float], leaves=None) -> float:
    names = list(ref) if leaves is None else list(leaves)
    if not names:
        return 0.0
    med = float(np.median([ref[n] for n in names]))
    return max(abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30) for n in names)


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    loss = abs(prog["losses"][0] - ref["losses"][0]) / abs(ref["losses"][0])
    med = float(np.median(list(ref["grad1"].values())))
    moving = [n for n, g in ref["grad1"].items() if g >= 1e-3 * med]
    return {"loss_gap": float(loss), "grad_gap": leaf_gap(prog["grad1"], ref["grad1"]),
            "change_gap": leaf_gap(prog["change"], ref["change"], moving)}


def step_loss_gaps(prog: dict, ref: dict) -> list:
    """Every step's relative loss gap, for the record."""
    return [abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"])]


@contextlib.contextmanager
def lower_precision(on: bool):
    """TF32 products and convolutions while ``on``: the control, the step
    below the configuration's float32 with TF32 off."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = bool(on)
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old

