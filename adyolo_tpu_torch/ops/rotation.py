"""FOA rotation augmentation (16 channel-swap/sign rotations): the port's
copy of :mod:`adyolo_tpu.ops.rotation`.

Host-side numpy re-implementation of the reference ``RotationAug``
(``src/utils/augmentations.py:36-111``): each of the 16 spatial
transforms multiplies the Y/Z/X FOA channels (wav channels 1..3) by ±1,
optionally swaps the X and Y channels (wav channels 1 and 3), and applies
the matching (azimuth, elevation) label transform
``azi' = azi * pi_weight + d_pi`` (wrapped into (-180, 180]) and
``ele' = ele * theta_weight``.

Runs on the host before the audio batch ships to the device: it is pure
sign/permute work on int16 audio and must transform the sparse label dict
in lockstep.
"""
from __future__ import annotations

import random
from typing import Optional, Tuple

import numpy as np

from ..data.io import LabelDict

__all__ = ["ROTATION_COMBINATIONS", "rotate_foa", "RotationAug"]

# (yzx channel weights, xy_swap, pi_weight, d_pi, theta_weight)
# — the 16 FOA-preserving rotations/reflections (augmentations.py:45-69).
ROTATION_COMBINATIONS: Tuple[Tuple[Tuple[int, int, int], bool, int, int, int], ...] = (
    ((1, 1, 1), False, 1, 0, 1),
    ((1, -1, 1), False, 1, 0, -1),
    ((-1, 1, 1), False, -1, 0, 1),
    ((-1, -1, 1), False, -1, 0, -1),
    ((-1, 1, -1), False, 1, 180, 1),
    ((-1, -1, -1), False, 1, 180, -1),
    ((1, 1, -1), False, -1, 180, 1),
    ((1, -1, -1), False, -1, 180, -1),
    ((-1, 1, 1), True, 1, 90, 1),
    ((-1, -1, 1), True, 1, 90, -1),
    ((1, 1, 1), True, -1, 90, 1),
    ((1, -1, 1), True, -1, 90, -1),
    ((1, 1, -1), True, 1, -90, 1),
    ((1, -1, -1), True, 1, -90, -1),
    ((-1, 1, -1), True, -1, -90, 1),
    ((-1, -1, -1), True, -1, -90, -1),
)


def rotate_foa(audio: np.ndarray, label: LabelDict, comb_no: int):
    """Apply rotation ``comb_no`` to (N, 4) FOA audio + label dict.
    Returns new (audio, label) — inputs are not mutated."""
    yzx_w, xy_swap, pi_w, d_pi, th_w = ROTATION_COMBINATIONS[comb_no]
    audio = audio.copy()
    for ch in range(1, 4):
        audio[:, ch] = audio[:, ch] * yzx_w[ch - 1]
    if xy_swap:
        audio = audio[:, [0, 3, 2, 1]]

    new_label: LabelDict = {}
    for frame, events in label.items():
        rows = []
        for ev in events:
            azi = ev[-2] * pi_w + d_pi
            ele = ev[-1] * th_w
            if azi < -180:
                azi += 360
            elif azi > 180:
                azi -= 360
            rows.append(list(ev[:-2]) + [azi, ele])
        new_label[frame] = rows
    return audio, new_label


class RotationAug:
    """Stateful wrapper matching the reference's train/eval gating
    (augmentations.py:71-88): active only when enabled and not validating;
    the combination index is drawn from python's ``random`` so it is
    covered by the checkpointable host RNG state."""

    def __init__(self, enabled: bool, is_valid: bool):
        self.active = enabled and not is_valid

    def draw(self, n: int):
        """Pre-draw ``n`` combination indices in order — consumes the host
        RNG exactly as ``n`` sequential __call__s would, so a loader can
        draw up-front and then load clips on parallel workers without
        changing the checkpointable RNG stream (None when inactive:
        inactive calls consume no randomness)."""
        if not self.active:
            return [None] * n
        return [int(random.uniform(0, 16)) for _ in range(n)]

    def __call__(self, audio: np.ndarray, label: LabelDict, comb_no: Optional[int] = None):
        if not self.active:
            return audio, label
        if comb_no is None:
            comb_no = int(random.uniform(0, 16))
        return rotate_foa(audio, label, comb_no)
