"""What the drivers share: the reference model with the run's seeded
weights, the FLOP counts of the reference at the cell's shapes, and a
driver's interface (``setup``, ``window``, ``check``, ``notes``)."""
from __future__ import annotations

import gc

import torch

from ..reference.frontend import Frontend
from ..reference.models import SELDModel
from ..yardstick import flops
from ..yardstick.traffic import Grid, sub_seed
from ..yardstick.weights import seeded_state

__all__ = ["DriverBase"]


class DriverBase:
    def __init__(self, cell, config, mix, seed, device, trace=False, chips=1):
        self.cell, self.config, self.mix = cell, config, mix
        self.seed, self.device = int(seed), torch.device(device)
        self.trace, self.chips = trace, chips
        self.grid = Grid(config["train"]["grid_size"], config["train"]["g_overlap"],
                         config["train"]["nb_anchors"])
        self._notes = []

    def reference_model(self) -> SELDModel:
        """The reference model holding the run's seeded weights, on the
        device (built on ``meta``, so nothing is drawn on the host)."""
        with torch.device("meta"):
            ref = SELDModel(self.config)
        state = seeded_state(ref.state_dict(), sub_seed(self.seed, 0), self.device,
                             self.config.get("init"))
        ref.load_state_dict(state, assign=True)
        return ref

    def reference_frontend(self) -> Frontend:
        return Frontend(self.config["data"], self.config["scaler"], self.device)

    def model_flops(self, frames: int, clips: int, backward: bool) -> int:
        """Model FLOPs of one call at ``clips`` x ``frames`` feature frames:
        the reference encoder and head (forward, and backward with
        ``backward``) and the front-end's FFTs and mel projections."""
        d = self.config["data"]
        feat = (clips, frames, d["mel_bins"], self.config["model"]["in_channels"])
        model = flops.model_flops(lambda: SELDModel(self.config).train(backward), feat, backward)
        return model + flops.frontend_model_flops(clips, frames, d["n_fft"], d["mel_bins"])

    def note(self, line: str) -> None:
        self._notes.append(line)

    def notes(self):
        return list(self._notes)

    @staticmethod
    def free():
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
