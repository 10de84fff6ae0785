"""Driver ``train_step``: the port's training step (``parallel/
train_step.py::build_train_step``: int16 audio -> K1 features -> the
encoder in training mode -> AD-YOLO loss -> backward -> Adam) on a pool
of host batches cycled, one step after another, as a training loop feeds
it.

Set-up builds the step once, then drives it through its first
``check_steps`` steps on the pool's first batches (all different), by the
window's own call; they warm every shape.  The program's losses, its
first gradient (Adam's first moment after step 1, over ``1 - beta1``) and
its parameters' change over those steps are kept for the check, which
runs the plain reference from the same weights, batches and dropout bits
once the window has closed.

Window: steps until ``--seconds`` have passed on the host clock, then a
synchronise; ``train_audio_s`` is every step's audio-seconds over the
window.  Traced: after the window (so that its clock holds none of the
tracer's cost), ``trace_steps`` more steps are profiled on the device
alone, one more with the host's ops, and one call of the step's feature
stage.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .. import checks, program
from ..reference.adam import Adam
from ..reference.frontend import mel_bank
from ..reference.loss import adyolo_loss
from ..yardstick import flops, profile
from ..yardstick.traffic import sub_seed, train_pool
from .base import DriverBase

__all__ = ["Driver"]


def half_batch(batch: dict) -> dict:
    """The batch's first half, its targets with it: a fault the check must
    see (half of the batch left out, the mean over the rest)."""
    B = len(batch["audio"])
    keep = batch["target_mask"] & (batch["targets"][:, 0] < B // 2)
    targets = np.zeros_like(batch["targets"])
    targets[:keep.sum()] = batch["targets"][keep]
    mask = np.zeros_like(keep)
    mask[:keep.sum()] = True
    return {"audio": batch["audio"][:B // 2], "targets": targets, "target_mask": mask}


class Driver(DriverBase):
    def setup(self):
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        cell, mix = self.cell, self.mix
        self.n_check = int(cell["check_steps"])
        self.ref = self.reference_model()
        self.cfg = program.port_config(self.config, cell)
        self.pool = train_pool(mix, self.config, self.seed, self.device)
        self.audio_s = mix["batch"] * mix["clip_s"]
        frames = mix["clip_s"] * self.config["data"]["sr"] // self.config["data"]["hop_length"]
        self.flops_per_step = self.model_flops(frames, mix["batch"], backward=True)
        self.prog = self.program_run()
        self.i = self.n_check

    def program_run(self, transform=None) -> dict:
        """Builds the program's step from the seeded weights and drives it
        through its first ``check_steps`` steps; keeps the step for the
        window.  ``transform`` plants a fault in the batches."""
        state = self.ref.state_dict()
        self.model = program.build_model(self.cfg, state, self.device, train=True)
        self.fe = program.frontend(self.config, self.cfg, self.device)
        self.step, self.features = program.train_step(self.cfg, self.model, self.fe)
        self.gen = torch.Generator(device=self.device).manual_seed(sub_seed(self.seed, 5))
        names = [n for n, _ in self.model.named_parameters()]
        params = list(self.model.parameters())
        opt = self.step.optimizer
        beta1 = opt.param_groups[0]["betas"][0]
        losses, grad1 = [], None
        for i in range(self.n_check):
            batch = self.pool[i] if transform is None else transform(self.pool[i])
            losses.append(self.step(batch, self.gen))
            if i == 0:
                grad1 = torch.stack([(opt.state[p]["exp_avg"] / (1.0 - beta1)).norm()
                                     for p in params])
        change = torch.stack([(p.detach() - state[n]).norm() for n, p in zip(names, params)])
        return {"losses": [float(x) for x in torch.stack(losses).cpu()],
                "grad1": dict(zip(names, grad1.cpu().tolist())),
                "change": dict(zip(names, change.cpu().tolist()))}

    def _one(self, _=None):
        with profile.span("train_step"):
            loss = self.step(self.pool[self.i % len(self.pool)], self.gen)
        self.i += 1
        self.calls += 1
        self.losses.append(loss)

    def window(self, seconds: float) -> dict:
        self.calls, self.losses = 0, []
        cuda = self.device.type == "cuda"
        sync = torch.cuda.synchronize if cuda else (lambda: None)
        sync()
        t0 = time.perf_counter()
        while True:
            self._one()
            if time.perf_counter() - t0 >= seconds:
                break
        sync()
        wall = time.perf_counter() - t0
        steps = self.calls
        res = {"seconds": wall, "steps": steps, "flops": self.flops_per_step * steps,
               "call_s": wall / steps,
               "e2e": {self.cell["rate_metric"]: steps * self.audio_s / wall}, "profile": None}
        if self.trace and cuda:  # after the window, so that its clock holds no tracer
            n = int(self.cell["trace_steps"])
            res["profile"] = profile.profile_calls(self._one, n, program.kernel_counters)
            res["ops"] = profile.profile_calls(self._one, 1, program.kernel_counters, cpu=True)
            res["frontend"] = self.frontend_probe()
            res["attention"] = self.attention_shapes()
        finite = torch.isfinite(torch.stack(self.losses)).cpu()
        res.update(attempted=self.calls, failed=int((~finite).sum()))
        return res

    def frontend_probe(self) -> dict:
        """One profiled call of the step's feature stage on a pool batch,
        and the stage's least work: the audio read once, the features
        written once, the FFTs, power, sparse mel projection and
        intensity vectors."""
        audio = torch.as_tensor(self.pool[0]["audio"], device=self.device)
        prof = profile.profile_calls(lambda i: self.features(audio), 1, program.kernel_counters,
                                     cpu=True)
        d, B = self.config["data"], self.mix["batch"]
        T = audio.shape[1]
        nnz = int(np.count_nonzero(mel_bank(d["sr"], d["n_fft"], d["mel_bins"])))
        return {"profile": prof,
                "flops": flops.frontend_flops(B, T, d["n_fft"], nnz),
                "bytes": flops.frontend_bytes(B, T * d["hop_length"], T, d["mel_bins"])}

    def attention_shapes(self):
        """The attention calls of one step: (blocks, heads, query lengths,
        key lengths, forward and backward), or None for an encoder without
        attention."""
        m = self.config["model"]
        if "conformer_blocks" not in m:
            return None
        T = self.mix["clip_s"] * self.config["data"]["sr"] // self.config["data"]["hop_length"]
        lens = [T] * self.mix["batch"]
        return {"calls": m["conformer_blocks"], "heads": m["heads"], "q": lens, "k": lens,
                "backward": True, "steps": 1}

    def reference_run(self, tf32: bool = False) -> dict:
        """The plain reference's first ``check_steps`` steps from the
        seeded weights, on the same batches and dropout bits."""
        ref = self.reference_model().train()
        fe = self.reference_frontend()
        tr = self.config["train"]
        adam = Adam(ref.parameters(), lr=tr["lr"], weight_decay=tr["weight_decay"])
        names = [n for n, _ in ref.named_parameters()]
        start = [p.detach().clone() for p in ref.parameters()]
        gen = torch.Generator(device=self.device).manual_seed(sub_seed(self.seed, 5))
        losses, grad1 = [], None
        with checks.lower_precision(tf32):
            for i in range(self.n_check):
                b = self.pool[i]
                audio = b["audio"].reshape(len(b["audio"]), -1, b["audio"].shape[-1])
                out = ref(fe(audio), generator=gen)
                loss = adyolo_loss(out, b["targets"], b["target_mask"], self.grid,
                                   self.config["data"]["nb_classes"], tr["train_unify"],
                                   tr["loss_gains"])
                loss.backward()
                losses.append(loss.detach())
                if i == 0:
                    grad1 = torch.stack([p.grad.norm() for p in ref.parameters()])
                adam.step()
        change = torch.stack([(p.detach() - s).norm() for p, s in zip(ref.parameters(), start)])
        return {"losses": [float(x) for x in torch.stack(losses).cpu()],
                "grad1": dict(zip(names, grad1.cpu().tolist())),
                "change": dict(zip(names, change.cpu().tolist()))}

    def free_program(self):
        for name in ("step", "features", "model", "fe"):
            if hasattr(self, name):
                delattr(self, name)
        self.free()

    def check(self) -> dict:
        self.free_program()
        ref = self.reference_run()
        nums = checks.train_numbers(self.prog, ref)
        self.note(f"program losses {self.prog['losses']}, reference {ref['losses']}: "
                  f"gaps a step {checks.step_loss_gaps(self.prog, ref)}")
        return {k: (v, float(self.cell["limits"][k])) for k, v in nums.items()}
