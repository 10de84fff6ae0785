"""The train step (counterpart of :mod:`adyolo_tpu.parallel.train_step`,
``make_optimizer`` and ``build_train_step``, ``:86-229``), single device,
float32.

One step: int16 audio -> ``x / 32768 + 1e-8`` -> features (the Hopper STFT
kernel on CUDA) -> the model in training mode (BatchNorm on batch stats,
dropout from one ``torch.Generator``; the conformer's attention on the
Hopper train kernels) -> the AD-YOLO loss -> backward -> optimizer step.
The model, its BatchNorm running stats and the optimizer's state are
updated in place; JAX threads them through a ``TrainState`` instead.

Matmuls and convolutions run in full float32 (TF32 off), as the JAX
package's f32 step does.  Not ported yet (``ROADMAP.md``): SpecAugment,
``compute_dtype="bfloat16"`` and ``remat``; each raises.  The JAX step's
``rbg`` dropout keys are TPU-only: all dropout here comes from the
generator passed to the step, on the model's device.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional

import torch

from ..config import Config
from ..models.wrapper import SELDModel, make_criterion
from ..ops.features import FeatureFrontend

__all__ = ["make_optimizer", "build_train_step"]


def make_optimizer(cfg: Config, params: Iterable[torch.nn.Parameter]
                   ) -> torch.optim.Optimizer:
    """Adam / AdamW / SGD as the JAX package chains them in optax
    (``train_step.py:86-104``): ``Adam(weight_decay=wd)`` adds ``wd * p`` to
    the gradient, like ``chain(add_decayed_weights(wd), adam(lr))``; AdamW
    decays the weights apart from the moments, like ``optax.adamw``; eps
    1e-8 and betas (0.9, 0.999) in both frameworks."""
    name, lr, wd = cfg.train.optim, cfg.train.lr, cfg.train.weight_decay
    if name == "Adam":
        return torch.optim.Adam(params, lr=lr, weight_decay=wd)
    if name == "AdamW":
        return torch.optim.AdamW(params, lr=lr, weight_decay=wd)
    if name == "SGD":
        return torch.optim.SGD(params, lr=lr, weight_decay=wd)
    raise NotImplementedError(name)


def _check_ported(cfg: Config) -> None:
    if cfg.aug.spec_augment:
        raise NotImplementedError("spec_augment: SpecAugment is not yet ported "
                                  "(ROADMAP.md, port queue: SpecAug)")
    if cfg.train.compute_dtype != "float32":
        raise NotImplementedError(
            f"compute_dtype={cfg.train.compute_dtype!r}: bf16 training is not "
            "yet ported (ROADMAP.md, port queue: bf16)")
    if cfg.train.remat:
        raise NotImplementedError("remat is not yet ported (ROADMAP.md, port "
                                  "queue: --remat)")


def build_train_step(cfg: Config, model: SELDModel, frontend: FeatureFrontend
                     ) -> Callable:
    """Returns ``train_step(batch, generator=None) -> loss`` (a detached
    scalar on the model's device).

    ``batch``: ``{"audio": (B, T, hop, 4) or (B, N, 4) int16 (or float32 in
    [-1, 1]), "targets": (M, 7), "target_mask": (M,)}``, numpy or tensors.
    ``generator``: a ``torch.Generator`` on the model's device, the source of
    every dropout bit of the step (None: the device's default one).  The
    optimizer is ``train_step.optimizer``."""
    _check_ported(cfg)
    criterion = make_criterion(cfg)
    optimizer = make_optimizer(cfg, model.parameters())
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = frontend.device

    def train_step(batch: Dict, generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
        audio = torch.as_tensor(batch["audio"], device=device)
        if audio.dtype == torch.int16:  # reference src/datasets.py:147
            audio = audio.to(torch.float32) / 32768.0 + 1e-8
        with torch.no_grad():
            feat = frontend(audio.contiguous())
        model.train()
        out = model(feat, generator=generator)
        loss = criterion(out, torch.as_tensor(batch["targets"], device=device),
                         torch.as_tensor(batch["target_mask"], device=device))
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return loss.detach()

    train_step.optimizer = optimizer
    return train_step
