"""The train step and the eval criterion (counterpart of
:mod:`adyolo_tpu.parallel.train_step`: ``make_optimizer``,
``build_train_step`` and ``build_eval_criterion``), single device.

One step: int16 audio -> ``x / 32768 + 1e-8`` -> features (the Hopper STFT
kernel on CUDA, float32, without autograd) -> SpecAugment when the config
turns it on -> the model in training mode (BatchNorm on batch stats,
dropout; the conformer's attention on the Hopper train kernels) in the
config's compute dtype -> the config's loss (float32) -> backward ->
optimizer step on the float32 parameters.  Every SpecAugment draw and
dropout bit comes from the ``torch.Generator`` passed to the step, on the
model's device.  The model,
its BatchNorm running stats and the optimizer's state are updated in
place; JAX threads them through a ``TrainState`` instead.

``compute_dtype="bfloat16"`` runs the encoder's conv stack (and the
conformer's blocks) in bfloat16 as the JAX package's bf16 step does
(:mod:`adyolo_tpu_torch.models.wrapper`); the parameters, the optimizer
state, the head and the loss stay float32.  ``remat`` checkpoints the
conformer's blocks.  Float32 matmuls and convolutions run in full float32
(TF32 off), as the JAX package's f32 step does.  The JAX step's ``rbg``
dropout keys are TPU-only.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional

import torch

from ..config import Config
from ..models.wrapper import SELDModel, make_criterion
from ..ops.features import FeatureFrontend
from ..ops.specaug import spec_augment

__all__ = ["make_optimizer", "build_step_features", "build_train_step",
           "build_eval_criterion"]


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


def build_step_features(cfg: Config, frontend: FeatureFrontend) -> Callable:
    """``features(audio, generator=None) -> (B, T, F, C)``: the train step's
    input, without autograd.  int16 audio -> ``x / 32768 + 1e-8`` -> the
    scaled features -> SpecAugment when the config turns it on, one mask
    pair per (clip, feature block) drawn from ``generator``; the blocks are
    the 4 log-mel channels and the rest (``adyolo_tpu/parallel/
    train_step.py:130-157``)."""
    device = frontend.device
    aug = cfg.aug
    blocks = (4, d_aux) if (d_aux := cfg.data.nb_feature_channels - 4) else (4,)

    @torch.no_grad()
    def features(audio, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        audio = torch.as_tensor(audio, device=device)
        if audio.dtype == torch.int16:  # reference src/datasets.py:147
            audio = audio.to(torch.float32) / 32768.0 + 1e-8
        feat = frontend(audio.contiguous())
        if aug.spec_augment:
            feat = spec_augment(feat, generator, blocks,
                                aug.spec_augment_time_mask_param,
                                aug.spec_augment_freq_mask_param,
                                aug.spec_augment_thresh)
        return feat

    return features


def build_train_step(cfg: Config, model: SELDModel, frontend: FeatureFrontend
                     ) -> Callable:
    """Returns ``train_step(batch, generator=None) -> loss`` (a detached
    scalar on the model's device).

    ``batch``: ``{"audio": (B, T, hop, 4) or (B, N, 4) int16 (or float32 in
    [-1, 1]), "targets", "target_mask"}``, numpy or tensors: AD-YOLO's
    (M, 7) targets and (M,) mask, or a dense format's (B, T', ...) targets
    and no mask.
    ``generator``: a ``torch.Generator`` on the model's device, the source of
    every SpecAugment draw and dropout bit of the step, in that order
    (None: the device's default one).  The
    optimizer is ``train_step.optimizer``."""
    criterion = make_criterion(cfg)
    optimizer = make_optimizer(cfg, model.parameters())
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = frontend.device
    features = build_step_features(cfg, frontend)

    def train_step(batch: Dict, generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
        feat = features(batch["audio"], generator)
        model.train()
        out = model(feat, generator=generator)
        loss = criterion(out, torch.as_tensor(batch["targets"], device=device),
                         _mask(batch.get("target_mask"), device))
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return loss.detach()

    train_step.optimizer = optimizer
    return train_step


def _mask(target_mask, device):
    """AD-YOLO's target mask on ``device``; None (dense formats) stays."""
    return None if target_mask is None else torch.as_tensor(target_mask, device=device)


def build_eval_criterion(cfg: Config) -> Callable:
    """``loss_fn(out, targets, target_mask, nb_label_frames) -> scalar``: the
    config's loss of an eval forward's output over its valid label frames
    only (``adyolo_tpu/parallel/train_step.py:255-277``); ``target_mask``
    is None for the dense formats.  The frame mask
    is built on the output's device, so a long clip's loss stays one device
    computation with no slicing on the host; it equals the loss of the
    output and targets cut to the valid frames.  Runs under
    ``torch.inference_mode``."""
    criterion = make_criterion(cfg)

    @torch.inference_mode()
    def loss_fn(out, targets, target_mask, nb_label_frames):
        dev = out.device
        valid = torch.as_tensor(nb_label_frames, device=dev).reshape(-1, 1)
        frame_mask = torch.arange(out.shape[1], device=dev)[None, :] < valid
        return criterion(out, torch.as_tensor(targets, device=dev),
                         _mask(target_mask, dev), frame_mask)

    return loss_fn
