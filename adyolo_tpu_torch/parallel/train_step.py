"""The train step and the eval criterion (counterpart of
:mod:`adyolo_tpu.parallel.train_step`: ``make_optimizer``,
``build_train_step`` and ``build_eval_criterion``), on one device or,
under a process group of several ranks, data-parallel.

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

Data parallelism (:mod:`adyolo_tpu_torch.parallel.mesh`): each rank takes
its shard of the global batch, and one step on N ranks is the JAX
package's DP step, which is its single-device step on the global batch:

* the model is wrapped in ``DistributedDataParallel`` (its parameters and
  optimizer are the wrapper's; ``broadcast_buffers=False``, since the
  BatchNorm running stats come out equal on every rank);
* every ``BatchNorm`` normalises by the global batch's moments
  (:func:`~adyolo_tpu_torch.models.layers.global_batch_stats`, on the
  mesh's batch group);
* AD-YOLO's denominators are the global counts (``reduce_counts``), and
  the rank's term is scaled for DDP's average of the gradients (below);
* every rank holds the same generator; each step draws one seed from it
  and makes the rank's generator of that step from the seed and the rank,
  so ranks draw different SpecAugment masks and dropout bits while the
  checkpoint keeps one generator state;
* the step returns the global batch's loss.

With one rank (no group) the step is the single-device one, bit for bit.

Tensor parallelism (``model_parallel`` N > 1, :func:`~adyolo_tpu_torch.
parallel.mesh.set_model_parallel`): every rank first takes global rank
0's full weights, then the conformer modules that N cuts cleanly
(:func:`~adyolo_tpu_torch.parallel.mesh.tp_plan`) are sharded over the TP
group (:func:`~adyolo_tpu_torch.models.resnet_conformer.shard_conformer_`)
before the optimizer is built, so Adam's state holds shards; every other
parameter, and all of SE-ResNet34's, is held whole on every rank, whose
step then repeats its peers' work, as JAX's model axis does.  The N ranks
of a model group take the same clips and the same generator: the data
replica's.  After the backward the gradients of the replicated
parameters are averaged over the TP group
(:func:`~adyolo_tpu_torch.parallel.mesh.average_replicated_grads`), so
the replicated weights stay equal on every rank.  With one replica the step uses the generator as the single
process does, so every dropout bit is the single-process step's and the
step is the single-process step up to the order of the sums; with
several, DDP averages over the DP group (the ranks holding the same
shard), the batch group is the DP group's ranks, and the rank generators
are the replicas' (``seed * dp + dp_rank``).
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, Iterable, Optional

import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel

from ..config import Config
from ..models.layers import global_batch_stats
from ..models.resnet_conformer import shard_conformer_
from ..models.wrapper import SELDModel, make_criterion
from ..ops.features import FeatureFrontend
from ..ops.specaug import spec_augment
from ..utils.profiling import span
from . import mesh

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
        with span("train.features"):
            with span("train.h2d"):
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
    optimizer is ``train_step.optimizer``; its first parameter group counts
    the steps taken (``"steps"``, saved with its state dict).  The model's
    layout over the TP group is ``train_step.plan`` (a
    :class:`~adyolo_tpu_torch.parallel.mesh.TPPlan`, empty without tensor
    parallelism), which reads and writes of the full state take.

    Under a process group of N > 1 data replicas, ``batch`` is this
    replica's shard (``batch_size / N`` clips, AD-YOLO targets indexed
    within it), every rank passes the same generator, and the loss
    returned is the global batch's, equal on every rank.  Under tensor
    parallelism ``model`` (full and initialised, either encoder) is
    sharded in place here, as far as its plan shards it.

    Under a ``torch.profiler`` capture the step's parts are the spans
    (:func:`~adyolo_tpu_torch.utils.profiling.span`) ``train.step`` holding
    ``train.features`` (which holds the audio's ``train.h2d``),
    ``train.forward``, the targets' ``train.h2d``, ``train.loss``,
    ``train.backward`` and ``train.optimizer``."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = frontend.device
    features = build_step_features(cfg, frontend)
    replicas, tp = mesh.dp_size(), mesh.tp_size()
    plan = mesh.tp_plan(model, tp)
    if tp > 1:
        _broadcast_from_rank0(model)
        shard_conformer_(model.encoder, mesh.tp_group(), mesh.tp_rank(), plan)
    if replicas == 1:
        net, criterion, scale = model, make_criterion(cfg), 1.0
        synced = contextlib.nullcontext
    else:
        dev = torch.device(device)
        ids = None if dev.type != "cuda" else [
            torch.cuda.current_device() if dev.index is None else dev.index]
        net = DistributedDataParallel(model, device_ids=ids, broadcast_buffers=False,
                                      process_group=mesh.dp_group())
        dense = cfg.args.loss != "adyolo"
        criterion = make_criterion(cfg, None if dense else mesh.all_reduce_counts)
        # DDP averages the ranks' gradients, so the ranks' objectives must
        # add up to N x the global loss.  A dense loss is a mean over this
        # rank's frames, and the shards are equal: the N means add up to N
        # x the global mean as they are.  AD-YOLO's term is this rank's
        # sums over the global counts: the N terms add up to the global
        # loss, so each is scaled by N.
        scale = 1.0 if dense else float(replicas)
        batch_group = mesh.batch_group()

        def synced():
            return global_batch_stats(model, batch_group)
    optimizer = make_optimizer(cfg, net.parameters())

    def train_step(batch: Dict, generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
        with span("train.step"):
            gen = generator if replicas == 1 else _rank_generator(generator, device)
            feat = features(batch["audio"], gen)
            model.train()
            with synced():  # the remat recompute, in the backward, included
                with span("train.forward"):
                    out = net(feat, generator=gen)
                with span("train.h2d"):
                    targets = torch.as_tensor(batch["targets"], device=device)
                    mask = _mask(batch.get("target_mask"), device)
                with span("train.loss"):
                    loss = criterion(out, targets, mask)
                optimizer.zero_grad(set_to_none=True)
                # the backward's kernels are launched from autograd's device
                # thread: the span names host time, it holds none of their device time
                with span("train.backward"):
                    (loss * scale if scale != 1.0 else loss).backward()
            if tp > 1:
                mesh.average_replicated_grads(model, plan)
            with span("train.optimizer"):
                optimizer.step()
            group = optimizer.param_groups[0]
            group["steps"] = group.get("steps", 0) + 1  # JAX's TrainState.step
            if replicas == 1:
                return loss.detach()
            # the global batch's loss: the AD-YOLO terms add up to it, the
            # dense means average to it
            return mesh.all_reduce_counts(loss.detach()) * (scale / replicas)

    train_step.optimizer = optimizer
    train_step.plan = plan
    return train_step


def _rank_generator(generator: Optional[torch.Generator], device) -> torch.Generator:
    """This data replica's generator for one step: seeded with ``seed * N +
    replica`` (N replicas; the replica is the rank without tensor
    parallelism) from one seed drawn from ``generator`` (the device's
    default one when None), which therefore advances alike on every rank;
    the ranks of a model group draw alike."""
    seed = int(torch.randint(0, 2 ** 31, (1,), generator=generator,
                             device=device if generator is None else generator.device))
    g = torch.Generator(device=device)
    return g.manual_seed(seed * mesh.dp_size() + mesh.dp_rank())


@torch.no_grad()
def _broadcast_from_rank0(model: torch.nn.Module) -> None:
    """Every rank's full weights and BatchNorm stats become global rank 0's,
    so the ranks cut their shards from one model (DDP's broadcast reaches
    only the ranks holding the same shard): one broadcast per dtype of the
    whole state, flattened, since each collective costs a round trip."""
    by_dtype: Dict[torch.dtype, list] = {}
    for t in model.state_dict().values():
        by_dtype.setdefault(t.dtype, []).append(t)
    for tensors in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.broadcast(flat, src=0)
        offset = 0
        for t in tensors:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


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
