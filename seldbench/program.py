"""The system under test: ``adyolo_tpu_torch``, built from the benchmark's
configuration files.  This is the one module of the benchmark that
imports the port; it takes from it only the entry points a user runs (the
model, the front-end, the train step, the eval forward, the decode and
the eval loader) and its kernel counters.  It never imports
``adyolo_tpu`` (the JAX package) or ``jax``."""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch


__all__ = ["port_config", "build_model", "frontend", "train_step", "eval_forward",
           "postprocessor", "eval_loader", "kernel_counters"]


def port_config(config: dict, cell: dict):
    """The port's ``Config`` for a configuration file and a cell."""
    from adyolo_tpu_torch.config import Config, LossGains

    cfg = Config()
    d, tr = config["data"], config["train"]
    data = dataclasses.replace(cfg.data, data_pth="", name_pth="", **{
        k: d[k] for k in ("sr", "hop_length", "win_length", "n_fft", "mel_bins", "window",
                          "nb_classes", "audio_format", "label_hop_len_s", "chunk_window_s")})
    train = dataclasses.replace(
        cfg.train, batch_size=cell.get("batch", cfg.train.batch_size),
        compute_dtype=cell.get("compute_dtype", "float32"), optim=tr["optim"], lr=tr["lr"],
        weight_decay=tr["weight_decay"], grid_size=tuple(tr["grid_size"]),
        nb_anchors=tr["nb_anchors"], g_overlap=tr["g_overlap"],
        train_unify=tuple(tr["train_unify"]), loss_gains=LossGains(**tr["loss_gains"]),
        max_targets_per_clip=tr["max_targets_per_clip"], unify_thresh=tr["unify_thresh"],
        nms=tr["nms"], decode_topk=tr["decode_topk"], remat=False)
    aug = dataclasses.replace(cfg.aug, spec_augment=False, rotation_augment=False)
    args = dataclasses.replace(cfg.args, encoder=config["encoder"], loss=config["loss"],
                               augment=False)
    return dataclasses.replace(cfg, data=data, train=train, aug=aug, args=args)


def build_model(cfg, state: Dict[str, torch.Tensor], device, train: bool):
    """The port's model for ``cfg`` on ``device`` holding ``state`` (a copy:
    the program owns its weights)."""
    from adyolo_tpu_torch.models.wrapper import build_model as port_build

    with torch.device("meta"):
        model = port_build(cfg, device="meta", train=train)
    model.load_state_dict({k: v.detach().clone() for k, v in state.items()}, strict=True,
                          assign=True)
    return model.to(device).train(train)


def frontend(config: dict, cfg, device):
    """The port's FOA front-end with the configuration's scaler stats."""
    from adyolo_tpu_torch.ops.features import FeatureFrontend, Scaler

    s, mel = config["scaler"], cfg.data.mel_bins
    scaler = Scaler(*(np.asarray(s[k], np.float64).reshape(1, mel, -1)
                      for k in ("mel_mean", "mel_std", "iv_mean", "iv_std")))
    return FeatureFrontend(cfg.data, scaler, device)


def train_step(cfg, model, fe):
    """``step(batch, generator) -> loss`` (``parallel/train_step.py``) and
    its step-feature stage (``build_step_features``)."""
    from adyolo_tpu_torch.parallel.train_step import build_step_features, build_train_step

    return build_train_step(cfg, model, fe), build_step_features(cfg, fe)


def eval_forward(model, fe):
    from adyolo_tpu_torch.engine.evaluate import build_eval_forward

    return build_eval_forward(model, fe)


def postprocessor(cfg, tau: float):
    from adyolo_tpu_torch.ops.decode import PostProcessor

    pp = PostProcessor(cfg)
    pp.set_conf_thresh(tau)
    return pp


def eval_loader(cfg, clips):
    """The port's eval loader (``data/dataset.py::EvalLoader``), as ``cli
    infer`` builds it, over ``clips``: ``[(name, int16 samples (N, C))]``
    held in memory.  Its dataset is the infer split (no label, no
    rotation) with the wav read replaced by the clip's samples; the
    loader normalises them (``data/io.py::normalize_audio``), pads each
    into its bucket (``bucket_samples``) in the hop-block layout and
    encodes the empty label, as it does for a wav folder."""
    from adyolo_tpu_torch.data.dataset import EvalLoader, SELDDataset
    from adyolo_tpu_torch.data.io import normalize_audio
    from adyolo_tpu_torch.ops.grid import GridGeometry

    class ClipSet(SELDDataset):
        def __init__(self):  # the infer split's state, without its wav folder
            self.cfg, self.loss_nm, self.set_type = cfg, cfg.args.loss, "infer"
            self.is_infer, self.sampler = True, None
            self.samples = dict(clips)
            self.filelist = [name for name, _ in clips]
            self.geom = GridGeometry(tuple(cfg.train.grid_size), cfg.train.g_overlap,
                                     cfg.train.nb_anchors)

        def load_clip(self, name, normalize=True, rot_comb=None):
            audio = self.samples[name]
            return normalize_audio(audio), {}, len(audio) // self.cfg.data.label_hop_len

    return EvalLoader(ClipSet(), cfg)


def kernel_counters() -> Dict[str, int]:
    """The port's hand-written kernels launched so far, by kernel name."""
    from adyolo_tpu_torch.ops import hopper_attention, hopper_stft

    return {**hopper_stft.KERNELS, **hopper_attention.KERNELS}

