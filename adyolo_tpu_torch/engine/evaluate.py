"""Inference engine (counterpart of :mod:`adyolo_tpu.engine.evaluate`,
``infer`` action only).

``infer`` runs a wav folder through the serving path: ``SELDDataset`` +
``EvalLoader`` (length-bucketed hop-block audio) -> :class:`FeatureFrontend`
(Hopper STFT kernel on CUDA) -> SE-ResNet34 or ResNet-Conformer (Hopper
attention kernel on CUDA) + AD-YOLO -> device decode + host NMS -> one
DCASE-format CSV per clip.  The model is whatever ``build_model`` made for
the experiment's config; a conformer experiment written by the JAX
trainer serves the same way.  ``val``/``test`` wait for the
AD-YOLO loss, whose value they print.
"""
from __future__ import annotations

import dataclasses
import os
import shutil
import sys
import time
from typing import Callable, List, Tuple

import torch

from ..config import Config
from ..data.dataset import EvalLoader, SELDDataset
from ..data.io import write_seld_output_csv
from ..models.wrapper import SELDModel
from ..ops.decode import PostProcessor
from ..ops.features import FeatureFrontend, Scaler, identity_scaler

__all__ = ["make_frontend", "build_eval_forward", "test_epoch", "infer",
           "delete_and_create_folder"]


def delete_and_create_folder(path: str) -> None:
    if os.path.isdir(path):
        shutil.rmtree(path)
    os.makedirs(path, exist_ok=True)


def make_frontend(cfg: Config, device="cuda") -> FeatureFrontend:
    """Frontend with the dataset's scaler stats (``scaler_wts.pkl``);
    identity stats, with a warning, when the file is absent."""
    pkl = os.path.join(cfg.data.data_pth, "scaler_wts.pkl")
    if os.path.isfile(pkl):
        scaler = Scaler.from_pickle(pkl)
    else:
        print(f"[adyolo_tpu_torch] WARNING: no scaler stats at {pkl}; "
              "using identity normalization.", file=sys.stderr)
        scaler = identity_scaler(cfg.data.mel_bins)
    return FeatureFrontend(cfg.data, scaler, device)


def build_eval_forward(model: SELDModel, frontend: FeatureFrontend) -> Callable:
    """``eval_forward(audio, valid_feat_frames) -> logits`` (B, T/4, D) on
    the frontend's device, under ``torch.inference_mode``.

    Eval runs at full float32, like the JAX package's eval
    (``default_matmul_precision("float32")``): this turns TF32 off for
    cuDNN convolutions and for CUDA matmuls, process-wide (PyTorch
    defaults cuDNN convolutions to TF32).
    """
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = frontend.device

    @torch.inference_mode()
    def fwd(audio, valid_feat_frames=None):
        audio = torch.as_tensor(audio, device=device)
        if valid_feat_frames is not None:
            valid_feat_frames = torch.as_tensor(valid_feat_frames, device=device)
        feat = frontend(audio, valid_feat_frames)
        return model(feat, valid_feat_frames)

    return fwd


def test_epoch(loader: EvalLoader, eval_fwd: Callable,
               postprocessor: PostProcessor, output_pth: str
               ) -> List[Tuple[str, float]]:
    """Forward + decode + CSV per clip.  Returns ``[(clip, seconds)]``:
    each clip's host wall time from its audio leaving the loader to its
    CSV on disk (the decode copies to the host, which waits for the
    device)."""
    delete_and_create_folder(output_pth)
    times = []
    for item in loader:
        t0 = time.perf_counter()
        out = eval_fwd(item["audio"], item["valid_feat_frames"])
        dets = postprocessor.postprocess(out, valid_label_frames=item["nb_label_frames"])
        write_seld_output_csv(os.path.join(output_pth, item["name"] + ".csv"), dets)
        times.append((item["name"], time.perf_counter() - t0))
    return times


def infer(cfg: Config, model: SELDModel, frontend: FeatureFrontend,
          postprocessor: PostProcessor, infer_pth: str, output_pth: str
          ) -> List[Tuple[str, float]]:
    """Label-free inference on every ``*.wav`` under ``infer_pth``; one
    ``<clip>.csv`` per wav under ``output_pth``.  Returns the per-clip
    times of :func:`test_epoch`."""
    cfg = dataclasses.replace(
        cfg, args=dataclasses.replace(cfg.args, infer_pth=infer_pth))
    loader = EvalLoader(SELDDataset(cfg, "infer", is_valid=True), cfg)
    return test_epoch(loader, build_eval_forward(model, frontend),
                      postprocessor, output_pth)
