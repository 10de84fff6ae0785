"""Evaluation and inference engine (counterpart of
:mod:`adyolo_tpu.engine.evaluate`, reference ``src/test.py``).

* :func:`test_epoch`: per clip, the eval forward (length-bucketed
  hop-block audio -> :class:`FeatureFrontend`, the Hopper STFT kernel on
  CUDA -> SE-ResNet34 or ResNet-Conformer, the Hopper attention kernel on
  CUDA -> the loss's head), the frame-masked loss when the clip has
  labels, the decode (AD-YOLO: device decode + host NMS; the dense
  formats on the host), and one DCASE-format CSV (``test.py:33-60``).
* :func:`cached_eval_outputs` / :func:`decode_cached_to_csv`: one forward
  over a split, then decodes under as many confidence thresholds as the
  trainer's τ-arbitration scans.
* :func:`test_model`: ``val`` / ``test`` of a saved experiment (the frozen
  config, the best checkpoint and its arbitrated threshold; the unify
  threshold sweep {15, 30, 45} for ADPIT and AD-YOLO; overall and
  classwise scores and the two polyphony-restricted re-scorings,
  ``test.py:63-140``), and ``infer``.
* :func:`infer`: label-free inference on a wav folder.

The experiment may come from either trainer: ``model_best.ckpt`` is in
the JAX package's file format.
"""
from __future__ import annotations

import dataclasses
import os
import shutil
import sys
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import Config, load_config
from ..data.dataset import EvalLoader, SELDDataset
from ..data.io import write_seld_output_csv
from ..metrics.seld import SegmentScorer
from ..models.wrapper import SELDModel
from ..ops.decode import PostProcessor
from ..ops.features import FeatureFrontend, Scaler, identity_scaler
from ..utils.profiling import COUNTERS, span

__all__ = ["make_frontend", "build_eval_forward", "test_epoch",
           "cached_eval_outputs", "decode_cached_to_csv", "test_model", "infer",
           "load_best_model", "delete_and_create_folder"]


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
        scaler = identity_scaler(cfg.data.mel_bins,
                                 n_aux_ch=cfg.data.nb_feature_channels - 4)
    return FeatureFrontend(cfg.data, scaler, device)


def build_eval_forward(model: SELDModel, frontend: FeatureFrontend) -> Callable:
    """``eval_forward(audio, valid_feat_frames) -> logits`` (B, T/4, D) on
    the frontend's device, under ``torch.inference_mode``, with the model
    in eval mode (BatchNorm on its running stats, no dropout): each call
    sets it, since a trainer switches the same module to training mode
    for its steps.

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
        model.eval()
        with span("eval.h2d"):
            audio = torch.as_tensor(audio, device=device)
            if valid_feat_frames is not None:
                valid_feat_frames = torch.as_tensor(valid_feat_frames, device=device)
        with span("eval.forward"):
            feat = frontend(audio, valid_feat_frames)
            return model(feat, valid_feat_frames)

    return fwd


def test_epoch(loader: EvalLoader, eval_fwd: Callable,
               postprocessor: PostProcessor, output_pth: str,
               eval_crit: Optional[Callable] = None
               ) -> Tuple[float, List[Tuple[str, float]]]:
    """Forward + decode + CSV per clip.  Returns ``(loss, times)``: the mean
    of the clips' :func:`~adyolo_tpu_torch.parallel.train_step.build_eval_criterion`
    losses (0 without ``eval_crit``), and ``[(clip, seconds)]``, each clip's
    host wall time from its audio leaving the loader to its CSV on disk
    (the decode copies to the host, which waits for the device)."""
    delete_and_create_folder(output_pth)
    times = []
    total_loss, n = 0.0, 0
    for item in loader:
        t0 = time.perf_counter()
        out = eval_fwd(item["audio"], item["valid_feat_frames"])
        t_valid = item["nb_label_frames"]
        if eval_crit is not None:
            total_loss += float(eval_crit(out, item["targets"],
                                          item.get("target_mask"), [t_valid]))
            n += 1
        dets = postprocessor.postprocess(out, valid_label_frames=t_valid)
        write_seld_output_csv(os.path.join(output_pth, item["name"] + ".csv"), dets)
        times.append((item["name"], time.perf_counter() - t0))
    return total_loss / max(n, 1), times


def cached_eval_outputs(loader: EvalLoader, eval_fwd: Callable,
                        postprocessor: PostProcessor, min_conf: float):
    """Forward every clip once; returns ``[(name, cache, nb_label_frames)]``
    for :func:`decode_cached_to_csv` at any threshold from ``min_conf`` up
    (only the host decode depends on τ)."""
    return [(item["name"],
             postprocessor.candidates(eval_fwd(item["audio"], item["valid_feat_frames"]),
                                      min_conf),
             item["nb_label_frames"]) for item in loader]


def decode_cached_to_csv(cached_items, postprocessor: PostProcessor,
                         output_pth: str) -> None:
    """Host decode + CSV of :func:`cached_eval_outputs` at the
    postprocessor's current thresholds (the CSVs of :func:`test_epoch`)."""
    delete_and_create_folder(output_pth)
    for name, cache, t_valid in cached_items:
        dets = postprocessor.postprocess_cached(cache, valid_label_frames=t_valid)
        write_seld_output_csv(os.path.join(output_pth, name + ".csv"), dets)


def _print_scores(tag: str, scores) -> None:
    ER, F, LE, LR, SELD = scores[:5]
    print(f"    {tag}ER: {ER:0.4f}, F: {F * 100:0.2f}, LE: {LE:0.2f}, "
          f"LR: {LR * 100:0.2f}, SELD: {SELD:0.4f}")


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
                      postprocessor, output_pth)[1]


def load_best_model(cfg: Config, exp_dir: str, device="cuda"
                    ) -> Tuple[SELDModel, Dict]:
    """The experiment's ``model_best.ckpt`` (the JAX package's file format,
    written by either trainer) as an eval-mode model on ``device``, and the
    checkpoint's host state."""
    from ..convert import state_dict_from_flax
    from ..models.wrapper import build_model
    from .checkpoint import load_jax_checkpoint

    variables, host = load_jax_checkpoint(os.path.join(exp_dir, "model_best.ckpt"))
    model = build_model(cfg, device="cpu")
    model.load_state_dict(state_dict_from_flax(variables, cfg.args.encoder,
                                               cfg.args.loss),
                          strict=True)
    return model.to(device), host


def test_model(cfg_args: Dict, results_dir: str = "results",
               device="cuda") -> Dict:
    """Full evaluation of a saved experiment (reference ``test.py:63-151``).

    ``cfg_args``: ``{"action": "val" | "test" | "infer", "eval_pth":
    <exp_id>, "infer_pth": <wav dir, infer only>}``.  Returns the scores of
    the last unify threshold (``ER``, ``F``, ``LE``, ``LR``, ``SELD``,
    ``loss``, ``unify``; for ``infer`` the per-clip ``times``)."""
    action = cfg_args["action"]
    if action not in ("val", "test", "infer"):
        raise ValueError(f"unknown action: {action}")
    exp_id = cfg_args.get("eval_pth")
    if exp_id is None:
        raise SystemExit("error: --eval_pth <exp_id> is required for val/test/infer "
                         "(the experiment directory under results/)")
    output_pth = os.path.join(results_dir, exp_id)
    cfg = load_config(os.path.join(output_pth, "hyp_exp.yaml"))
    model, host = load_best_model(cfg, output_pth, device)
    frontend = make_frontend(cfg, device)
    postprocessor = PostProcessor(cfg)
    postprocessor.set_conf_thresh(host["confidence_thresh"])

    if action == "infer":
        infer_pth = cfg_args.get("infer_pth")
        if not infer_pth:
            raise SystemExit("error: --infer_pth <wav_dir> is required for infer")
        print(f"\n===== INFERENCE ON WAVS UNDER: {infer_pth} =====")
        t0 = time.time()
        before = dict(COUNTERS)
        times = infer(cfg, model, frontend, postprocessor, infer_pth,
                      os.path.join(output_pth, "output_infer"))
        p50 = np.median([s for _, s in times]) if times else 0.0
        print(f"total inference time: {(time.time() - t0) / 60:0.2f} min "
              f"({len(times)} clips, p50 {p50:0.3f} s/clip)")
        frames, rows = (COUNTERS.get(k, 0) - before.get(k, 0)
                        for k in ("decode.label_frames", "decode.candidates"))
        if frames:  # AD-YOLO: the host NMS's work, which τ sets
            print(f"decode: {rows / frames:0.4f} candidates over tau a label frame "
                  f"({rows} over {frames} label frames)")
        print("\nTEST DONE.")
        return {"times": times}

    from ..parallel.train_step import build_eval_criterion

    loader = EvalLoader(SELDDataset(cfg, action, is_valid=True), cfg)
    eval_fwd = build_eval_forward(model, frontend)
    eval_crit = build_eval_criterion(cfg)
    ref_dir = os.path.join(cfg.data.data_pth, "metadata_dev", f"dev-{action}")
    frames_1s = int(cfg.data.sr / cfg.data.label_hop_len)
    out_dir = os.path.join(output_pth, "output_eval")
    names = []
    if os.path.isfile(cfg.data.name_pth):
        with open(cfg.data.name_pth) as f:
            names = [ln.strip() for ln in f if ln.strip()]

    results: Dict = {}
    # the unify threshold matters to the formats that merge tracks or
    # anchors (adyolo_tpu/engine/evaluate.py:177-183)
    sweep = (15.0, 30.0, 45.0) if cfg.args.loss in ("adpit", "adyolo") else (None,)
    for unify in sweep:
        if unify is not None:
            postprocessor.unify_thresh = unify
            print(f"\n===== EVALUATING '{exp_id}' ON {cfg.args.dataset} "
                  f"{action}, unify threshold {unify} deg =====")
        else:
            print(f"\n===== EVALUATING '{exp_id}' ON {cfg.args.dataset} {action} =====")
        t0 = time.time()
        loss, _ = test_epoch(loader, eval_fwd, postprocessor, out_dir,
                             eval_crit=eval_crit)
        print(f"eval time: {(time.time() - t0) / 60:0.2f} min, loss: {loss:0.4f}")

        scorer = SegmentScorer(ref_dir, nb_classes=cfg.data.nb_classes,
                               nb_label_frames_1s=frames_1s)
        ER, F, LE, LR, SELD, classwise = scorer.get_SELD_Results(out_dir)
        _print_scores("", (ER, F, LE, LR, SELD))
        results = {"ER": ER, "F": F, "LE": LE, "LR": LR, "SELD": SELD,
                   "loss": loss, "unify": unify}

        print("\nClasswise results")
        print("Class\tER\tF\tLE\tLR\tSELD")
        for c in range(cfg.data.nb_classes):
            nm = names[c] if c < len(names) else ""
            print(f"{c}\t{classwise[0][c]:0.4f}\t{classwise[1][c] * 100:0.2f}\t"
                  f"{classwise[2][c]:0.2f}\t{classwise[3][c] * 100:0.2f}\t"
                  f"{classwise[4][c]:0.4f}\t{nm}")

        for title, overlap in (("class-independent", "any"),
                               ("class-homogenous", "classwise")):
            print(f"\nevaluation on {title} polyphony:")
            ov = SegmentScorer(ref_dir, nb_classes=cfg.data.nb_classes,
                               nb_label_frames_1s=frames_1s, overlap=overlap)
            _print_scores("", ov.get_SELD_Results(out_dir))
    print("\nTEST DONE.")
    return results
