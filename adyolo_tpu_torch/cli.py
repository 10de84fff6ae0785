"""Command-line entry point of the port (counterpart of
:mod:`adyolo_tpu.cli`; the ``infer`` action only).

Usage:
    python -m adyolo_tpu_torch.cli infer --eval_pth <exp_id> --infer_pth <wav_dir> \\
        [--results_dir results] [--device cuda]

Reads ``<results_dir>/<exp_id>/hyp_exp.yaml`` and ``model_best.ckpt`` as
the JAX trainer wrote them, for either encoder the config names
(``se-resnet34`` or ``resnet-conformer``, with the ``adyolo`` loss),
restores the arbitrated confidence threshold from the checkpoint, and
writes one CSV per wav to ``<results_dir>/<exp_id>/output_infer/``.  ``train``, ``val``, ``test``,
``export`` and ``preprocess`` are not ported yet.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="adyolo_tpu_torch")
    sub = p.add_subparsers(dest="action", required=True)
    sp = sub.add_parser("infer", help="label-free inference on a wav folder")
    sp.add_argument("--eval_pth", type=str, required=True,
                    help="experiment id (directory under --results_dir)")
    sp.add_argument("--infer_pth", type=str, required=True,
                    help="folder of FOA wav files")
    sp.add_argument("--results_dir", type=str, default="results")
    sp.add_argument("--device", type=str, default="cuda")
    return p


def run_infer(eval_pth: str, infer_pth: str, results_dir: str = "results",
              device: str = "cuda"):
    """Returns the per-clip times of
    :func:`adyolo_tpu_torch.engine.evaluate.infer`."""
    from .config import load_config
    from .convert import state_dict_from_flax
    from .engine.checkpoint import load_jax_checkpoint
    from .engine.evaluate import infer, make_frontend
    from .models.wrapper import build_model
    from .ops.decode import PostProcessor

    exp_dir = os.path.join(results_dir, eval_pth)
    cfg = load_config(os.path.join(exp_dir, "hyp_exp.yaml"))
    variables, host = load_jax_checkpoint(os.path.join(exp_dir, "model_best.ckpt"))
    model = build_model(cfg, device="cpu")
    model.load_state_dict(state_dict_from_flax(variables, cfg.args.encoder),
                          strict=True)
    model = model.to(device)
    frontend = make_frontend(cfg, device)
    postprocessor = PostProcessor(cfg)
    postprocessor.set_conf_thresh(host["confidence_thresh"])

    print(f"\n===== INFERENCE ON WAVS UNDER: {infer_pth} =====")
    t0 = time.time()
    times = infer(cfg, model, frontend, postprocessor, infer_pth,
                  os.path.join(exp_dir, "output_infer"))
    print(f"total inference time: {(time.time() - t0) / 60:0.2f} min "
          f"({len(times)} clips, p50 {np.median([s for _, s in times]) if times else 0:0.3f} s/clip)")
    return times


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    run_infer(args.eval_pth, args.infer_pth, args.results_dir, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
