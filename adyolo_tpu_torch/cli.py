"""Command-line entry point of the port (counterpart of
:mod:`adyolo_tpu.cli`, reference ``src/main.py``).

Usage:
    python -m adyolo_tpu_torch.cli train [--encoder resnet-conformer] [--augment] [--logger]
                                         [--compute_dtype bfloat16] [--remat] ...
    python -m adyolo_tpu_torch.cli train --resume_pth <exp_id>
    torchrun --nproc_per_node <N> -m adyolo_tpu_torch.cli train ...
    torchrun --nproc_per_node <N> -m adyolo_tpu_torch.cli train --model_parallel <M> ...
    python -m adyolo_tpu_torch.cli val   --eval_pth <exp_id>
    python -m adyolo_tpu_torch.cli test  --eval_pth <exp_id>
    python -m adyolo_tpu_torch.cli infer --eval_pth <exp_id> --infer_pth <wav_dir>
    python -m adyolo_tpu_torch.cli export --eval_pth <exp_id> [--serve_dtype bfloat16]
    python -m adyolo_tpu_torch.cli preprocess {chunking,scaler} --dataset <DS | all>
                                              [--config_dir <dir>] [--device cpu]

Every action takes ``--results_dir`` (default ``results``) and ``--device``
(default ``cuda``; ``cpu`` runs the kernels' plain versions).  ``train``
writes ``<results_dir>/<exp_id>/`` (``hyp_exp.yaml``, ``model_best.ckpt`` in
the JAX package's format, the resumable ``model_ckpt.ckpt``, the per-clip
CSVs and, with ``--logger``, ``logs.jsonl``); ``val`` / ``test`` / ``infer``
read an experiment dir written by either package's trainer, for either
encoder; ``export`` writes ``<results_dir>/<exp_id>/export/`` (``model.pt2``,
``meta.json``, ``hyp_exp.yaml``; :mod:`adyolo_tpu_torch.engine.export`), the
program of one clip of the config's ``chunk_window_s`` (20 s), traced on
``--device`` with the encoder in ``--serve_dtype`` (``float32`` or
``bfloat16``; without the flag, ``ADYOLO_SERVE_DTYPE`` or ``float32``).  Both encoders train with any ``--loss`` (``seddoa``,
``masked-seddoa``, ``accdoa``, ``adpit``, ``adyolo``) on FOA or MIC input
(``audio_format: mic`` in the dataset preset: GCC-PHAT features), in
float32 or (``--compute_dtype bfloat16``) bf16; ``--remat`` checkpoints
the conformer's blocks.  Val, test and infer run in float32.

``train`` under ``torchrun`` is data-parallel, one process per card (rank
r on ``cuda:LOCAL_RANK``): each rank trains on ``batch_size / N`` clips of
every global batch, and a step computes the single-process step on the
global batch (BatchNorm's moments and AD-YOLO's denominators are the
global batch's); rank 0 alone logs, checkpoints and evaluates
(:mod:`adyolo_tpu_torch.engine.train`).  Under plain ``python -m`` it
runs in one process.  ``--model_parallel M`` adds tensor parallelism:
each group of M consecutive ranks trains one data replica's clips, so
N / M replicas take ``batch_size / (N / M)`` clips each; the step is
still the single-process step on the global batch.  The group shards the
ResNet-Conformer's blocks where M cuts them cleanly (the FFNs where M
divides their hidden width, the conv module where M divides ``emb_dim``,
the MHSA where M divides its 4 heads) and holds every other module, and
all of SE-ResNet34, whole on each of its ranks, as JAX replicates what M
does not divide.  Rank 0 evaluates and checkpoints the gathered,
unsharded model.  M must divide N.  ``val``, ``test``, ``infer`` and
``export`` run one process on one device and take ``--model_parallel``
without using it, as the JAX package's eval does.

``preprocess chunking`` cuts the dataset's ``dev-train`` wavs and labels
into the 20-s training chunks; ``preprocess scaler`` writes
``<data_pth>/scaler_wts.pkl`` from the front-end's features of every
``dev-train`` clip, on ``--device``.  Both read the same presets as
``train`` (``--config_dir``).

``--serve_dtype`` on any action but ``export`` is refused with a message,
not ignored.
"""
from __future__ import annotations

import argparse
import sys

_ACTIONS = ("train", "val", "test", "infer", "export")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="adyolo_tpu_torch")
    sub = p.add_subparsers(dest="action", required=True)
    for action in _ACTIONS:
        sp = sub.add_parser(action)
        sp.add_argument("--dataset", type=str, default="DCASE2022",
                        choices=["DCASE2020", "DCASE2021", "DCASE2022"])
        sp.add_argument("--encoder", type=str, default="se-resnet34",
                        choices=["se-resnet34", "resnet-conformer"])
        sp.add_argument("--loss", type=str, default="adyolo",
                        choices=["seddoa", "masked-seddoa", "accdoa", "adpit", "adyolo"])
        sp.add_argument("--seed", type=int, default=100)
        sp.add_argument("--augment", action="store_true",
                        help="rotation and SpecAugment")
        sp.add_argument("--fix_thresh", action="store_true")
        sp.add_argument("--logger", action="store_true")
        sp.add_argument("--quick_test", action="store_true",
                        help="3 epochs x 5 batches")
        sp.add_argument("--eval_pth", type=str, default=None)
        sp.add_argument("--resume_pth", type=str, default=None)
        sp.add_argument("--infer_pth", type=str, default=None)
        sp.add_argument("--results_dir", type=str, default="results")
        sp.add_argument("--config_dir", type=str, default=None,
                        help="directory of editable hyp_*.yaml presets "
                             "(default: ./configs when present)")
        sp.add_argument("--exp_id", type=str, default=None,
                        help="experiment id (default: local-<timestamp>)")
        sp.add_argument("--debug_nans", action="store_true",
                        help="torch.autograd.set_detect_anomaly (the reference's "
                             "anomaly detection)")
        # train-config overrides (merged by config_reader semantics)
        sp.add_argument("--batch_size", type=int, default=None)
        sp.add_argument("--nb_epochs", type=int, default=None)
        sp.add_argument("--nb_iters", type=int, default=None)
        sp.add_argument("--lr", type=float, default=None)
        sp.add_argument("--optim", type=str, default=None)
        sp.add_argument("--nms", type=str, default=None)
        sp.add_argument("--compute_dtype", type=str, default=None,
                        choices=["float32", "bfloat16"],
                        help="training compute dtype (eval runs float32)")
        sp.add_argument("--remat", action="store_const", const=True, default=None,
                        help="checkpoint the conformer blocks (recompute them "
                             "in the backward)")
        sp.add_argument("--serve_dtype", type=str, default=None,
                        choices=["float32", "bfloat16"],
                        help="export: the encoder's compute dtype in the "
                             "artifact (default: ADYOLO_SERVE_DTYPE, else float32)")
        sp.add_argument("--model_parallel", type=int, default=None,
                        help="train: ranks in a model group, which shard the "
                             "conformer's modules that it divides and hold the "
                             "rest whole (WORLD_SIZE = data replicas x this)")
        sp.add_argument("--device", type=str, default="cuda")

    pp = sub.add_parser("preprocess")
    pp.add_argument("task", choices=["chunking", "scaler"])
    pp.add_argument("--dataset", type=str, required=True,
                    choices=["DCASE2020", "DCASE2021", "DCASE2022", "all"])
    pp.add_argument("--config_dir", type=str, default=None,
                    help="the preset directory train reads, so preprocessing "
                         "and training share one data config")
    pp.add_argument("--device", type=str, default="cuda",
                    help="the scaler pass's device")
    return p


def _preprocess(args) -> None:
    """``preprocess {chunking, scaler}`` over one dataset or all three
    (``adyolo_tpu/cli.py:97-117``)."""
    from .config import build_config
    from .data.chunking import preprocess_chunking
    from .data.scaler import preprocess_scaler

    datasets = (["DCASE2020", "DCASE2021", "DCASE2022"]
                if args.dataset == "all" else [args.dataset])
    for ds in datasets:
        # the same three-tier merge train uses: an edited hyp_data_*.yaml
        # (mel bins, audio format, paths) feeds both
        dcfg = build_config({"dataset": ds, "config_dir": args.config_dir}).data
        if args.task == "chunking":
            print(f"{ds}: wrote {preprocess_chunking(dcfg)} chunks")
        else:
            print(f"{ds}: wrote {preprocess_scaler(dcfg, device=args.device)}")


def _refuse(args) -> None:
    """Exit with a message for an argument the action does not take."""
    refused = {
        "--serve_dtype": (args.serve_dtype is not None and args.action != "export",
                          "it sets the dtype of the export artifact: only "
                          "'export' takes it"),
    }
    for flag, (given, why) in refused.items():
        if given:
            raise SystemExit(f"error: {flag}: {why}")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    if args.action == "preprocess":
        _preprocess(args)
        return 0
    _refuse(args)
    if args.debug_nans:
        import torch

        torch.autograd.set_detect_anomaly(True)
    if args.action == "export":
        from .engine.export import export_cmd

        export_cmd(vars(args), results_dir=args.results_dir, device=args.device)
        return 0
    arg_dict = {k: v for k, v in vars(args).items() if k not in ("device", "serve_dtype")}
    if args.action == "train":
        from .engine.train import train_model

        train_model(arg_dict, is_resume=args.resume_pth is not None,
                    device=args.device)
    else:
        from .engine.evaluate import test_model

        test_model(arg_dict, results_dir=args.results_dir, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
