"""Training engine (counterpart of :mod:`adyolo_tpu.engine.train`,
reference ``src/train.py:65-290``): one process on one device, or one
process per card under ``torchrun`` (data parallelism).

The experiment protocol of the reference:

* a fresh run freezes the merged config to ``<results>/<exp_id>/hyp_exp.yaml``
  (``train.py:112-115``); ``--resume_pth`` reads it back (``train.py:81-82``)
  and restores ``model_ckpt.ckpt``;
* per epoch: train over the epoch's sampled file list, then draw the next
  epoch's list from the pool (``train.py:175``);
* every 10th epoch, unless ``--fix_thresh``, the confidence threshold is
  re-arbitrated: one forward over val, then the val SELD of each τ in
  {0.1, ..., 0.9} from host decodes of the cached candidates; the best τ
  is frozen into the config (``train.py:178-206``);
* val and test every epoch; the best model by val SELD (``<=``) goes to
  ``model_best.ckpt`` in the JAX package's file format; the resumable
  state to ``model_ckpt.ckpt`` (``train.py:222-248``); a console report
  and the logger (``logs/<split>/<metric>`` channels; ``logs.jsonl`` with
  ``--logger`` unless a neptune project is configured);
* after the last epoch, ``test_model`` on the best checkpoint
  (``train.py:282-287``).

``--quick_test`` caps the run at 3 epochs x 5 batches.  A SIGTERM or SIGINT
finishes the batch in flight, checkpoints the epoch and returns, so
``--resume_pth`` loses at most that epoch.

Under ``torchrun --nproc_per_node N`` (:mod:`adyolo_tpu_torch.parallel.mesh`)
every rank trains on its shard of each global batch
(:class:`~adyolo_tpu_torch.data.dataset.TrainLoader`, the data-parallel
:func:`~adyolo_tpu_torch.parallel.train_step.build_train_step`).  Rank 0
alone opens the experiment (its id is the run's), logs, writes
``hyp_exp.yaml`` and both checkpoints, runs the threshold scan, val and
test, and the final test; the other ranks wait for it and receive the
config and ``best_log``, so an error on rank 0 stops every rank.  A stop
request on any rank stops all of them at the same batch.  A resume loads
rank 0's checkpoint on every rank (the host RNG streams and the sampler
advance alike on all ranks) and, at the same world size, continues the
uninterrupted run.

With ``--model_parallel N`` (either encoder, any N that divides the
ranks) the ranks form a (dp, tp) grid: each model group of N ranks trains
one data replica's shard of the batch on the model laid out over the
group (:func:`~adyolo_tpu_torch.parallel.mesh.tp_plan`: the conformer's
modules that N cuts cleanly are sharded, everything else, SE-ResNet34
whole, is held whole on every rank).  At each epoch's end every rank
takes part in gathering the parameters, BatchNorm stats and Adam moments
into the full state (an entry held whole is rank 0's as it is), which
rank 0 loads into an unsharded copy of the model: it evaluates that copy
(the same function as the sharded model) and checkpoints the full state,
so both files are in JAX's format and order, readable by a
single-process run and by JAX's ``load_checkpoint``.  A resume loads the
full checkpoint on every rank and shards it; ``--model_parallel`` on a
resume overrides the frozen config's.

Both encoders train, with any of the five losses, on FOA or MIC input, in
float32 or (``--compute_dtype bfloat16``) in the JAX package's bf16 (the
master weights, the optimizer, the checkpoints and every eval in
float32), the conformer optionally with ``--remat``.  The step's losses
stay on the device and are read once per epoch, so the loader's prefetch
thread and the device overlap.  Unlike the JAX engine, the checkpoint
also stores the next epoch's file list, so a resumed run trains on the
same files as an uninterrupted one.
"""
from __future__ import annotations

import dataclasses
import os
import re
import signal
import time
from datetime import datetime
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..config import (Config, build_config, flatten_config, load_config,
                      save_config, with_conf_thresh)
from ..convert import flax_from_state_dict
from ..data.dataset import EvalLoader, SELDDataset, TrainLoader
from ..metrics.seld import SegmentScorer
from ..models.wrapper import DTYPES, build_model
from ..ops.decode import PostProcessor
from ..parallel import mesh
from ..parallel.train_step import build_eval_criterion, build_train_step
from ..utils.logging import (JsonlLogger, NullLogger, get_logging_meta_config,
                             make_logger)
from ..utils.rng import get_rng_state, seed_init, set_rng_state
from .checkpoint import (load_train_checkpoint, optax_state, save_jax_checkpoint,
                         save_train_checkpoint)
from .evaluate import (build_eval_forward, cached_eval_outputs,
                       decode_cached_to_csv, make_frontend, test_epoch,
                       test_model)

__all__ = ["train_model", "train_one_epoch", "scan_conf_thresh",
           "check_trainable", "TAU_SCAN"]

TAU_SCAN = tuple(float(t) for t in np.arange(0.1, 1.0, 0.1))  # train.py:178-206
SCAN_EVERY = 10  # epochs between threshold arbitrations
QUICK_TEST = (3, 5)  # epochs, batches per epoch


class _PreemptionGuard:
    """SIGTERM / SIGINT set a flag that the epoch loop reads at batch
    boundaries (:meth:`should_stop`).  Handlers can only be installed from
    the main thread; elsewhere (a test's worker thread) the guard installs
    none."""

    def __init__(self):
        self.stop = False
        self._orig = {}

    def should_stop(self) -> bool:
        """The stop decision, agreed by every rank: a signal that reached
        one rank stops all of them at this batch boundary (a rank that
        went on alone would wait forever in the next step's
        collectives)."""
        self.stop = mesh.any_rank(self.stop)
        return self.stop

    def __enter__(self):
        def handler(signum, frame):
            print(f"\n[adyolo_tpu_torch] received signal {signum}; will "
                  "checkpoint and exit after the current batch...", flush=True)
            self.stop = True

        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                self._orig[sig] = signal.signal(sig, handler)
            except ValueError:  # not the main thread
                pass
        return self

    def __exit__(self, *exc):
        for sig, orig in self._orig.items():
            signal.signal(sig, orig)
        return False


def check_trainable(cfg: Config) -> None:
    """Raise ``ValueError`` for an unknown compute dtype, a model-parallel
    size below 1 or that the ranks do not divide, or a batch size that the
    data replicas do not divide, before a fresh run creates its
    directory."""
    if cfg.train.compute_dtype not in DTYPES:
        raise ValueError(f"compute_dtype {cfg.train.compute_dtype!r}: one of "
                         f"{sorted(DTYPES)}")
    n = cfg.mesh.model_parallel
    mesh.check_model_parallel(n)
    mesh.check_batch(cfg.train.batch_size, mesh.world_size() // n)


def train_one_epoch(loader: TrainLoader, train_step, generator: torch.Generator,
                    max_batches: Optional[int] = None,
                    guard: Optional[_PreemptionGuard] = None
                    ) -> Tuple[float, Dict]:
    """The hot loop (``train.py:40-62``).  Returns the epoch's mean loss and
    ``{"steps", "loader_wait_s"}``: the host seconds spent waiting for the
    loader's next batch.  The losses are read from the device once, at
    the end; leaving early closes the loader, which reaps its threads."""
    losses = []
    wait = 0.0
    it = iter(loader)
    try:
        while max_batches is None or len(losses) < max_batches:
            t0 = time.perf_counter()
            batch = next(it, None)
            wait += time.perf_counter() - t0
            if batch is None:
                break
            losses.append(train_step(batch, generator))
            if guard is not None and guard.should_stop():
                break
    finally:
        it.close()
    loss = float(torch.stack(losses).mean()) if losses else 0.0
    return loss, {"steps": len(losses), "loader_wait_s": wait}


def scan_conf_thresh(loader: EvalLoader, eval_fwd, postprocessor: PostProcessor,
                     scorer: SegmentScorer, output_pth: str) -> Tuple[float, Dict]:
    """The τ-arbitration: one forward over ``loader`` (the val split), then
    for each τ of :data:`TAU_SCAN` a host decode of the cached candidates
    into ``output_pth`` and its SELD score.  Returns the τ of the lowest
    SELD (the first on ties) and ``{"scores": [(τ, scores)], "forward_s",
    "decode_score_s"}``.  The postprocessor is left at the returned τ."""
    t0 = time.perf_counter()
    cached = cached_eval_outputs(loader, eval_fwd, postprocessor, min(TAU_SCAN))
    forward_s = time.perf_counter() - t0
    best_seld, best = 9999.0, postprocessor.get_conf_thresh()
    rows, rounds = [], []
    for tau in TAU_SCAN:
        t0 = time.perf_counter()
        postprocessor.set_conf_thresh(tau)
        decode_cached_to_csv(cached, postprocessor, output_pth)
        scores = scorer.get_SELD_Results(output_pth)
        rounds.append(time.perf_counter() - t0)
        rows.append((tau, scores[:5]))
        print(f"\tconf_thresh {tau:0.1f} - ER {scores[0]:0.4f}, "
              f"F {scores[1] * 100:0.2f}, LE {scores[2]:0.2f}, "
              f"LR {scores[3] * 100:0.2f}, SELD {scores[4]:0.4f}")
        if scores[4] < best_seld:
            best_seld, best = scores[4], tau
    postprocessor.set_conf_thresh(best)
    return best, {"scores": rows, "forward_s": forward_s, "decode_score_s": rounds}


def _local_exp_id() -> str:
    """``local-<timestamp>`` (reference ``train.py:108``)."""
    return "local-" + datetime.now().strftime("%Y%m%d-%H%M%S")


def _open_experiment(args: Dict, is_resume: bool):
    """The config, experiment dir and neptune logger (or None) of a fresh
    or resumed run.  A fresh run checks that the port can train the
    config before it creates the directory."""
    results_dir = args.get("results_dir", "results")
    if is_resume:
        if not args.get("resume_pth"):
            raise ValueError("--resume_pth <exp_id> required")
        output_pth = os.path.join(results_dir, args["resume_pth"])
        if not os.path.isdir(output_pth):
            raise FileNotFoundError(f"no experiment directory {output_pth}")
        cfg = load_config(os.path.join(output_pth, "hyp_exp.yaml"))
        if cfg.args.exp_id != args["resume_pth"]:
            raise ValueError(f"{output_pth} holds experiment {cfg.args.exp_id!r}")
        if args.get("model_parallel") is not None:
            cfg = dataclasses.replace(cfg, mesh=dataclasses.replace(
                cfg.mesh, model_parallel=int(args["model_parallel"])))
        check_trainable(cfg)
        # reattach the neptune run frozen at create time; the credential is
        # never frozen, so it is read again (reference train.py:86-91)
        meta = dict(cfg.args.logging_meta or {})
        if cfg.args.logger and meta.get("neptune_project") \
                and not meta.get("neptune_api_token"):
            meta["neptune_api_token"] = get_logging_meta_config(
                cfg.args.config_dir).get("neptune_api_token")
        resume_id = meta.get("neptune_run_id")
        if not resume_id and re.fullmatch(r"[A-Z][A-Z0-9]*-\d+", args["resume_pth"]):
            resume_id = args["resume_pth"]
        return cfg, output_pth, make_logger(cfg.args.logger, meta, resume_id=resume_id)

    cfg = build_config(args)
    check_trainable(cfg)
    meta = get_logging_meta_config(cfg.args.config_dir)
    # freeze the meta for resume, never the api token (hyp_exp.yaml and
    # the logged parameters are plaintext)
    frozen_meta = {**meta, "neptune_api_token": None}
    neptune_logger = make_logger(cfg.args.logger, meta)
    sys_id = neptune_logger.sys_id if neptune_logger is not None else None
    if sys_id:
        frozen_meta["neptune_run_id"] = sys_id
    exp_id = args.get("exp_id") or sys_id or _local_exp_id()
    cfg = dataclasses.replace(cfg, args=dataclasses.replace(
        cfg.args, logging_meta=frozen_meta, exp_id=exp_id))
    output_pth = os.path.join(results_dir, exp_id)
    os.makedirs(output_pth, exist_ok=True)
    save_config(cfg, os.path.join(output_pth, "hyp_exp.yaml"))
    return cfg, output_pth, neptune_logger


def train_model(args: Dict, is_resume: bool = False, device="cuda") -> Config:
    """``args``: the CLI's dict (:mod:`adyolo_tpu_torch.cli`); a fresh run
    takes its presets from ``args["config_dir"]`` (default ``./configs``).
    Returns the final config.  Under torchrun the process joins the
    data-parallel group on its own card (``cuda:LOCAL_RANK``) and leaves
    it at the end; a group that the caller initialised is used as it is,
    on ``device``."""
    device = mesh.init_distributed(device)
    try:
        return _train(args, is_resume, device)
    finally:
        mesh.shutdown()


def _train(args: Dict, is_resume: bool, device) -> Config:
    results_dir = args.get("results_dir", "results")
    main = mesh.is_main()
    opened = {}

    def open_experiment():
        cfg, output_pth, opened["neptune"] = _open_experiment(args, is_resume)
        return cfg, output_pth

    # rank 0 opens the experiment; every rank takes its config and id, and
    # joins its groups of the (dp, tp) grid
    cfg, output_pth = mesh.on_main(open_experiment)
    mesh.set_model_parallel(cfg.mesh.model_parallel)
    tp = mesh.tp_size()
    if opened.get("neptune") is not None:
        logger = opened["neptune"]
    elif cfg.args.logger and main:
        logger = JsonlLogger(os.path.join(output_pth, "logs.jsonl"))
    else:
        logger = NullLogger()
    logger.log_params(flatten_config(cfg))
    if is_resume:
        generator = torch.Generator(device=device)  # state restored below
    else:
        logger.log("logs/train/conf_thresh", float(cfg.train.conf_thresh))
        generator = seed_init(cfg.args.seed, device)

    # ---- data / model / step (the train set draws epoch 1 from the seed) --
    train_ds = SELDDataset(cfg, "train")
    train_loader = TrainLoader(train_ds, cfg, mesh.dp_rank(), mesh.dp_size())
    frontend = make_frontend(cfg, device)
    model = build_model(cfg, device=device,
                        generator=torch.Generator().manual_seed(cfg.args.seed),
                        train=True)
    train_step = build_train_step(cfg, model, frontend)  # shards the model under TP
    optimizer, plan = train_step.optimizer, train_step.plan
    if main:  # evaluation runs on rank 0 only, on an unsharded model
        valid_loader = EvalLoader(SELDDataset(cfg, "val", is_valid=True), cfg)
        test_loader = EvalLoader(SELDDataset(cfg, "test", is_valid=True), cfg)
        eval_model = model if tp == 1 else build_model(cfg, device=device)
        eval_fwd = build_eval_forward(eval_model, frontend)
        eval_crit = build_eval_criterion(cfg)
        postprocessor = PostProcessor(cfg)
        frames_1s = int(cfg.data.sr / cfg.data.label_hop_len)
        scorers = {split: SegmentScorer(
            os.path.join(cfg.data.data_pth, "metadata_dev", f"dev-{split}"),
            nb_classes=cfg.data.nb_classes, nb_label_frames_1s=frames_1s)
            for split in ("val", "test")}

    # ---- resume (train.py:145-159): every rank loads rank 0's checkpoint --
    if is_resume:
        host = load_train_checkpoint(os.path.join(output_pth, "model_ckpt.ckpt"),
                                     model, optimizer, plan, mesh.tp_rank())
        train_ds.sampler.set_remaining(host["train_remaining_file"])
        train_ds.filelist = list(host["train_file_list"])
        # the reference resumes at the BEST threshold (train.py:151)
        best_log = host["best_log"]
        if main:
            postprocessor.set_conf_thresh(best_log["best_conf_thresh"])
        cfg = with_conf_thresh(cfg, best_log["best_conf_thresh"])
        start_epoch = host["start_epoch_nb"]
        set_rng_state(host["rng_state"], generator)
    else:
        start_epoch = 1
        best_log = {"best_epoch": -1, "best_val_SELD": 9999.0,
                    "best_conf_thresh": float(cfg.train.conf_thresh)}
    last_epoch = QUICK_TEST[0] if cfg.args.quick_test else cfg.train.nb_epochs

    def host_state(next_epoch):
        return {"start_epoch_nb": next_epoch,
                "confidence_thresh": float(postprocessor.get_conf_thresh()),
                "rng_state": get_rng_state(generator), "best_log": best_log,
                "train_remaining_file": list(train_ds.sampler.get_remaining()),
                "train_file_list": list(train_ds.get_filelist())}

    ckpt = os.path.join(output_pth, "model_ckpt.ckpt")
    out = {split: os.path.join(output_pth, f"output_{split}") for split in ("val", "test")}
    names = [n for n, _ in model.named_parameters()]
    full = {}

    def gather_full_state():
        """Rank 0's full optimizer state (and, under TP, its eval model's
        weights) for checkpoints; under TP a collective of every rank,
        which gathers the shards."""
        if tp == 1:
            full["optimizer"] = optimizer.state_dict() if main else None
            return
        state = mesh.gather_state_dict(model.state_dict(), plan)
        full["optimizer"] = mesh.gather_optimizer_state(optimizer.state_dict(), names, plan)
        if main:
            eval_model.load_state_dict(state)

    def save_ckpt(next_epoch):
        save_train_checkpoint(ckpt, eval_model.state_dict(), full["optimizer"],
                              host_state(next_epoch))

    def preempted(epoch):
        save_ckpt(epoch)
        print(f"[adyolo_tpu_torch] preempted during epoch {epoch}; checkpoint "
              f"saved; resume with --resume_pth {cfg.args.exp_id}")

    def end_of_epoch(epoch, train_loss, train_s, info):
        """Rank 0's threshold scan, val, test, checkpoints, report and logs;
        returns the config and ``best_log`` for every rank."""
        nonlocal cfg, best_log
        if not cfg.args.fix_thresh and epoch % SCAN_EVERY == 0:
            print("resetting confidence threshold per each 10th epoch:")
            tau, scan = scan_conf_thresh(valid_loader, eval_fwd, postprocessor,
                                         scorers["val"], out["val"])
            print(f"confidence threshold -> {tau} (forward {scan['forward_s']:0.2f} s, "
                  f"{len(TAU_SCAN)} decode + score rounds "
                  f"{sum(scan['decode_score_s']):0.2f} s)")
            cfg = with_conf_thresh(cfg, tau)
            save_config(cfg, os.path.join(output_pth, "hyp_exp.yaml"))
            logger.log("logs/train/conf_thresh", tau, epoch)
            logger.log("logs/train/conf_scan_forward_s", scan["forward_s"], epoch)
            logger.log("logs/train/conf_scan_decode_score_s",
                       sum(scan["decode_score_s"]), epoch)

        # val / test (train.py:209-219)
        split_loss, split_s, scores = {}, {}, {}
        for split, loader in (("val", valid_loader), ("test", test_loader)):
            t0 = time.perf_counter()
            split_loss[split], _ = test_epoch(loader, eval_fwd, postprocessor,
                                              out[split], eval_crit=eval_crit)
            split_s[split] = time.perf_counter() - t0
        for split in ("val", "test"):
            scores[split] = scorers[split].get_SELD_Results(out[split])
        val_s, test_s = scores["val"], scores["test"]

        # the best model (train.py:222-238)
        t0 = time.perf_counter()
        if val_s[4] <= best_log["best_val_SELD"]:
            best_log = {"best_epoch": epoch, "best_val_loss": split_loss["val"],
                        **{f"best_val_{k}": v for k, v in zip(
                            ("ER", "F", "LE", "LR", "SELD"), val_s[:5])},
                        "best_test_loss": split_loss["test"],
                        **{f"best_test_{k}": v for k, v in zip(
                            ("ER", "F", "LE", "LR", "SELD"), test_s[:5])},
                        "best_conf_thresh": float(postprocessor.get_conf_thresh())}
            save_jax_checkpoint(os.path.join(output_pth, "model_best.ckpt"),
                                flax_from_state_dict(eval_model.state_dict()),
                                {"epoch_nb": epoch,
                                 "confidence_thresh": best_log["best_conf_thresh"]},
                                *optax_state(cfg.train.optim, cfg.train.weight_decay,
                                             full["optimizer"],
                                             dict(eval_model.named_parameters())))
        # the rolling checkpoint (train.py:241-248)
        save_ckpt(epoch + 1)
        ckpt_s = time.perf_counter() - t0

        # console report (train.py:251-261)
        print(f"{epoch:03d} epoch result... (conf_thresh: "
              f"{postprocessor.get_conf_thresh():0.2f})")
        print(f"train/valid/test time: {train_s / 60:0.2f}/{split_s['val'] / 60:0.2f}/"
              f"{split_s['test'] / 60:0.2f} min, loss: {train_loss:0.4f}/"
              f"{split_loss['val']:0.4f}/{split_loss['test']:0.4f}, "
              f"loader wait {info['loader_wait_s']:0.2f} s over {info['steps']} steps, "
              f"checkpoints {ckpt_s:0.2f} s")
        for tag, sc in (("valid", val_s), (" test", test_s)):
            print(f"{tag} score: ER: {sc[0]:0.4f}, F: {sc[1] * 100:0.2f}, "
                  f"LE: {sc[2]:0.2f}, LR: {sc[3] * 100:0.2f}, SELD: {sc[4]:0.4f}")
        print(f"\tbest epoch: {best_log['best_epoch']:03d} "
              f"(conf_thresh {best_log['best_conf_thresh']:0.2f}, "
              f"val SELD {best_log['best_val_SELD']:0.4f})", flush=True)

        for split, loss_v, sc in (("train", train_loss, None),
                                  ("val", split_loss["val"], val_s),
                                  ("test", split_loss["test"], test_s)):
            logger.log(f"logs/{split}/loss", loss_v, epoch)
            if sc is not None:
                for nm, v in zip(("ER", "F1", "LE", "LR", "SELD"),
                                 (sc[0], sc[1] * 100, sc[2], sc[3] * 100, sc[4])):
                    logger.log(f"logs/{split}/{nm}", float(v), epoch)
        for split, sec in (("train", train_s), ("val", split_s["val"]),
                           ("test", split_s["test"])):
            logger.log(f"logs/{split}/time_s", sec, epoch)
        logger.log("logs/train/loader_wait_s", info["loader_wait_s"], epoch)
        logger.log("logs/train/steps", info["steps"], epoch)
        logger.log("logs/train/checkpoint_s", ckpt_s, epoch)
        return cfg, best_log

    def final_test():
        print("\n===== TRAINING ENDED; FINAL TEST WITH BEST CHECKPOINT =====\n")
        test_model({"action": "test", "eval_pth": cfg.args.exp_id},
                   results_dir=results_dir, device=device)

    with _PreemptionGuard() as guard:
        for epoch in range(start_epoch, last_epoch + 1):
            if main:
                print(f"\nnow training {epoch:03d}/{last_epoch:03d} epoch...", flush=True)
            t0 = time.perf_counter()
            train_loss, info = train_one_epoch(
                train_loader, train_step, generator,
                QUICK_TEST[1] if cfg.args.quick_test else None, guard)
            train_s = time.perf_counter() - t0
            gather_full_state()
            if guard.stop:  # preempted (on any rank): keep this epoch resumable
                mesh.on_main(lambda: preempted(epoch))
                logger.stop()
                return cfg
            train_ds.resample_epoch()
            cfg, best_log = mesh.on_main(
                lambda: end_of_epoch(epoch, train_loss, train_s, info))

    mesh.on_main(final_test)
    logger.stop()
    return cfg
