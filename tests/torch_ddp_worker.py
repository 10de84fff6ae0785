"""Rank processes of ``tests/test_torch_ddp.py``: torch and the port only
(no JAX), on the CPU, joined by a gloo group through a ``file://``
rendezvous::

    python -m tests.torch_ddp_worker <job> <rank> <world> <rendezvous> <out_dir>

``steps``: one data-parallel train step of each case in :data:`CASES` on
this rank's shard of :func:`global_clips`, compared on rank 0 with the
single-process step on the whole batch (:func:`job_steps`), into
``steps.pkl``.

``engine``: ``train_model`` on the synthetic set of ``<out_dir>/configs``
(``--quick_test``; 1 epoch, then a resume for 2 more; a stop request on
rank 1 alone), recording on each rank the files it wrote, the
evaluations and final tests it ran, and its step losses, to
``engine.r<rank>.json``.

The test process builds the same batches and weights for JAX's step.
"""
import contextlib
import dataclasses
import functools
import json
import os
import pickle
import sys

import numpy as np
import torch
import torch.distributed as dist

from adyolo_tpu_torch import cli
from adyolo_tpu_torch.config import Config, load_config, save_config
from adyolo_tpu_torch.data.labels import encode_adyolo, encode_seddoa, pad_yolo_targets
from adyolo_tpu_torch.engine import train as port_train
from adyolo_tpu_torch.engine.evaluate import make_frontend
from adyolo_tpu_torch.models import resnet_conformer as port_rc
from adyolo_tpu_torch.models import wrapper as port_wrapper
from adyolo_tpu_torch.models.layers import BatchNorm, U8Dropout
from adyolo_tpu_torch.models.resnet_conformer import MHSA
from adyolo_tpu_torch.ops import attention as plain_attention
from adyolo_tpu_torch.parallel import mesh
from adyolo_tpu_torch.parallel.train_step import build_train_step

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(_REPO, "data", "DCASE2022_SELD")  # the repository's scaler stats
HOP = 600
GLOBAL_B, FRAMES = 4, 80  # 2-s clips: 80 feature frames, 20 label frames
BLOCKS = 2  # the conformer's blocks (8 at full depth)
SEED = 100
# name: (encoder, loss, train overrides)
CASES = {
    "se-adyolo": ("se-resnet34", "adyolo", {}),
    "conformer-adyolo": ("resnet-conformer", "adyolo", {}),
    "conformer-seddoa": ("resnet-conformer", "seddoa", {}),
    "conformer-adyolo-remat": ("resnet-conformer", "adyolo", {"remat": True}),
    "conformer-adyolo-bf16": ("resnet-conformer", "adyolo", {"compute_dtype": "bfloat16"}),
}
F64 = ("se-adyolo", "conformer-adyolo", "conformer-seddoa")  # also run in float64


def shallow_conformer():
    """The port's conformer at :data:`BLOCKS` blocks; returns the encoder
    it replaces."""
    saved = port_wrapper.ENCODERS["resnet-conformer"]
    port_wrapper.ENCODERS["resnet-conformer"] = functools.partial(
        port_rc.ResNetConformer, num_layers=BLOCKS)
    return saved


def case_config(case: str) -> Config:
    encoder, loss, train = CASES[case]
    cfg = Config()
    return dataclasses.replace(
        cfg, args=dataclasses.replace(cfg.args, encoder=encoder, loss=loss, seed=SEED),
        data=dataclasses.replace(cfg.data, data_pth=DATA,
                                 name_pth=os.path.join(DATA, "classes.txt")),
        train=dataclasses.replace(cfg.train, batch_size=GLOBAL_B, max_targets_per_clip=32,
                                  **train))


def global_clips(cfg: Config, seed: int = 0):
    """The global batch's clips: int16 FOA audio (T, hop, 4) in the
    hop-block layout and a label dict of random events each."""
    rng = np.random.default_rng(seed)
    frames = FRAMES // 4
    clips = []
    for _ in range(GLOBAL_B):
        label = {int(f): [[int(rng.integers(cfg.data.nb_classes)), 0,
                           float(rng.uniform(-180, 180)), float(rng.uniform(-90, 90))]]
                 for f in rng.choice(frames, 6, replace=False)}
        audio = (rng.standard_normal((FRAMES, HOP, 4)) * 1500).astype(np.int16)
        clips.append((audio, label))
    return clips


def make_batch(cfg: Config, clips):
    """The train step's batch of ``clips``, as ``TrainLoader`` assembles it:
    AD-YOLO targets indexed within the batch and padded to
    ``max_targets_per_clip`` x its size, or stacked dense targets."""
    frames = FRAMES // 4
    audio = np.stack([a for a, _ in clips])
    if cfg.args.loss == "adyolo":
        geom = port_wrapper.make_grid_geometry(cfg)
        targets, mask = pad_yolo_targets([encode_adyolo(lab, frames, geom) for _, lab in clips],
                                         cfg.train.max_targets_per_clip * len(clips))
        return {"audio": audio, "targets": targets, "target_mask": mask}
    return {"audio": audio, "targets": np.stack(
        [encode_seddoa(lab, frames, cfg.data.nb_classes) for _, lab in clips]).astype(np.float32)}


def build(cfg: Config, float64: bool = False):
    """The seeded model with dropout off, and its train step, on the CPU;
    with ``float64`` the model's weights and compute dtype are float64
    (its attention the plain version, which the kernels' wrapper is not
    for float64)."""
    model = port_wrapper.build_model(cfg, device="cpu",
                                     generator=torch.Generator().manual_seed(0), train=True)
    for m in model.modules():
        if isinstance(m, U8Dropout):
            m.rate = 0.0
        elif isinstance(m, MHSA):
            m.dropout = 0.0
    if float64:
        model.double()
        model.compute_dtype = torch.float64
    return model, build_train_step(cfg, model, make_frontend(cfg, device="cpu"))


def step_record(cfg: Config, batch, float64: bool = False):
    """One step from the seeded init: the loss, every parameter's gradient
    and every BatchNorm's running stats."""
    model, step = build(cfg, float64)
    attn = port_rc.flash_attention
    if float64:
        port_rc.flash_attention = plain_attention.mhsa_attention
    try:
        loss = float(step(batch, torch.Generator().manual_seed(1)))
    finally:
        port_rc.flash_attention = attn
    return {"loss": loss,
            "grads": {n: p.grad.detach().clone() for n, p in model.named_parameters()},
            "stats": {f"{n}.{b}": getattr(m, b).detach().clone()
                      for n, m in model.named_modules() if isinstance(m, BatchNorm)
                      for b in ("running_mean", "running_var")}}


@contextlib.contextmanager
def single_process():
    """Train steps built inside take the single-process path (no DDP, no
    collective), as in a process that runs alone."""
    saved = mesh.world_size
    mesh.world_size = lambda: 1
    try:
        yield
    finally:
        mesh.world_size = saved


def same_on_ranks(rec) -> bool:
    """Whether every rank holds rank 0's gradients and running stats."""
    same = True
    for t in list(rec["grads"].values()) + list(rec["stats"].values()):
        buf = t.clone()
        dist.broadcast(buf, src=0)
        same &= torch.equal(buf, t)
    flag = torch.tensor([int(same)])
    dist.all_reduce(flag, op=dist.ReduceOp.MIN)
    return bool(flag.item())


def _max_err(a, b):
    return float((a.double() - b.double()).abs().max())


def _norm(tensors):
    return float(torch.linalg.vector_norm(torch.cat([t.reshape(-1) for t in tensors.values()])))


def job_steps(rank: int, world: int, out: str):
    """Each case's data-parallel step on this rank's shard; rank 0 also
    takes the single-process step on the global batch and compares: per
    case the two losses, the running stats' largest error relative to each
    tensor's max, and whether the ranks agree; for the float64 cases, each
    float64 gradient tensor's error beside its max|grad|, and the whole
    float32 gradient's L2 distance from float64, of the data-parallel and
    of the single-process step; the remat case against the step without
    remat; the float32 cases' running stats, for JAX."""
    shallow_conformer()
    rec, dp_plain = {}, None
    for case in CASES:
        cfg = case_config(case)
        clips = global_clips(cfg)
        shard, whole = make_batch(cfg, clips[rank::world]), make_batch(cfg, clips)
        dp = step_record(cfg, shard)
        row = {"ranks_equal": same_on_ranks(dp)}
        if case in F64:
            dp64 = step_record(cfg, shard, True)
            row["ranks_equal_f64"] = same_on_ranks(dp64)
        if rank == 0:
            with single_process():
                sp = step_record(cfg, whole)
                sp64 = step_record(cfg, whole, True) if case in F64 else None
            row["loss"] = [dp["loss"], sp["loss"]]
            row["stats_err"] = max(_max_err(dp["stats"][n], t) / float(t.abs().max())
                                   for n, t in sp["stats"].items())
            row["stats"] = {n: t.numpy() for n, t in dp["stats"].items()}
            if sp64 is not None:
                row["loss_f64"] = [dp64["loss"], sp64["loss"]]
                row["grads_f64"] = {n: [_max_err(dp64["grads"][n], g), float(g.abs().max())]
                                    for n, g in sp64["grads"].items()}
                # the float32 gradients' whole distance from float64:
                # |dp32 - sp64|, |sp32 - sp64|, and |sp64|
                row["grad_norms"] = [_norm({n: a[n].double() - g for n, g in sp64["grads"].items()})
                                     for a in (dp["grads"], sp["grads"])] + [
                                         _norm(sp64["grads"])]
            if case == "conformer-adyolo":
                dp_plain = dp
            elif case == "conformer-adyolo-remat":
                top = max(float(g.abs().max()) for g in dp_plain["grads"].values())
                row["vs_no_remat"] = {
                    "loss": [dp["loss"], dp_plain["loss"]],
                    "grad_err": max(_max_err(dp["grads"][n], g)
                                    for n, g in dp_plain["grads"].items()) / top,
                    "stats_err": max(_max_err(dp["stats"][n], t) / float(t.abs().max())
                                     for n, t in dp_plain["stats"].items())}
        rec[case] = row
    if rank == 0:
        with open(os.path.join(out, "steps.pkl"), "wb") as f:
            pickle.dump(rec, f)


def engine_argv(configs, results, exp_id, *extra):
    return ["train", "--encoder", "resnet-conformer", "--augment", "--logger",
            "--batch_size", "2", "--nb_iters", "2", "--seed", str(SEED),
            "--config_dir", configs, "--results_dir", results, "--exp_id", exp_id,
            "--device", "cpu", *extra]


def job_engine(rank: int, world: int, out: str, extra=()):
    """Four ``cli train`` runs on the set under ``out``, each with the
    arguments ``extra`` added: ``quick`` (``--quick_test``, 3 epochs);
    ``resumed`` (1 epoch) and ``resume`` (its ``--resume_pth`` to epoch 3);
    ``preempted``, where rank 1 alone sees a stop request during its first
    batch.  Epoch 3 scans the threshold.  Recorded per run: what this rank
    wrote or evaluated, in order (``events``), its step losses, its steps
    per epoch, and the threshold of the config it returned."""
    shallow_conformer()
    port_train.SCAN_EVERY = 3
    configs, results = os.path.join(out, "configs"), os.path.join(out, "results")
    rec = {"events": {}, "losses": {}, "steps": {}, "conf_thresh": {}}
    run = [None]

    def log(what):
        rec["events"].setdefault(run[0], []).append(what)

    def recording(name, fn):
        def wrapped(*a, **kw):
            log(name)
            return fn(*a, **kw)
        return wrapped

    for name in ("save_train_checkpoint", "save_jax_checkpoint", "save_config",
                 "test_epoch", "test_model", "scan_conf_thresh", "JsonlLogger"):
        setattr(port_train, name, recording(name, getattr(port_train, name)))
    orig_step, orig_epoch, orig_train = (port_train.build_train_step,
                                         port_train.train_one_epoch, port_train.train_model)

    def build_step(*a, **kw):
        step = orig_step(*a, **kw)

        def recorded(batch, gen):
            loss = step(batch, gen)
            rec["losses"].setdefault(run[0], []).append(float(loss))
            return loss

        recorded.optimizer, recorded.plan = step.optimizer, step.plan
        return recorded

    def one_epoch(loader, step, gen, max_batches, guard):
        if run[0] == "preempted" and rank == 1:
            def stop_requested(batch, g):  # as the signal handler does
                guard.stop = True
                return step(batch, g)

            loss, info = orig_epoch(loader, stop_requested, gen, max_batches, guard)
        else:
            loss, info = orig_epoch(loader, step, gen, max_batches, guard)
        rec["steps"].setdefault(run[0], []).append(info["steps"])
        return loss, info

    def train_model(*a, **kw):
        cfg = orig_train(*a, **kw)
        rec["conf_thresh"][run[0]] = cfg.train.conf_thresh
        return cfg

    port_train.build_train_step = build_step
    port_train.train_one_epoch = one_epoch
    port_train.train_model = train_model

    run[0] = "quick"
    cli.main(engine_argv(configs, results, "quick", "--quick_test", *extra))
    run[0] = "resumed"
    cli.main(engine_argv(configs, results, "resumed", "--nb_epochs", "1", *extra))
    if rank == 0:  # the frozen config asks for the quick run's 3 epochs
        fp = os.path.join(results, "resumed", "hyp_exp.yaml")
        cfg = load_config(fp)
        save_config(dataclasses.replace(
            cfg, train=dataclasses.replace(cfg.train, nb_epochs=3)), fp)
    dist.barrier()
    run[0] = "resume"
    cli.main(["train", "--resume_pth", "resumed", "--results_dir", results,
              "--device", "cpu"])
    run[0] = "preempted"
    cli.main(engine_argv(configs, results, "preempted", "--nb_epochs", "2", *extra))
    with open(os.path.join(out, f"engine.r{rank}.json"), "w") as f:
        json.dump(rec, f)


def main(argv):
    job, rank, world, rendezvous, out = argv
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rendezvous}",
                            rank=rank, world_size=world)
    try:
        mesh.init_distributed("cpu")
        {"steps": job_steps, "engine": job_engine}[job](rank, world, out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
