"""Rank processes of ``tests/test_torch_tp.py``: torch and the port only (no
JAX), on the CPU, joined by a gloo group through a ``file://`` rendezvous::

    python -m tests.torch_tp_worker <job> <rank> <world> <rendezvous> <out_dir>

``tp`` (2 ranks, ``model_parallel`` 2, one data replica): the tensor-parallel
step of each case of :data:`CASES` on the whole batch of
``torch_ddp_worker.global_clips``, with dropout on unless the case turns
it off, compared on rank 0 with the single-process step on the same batch
and generator (:func:`job_tp`), into ``tp.pkl``.  Every rank but 0 builds
its model from another seed: the step takes rank 0's weights before it
shards them.

``grid`` (4 ranks, dp 2 x tp 2): the step on each replica's half of the
batch, against the single-process step in float64 with dropout off, and
with dropout on against the data-parallel step of the same two replicas
on the unsharded model (:func:`job_grid`), into ``grid.pkl``.

``engine`` (2 ranks): ``torch_ddp_worker.job_engine`` with
``--model_parallel 2``.
"""
import contextlib
import dataclasses
import os
import pickle
import sys

import torch
import torch.distributed as dist

from adyolo_tpu_torch.engine.evaluate import make_frontend
from adyolo_tpu_torch.models import resnet_conformer as port_rc
from adyolo_tpu_torch.models import wrapper as port_wrapper
from adyolo_tpu_torch.models.layers import BatchNorm, U8Dropout
from adyolo_tpu_torch.ops import attention as plain_attention
from adyolo_tpu_torch.parallel import mesh
from adyolo_tpu_torch.parallel.train_step import build_train_step

from tests import torch_ddp_worker as ddp

MP = 2  # ranks in a model group
# name: (float64, dropout on, train overrides)
CASES = {
    "f64": (True, True, {}),
    "f32": (False, True, {}),
    "f32-nodrop": (False, False, {}),
    "remat": (False, True, {"remat": True}),
    "bf16": (False, True, {"compute_dtype": "bfloat16"}),
}


def case_config(train):
    cfg = ddp.case_config("conformer-adyolo")
    return dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, **train))


def build(cfg, float64=False, dropout=True, seed=0):
    """The seeded conformer in training mode (dropout 0.2, or off) and its
    train step, on the CPU; float64 as ``torch_ddp_worker.build``."""
    model = port_wrapper.build_model(cfg, device="cpu",
                                     generator=torch.Generator().manual_seed(seed), train=True)
    if not dropout:
        for m in model.modules():
            if isinstance(m, U8Dropout):
                m.rate = 0.0
            elif isinstance(m, port_rc.MHSA):
                m.dropout = 0.0
    if float64:
        model.double()
        model.compute_dtype = torch.float64
    return model, build_train_step(cfg, model, make_frontend(cfg, device="cpu"))


def step_record(cfg, batch, float64=False, dropout=True, seed=0):
    """One step from the seeded init with generator seed 1: the loss, every
    parameter's gradient and every BatchNorm's running stats, as this rank
    holds them, the model and its layout over the TP group."""
    model, step = build(cfg, float64, dropout, seed)
    attn = port_rc.flash_attention
    if float64:  # the kernels' wrapper takes float32 and bfloat16
        port_rc.flash_attention = plain_attention.mhsa_attention
    try:
        loss = float(step(batch, torch.Generator().manual_seed(1)))
    finally:
        port_rc.flash_attention = attn
    return {"loss": loss, "model": model, "plan": step.plan,
            "grads": {n: p.grad.detach().clone() for n, p in model.named_parameters()},
            "stats": {f"{n}.{b}": getattr(m, b).detach().clone()
                      for n, m in model.named_modules() if isinstance(m, BatchNorm)
                      for b in ("running_mean", "running_var")}}


def gathered(rec):
    """``rec``'s gradients and stats in the unsharded model's shapes."""
    return {**rec, "grads": mesh.gather_state_dict(rec["grads"], rec["plan"]),
            "stats": mesh.gather_state_dict(rec["stats"], rec["plan"])}


@contextlib.contextmanager
def single_process():
    """Train steps built inside take the single-process path: no sharding,
    no DDP, no collective."""
    saved = mesh.world_size, mesh.tp_size
    mesh.world_size = mesh.tp_size = lambda: 1
    try:
        yield
    finally:
        mesh.world_size, mesh.tp_size = saved


@contextlib.contextmanager
def data_parallel_only():
    """Train steps built inside are this grid's data-parallel step on the
    unsharded model: DDP over the DP group, the replica's generator."""
    saved = mesh.tp_size, mesh.dp_size, mesh.dp_rank
    replicas, replica = mesh.dp_size(), mesh.dp_rank()
    mesh.tp_size, mesh.dp_size, mesh.dp_rank = (lambda: 1), (lambda: replicas), (lambda: replica)
    try:
        yield
    finally:
        mesh.tp_size, mesh.dp_size, mesh.dp_rank = saved


def replicated_equal(rec) -> bool:
    """Whether every rank holds rank 0's gradients of the replicated
    parameters and rank 0's replicated running stats."""
    same = True
    for name, t in list(rec["grads"].items()) + list(rec["stats"].items()):
        if rec["plan"].rule(name) is None:
            buf = t.clone()
            dist.broadcast(buf, src=0)
            same &= torch.equal(buf, t)
    flag = torch.tensor([int(same)])
    dist.all_reduce(flag, op=dist.ReduceOp.MIN)
    return bool(flag.item())


def _max_err(a, b):
    return float((a.double() - b.double()).abs().max())


def _norm(tensors):
    return float(torch.linalg.vector_norm(torch.cat([t.double().reshape(-1)
                                                     for t in tensors.values()])))


def compare(got, want):
    """``got``'s step against ``want``'s: both losses, each gradient
    tensor's largest error beside its max|grad|, the running stats'
    largest error relative to each tensor's max."""
    return {"loss": [got["loss"], want["loss"]],
            "grads": {n: [_max_err(got["grads"][n], g), float(g.abs().max())]
                      for n, g in want["grads"].items()},
            "stats_err": max(_max_err(got["stats"][n], t) / float(t.abs().max())
                             for n, t in want["stats"].items())}


def job_tp(rank: int, world: int, out: str):
    """Each case's 2-rank step on the whole batch; rank 0 compares it with
    the single-process step.  Recorded per case on rank 0: the
    comparison; whether the ranks hold equal gradients of the replicated
    parameters and equal replicated stats; the shapes a rank holds; for
    f32, the whole gradient's L2 distance from the single-process float64
    gradient beside the float32 single-process step's own; remat against
    the step without it; f32-nodrop's loss and stats (for JAX)."""
    ddp.shallow_conformer()
    seed = 0 if rank == 0 else 7  # the step takes rank 0's weights
    rec, tp, sp = {}, {}, {}
    for case, (f64, dropout, train) in CASES.items():
        cfg = case_config(train)
        batch = ddp.make_batch(cfg, ddp.global_clips(cfg))
        got = step_record(cfg, batch, f64, dropout, seed)
        enc = got.pop("model").encoder
        row = {"replicated_equal": replicated_equal(got),
               "shapes": {"fc1": tuple(enc.conformer0.ffn1.fc1.weight.shape),
                          "pw1": tuple(enc.conformer0.conv.pw1.weight.shape),
                          "dw": tuple(enc.conformer0.conv.dw_conv.weight.shape),
                          "heads": enc.conformer0.mhsa.heads,
                          "head_range": enc.conformer0.mhsa.head_range}}
        tp[case] = gathered(got)
        if rank == 0:
            if case != "remat":
                with single_process():
                    sp[case] = step_record(cfg, batch, f64, dropout)
                    sp[case].pop("model")
                row.update(compare(tp[case], sp[case]))
            if case == "f32":
                sp64 = sp["f64"]["grads"]
                row["grad_norms"] = [_norm({n: run[case]["grads"][n].double() - g
                                            for n, g in sp64.items()})
                                     for run in (tp, sp)] + [_norm(sp64)]
            elif case == "remat":
                row.update(compare(tp[case], tp["f32"]))
            elif case == "f32-nodrop":
                row["stats"] = {n: t.numpy() for n, t in tp[case]["stats"].items()}
        rec[case] = row
    if rank == 0:
        with open(os.path.join(out, "tp.pkl"), "wb") as f:
            pickle.dump(rec, f)


def job_grid(rank: int, world: int, out: str):
    """dp 2 x tp 2 on the 4-clip batch, in float64: dropout off against the
    single-process step on the whole batch; dropout on against the
    data-parallel step of the same replicas on the unsharded model (whose
    dropout bits are the replicas', as at model_parallel 1)."""
    ddp.shallow_conformer()
    cfg = case_config({})
    clips = ddp.global_clips(cfg)
    shard = ddp.make_batch(cfg, clips[mesh.dp_rank()::mesh.dp_size()])
    rec = {"grid": [mesh.dp_size(), mesh.tp_size()]}
    for case, dropout in (("nodrop", False), ("dropout", True)):
        got = gathered(step_record(cfg, shard, True, dropout))
        got.pop("model")
        if dropout:
            with data_parallel_only():
                want = step_record(cfg, shard, True, dropout)
        elif rank == 0:
            with single_process():
                want = step_record(cfg, ddp.make_batch(cfg, clips), True, dropout)
        if rank == 0:
            want.pop("model")
            rec[case] = compare(got, want)
    if rank == 0:
        with open(os.path.join(out, "grid.pkl"), "wb") as f:
            pickle.dump(rec, f)


def main(argv):
    job, rank, world, rendezvous, out = argv
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rendezvous}",
                            rank=rank, world_size=world)
    try:
        mesh.init_distributed("cpu", model_parallel=1 if job == "engine" else MP)
        if job == "engine":
            ddp.job_engine(rank, world, out, ("--model_parallel", str(MP)))
        else:
            {"tp": job_tp, "grid": job_grid}[job](rank, world, out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
