"""Rank processes of ``tests/test_torch_tp_replicated.py``: torch and the port
only (no JAX), on the CPU, joined by a gloo group through a ``file://``
rendezvous::

    python -m tests.torch_tp_replicated_worker <job> <rank> <world> <rendezvous> <out_dir>

``n3`` (3 ranks, ``model_parallel`` 3, one data replica): the conformer at
2 blocks and ``emb_dim`` 96, whose FFNs (hidden 384) and conv modules are
sharded 3 ways while each MHSA (4 heads) is held whole; the float64 step
with dropout 0.2 on the whole batch against the single-process step on
the same batch and generator, compared on rank 0, into ``n3.pkl``.

``se`` (2 ranks, ``model_parallel`` 2): SE-ResNet34, every parameter held
whole; the float64 step with its GRU dropout against the single-process
step, and the float32 step with dropout off (for JAX), into ``se.pkl``.

``engine`` (2 ranks): ``torch_ddp_worker.job_engine`` with ``--encoder
se-resnet34 --model_parallel 2``.
"""
import functools
import os
import pickle
import sys

import torch
import torch.distributed as dist

from adyolo_tpu_torch.models import resnet_conformer as port_rc
from adyolo_tpu_torch.models import wrapper as port_wrapper
from adyolo_tpu_torch.parallel import mesh

from tests import torch_ddp_worker as ddp
from tests import torch_tp_worker as tp

EMB = 96  # the n3 job's conformer width: 3 divides 96 and 384, not the 4 heads
JOBS_MP = {"n3": 3, "se": 2, "engine": 1}  # the engine sets its own


def narrow_conformer():
    """The port's conformer at :data:`ddp.BLOCKS` blocks and ``emb_dim``
    :data:`EMB` (the head's input width follows)."""
    port_wrapper.ENCODERS["resnet-conformer"] = functools.partial(
        port_rc.ResNetConformer, num_layers=ddp.BLOCKS)
    port_wrapper.SELDModel = functools.partial(port_wrapper.SELDModel, enc_out_dim=EMB)


def layout(model):
    """What a rank holds of conformer block 0 (None for SE-ResNet34)."""
    enc = model.encoder
    if not hasattr(enc, "conformer0"):
        return None
    b = enc.conformer0
    return {"fc1": tuple(b.ffn1.fc1.weight.shape), "pw1": tuple(b.conv.pw1.weight.shape),
            "dw": tuple(b.conv.dw_conv.weight.shape), "query": tuple(b.mhsa.query.weight.shape),
            "heads": b.mhsa.heads, "head_range": b.mhsa.head_range,
            "mhsa_tp": b.mhsa.tp is not None, "ffn_shard": b.ffn1.drop1.shard}


def compare_f64(rank, cfg, batch, f64, dropout, seed):
    """This rank's step gathered into the full model's shapes; on rank 0
    also its comparison with the single-process step (``tp.compare``)."""
    got = tp.step_record(cfg, batch, f64, dropout, seed)
    model = got.pop("model")
    row = {"replicated_equal": tp.replicated_equal(got), "layout": layout(model),
           "sharded": sorted(got["plan"].sharded)}
    full = tp.gathered(got)
    if rank == 0:
        with tp.single_process():
            want = tp.step_record(cfg, batch, f64, dropout)
        want.pop("model")
        row.update(tp.compare(full, want))
    return row, full


def job_n3(rank: int, world: int, out: str):
    narrow_conformer()
    cfg = tp.case_config({})
    batch = ddp.make_batch(cfg, ddp.global_clips(cfg))
    # every rank but 0 builds from another seed: the step takes rank 0's weights
    row, _ = compare_f64(rank, cfg, batch, True, True, 0 if rank == 0 else 7)
    if rank == 0:
        with open(os.path.join(out, "n3.pkl"), "wb") as f:
            pickle.dump(row, f)


def job_se(rank: int, world: int, out: str):
    rec = {}
    for case, f64, dropout in (("f64", True, True), ("f32-nodrop", False, False)):
        cfg = ddp.case_config("se-adyolo")
        batch = ddp.make_batch(cfg, ddp.global_clips(cfg))
        row, full = compare_f64(rank, cfg, batch, f64, dropout, 0 if rank == 0 else 7)
        if case == "f32-nodrop":
            row["stats"] = {n: t.numpy() for n, t in full["stats"].items()}
        rec[case] = row
    if rank == 0:
        with open(os.path.join(out, "se.pkl"), "wb") as f:
            pickle.dump(rec, f)


def main(argv):
    job, rank, world, rendezvous, out = argv
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rendezvous}",
                            rank=rank, world_size=world)
    try:
        mesh.init_distributed("cpu", model_parallel=JOBS_MP[job])
        if job == "engine":
            ddp.job_engine(rank, world, out, ("--encoder", "se-resnet34",
                                              "--model_parallel", "2"))
        else:
            {"n3": job_n3, "se": job_se}[job](rank, world, out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
