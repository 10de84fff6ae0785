#!/usr/bin/env python3
"""Data- and tensor-parallel training of the PyTorch port across the cards
of one host: one rank a card over NCCL, started the way ``torchrun`` starts
them (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT`` read by ``parallel.mesh.init_distributed``).
``chip_smoke.py``'s phases ``ddp`` and ``tp`` run two ranks over gloo on
one card; this is the NCCL path.

Run from the repository root on a host with N >= 2 cards::

    python3 scripts/torch_ddp_cards.py [dp] [tp]

(both parts when none is named; ``tp`` needs N = 4.)  The ``dp`` part:

1. ``step``: the single-process fp32 step of SE-ResNet34 and of the
   conformer with ``--remat`` (AD-YOLO, dropout 0) on a global batch of
   ``4 N`` 20-s clips, on card 0, in the ranks' clip order and in its own
   (float32's floor); then N ranks take the same step on 4 clips each.
   Held as phase ``ddp`` holds it (``chip_smoke.grad_distance``): the
   loss within 1e-4 rel, the gradients' L2 distance within 1e-3 or 2x the
   floor,
   the running stats within 1e-3, gradients and stats equal on every rank
   (NCCL broadcasts); per rank per step K1 once and, for the conformer,
   k2_dropout 16 and k3 8 times, the plain versions patched to raise.
2. ``scaling``: the conformer in bf16 with dropout 0.2, 16 clips a rank,
   5 steps: the step time of each rank, the N ranks' audio-s/s against
   one process's 16-clip step on card 0 (same call), per rank per step
   k2_dropout_bf16 / k3_bf16 8 times; the gradient all-reduce and one
   BatchNorm all-reduce timed alone; a profile of 2 steps on rank 0.
3. ``cli``: ``python -m torch.distributed.run --nproc_per_node N -m
   adyolo_tpu_torch.cli train --quick_test`` on a synthetic DCASE2022 set
   (4 clips a rank): exit 0, one experiment dir, one final test.

The ``tp`` part (``--model_parallel``), the full-width conformer +
AD-YOLO, and SE-ResNet34 + AD-YOLO held whole on every rank:

4. ``tp_step``: the conformer's fp32 step at dp 2 x tp 2 (4 clips a
   replica, dropout 0, against the single-process step on the 8 clips in
   the replicas' order; float32's floor from the same step in its own
   order) and at dp 1 x tp 4 (4 clips, dropout 0.2, against the
   single-process step on the same batch and generator; the floor from
   the step with dropout 0 in two clip orders); SE-ResNet34's fp32 step at
   dp 2 x tp 2 as the conformer's, then 4 more steps, each rank's step
   time beside one process's on the 8 clips on card 0: held as phase
   ``tp`` holds it (loss 1e-4 rel, the gathered gradients' L2 distance
   within 1e-3 or 2x the floor, stats 1e-3), the replicated parameters'
   gradients equal on every rank; per rank per step K1 once and, for the
   conformer, k2_dropout / k3 8 times each, the plain versions patched to
   raise.
5. ``tp_scaling``: the bf16 conformer with dropout 0.2, 16 clips a
   replica, 5 steps at tp 2 (two replicas) and at tp 4 (one): each
   rank's step time, the audio-s/s against one process's 16-clip step on
   card 0 in the same call, per rank per step k2_dropout_bf16 / k3_bf16 8
   times, one TP all-reduce of a row-parallel output timed alone.
6. ``tp_cli``: ``python -m torch.distributed.run --nproc_per_node 4 -m
   adyolo_tpu_torch.cli train --encoder resnet-conformer --model_parallel
   2 --quick_test``: exit 0, one experiment dir, one final test.

Each part prints one JSON line; then the card's nvidia-smi line.
"""
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

import chip_smoke as cs  # noqa: E402
from adyolo_tpu_torch.parallel import mesh  # noqa: E402

STEP_PER_RANK = 4  # clips a rank in part 1
SCALE_PER_RANK = 16  # clips a rank in part 2
SCALE_STEPS = 5
# part 4: name -> (encoder, model_parallel, dropout on, steps); 4 clips a
# data replica; step 1 is compared, the others timed
TP_GRIDS = {"dp2xtp2": ("resnet-conformer", 2, False, 1),
            "dp1xtp4": ("resnet-conformer", 4, True, 1),
            "se_dp2xtp2": ("se-resnet34", 2, False, SCALE_STEPS)}
TP_PER_REPLICA = 4
TP_SCALE = (2, 4)  # part 5's model-parallel sizes


def rank_main(rank, world, port, tmp, cfg, conf_cfg):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    device = mesh.init_distributed("cuda")  # NCCL, cuda:LOCAL_RANK
    try:
        fe = cs.make_frontend(cfg, device=device)
        out = {}
        cases = cs.ddp_cases(cfg, conf_cfg)
        for name, (c, dropout) in cases.items():
            per_rank = SCALE_PER_RANK if name == "conformer_bf16" else STEP_PER_RANK
            audio, per_clip = cs.synthetic_clips(c, np.random.default_rng(cs.DDP_SEED),
                                                 per_rank * world)
            shard = {k: v.to(device) for k, v in cs.clips_batch(
                c, audio[rank::world], per_clip[rank::world]).items()}
            model = cs.ddp_model(c, dropout).to(device)
            step = cs.build_train_step(c, model, fe)
            gen = torch.Generator(device=device).manual_seed(1234)
            steps = SCALE_STEPS if name == "conformer_bf16" else 1
            losses, step_ms, per_step = [], [], []
            with cs.plain_versions_raise():
                cs.zero_counts()
                for _ in range(steps):
                    before = cs.counts()
                    t0 = time.perf_counter()
                    losses.append(float(step(shard, gen)))
                    step_ms.append((time.perf_counter() - t0) * 1e3)
                    per_step.append({n: v - before[n] for n, v in cs.counts().items()})
            row = {"losses": losses, "step_ms": step_ms, "per_step": per_step}
            if name == "conformer_bf16":
                row["profile"] = cs.profile_calls(
                    lambda i: step(shard, gen), 2, every_rank=True,
                    expect=cs.kernels_launched(lambda: step(shard, gen)))
                row["collectives"] = cs.ddp_collective_ms(model)
            rec = cs.ddp_record(model)
            same = True
            for t in list(rec["grads"].values()) + list(rec["stats"].values()):
                mine = t.to(device)
                theirs = mine.clone()
                dist.broadcast(theirs, src=0)
                same &= torch.equal(mine, theirs)
            row["same_as_rank0"] = same
            if rank == 0 and name != "conformer_bf16":
                torch.save(rec, os.path.join(tmp, f"{name}.pt"))
            out[name] = row
            del model, step, rec, shard
            torch.cuda.empty_cache()
        with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        mesh.shutdown()


def tp_rank_main(rank, world, port, tmp, cfg, conf_cfg):
    """One rank of parts 4 and 5: each grid of :data:`TP_GRIDS`, then the
    bf16 scaling at each size of :data:`TP_SCALE`; rank 0 writes the
    gathered fp32 gradients and stats of part 4's step 1."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    device = mesh.init_distributed("cuda")  # NCCL, cuda:LOCAL_RANK
    try:
        fe = cs.make_frontend(conf_cfg, device=device)
        out = {}
        cfgs = {"resnet-conformer": conf_cfg, "se-resnet34": cfg}
        runs = [(name, mp, dropout, cfgs[encoder], TP_PER_REPLICA, steps)
                for name, (encoder, mp, dropout, steps) in TP_GRIDS.items()]
        bf16 = cs.with_train(conf_cfg, compute_dtype="bfloat16")
        runs += [(f"bf16_tp{mp}", mp, True, bf16, SCALE_PER_RANK, SCALE_STEPS) for mp in TP_SCALE]
        for name, mp, dropout, c, per, steps in runs:
            mesh.set_model_parallel(mp)
            dp, r = mesh.dp_size(), mesh.dp_rank()
            audio, per_clip = cs.synthetic_clips(c, np.random.default_rng(cs.TP_SEED), per * dp)
            shard = {k: v.to(device) for k, v in cs.clips_batch(
                c, audio[r::dp], per_clip[r::dp]).items()}
            model = cs.ddp_model(c, dropout).to(device)
            step = cs.build_train_step(c, model, fe)
            gen = torch.Generator(device=device).manual_seed(1234)
            losses, step_ms, per_step, row = [], [], [], {}
            with cs.plain_versions_raise():
                cs.zero_counts()
                for i in range(steps):
                    before = cs.counts()
                    t0 = time.perf_counter()
                    losses.append(float(step(shard, gen)))
                    step_ms.append((time.perf_counter() - t0) * 1e3)
                    per_step.append({n: v - before[n] for n, v in cs.counts().items()})
                    if i == 0 and name in TP_GRIDS:
                        full, row["replicated_equal"] = cs.tp_gathered_record(model, step.plan)
                        if rank == 0:
                            torch.save(full, os.path.join(tmp, f"{name}.pt"))
            row.update(losses=losses, step_ms=step_ms, per_step=per_step,
                       grid=[dp, mesh.tp_size()], sharded=sorted(step.plan.sharded))
            if name not in TP_GRIDS:
                x = torch.ones((per, 800, 256), device=device)
                ms = []
                for _ in range(6):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    dist.all_reduce(x, group=mesh.tp_group())
                    torch.cuda.synchronize()
                    ms.append((time.perf_counter() - t0) * 1e3)
                row["allreduce_ms"] = float(np.median(ms[1:]))
            out[name] = row
            del model, step, shard
            torch.cuda.empty_cache()
        with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        mesh.shutdown()


def part_tp(smi, world, cfg, conf_cfg, fe):
    """Parts 4-6 (see the module docstring)."""
    cs.require(world == 4, f"the tp part needs 4 cards, found {world}")
    ref, floor, ref_ms = {}, {}, {}
    cfgs = {"resnet-conformer": conf_cfg, "se-resnet34": cfg}
    for name, (encoder, mp, dropout, steps) in TP_GRIDS.items():
        c = cfgs[encoder]
        dp = world // mp
        B = TP_PER_REPLICA * dp
        order = [i for r in range(dp) for i in range(r, B, dp)]
        _, ref_ms[name], ref[name] = single_steps(c, dropout, fe, B, order, steps=steps,
                                                  seed=cs.TP_SEED)
        if dropout:  # the same function in another summation order needs dropout off
            a = single_steps(c, False, fe, B, order, seed=cs.TP_SEED)[2]
            b = single_steps(c, False, fe, B, order[::-1], seed=cs.TP_SEED)[2]
        else:
            a, b = single_steps(c, False, fe, B, seed=cs.TP_SEED)[2], ref[name]
        floor[name] = cs.grad_distance(a, b)
    bf16 = cs.with_train(conf_cfg, compute_dtype="bfloat16")
    _, one_ms, _ = single_steps(bf16, True, fe, SCALE_PER_RANK, steps=SCALE_STEPS,
                                seed=cs.TP_SEED)
    torch.cuda.empty_cache()

    tmp = tempfile.mkdtemp(prefix="torch_ddp_cards_tp_")
    try:
        torch.multiprocessing.spawn(tp_rank_main,
                                    args=(world, cs.free_port(), tmp, cfg, conf_cfg),
                                    nprocs=world, join=True)
        ranks = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        rows = {}
        for name in TP_GRIDS:
            got = torch.load(os.path.join(tmp, f"{name}.pt"))
            got["loss"] = ranks[0][name]["losses"][0]
            rows[name] = {**cs.grad_distance(got, ref[name]), "grid": ranks[0][name]["grid"],
                          "sharded": ranks[0][name]["sharded"],
                          "single_process_batch_order_floor": floor[name]}
            if TP_GRIDS[name][3] > 1:  # timed: each rank's steps beside one card's
                rows[name]["timing"] = {
                    "median_step_ms_per_rank": [float(np.median(rec[name]["step_ms"][1:]))
                                                for rec in ranks],
                    "one_card_median_step_ms": float(np.median(ref_ms[name][1:])),
                    "step_ms": [rec[name]["step_ms"] for rec in ranks],
                    "one_card_step_ms": ref_ms[name]}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    cs.emit({"part": "tp_step", "world": world, "backend": "nccl", **rows, "card": smi})
    nb = cs.CONFORMER_BLOCKS
    want = {"fp32": {"stft": 1, "k2_dropout": nb, "k3": nb},
            "bf16": {"stft": 1, "k2_dropout_bf16": nb, "k3_bf16": nb}, "se": {"stft": 1}}
    for name, row in rows.items():
        tol = cs.ddp_grad_tol(row)
        cs.require(row["loss_rel"] <= cs.TRAIN_LOSS_TOL, f"{name}: loss {row['loss']}")
        cs.require(row["grad_l2_rel"] <= tol, f"{name}: grads {row['grad_l2_rel']} > {tol}")
        cs.require(row["stats_rel"] <= cs.TRAIN_GRAD_TOL, f"{name}: stats {row['stats_rel']}")
    for r, rec in enumerate(ranks):
        for name, row in rec.items():
            kind = "bf16" if name.startswith("bf16") else "se" if name.startswith("se") else "fp32"
            cs.require(row.get("replicated_equal", True),
                       f"{name}: rank {r}'s replicated gradients differ from rank 0's")
            cs.require(all(np.isfinite(row["losses"])), f"{name} rank {r}: {row['losses']}")
            for i, n in enumerate(row["per_step"]):
                cs.require(n == {**{k: 0 for k in n}, **want[kind]},
                           f"{name} rank {r} step {i + 1}: launches {n}, want {want[kind]}")
    one = float(np.median(one_ms[1:]))
    n_audio = SCALE_PER_RANK * 20.0
    scaling = {}
    for mp in TP_SCALE:
        name = f"bf16_tp{mp}"
        rank_ms = [float(np.median(rec[name]["step_ms"][1:])) for rec in ranks]
        dp = world // mp
        scaling[name] = {"grid": ranks[0][name]["grid"], "median_step_ms_per_rank": rank_ms,
                         "audio_s_per_s": dp * n_audio / (max(rank_ms) * 1e-3),
                         "losses": ranks[0][name]["losses"],
                         "step_ms": [rec[name]["step_ms"] for rec in ranks],
                         "allreduce_ms_rank0": ranks[0][name]["allreduce_ms"],
                         "allreduce_bytes": SCALE_PER_RANK * 800 * 256 * 4}
    cs.emit({"part": "tp_scaling", "world": world, "backend": "nccl",
             "clips_per_replica": SCALE_PER_RANK, **scaling,
             "one_process": {"step_ms": one_ms, "median_step_ms": one,
                             "audio_s_per_s": n_audio / (one * 1e-3)},
             "allreduces_per_step": 8 * nb, "card": smi})
    run_cli(smi, world, cfg, ["--encoder", "resnet-conformer", "--model_parallel", "2"],
            "tp_cli")


def run_cli(smi, world, cfg, extra, part):
    """``python -m torch.distributed.run --nproc_per_node <world> -m
    adyolo_tpu_torch.cli train --quick_test`` with ``extra`` on a synthetic
    DCASE2022 set (4 clips a rank): exit 0, one experiment dir, one final
    test."""
    tmp = tempfile.mkdtemp(prefix="torch_ddp_cards_cli_")
    try:
        data = os.path.join(tmp, "data")
        cs.write_dcase_set(data, cfg, os.path.join(cfg.data.data_pth, "scaler_wts.pkl"))
        configs = cs.preset_dir(tmp, cfg, data_pth=data, name_pth=os.path.join(data, "classes.txt"))
        results = os.path.join(tmp, "results")
        env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", str(world),
             "--master_port", str(cs.free_port()), "-m", "adyolo_tpu_torch.cli", "train",
             "--quick_test", "--batch_size", str(4 * world), "--nb_iters", "1",
             "--config_dir", configs, "--results_dir", results, "--exp_id", "cards-cli",
             *extra],
            cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
        cli_s = time.perf_counter() - t0
        cs.require(proc.returncode == 0, f"{part}: exit {proc.returncode}\n"
                   f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        exps = os.listdir(results)
        cs.require(exps == ["cards-cli"], f"{part}: experiment dirs {exps}")
        final = proc.stdout.count("FINAL TEST WITH BEST CHECKPOINT")
        cs.require(final == 1, f"{part}: the final test ran {final} times")
        cs.emit({"part": part, "world": world, "args": extra, "seconds": cli_s,
                 "files": sorted(os.listdir(os.path.join(results, "cards-cli"))), "card": smi})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def single_steps(c, dropout, fe, B, idx_order=None, steps=1, seed=None):
    """``steps`` single-process steps on card 0 from the seeded init on
    ``B`` clips (in ``idx_order``; the clips drawn from ``seed``, phase
    ddp's by default): the losses, step ms and step 1's record."""
    seed = cs.DDP_SEED if seed is None else seed
    audio, per_clip = cs.synthetic_clips(c, np.random.default_rng(seed), B)
    idx = list(range(B)) if idx_order is None else idx_order
    batch = cs.clips_batch(c, audio[idx], [per_clip[i] for i in idx])
    model = cs.ddp_model(c, dropout)
    step = cs.build_train_step(c, model, fe)
    gen = torch.Generator(device="cuda").manual_seed(1234)
    losses, ms = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        losses.append(float(step(batch, gen)))
        ms.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            rec = {"loss": losses[0], **cs.ddp_record(model)}
    return losses, ms, rec


def part_dp(smi, world, cfg, conf_cfg, fe):
    """Parts 1-3 (see the module docstring)."""
    cases = cs.ddp_cases(cfg, conf_cfg)

    ref, floor = {}, {}
    B = STEP_PER_RANK * world
    order = [i for r in range(world) for i in range(r, B, world)]
    for name in ("se", "conformer_remat"):
        ref[name] = single_steps(*cases[name], fe, B, order)[2]
        floor[name] = cs.grad_distance(single_steps(*cases[name], fe, B)[2], ref[name])
    _, one_ms, _ = single_steps(*cases["conformer_bf16"], fe, SCALE_PER_RANK,
                                steps=SCALE_STEPS)
    torch.cuda.empty_cache()

    tmp = tempfile.mkdtemp(prefix="torch_ddp_cards_")
    try:
        torch.multiprocessing.spawn(rank_main, args=(world, cs.free_port(), tmp, cfg, conf_cfg),
                                    nprocs=world, join=True)
        ranks = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        rows = {}
        for name in ("se", "conformer_remat"):
            got = torch.load(os.path.join(tmp, f"{name}.pt"))
            got["loss"] = ranks[0][name]["losses"][0]
            rows[name] = {**cs.grad_distance(got, ref[name]),
                          "single_process_batch_order_floor": floor[name]}
        cs.emit({"part": "step", "world": world, "backend": "nccl",
                 "global_batch": [B, 800, cs.HOP, 4], **rows, "card": smi})
        nb = cs.CONFORMER_BLOCKS
        want_step = {"se": {"stft": 1},
                     "conformer_remat": {"stft": 1, "k2_dropout": 2 * nb, "k3": nb},
                     "conformer_bf16": {"stft": 1, "k2_dropout_bf16": nb, "k3_bf16": nb}}
        for name, row in rows.items():
            tol = cs.ddp_grad_tol(row)
            cs.require(row["loss_rel"] <= cs.TRAIN_LOSS_TOL, f"{name}: loss {row['loss']}")
            cs.require(row["grad_l2_rel"] <= tol, f"{name}: grads {row['grad_l2_rel']} > {tol}")
            cs.require(row["stats_rel"] <= cs.TRAIN_GRAD_TOL, f"{name}: stats {row['stats_rel']}")
        for r, rec in enumerate(ranks):
            for name, want in want_step.items():
                row = rec[name]
                cs.require(row["same_as_rank0"], f"{name}: rank {r} differs from rank 0")
                cs.require(row["losses"] == ranks[0][name]["losses"]
                           and all(np.isfinite(row["losses"])),
                           f"{name} rank {r}: losses {row['losses']}")
                for i, n in enumerate(row["per_step"]):
                    cs.require(n == {**{k: 0 for k in n}, **want},
                               f"{name} rank {r} step {i + 1}: launches {n}, want {want}")
        bf = [rec["conformer_bf16"] for rec in ranks]
        rank_ms = [float(np.median(b["step_ms"][1:])) for b in bf]
        one = float(np.median(one_ms[1:]))
        n_audio = SCALE_PER_RANK * 20.0
        cs.emit({"part": "scaling", "world": world, "backend": "nccl",
                 "clips_per_rank": SCALE_PER_RANK, "losses": bf[0]["losses"],
                 "step_ms": [b["step_ms"] for b in bf], "median_step_ms_per_rank": rank_ms,
                 "audio_s_per_s": world * n_audio / (max(rank_ms) * 1e-3),
                 "one_process": {"step_ms": one_ms, "median_step_ms": one,
                                 "audio_s_per_s": n_audio / (one * 1e-3)},
                 "scaling_efficiency": one / max(rank_ms),
                 "profile_rank0": bf[0]["profile"], "collectives_rank0": bf[0]["collectives"],
                 "card": smi})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    run_cli(smi, world, cfg, [], "cli")


def main():
    which = sys.argv[1:] or ["dp", "tp"]
    smi = cs.phase_env()
    world = torch.cuda.device_count()
    cs.require(world >= 2, f"{world} card(s): this script needs two or more")
    cs.phase_build()
    data = os.path.join(REPO, "data", "DCASE2022_SELD")
    cfg = cs.Config()
    cfg = cs.dataclasses.replace(cfg, data=cs.dataclasses.replace(
        cfg.data, data_pth=data, name_pth=os.path.join(data, "classes.txt")))
    conf_cfg = cs.dataclasses.replace(cfg, args=cs.dataclasses.replace(
        cfg.args, encoder="resnet-conformer"))
    fe = cs.make_frontend(cfg)
    if "dp" in which:
        part_dp(smi, world, cfg, conf_cfg, fe)
    if "tp" in which:
        part_tp(smi, world, cfg, conf_cfg, fe)
    print(smi, flush=True)


if __name__ == "__main__":
    main()
