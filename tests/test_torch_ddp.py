"""Data-parallel training in the port, on the CPU: two rank processes
(``tests/torch_ddp_worker.py``, torch only) in a gloo group.

Global step.  Two ranks x 2 clips against the port's single-process step
on the 4-clip global batch (2-s clips, from the same seeded init, dropout
and SpecAugment off): SE-ResNet34 + AD-YOLO, ResNet-Conformer (2 blocks) +
AD-YOLO and + SED-DOA; rank 0 takes both and compares
(``torch_ddp_worker.job_steps``).  Held, in float32: the global loss within 1e-5
rel, the BatchNorm running stats within 1e-5 of each tensor's max, and
the gradients and stats equal on both ranks.  The gradients are held in
float64 (the same cases with the model in float64): each tensor within
1e-4 of its max|grad| (measured: 1e-8), the loss within 1e-12.  In
float32 the single-process step's own gradients lie 5.7e-4 (SE-ResNet34)
to 1.1e-2 (the conformer, AD-YOLO) of the whole gradient's L2 norm from
float64 on these batches (BatchNorm's one-pass E[x²] - E[x]² in float32,
and AD-YOLO's responsible anchors at a threshold), so the 2-rank float32
gradient is held to no more than 2x that distance from float64 (plus
1e-4 of the norm; measured 0.8x to 1.9x).

Against JAX: the 2-rank float32 step's loss and BatchNorm running stats
against ``adyolo_tpu.parallel.train_step.build_train_step`` on the global
batch from the same weights (its DP step is its single-device step,
``tests/test_dp_mesh.py``), within ``tests/test_torch_train_step.py``'s
tolerances: 1e-4 rel and 1e-4 abs.

remat and bf16: the conformer with ``remat`` on 2 ranks gives the loss,
gradients and stats of the 2-rank step without it (1e-6 rel, 1e-6 of the
largest gradient); bf16 on 2 ranks has its loss within 1e-2 rel of the
single-process bf16 step (``chip_smoke.py``'s bf16 step tolerance).

Loader (``tests/test_multihost.py:74,81``'s counterparts): the ranks'
batches are disjoint slices whose union is the single-process epoch, each
clip with its single-process rotation; ``(0, 1)`` yields the JAX
package's batches bit for bit; a batch size that the ranks do not divide
is refused.

Engine: ``cli train`` on two ranks (the synthetic set of
``tests/test_torch_engine.py``, the conformer at 2 blocks, B = 2): one
experiment dir per run, only rank 0 writes, evaluates and logs, the final
test once, both ranks return rank 0's threshold; a stop request on rank 1
alone stops both after the same batch, and a run of 1 epoch resumed for
2 more gives the uninterrupted 3-epoch run's step losses.

Mesh: ``cuda`` becomes ``cuda:LOCAL_RANK`` and a LOCAL_RANK past the
cards is refused; without a group every collective is the identity.
"""
import dataclasses
import functools
import json
import os
import pickle
import random
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import yaml

from adyolo_tpu import config as jax_config
from adyolo_tpu.data import dataset as jax_dataset
from adyolo_tpu.engine.evaluate import make_frontend as jax_make_frontend
from adyolo_tpu.models import layers as jax_layers
from adyolo_tpu.models import resnet_conformer as jax_rc
from adyolo_tpu.models.wrapper import build_model as jax_build_model
from adyolo_tpu.parallel import train_step as jax_train_step
from adyolo_tpu_torch.config import save_config
from adyolo_tpu_torch.convert import flax_from_state_dict
from adyolo_tpu_torch.data.dataset import SELDDataset, TrainLoader
from adyolo_tpu_torch.models import wrapper as port_wrapper
from adyolo_tpu_torch.parallel import mesh

from tests import torch_ddp_worker as worker
from tests.synth_data import make_synth_dataset
from tests.test_torch_config import one_torch_thread, port_config, module_tmp  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
LOSS_REL = 1e-5
STATS_REL = 1e-5
GRAD_TOL = 1e-4
F32_GRAD_RATIO = 2.0  # float32: at most this x the single-process step's distance
REMAT_TOL = 1e-6
BF16_LOSS_REL = 1e-2
JAX_LOSS_REL = 1e-4
JAX_STATS_TOL = 1e-4
FP32 = worker.F64
JOB_TIMEOUT = 600  # s


def _run_ranks(job, out, world=WORLD, module="tests.torch_ddp_worker"):
    """Start the ``world`` rank processes of ``job`` (of the worker
    ``module``); returns a function that waits for them and, with
    ``check``, fails with a rank's log if it failed."""
    env = dict(os.environ, PYTHONPATH=_REPO, OMP_NUM_THREADS="1")
    rdv = os.path.join(out, "rendezvous")
    logs = [open(os.path.join(out, f"{job}.log.r{r}"), "w") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, "-m", module, job,
                               str(r), str(world), rdv, out], cwd=_REPO, env=env,
                              stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(world)]

    def wait(check=True):
        try:
            for p in procs:
                p.wait(timeout=JOB_TIMEOUT)
        finally:
            for p, f in zip(procs, logs):
                if p.poll() is None:
                    p.kill()
                    p.wait()
                f.close()
        for r, p in enumerate(procs if check else ()):
            with open(os.path.join(out, f"{job}.log.r{r}")) as f:
                assert p.returncode == 0, f"rank {r} of {job}:\n{f.read()[-4000:]}"

    return wait


# ---- global step ------------------------------------------------------------

@pytest.fixture(scope="module")
def jobs(module_tmp):
    """Both jobs' rank processes, started together: the step comparisons
    and the engine runs on a synthetic set."""
    root = str(module_tmp("ddp"))
    data = make_synth_dataset(os.path.join(root, "data"), n_train=8, n_val=2, n_test=2,
                              train_secs=1, eval_secs=2, chunk_window_s=1, seed=4)
    configs = os.path.join(root, "engine", "configs")
    os.makedirs(configs)
    with open(os.path.join(configs, "hyp_data_DCASE2022.yaml"), "w") as f:
        yaml.safe_dump({"data_pth": data, "name_pth": os.path.join(data, "classes.txt"),
                        "chunk_window_s": 1}, f)
    with open(os.path.join(configs, "hyp_train.yaml"), "w") as f:
        yaml.safe_dump({"max_targets_per_clip": 64}, f)
    out = {"steps": os.path.join(root, "steps"), "engine": os.path.join(root, "engine")}
    os.makedirs(out["steps"])
    waits = {job: _run_ranks(job, d) for job, d in out.items()}
    yield root, data, out, waits
    for wait in waits.values():  # reaps the ranks of a job no test waited for
        wait(check=False)


@pytest.fixture(scope="module")
def steps(jobs):
    """The ranks' comparisons (``torch_ddp_worker.job_steps``) and, taken
    while the ranks run, JAX's step on each float32 case's global batch."""
    _, _, outs, waits = jobs
    out, wait = outs["steps"], waits["steps"]
    saved = worker.shallow_conformer()
    try:
        jax_ref = {}
        for case in FP32:
            cfg = worker.case_config(case)
            init = worker.build(cfg)[0].state_dict()
            jax_ref[case] = _jax_step(cfg, worker.make_batch(cfg, worker.global_clips(cfg)),
                                      init, out)
            jax_ref[case]["init"] = init
    finally:
        port_wrapper.ENCODERS["resnet-conformer"] = saved
        wait()
    with open(os.path.join(out, "steps.pkl"), "rb") as f:
        return pickle.load(f), jax_ref


def _jax_step(cfg, batch, init, out):
    """The JAX package's train step on the global batch from the port's
    seeded weights: its loss and BatchNorm running stats."""
    path = os.path.join(out, f"{cfg.args.encoder}-{cfg.args.loss}.yaml")
    save_config(cfg, path)
    jcfg = jax_config.load_config(path)
    jcfg = dataclasses.replace(jcfg, train=dataclasses.replace(jcfg.train,
                                                               dropout_rng="threefry"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_layers.U8Dropout, "__call__", lambda self, x: x)
        mp.setattr(jax_rc, "ResNetConformer", functools.partial(
            jax_rc.ResNetConformer, num_layers=worker.BLOCKS))
        jm = jax_build_model(jcfg)
        step = jax_train_step.build_train_step(jcfg, jm, jax_make_frontend(jcfg))
        v = flax_from_state_dict(init)
        params = jax.tree_util.tree_map(jnp.asarray, v["params"])
        state = jax_train_step.TrainState(
            params, jax.tree_util.tree_map(jnp.asarray, v["batch_stats"]),
            jax_train_step.make_optimizer(jcfg).init(params), jnp.zeros((), jnp.int32))
        state, loss = step(state, dict(batch), jax.random.PRNGKey(0))
    return {"loss": float(loss),
            "stats": jax.tree_util.tree_map(np.asarray, state.batch_stats)}


@pytest.mark.parametrize("case", FP32)
def test_global_step_loss_and_stats_fp32(steps, case):
    row = steps[0][case]
    got, want = row["loss"]
    assert abs(got - want) <= LOSS_REL * abs(want), (got, want)
    assert row["stats_err"] <= STATS_REL, row["stats_err"]
    assert row["ranks_equal"] and row["ranks_equal_f64"]  # gradients and running stats


@pytest.mark.parametrize("case", FP32)
def test_global_step_gradients(steps, case):
    row = steps[0][case]
    grads = row["grads_f64"]
    top = max(scale for _, scale in grads.values())
    assert len(grads) > 10
    for n, (err, scale) in grads.items():
        if scale <= 1e-8 * top:  # a true gradient of 0: the biases before a BatchNorm
            scale = top
        assert err <= GRAD_TOL * scale, (n, err, scale)
    got, want = row["loss_f64"]
    assert abs(got - want) <= 1e-12 * abs(want), (got, want)
    dp32, sp32, norm = row["grad_norms"]
    assert dp32 <= F32_GRAD_RATIO * sp32 + GRAD_TOL * norm, (dp32 / norm, sp32 / norm)


@pytest.mark.parametrize("case", FP32)
def test_global_step_matches_jax(steps, case):
    row, want = steps[0][case], steps[1][case]
    got = row["loss"][0]
    assert abs(got - want["loss"]) <= JAX_LOSS_REL * abs(want["loss"]), (got, want["loss"])
    stats = flax_from_state_dict({**want["init"], **{n: torch.as_tensor(t)
                                                     for n, t in row["stats"].items()}})
    got_t = dict(jax.tree_util.tree_leaves_with_path(stats["batch_stats"]))
    want_t = dict(jax.tree_util.tree_leaves_with_path(want["stats"]))
    assert got_t.keys() == want_t.keys() and want_t
    for path, w in want_t.items():
        np.testing.assert_allclose(np.asarray(got_t[path]), w, atol=JAX_STATS_TOL, rtol=0,
                                   err_msg=jax.tree_util.keystr(path))


def test_remat_equals_the_step_without_it(steps):
    row = steps[0]["conformer-adyolo-remat"]
    got, want = row["vs_no_remat"]["loss"]
    assert abs(got - want) <= REMAT_TOL * abs(want), (got, want)
    assert row["vs_no_remat"]["grad_err"] <= REMAT_TOL
    assert row["vs_no_remat"]["stats_err"] <= REMAT_TOL
    assert row["ranks_equal"]


def test_bf16_global_step_loss(steps):
    row = steps[0]["conformer-adyolo-bf16"]
    got, want = row["loss"]
    assert np.isfinite(got) and abs(got - want) <= BF16_LOSS_REL * abs(want), (got, want)
    assert row["ranks_equal"]


# ---- loader -----------------------------------------------------------------

@pytest.fixture(scope="module")
def synth(jobs):
    return jobs[0], jobs[1]


def _loader_cfgs(data, batch_size=4):
    jcfg = jax_config.Config()
    jcfg = dataclasses.replace(
        jcfg, data=dataclasses.replace(jcfg.data, data_pth=data, chunk_window_s=1,
                                       name_pth=os.path.join(data, "classes.txt")),
        aug=dataclasses.replace(jcfg.aug, rotation_augment=True),
        train=dataclasses.replace(jcfg.train, batch_size=batch_size, nb_iters=2,
                                  num_workers=0, max_targets_per_clip=16))
    return jcfg, port_config(jcfg)


def _epoch(cfg, rank, shards, seed=7):
    random.seed(seed)
    ds = SELDDataset(cfg, "train")
    return ds, list(TrainLoader(ds, cfg, rank, shards))


def test_loader_single_rank_is_the_jax_loader(synth):
    _, data = synth
    jcfg, cfg = _loader_cfgs(data)
    _, got = _epoch(cfg, 0, 1)
    random.seed(7)
    want = list(jax_dataset.TrainLoader(jax_dataset.SELDDataset(jcfg, "train"), jcfg))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_loader_rank_slices_partition_the_epoch(synth):
    _, data = synth
    _, cfg = _loader_cfgs(data)
    _, single = _epoch(cfg, 0, 1)
    states = [random.getstate()]
    per_rank = []
    for r in range(WORLD):
        per_rank.append(_epoch(cfg, r, WORLD)[1])
        states.append(random.getstate())
    # every rank consumes python's random as the single process does: the
    # checkpointed host state is the same on all of them
    assert all(st == states[0] for st in states)
    for batches in per_rank:
        assert len(batches) == len(single) == 2
    for i, whole in enumerate(single):
        for r, batches in enumerate(per_rank):
            b = batches[i]
            assert b["audio"].shape[0] == cfg.train.batch_size // WORLD
            # clip for clip (rotation included) the single-process batch's
            np.testing.assert_array_equal(b["audio"], whole["audio"][r::WORLD])


def test_loader_refuses_a_batch_the_ranks_do_not_divide(synth):
    _, data = synth
    _, cfg = _loader_cfgs(data, batch_size=3)
    with pytest.raises(ValueError, match="does not divide"):
        TrainLoader(SELDDataset(cfg, "train"), cfg, 0, WORLD)
    with pytest.raises(ValueError, match="does not divide"):
        mesh.check_batch(3, WORLD)
    mesh.check_batch(4, WORLD)


def test_rank_device_takes_the_local_card_and_refuses_a_shared_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert mesh._rank_device("cuda") == torch.device("cuda", 1)
    assert mesh._rank_device("cuda:0") == torch.device("cuda", 0)
    assert mesh._rank_device("cpu") == torch.device("cpu")
    monkeypatch.setenv("LOCAL_RANK", "2")
    with pytest.raises(RuntimeError, match="LOCAL_RANK 2 has no card of its own"):
        mesh._rank_device("cuda")


def test_without_a_group_the_mesh_is_one_process(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert mesh.init_distributed("cpu") == "cpu"
    assert (mesh.rank(), mesh.world_size(), mesh.is_main()) == (0, 1, True)
    x = torch.arange(3.0, requires_grad=True)
    assert mesh.all_reduce_sum(x) is x and mesh.all_reduce_counts(x) is x
    assert mesh.broadcast_object({"a": 1}) == {"a": 1} and mesh.any_rank(True)
    assert mesh.on_main(lambda: 7) == 7


# ---- engine -----------------------------------------------------------------

@pytest.fixture(scope="module")
def engine(jobs):
    _, _, outs, waits = jobs
    out = outs["engine"]
    waits["engine"]()
    recs = []
    for r in range(WORLD):
        with open(os.path.join(out, f"engine.r{r}.json")) as f:
            recs.append(json.load(f))
    return out, recs


def test_engine_one_experiment_and_rank0_writes(engine):
    out, (r0, r1) = engine
    results = os.path.join(out, "results")
    assert sorted(os.listdir(results)) == ["preempted", "quick", "resumed"]
    assert r1["events"] == {}  # rank 1 wrote, logged and evaluated nothing
    quick = r0["events"]["quick"]
    assert quick.count("save_config") == 2  # the fresh config, then epoch 3's τ
    assert quick.count("JsonlLogger") == 1
    assert quick.count("scan_conf_thresh") == 1
    assert quick.count("test_epoch") == 2 * 3 and quick.count("save_train_checkpoint") == 3
    exp = os.path.join(results, "quick")
    assert sorted(os.listdir(exp)) == ["hyp_exp.yaml", "logs.jsonl", "model_best.ckpt",
                                       "model_ckpt.ckpt", "output_eval", "output_test",
                                       "output_val"]
    with open(os.path.join(exp, "logs.jsonl")) as f:
        logs = [json.loads(ln) for ln in f]
    assert [r["step"] for r in logs if r["channel"] == "logs/train/loss"] == [1, 2, 3]


def test_engine_final_test_runs_once(engine):
    _, (r0, r1) = engine
    for run in ("quick", "resumed", "resume"):
        assert r0["events"][run].count("test_model") == 1, run
        assert r0["events"][run][-1] == "test_model"
    assert "test_model" not in r0["events"]["preempted"]


def test_engine_ranks_agree(engine):
    _, (r0, r1) = engine
    assert r0["losses"] == r1["losses"]  # the global batch's loss on both
    assert r0["steps"] == r1["steps"] and r0["steps"]["quick"] == [2, 2, 2]
    assert r0["conf_thresh"] == r1["conf_thresh"]
    assert all(np.isfinite(r0["losses"]["quick"]))


def test_engine_stop_on_one_rank_stops_both(engine):
    out, (r0, r1) = engine
    assert r0["steps"]["preempted"] == r1["steps"]["preempted"] == [1]
    assert r0["events"]["preempted"] == ["save_config", "JsonlLogger",
                                         "save_train_checkpoint"]
    ckpt = torch.load(os.path.join(out, "results", "preempted", "model_ckpt.ckpt"),
                      weights_only=False)
    assert ckpt["host"]["start_epoch_nb"] == 1


def test_engine_resume_reproduces_the_uninterrupted_run(engine):
    out, (r0, _) = engine
    quick = r0["losses"]["quick"]
    assert len(quick) == 6
    assert r0["losses"]["resumed"] + r0["losses"]["resume"] == quick
    assert r0["conf_thresh"]["resume"] == r0["conf_thresh"]["quick"]
