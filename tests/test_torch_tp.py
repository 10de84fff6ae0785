"""Tensor parallelism in the port (``--model_parallel``), on the CPU: rank
processes (``tests/torch_tp_worker.py``, torch only) in gloo groups, the
counterpart of ``tests/test_tp_mesh.py``.  The conformer at 2 blocks,
2-s clips (80 feature frames), B = 4, AD-YOLO.

(a) The rules: the port's sharded state-dict entries, mapped through
``convert``, are JAX's ``state_shardings`` set at N = 2 (params and
batch_stats), each cut along JAX's axis; Adam's moments follow.
(b) ``shard_state_dict`` then joining the ranks' pieces is the identity,
the GLU's halves paired on each rank.
(c) The keep bits of heads ``[2, 4)`` at ``heads=(2, 4)`` are the full
call's, and so are the attention output and gradients (plain versions:
float32 and bfloat16; the kernels themselves in
``tests/test_torch_attention.py -m cuda`` and ``chip_smoke.py``'s phase
``tp``).
(d) Two ranks, one model group, dropout on, against the single-process
step on the same batch and generator: float64 loss within 1e-12 rel and
every gradient within 1e-8 of its max|grad| (measured ~1e-14); float32
loss within 1e-5 rel and the whole gradient's L2 distance from float64 at
most 2x the single-process float32 step's own.  The replicated
parameters' gradients are equal on both ranks, and rank 1, built from
another seed, trained rank 0's weights.
(e) Four ranks, dp 2 x tp 2, float64: dropout off against the
single-process step on the global batch, dropout on against the 2-replica
data-parallel step of the unsharded model (a data replica's dropout bits
are its own, as at model_parallel 1), both within (d)'s float64
tolerances.
(f) The 2-rank float32 step (dropout off) against JAX's single-device
``build_train_step`` from the same weights: loss and BatchNorm running
stats within ``tests/test_torch_train_step.py``'s 1e-4 rel and abs.
(g) ``remat`` under TP gives TP's step without it (1e-6); bf16 under TP is
within 1e-2 rel of the single-process bf16 step.
(h) ``cli train --model_parallel 2`` on 2 ranks: one experiment dir per
run, rank 0 alone writes and evaluates, the final test once; the best
checkpoint loads in JAX's ``load_checkpoint`` and in a single-process
port model, the rolling one holds the full shapes; a run of 1 epoch
resumed for 2 more gives the uninterrupted run's step losses.
(i) The refusals that stay (N below 1 or not dividing the ranks, a batch
the replicas do not divide), the layouts taken where N does not divide
the heads or the encoder has no conformer blocks
(``tests/test_torch_tp_replicated.py`` trains them), and the flag's
parsing.

The three jobs start together (8 rank processes, one thread each).
"""
import dataclasses
import functools
import json
import os
import pickle

import numpy as np
import jax
import pytest
import torch
import yaml

from adyolo_tpu import config as jax_config
from adyolo_tpu.config import MeshConfig
from adyolo_tpu.engine import checkpoint as jax_checkpoint
from adyolo_tpu.engine.evaluate import make_frontend as jax_make_frontend
from adyolo_tpu.models import resnet_conformer as jax_rc
from adyolo_tpu.models.wrapper import build_model as jax_build_model
from adyolo_tpu.parallel.mesh import make_mesh, state_shardings
from adyolo_tpu.parallel.train_step import init_state
from adyolo_tpu_torch import cli
from adyolo_tpu_torch.config import Config, build_config, load_config
from adyolo_tpu_torch.convert import flax_from_state_dict, state_dict_from_flax
from adyolo_tpu_torch.engine import train as port_train
from adyolo_tpu_torch.engine.checkpoint import load_jax_checkpoint
from adyolo_tpu_torch.models import resnet_conformer as port_rc
from adyolo_tpu_torch.models import wrapper as port_wrapper
from adyolo_tpu_torch.ops import attention, hopper_attention
from adyolo_tpu_torch.parallel import mesh

from tests import torch_ddp_worker as ddp
from tests import torch_tp_worker as worker
from tests.test_torch_config import one_torch_thread, module_tmp  # noqa: F401
from tests.synth_data import make_synth_dataset
from tests.test_torch_ddp import _jax_step, _run_ranks

pytestmark = pytest.mark.usefixtures("one_torch_thread")

F64_LOSS_REL = 1e-12
F64_GRAD_TOL = 1e-8
F32_LOSS_REL = 1e-5
F32_GRAD_RATIO = 2.0
REMAT_TOL = 1e-6
BF16_LOSS_REL = 1e-2
JAX_LOSS_REL = 1e-4
JAX_STATS_TOL = 1e-4
JOBS = {"tp": 2, "grid": 4, "engine": 2}  # job: ranks


# ---- the jobs -----------------------------------------------------------------

@pytest.fixture(scope="module")
def jobs(module_tmp):
    """Every job's rank processes, started together."""
    root = str(module_tmp("tp"))
    out = {job: os.path.join(root, job) for job in JOBS}
    os.makedirs(out["tp"])
    os.makedirs(out["grid"])
    _write_engine_set(os.path.join(root, "data"), os.path.join(out["engine"], "configs"))
    waits = {job: _run_ranks(job, d, JOBS[job], "tests.torch_tp_worker")
             for job, d in out.items()}
    yield out, waits
    for wait in waits.values():
        wait(check=False)


def _write_engine_set(data, configs):
    """The synthetic DCASE2022 set of ``tests/test_torch_ddp.py``'s engine
    job, with one val and one test clip (the evaluations are most of the
    job's time), and its presets."""
    data = make_synth_dataset(data, n_train=8, n_val=1, n_test=1, train_secs=1,
                              eval_secs=2, chunk_window_s=1, seed=4)
    os.makedirs(configs)
    with open(os.path.join(configs, "hyp_data_DCASE2022.yaml"), "w") as f:
        yaml.safe_dump({"data_pth": data, "name_pth": os.path.join(data, "classes.txt"),
                        "chunk_window_s": 1}, f)
    with open(os.path.join(configs, "hyp_train.yaml"), "w") as f:
        yaml.safe_dump({"max_targets_per_clip": 64}, f)


def _load(jobs, job, name):
    out, waits = jobs
    waits[job]()
    with open(os.path.join(out[job], name), "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def tp(jobs):
    """The 2-rank comparisons and, taken while the ranks run, JAX's step on
    the f32-nodrop case's batch from the same weights."""
    saved = ddp.shallow_conformer()
    try:
        cfg = worker.case_config({})
        init = worker.build(cfg, dropout=False)[0].state_dict()
        jax_ref = _jax_step(cfg, ddp.make_batch(cfg, ddp.global_clips(cfg)), init,
                            jobs[0]["tp"])
        jax_ref["init"] = init
    finally:
        port_wrapper.ENCODERS["resnet-conformer"] = saved
    return _load(jobs, "tp", "tp.pkl"), jax_ref


def _hold_f64(row):
    got, want = row["loss"]
    assert abs(got - want) <= F64_LOSS_REL * abs(want), (got, want)
    grads = row["grads"]
    top = max(scale for _, scale in grads.values())
    assert len(grads) > 10
    for n, (err, scale) in grads.items():
        if scale <= 1e-8 * top:  # a true gradient of 0: the biases before a BatchNorm
            scale = top
        assert err <= F64_GRAD_TOL * scale, (n, err, scale)


# ---- (a), (b): the rules ------------------------------------------------------

def _flax_paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flax_paths(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_tp_rules_shard_what_jax_shards():
    """The port's sharded entries at N = 2 are JAX's sharded leaves (params
    and batch_stats of the full-size conformer), each cut along JAX's
    sharded axis to half its length."""
    jcfg = dataclasses.replace(jax_config.Config(),
                               args=jax_config.RunConfig(encoder="resnet-conformer"),
                               mesh=MeshConfig(model_parallel=2))
    struct = jax.eval_shape(lambda: init_state(jcfg, jax_build_model(jcfg),
                                               jax_make_frontend(jcfg), jax.random.PRNGKey(0)))
    sh = state_shardings(struct, make_mesh(jcfg.mesh, batch_size=8))
    want = {}
    for coll, tree in (("params", sh.params), ("batch_stats", sh.batch_stats)):
        for path, s in jax.tree_util.tree_flatten_with_path(tree)[0]:
            if s.spec != jax.sharding.PartitionSpec():
                want[(coll,) + tuple(k.key for k in path)] = list(s.spec).index("model")
    with torch.device("meta"):
        meta = port_wrapper.SELDModel("resnet-conformer", "adyolo")
    keys, plan = meta.state_dict(), mesh.tp_plan(meta, 2)
    full = {k: torch.zeros(v.shape) for k, v in keys.items() if plan.rule(k)}
    got = dict(_flax_paths(flax_from_state_dict(full)))
    shard = dict(_flax_paths(flax_from_state_dict(mesh.shard_state_dict(full, plan, 1))))
    assert got.keys() == want.keys() and len(want) == 8 * 26
    for path, axis in want.items():
        halved = list(got[path].shape)
        halved[axis] //= 2
        assert list(shard[path].shape) == halved, path
    assert not any(plan.rule(k) for k in keys if ".conformer" not in k)


def test_adam_moments_follow_the_parameters():
    saved = ddp.shallow_conformer()
    try:
        model = worker.build(worker.case_config({}), dropout=False)[0]
    finally:
        port_wrapper.ENCODERS["resnet-conformer"] = saved
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    names, plan = [n for n, _ in model.named_parameters()], mesh.tp_plan(model, 2)
    params = mesh.shard_state_dict(dict(model.named_parameters()), plan, 1)
    osd = mesh.shard_optimizer_state(opt.state_dict(), names, plan, 1)
    n_sharded = 0
    for idx, st in osd["state"].items():
        assert st["exp_avg"].shape == st["exp_avg_sq"].shape == params[names[idx]].shape
        assert st["step"] == 1
        n_sharded += plan.rule(names[idx]) is not None
    assert n_sharded == 2 * 22  # 22 sharded parameters a block (26 entries with the stats)


def test_shard_then_join_is_the_identity():
    saved = ddp.shallow_conformer()
    try:
        model = worker.build(worker.case_config({}), dropout=False)[0]
    finally:
        port_wrapper.ENCODERS["resnet-conformer"] = saved
    sd, plan = model.state_dict(), mesh.tp_plan(model, 2)
    pieces = [mesh.shard_state_dict(sd, plan, r) for r in range(2)]
    for k, t in sd.items():
        kind = plan.rule(k)
        if kind is None:
            assert all(p[k] is t for p in pieces), k
            continue
        assert torch.equal(mesh.join_tensor([p[k] for p in pieces], kind), t), k
    # the GLU: rank 1 holds a's second half, then b's
    w = sd["encoder.conformer0.conv.pw1.weight"]
    d = w.shape[0] // 2
    assert torch.equal(pieces[1]["encoder.conformer0.conv.pw1.weight"],
                       torch.cat([w[d // 2:d], w[d + d // 2:]]))


# ---- (c): the head shard's dropout bits -----------------------------------------

def test_dropout_bits_of_a_head_shard_are_the_full_calls():
    seed = torch.tensor([-123456], dtype=torch.int32)
    full = attention.dropout_bits(2, 4, 200, seed)
    for h0 in (0, 1, 2):
        got = attention.dropout_bits(2, 2, 200, seed, heads=(h0, 4))
        assert torch.equal(got, full[:, h0:h0 + 2])
    assert torch.equal(attention.dropout_bits(2, 4, 200, seed, heads=(0, 4)), full)
    with pytest.raises(ValueError, match="do not lie"):
        attention.dropout_bits(2, 2, 200, seed, heads=(3, 4))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_of_a_head_shard_is_the_full_calls(dtype):
    """Heads [2, 4) at heads=(2, 4), rate 0.2, with a ragged kv_len: the
    output and q/k/v gradients equal the full call's heads [2, 4)."""
    rng = np.random.default_rng(5)
    q, k, v, do = (torch.tensor(rng.standard_normal((2, 160, 4, 64)), dtype=dtype)
                   for _ in range(4))
    kv = torch.tensor([160, 97], dtype=torch.int32)
    seed = torch.tensor([777], dtype=torch.int32)

    def run(q, k, v, do, heads=None):
        args = [x.clone().requires_grad_(True) for x in (q, k, v)]
        out = hopper_attention.flash_attention(*args, kv, rate=0.2, seed=seed, heads=heads)
        out.backward(do)
        return [out.detach()] + [a.grad for a in args]

    full = run(q, k, v, do)
    part = run(*(x[:, :, 2:].contiguous() for x in (q, k, v, do)), heads=(2, 4))
    for got, want in zip(part, full):
        assert torch.equal(got, want[:, :, 2:])
    other = run(*(x[:, :, 2:].contiguous() for x in (q, k, v, do)))  # heads (0, 2)
    assert not torch.equal(other[0], full[0][:, :, 2:])


# ---- (d), (f), (g): two ranks, one model group ----------------------------------

def test_tp_step_is_the_single_process_step_f64(tp):
    row = tp[0]["f64"]
    _hold_f64(row)
    assert row["replicated_equal"]


def test_tp_step_is_the_single_process_step_f32(tp):
    row = tp[0]["f32"]
    got, want = row["loss"]
    assert abs(got - want) <= F32_LOSS_REL * abs(want), (got, want)
    tp32, sp32, norm = row["grad_norms"]
    assert tp32 <= F32_GRAD_RATIO * sp32, (tp32 / norm, sp32 / norm)
    assert row["replicated_equal"]


def test_tp_ranks_hold_shards(tp):
    """Each rank holds half of fc1's and pw1's rows, half the depthwise
    channels and 2 of the 4 heads (rank 0's: heads 0 and 1)."""
    for row in tp[0].values():
        assert row["shapes"] == {"fc1": (512, 256), "pw1": (256, 256), "dw": (128, 1, 3),
                                 "heads": 2, "head_range": (0, 4)}


def test_tp_step_matches_jax(tp):
    row, want = tp
    row, want = row["f32-nodrop"], want
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


def test_tp_remat_equals_tp_without_it(tp):
    row = tp[0]["remat"]
    got, want = row["loss"]
    assert abs(got - want) <= REMAT_TOL * abs(want), (got, want)
    top = max(scale for _, scale in row["grads"].values())
    assert max(err for err, _ in row["grads"].values()) <= REMAT_TOL * top
    assert row["stats_err"] <= REMAT_TOL and row["replicated_equal"]


def test_tp_bf16_step_loss(tp):
    row = tp[0]["bf16"]
    got, want = row["loss"]
    assert np.isfinite(got) and abs(got - want) <= BF16_LOSS_REL * abs(want), (got, want)
    assert row["replicated_equal"]


# ---- (e): dp 2 x tp 2 -----------------------------------------------------------

@pytest.fixture(scope="module")
def grid(jobs):
    return _load(jobs, "grid", "grid.pkl")


@pytest.mark.parametrize("case", ["nodrop", "dropout"])
def test_grid_step(grid, case):
    assert grid["grid"] == [2, 2]
    _hold_f64(grid[case])


# ---- (h): the engine ------------------------------------------------------------

@pytest.fixture(scope="module")
def engine(jobs):
    out, waits = jobs
    waits["engine"]()
    recs = []
    for r in range(JOBS["engine"]):
        with open(os.path.join(out["engine"], f"engine.r{r}.json")) as f:
            recs.append(json.load(f))
    return os.path.join(out["engine"], "results"), recs


def test_tp_engine_one_experiment_and_rank0_writes(engine):
    results, (r0, r1) = engine
    assert sorted(os.listdir(results)) == ["preempted", "quick", "resumed"]
    assert r1["events"] == {}  # rank 1 wrote, logged and evaluated nothing
    quick = r0["events"]["quick"]
    assert quick.count("test_epoch") == 2 * 3 and quick.count("save_train_checkpoint") == 3
    for run in ("quick", "resumed", "resume"):
        assert r0["events"][run].count("test_model") == 1 and r0["events"][run][-1] == "test_model"
    assert r0["events"]["preempted"] == ["save_config", "JsonlLogger", "save_train_checkpoint"]
    assert load_config(os.path.join(results, "quick", "hyp_exp.yaml")).mesh.model_parallel == 2


def test_tp_engine_ranks_agree_and_resume_reproduces(engine):
    _, (r0, r1) = engine
    assert r0["losses"] == r1["losses"] and r0["steps"] == r1["steps"]
    assert r0["steps"]["quick"] == [2, 2, 2] and r0["steps"]["preempted"] == [1]
    quick = r0["losses"]["quick"]
    assert len(quick) == 6 and all(np.isfinite(quick))
    assert r0["losses"]["resumed"] + r0["losses"]["resume"] == quick
    assert r0["conf_thresh"] == r1["conf_thresh"]


def test_tp_checkpoints_are_full_and_load_in_jax_and_one_process(engine, monkeypatch):
    results, _ = engine
    exp = os.path.join(results, "quick")
    cfg = load_config(os.path.join(exp, "hyp_exp.yaml"))
    variables, host = load_jax_checkpoint(os.path.join(exp, "model_best.ckpt"))
    saved = ddp.shallow_conformer()
    try:
        model = port_wrapper.build_model(cfg, device="cpu")
        model.load_state_dict(state_dict_from_flax(variables, "resnet-conformer"), strict=True)
    finally:
        port_wrapper.ENCODERS["resnet-conformer"] = saved
    rolling = torch.load(os.path.join(exp, "model_ckpt.ckpt"), weights_only=False)
    model.load_state_dict(rolling["model"], strict=True)
    names = [n for n, _ in model.named_parameters()]
    for idx, st in rolling["optimizer"]["state"].items():
        assert st["exp_avg"].shape == model.get_parameter(names[idx]).shape
    jcfg = jax_config.load_config(os.path.join(exp, "hyp_exp.yaml"))
    monkeypatch.setattr(jax_rc, "ResNetConformer", functools.partial(
        jax_rc.ResNetConformer, num_layers=ddp.BLOCKS))
    jm = jax_build_model(jcfg, "float32")
    # the full template: the file holds the gathered Adam state in optax's
    # structure, at the full model's shapes
    template = jax.eval_shape(lambda: init_state(jcfg, jm, jax_make_frontend(jcfg),
                                                 jax.random.PRNGKey(0)))
    state, jhost = jax_checkpoint.load_checkpoint(os.path.join(exp, "model_best.ckpt"),
                                                  template)
    assert jhost == host and 1 <= host["epoch_nb"] <= 3
    for got, want in zip(jax.tree_util.tree_leaves(state.opt_state),
                         jax.tree_util.tree_leaves(template.opt_state)):
        assert np.shape(got) == want.shape
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           jax.tree_util.tree_map(np.asarray, state.params), variables["params"])


# ---- (i): refusals and the flag ---------------------------------------------------

def test_model_parallel_refusals(monkeypatch):
    """The refusals that stay: N below 1, N not dividing the ranks, a batch
    that the data replicas do not divide.  SE-ResNet34 at N = 2 and the
    conformer at N = 3 and 8 (4 heads) are taken: ``shard_conformer_``
    leaves SE-ResNet34 whole, shards nothing of the conformer at N = 3
    (1024, 256 and 4 heads are not divisible by 3) and, at N = 8, its FFNs
    and conv modules while each MHSA stays whole."""
    with pytest.raises(ValueError, match="does not divide the 4 ranks"):
        mesh.check_model_parallel(3, 4)
    with pytest.raises(ValueError, match="at least 1"):
        mesh.check_model_parallel(0, 4)
    mesh.check_model_parallel(4, 8)
    mesh.check_model_parallel(8, 8)  # more ranks than heads
    with pytest.raises(ValueError, match="does not divide the 1 ranks"):
        mesh.set_model_parallel(2)  # one process, no group
    cfg = Config()

    def config(encoder, n, batch_size=cfg.train.batch_size):
        return dataclasses.replace(
            cfg, args=dataclasses.replace(cfg.args, encoder=encoder),
            mesh=dataclasses.replace(cfg.mesh, model_parallel=n),
            train=dataclasses.replace(cfg.train, batch_size=batch_size))

    monkeypatch.setattr(mesh, "world_size", lambda: 6)
    with pytest.raises(ValueError, match="does not divide the 6 ranks"):
        port_train.check_trainable(config("resnet-conformer", 4))
    with pytest.raises(ValueError, match="does not divide across 2 ranks"):
        port_train.check_trainable(config("se-resnet34", 3, batch_size=5))
    for encoder, n, world in (("se-resnet34", 2, 4), ("resnet-conformer", 3, 6),
                              ("resnet-conformer", 8, 8)):
        monkeypatch.setattr(mesh, "world_size", lambda: world)
        c = config(encoder, n)
        port_train.check_trainable(c)
        model = port_wrapper.build_model(c, device="meta")
        shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
        plan = mesh.tp_plan(model, n)
        port_rc.shard_conformer_(model.encoder, None, 0, plan)
        cut = {k: tuple(v.shape) for k, v in model.state_dict().items() if v.shape != shapes[k]}
        if encoder == "se-resnet34" or n == 3:
            assert not plan.sharded and not cut
            continue
        assert plan.sharded == {"ffn1", "ffn2", "conv"}
        block = model.encoder.conformer0
        assert block.ffn1.fc1.weight.shape == (128, 256) and block.conv.pw1.weight.shape == (64, 256)
        assert block.conv.dw_conv.weight.shape == (32, 1, 3) and block.ffn1.drop1.shard == (0, 8)
        assert block.mhsa.heads == 4 and block.mhsa.head_range is None and block.mhsa.tp is None
        assert block.mhsa.query.weight.shape == (256, 256)
        assert all(".mhsa." not in k for k in cut) and len(cut) == 8 * 19


def test_model_parallel_flag_parses():
    assert build_config({"dataset": "DCASE2022", "model_parallel": 2}).mesh.model_parallel == 2
    assert build_config({"dataset": "DCASE2022"}).mesh.model_parallel == 1
    for action in ("train", "val", "test", "infer", "export"):
        args = cli.build_parser().parse_args([action, "--model_parallel", "2"])
        cli._refuse(args)  # taken, not refused
        assert args.model_parallel == 2
