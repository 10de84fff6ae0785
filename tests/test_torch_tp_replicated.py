"""Tensor parallelism of what N does not cut (``--model_parallel``), on the
CPU: rank processes (``tests/torch_tp_replicated_worker.py``, torch only)
in gloo groups.  The JAX package shards a leaf only where N divides it and
replicates the others (``adyolo_tpu/parallel/mesh.py::_tp_spec``); the
port shards a conformer module where N cuts it cleanly and holds every
other module, and all of SE-ResNet34, whole on each rank of the group.

(a) The layout: at N = 2, 3 and 8, for the full-size conformer and for
SE-ResNet34, the port's sharded state-dict entries, mapped through
``convert``, are JAX's ``state_shardings`` set on a (1, N) mesh, except
the MHSA's q/k/v and output ``linear`` where N does not divide the 4
heads (N = 8: JAX cuts them through a head, the port keeps the MHSA
whole); each entry is cut along JAX's axis.  SE-ResNet34 shards nothing.
Under the mixed plans (N = 3 at ``emb_dim`` 96, N = 8 at 256: FFNs and
conv modules cut, the MHSA whole) the ranks' pieces of the weights, stats
and Adam moments join into the full ones.
(b) Three ranks at N = 3, the conformer at 2 blocks and ``emb_dim`` 96:
the FFNs and conv modules sharded 3 ways, the MHSA whole; dropout 0.2,
float64, against the single-process step on the same batch and
generator: loss within 1e-12 rel, each gradient within 1e-8 of its
max|grad|, the replicated gradients equal on every rank.
(c) Two ranks at N = 2 with SE-ResNet34 (every parameter whole): the same
float64 gates; the float32 step with dropout off against JAX's
``build_train_step`` on a (1, 2) mesh from the same weights: loss and
BatchNorm running stats within 1e-4 rel and abs, the gates of
``tests/test_torch_tp.py::test_tp_step_matches_jax``.
(d) ``cli train --encoder se-resnet34 --model_parallel 2`` on two ranks:
rank 0 alone writes and evaluates, the ranks' losses agree, a resumed run
reproduces the uninterrupted one; ``model_best.ckpt`` loads in JAX's
``load_checkpoint`` with the full template and in a single-process port
model.

The three jobs start together (7 rank processes, one thread each).
"""
import dataclasses
import functools
import json
import os
import pickle

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from adyolo_tpu import config as jax_config
from adyolo_tpu.config import MeshConfig
from adyolo_tpu.engine import checkpoint as jax_checkpoint
from adyolo_tpu.engine.evaluate import make_frontend as jax_make_frontend
from adyolo_tpu.models import layers as jax_layers
from adyolo_tpu.models.wrapper import build_model as jax_build_model
from adyolo_tpu.parallel import train_step as jax_train_step
from adyolo_tpu.parallel.mesh import make_mesh, state_shardings
from adyolo_tpu_torch.config import load_config, save_config
from adyolo_tpu_torch.convert import flax_from_state_dict, state_dict_from_flax
from adyolo_tpu_torch.engine.checkpoint import load_jax_checkpoint
from adyolo_tpu_torch.models import resnet_conformer as port_rc
from adyolo_tpu_torch.models import wrapper as port_wrapper
from adyolo_tpu_torch.parallel import mesh

from tests import torch_ddp_worker as ddp
from tests.test_torch_config import one_torch_thread, module_tmp  # noqa: F401
from tests.test_torch_ddp import _run_ranks
from tests.test_torch_tp import _flax_paths, _hold_f64, _write_engine_set

pytestmark = pytest.mark.usefixtures("one_torch_thread")

JAX_LOSS_REL = 1e-4
JAX_STATS_TOL = 1e-4
JOBS = {"n3": 3, "se": 2, "engine": 2}  # job: ranks
ENCODERS = ["resnet-conformer", "se-resnet34"]
MHSA_LEAVES = ("query", "key", "value", "linear")


@pytest.fixture(scope="module")
def jobs(module_tmp):
    """Every job's rank processes, started together."""
    root = str(module_tmp("tp_replicated"))
    out = {job: os.path.join(root, job) for job in JOBS}
    os.makedirs(out["n3"])
    os.makedirs(out["se"])
    _write_engine_set(os.path.join(root, "data"), os.path.join(out["engine"], "configs"))
    waits = {job: _run_ranks(job, d, JOBS[job], "tests.torch_tp_replicated_worker")
             for job, d in out.items()}
    yield out, waits
    for wait in waits.values():
        wait(check=False)


def _load(jobs, job):
    out, waits = jobs
    waits[job]()
    with open(os.path.join(out[job], f"{job}.pkl"), "rb") as f:
        return pickle.load(f)


# ---- (a): the layout against JAX's -------------------------------------------

@pytest.mark.parametrize("encoder", ENCODERS)
@pytest.mark.parametrize("n", [2, 3, 8])
def test_plan_matches_jax_state_shardings(encoder, n):
    jcfg = dataclasses.replace(jax_config.Config(),
                               args=jax_config.RunConfig(encoder=encoder),
                               mesh=MeshConfig(model_parallel=n))
    struct = jax.eval_shape(lambda: jax_train_step.init_state(
        jcfg, jax_build_model(jcfg), jax_make_frontend(jcfg), jax.random.PRNGKey(0)))
    jmesh = make_mesh(jcfg.mesh, devices=jax.devices()[:n])
    assert dict(jmesh.shape) == {"data": 1, "model": n}
    sh = state_shardings(struct, jmesh)
    jax_cut = {}
    for coll, tree in (("params", sh.params), ("batch_stats", sh.batch_stats)):
        for path, s in jax.tree_util.tree_flatten_with_path(tree)[0]:
            if s.spec != jax.sharding.PartitionSpec():
                jax_cut[(coll,) + tuple(k.key for k in path)] = list(s.spec).index("model")
    through_heads = {p for p in jax_cut if "mhsa" in p and p[-2] in MHSA_LEAVES}
    with torch.device("meta"):
        model = port_wrapper.SELDModel(encoder, "adyolo")
    plan = mesh.tp_plan(model, n)
    full = {k: torch.zeros(v.shape) for k, v in model.state_dict().items() if plan.rule(k)}
    got = dict(_flax_paths(flax_from_state_dict(full))) if full else {}
    if encoder == "se-resnet34" or n == 3:
        assert not jax_cut and not plan.sharded and not got
        return
    if n == 8:  # JAX cuts q/k/v through a head; the port keeps the MHSA whole
        assert len(through_heads) == 8 * 7 and plan.sharded == {"ffn1", "ffn2", "conv"}
        want = {p: a for p, a in jax_cut.items() if p not in through_heads}
    else:
        assert plan.sharded == {"ffn1", "ffn2", "mhsa", "conv"}
        want = jax_cut
    assert got.keys() == want.keys() and len(want) == 8 * (26 if n == 2 else 19)
    shard = dict(_flax_paths(flax_from_state_dict(mesh.shard_state_dict(full, plan, n - 1))))
    for path, axis in want.items():
        cut = list(got[path].shape)
        cut[axis] //= n
        assert list(shard[path].shape) == cut, path


@pytest.mark.parametrize("n, emb", [(3, 96), (8, 256)])
def test_mixed_plan_shard_then_join_is_the_identity(n, emb, monkeypatch):
    """Under a plan that shards the FFNs and conv modules and keeps the
    MHSA whole, the ranks' pieces of the weights, stats and Adam moments
    join into the full ones, and an entry held whole is the full tensor on
    every rank."""
    monkeypatch.setitem(port_wrapper.ENCODERS, "resnet-conformer", functools.partial(
        port_rc.ResNetConformer, num_layers=ddp.BLOCKS))
    model = port_wrapper.SELDModel("resnet-conformer", "adyolo", enc_out_dim=emb)
    plan = mesh.tp_plan(model, n)
    assert plan.sharded == {"ffn1", "ffn2", "conv"}
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    gen = torch.Generator().manual_seed(0)
    for p in model.parameters():
        p.grad = torch.randn(p.shape, generator=gen)
    opt.step()
    sd, names = model.state_dict(), [k for k, _ in model.named_parameters()]
    pieces = [mesh.shard_state_dict(sd, plan, r) for r in range(n)]
    moments = [mesh.shard_optimizer_state(opt.state_dict(), names, plan, r)["state"]
               for r in range(n)]
    for k, t in sd.items():
        kind = plan.rule(k)
        if kind is None:
            assert all(p[k] is t for p in pieces), k
        else:
            assert torch.equal(mesh.join_tensor([p[k] for p in pieces], kind), t), k
    n_cut = 0
    for idx, st in opt.state_dict()["state"].items():
        kind = plan.rule(names[idx])
        n_cut += kind is not None
        for key in ("exp_avg", "exp_avg_sq"):
            got = [m[idx][key] for m in moments]
            assert all(g.shape == p[names[idx]].shape for g, p in zip(got, pieces))
            assert torch.equal(got[0] if kind is None else mesh.join_tensor(got, kind),
                               st[key]), names[idx]
    assert n_cut == ddp.BLOCKS * 15  # FFN 3 + 3, conv 9 parameters a block


# ---- (b): N = 3, the MHSA whole -------------------------------------------------

@pytest.fixture(scope="module")
def n3(jobs):
    return _load(jobs, "n3")


def test_n3_layout(n3):
    """Each rank holds a third of fc1's and pw1's rows and of the
    depthwise channels, and the whole MHSA: 4 heads, no head range, no
    group; the FFN's first dropout draws the full tensor's bits."""
    assert n3["sharded"] == ["conv", "ffn1", "ffn2"]
    assert n3["layout"] == {"fc1": (128, 96), "pw1": (64, 96), "dw": (32, 1, 3),
                            "query": (96, 96), "heads": 4, "head_range": None,
                            "mhsa_tp": False, "ffn_shard": (0, 3)}


def test_n3_step_is_the_single_process_step_f64(n3):
    _hold_f64(n3)
    assert n3["replicated_equal"]


# ---- (c): SE-ResNet34 at N = 2 -------------------------------------------------

@pytest.fixture(scope="module")
def se(jobs):
    """The 2-rank comparisons and, taken while the ranks run, JAX's step on
    a (1, 2) mesh on the f32-nodrop case's batch from the same weights."""
    cfg = ddp.case_config("se-adyolo")
    init = ddp.build(cfg)[0].state_dict()
    jax_ref = _jax_tp_step(cfg, ddp.make_batch(cfg, ddp.global_clips(cfg)), init,
                           jobs[0]["se"], 2)
    jax_ref["init"] = init
    return _load(jobs, "se"), jax_ref


def _jax_tp_step(cfg, batch, init, out, n):
    """The JAX package's train step on a (1, ``n``) mesh, dropout off, from
    the port's weights: its loss and BatchNorm running stats."""
    path = os.path.join(out, "se.yaml")
    save_config(cfg, path)
    jcfg = jax_config.load_config(path)
    jcfg = dataclasses.replace(jcfg, train=dataclasses.replace(jcfg.train,
                                                               dropout_rng="threefry"),
                               mesh=dataclasses.replace(jcfg.mesh, model_parallel=n))
    jmesh = make_mesh(jcfg.mesh, devices=jax.devices()[:n])
    assert dict(jmesh.shape) == {"data": 1, "model": n}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_layers.U8Dropout, "__call__", lambda self, x: x)
        step = jax_train_step.build_train_step(jcfg, jax_build_model(jcfg),
                                               jax_make_frontend(jcfg), jmesh)
        place = jax_train_step.make_batch_placer(jcfg, jmesh)
        v = flax_from_state_dict(init)
        params = jax.tree_util.tree_map(jnp.asarray, v["params"])
        state = jax_train_step.TrainState(
            params, jax.tree_util.tree_map(jnp.asarray, v["batch_stats"]),
            jax_train_step.make_optimizer(jcfg).init(params), jnp.zeros((), jnp.int32))
        state, loss = step(state, place(dict(batch)), jax.random.PRNGKey(0))
    return {"loss": float(loss),
            "stats": jax.tree_util.tree_map(np.asarray, state.batch_stats)}


def test_se_holds_everything_whole(se):
    for row in se[0].values():
        assert row["sharded"] == [] and row["layout"] is None


def test_se_tp_step_is_the_single_process_step_f64(se):
    row = se[0]["f64"]
    _hold_f64(row)
    assert row["replicated_equal"]


def test_se_tp_step_matches_jax(se):
    row, want = se[0]["f32-nodrop"], se[1]
    assert row["replicated_equal"]
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


# ---- (d): the engine -------------------------------------------------------------

@pytest.fixture(scope="module")
def engine(jobs):
    out, waits = jobs
    waits["engine"]()
    recs = []
    for r in range(JOBS["engine"]):
        with open(os.path.join(out["engine"], f"engine.r{r}.json")) as f:
            recs.append(json.load(f))
    return os.path.join(out["engine"], "results"), recs


def test_se_tp_engine_rank0_writes_and_ranks_agree(engine):
    results, (r0, r1) = engine
    assert sorted(os.listdir(results)) == ["preempted", "quick", "resumed"]
    assert r1["events"] == {}  # rank 1 wrote, logged and evaluated nothing
    quick = r0["events"]["quick"]
    assert quick.count("test_epoch") == 2 * 3 and quick.count("save_train_checkpoint") == 3
    for run in ("quick", "resumed", "resume"):
        assert r0["events"][run].count("test_model") == 1
    cfg = load_config(os.path.join(results, "quick", "hyp_exp.yaml"))
    assert cfg.mesh.model_parallel == 2 and cfg.args.encoder == "se-resnet34"
    assert r0["losses"] == r1["losses"] and r0["steps"]["quick"] == [2, 2, 2]
    assert all(np.isfinite(r0["losses"]["quick"]))
    assert r0["losses"]["resumed"] + r0["losses"]["resume"] == r0["losses"]["quick"]


def test_se_tp_checkpoint_loads_in_jax_and_one_process(engine):
    results, _ = engine
    exp = os.path.join(results, "quick")
    cfg = load_config(os.path.join(exp, "hyp_exp.yaml"))
    variables, host = load_jax_checkpoint(os.path.join(exp, "model_best.ckpt"))
    model = port_wrapper.build_model(cfg, device="cpu")
    model.load_state_dict(state_dict_from_flax(variables, "se-resnet34"), strict=True)
    rolling = torch.load(os.path.join(exp, "model_ckpt.ckpt"), weights_only=False)
    model.load_state_dict(rolling["model"], strict=True)
    jcfg = jax_config.load_config(os.path.join(exp, "hyp_exp.yaml"))
    jm = jax_build_model(jcfg, "float32")
    template = jax.eval_shape(lambda: jax_train_step.init_state(
        jcfg, jm, jax_make_frontend(jcfg), jax.random.PRNGKey(0)))
    state, jhost = jax_checkpoint.load_checkpoint(os.path.join(exp, "model_best.ckpt"),
                                                  template)
    assert jhost == host and 1 <= host["epoch_nb"] <= 3
    for got, want in zip(jax.tree_util.tree_leaves(state.opt_state),
                         jax.tree_util.tree_leaves(template.opt_state)):
        assert np.shape(got) == want.shape
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           jax.tree_util.tree_map(np.asarray, state.params), variables["params"])
