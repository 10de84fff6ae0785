"""bf16 training pieces of the port: the attention's plain bf16 pair, the
kernels' choice of D, ``remat``, and (on a card) the bf16 Hopper kernels.

* The plain bf16 attention forward and its written-out backward (K3's
  rounding points), through the Hopper wrapper's CPU route, against
  ``flash_mhsa(..., rate=0.2, interpret=True)`` on the same bf16 q/k/v
  (and bf16 output gradient) at (3, 96, 4, 64), kv_len (96, 50, 0), the
  same dropout mask (the seed JAX derives from its key).  Both are
  measured against a float64 evaluation of the same function on the same
  inputs, over the rows with keys: each of out, dq, dk, dv within 2x JAX's
  max|error| plus half a bfloat16 step at the output's max (2^-9 * max).
  The kv_len = 0 row is zeros with zero gradients (the port's convention;
  JAX's kernel averages v there).
* D = rowsum(dO o O) in the bf16 backward: the kernels take it from the
  forward's float32 output.  A model of the backward's arithmetic at
  (2, 800, 4, 64), rate 0.2, with sharp attention (q and k scaled by 3, so
  dp ~ D cancels): D from the float32 output gives dq/dk errors within
  1.05x of D summed exactly, D from the bfloat16 output more than 1.5x
  (measured: 1.00x and 2.05x).
* ``remat`` with dropout on: one train step of the conformer (2 blocks) in
  float32 and in bf16 with ``cfg.train.remat`` equals the same step
  without it bit for bit: loss, every gradient, the weights and BatchNorm
  running stats after the step and the generator's state.  SE-ResNet34
  has no blocks to checkpoint: remat changes nothing.
* The kernels' keep test drops the hash's last xorshift: ``x ^ (x >> 16)``
  keeps the top 8 bits of x, and ``thresh << 24`` compares only those, so
  ``(x ^ (x >> 16)) >= thresh << 24`` equals ``x >= thresh << 24`` for
  every x and thresh (random words and the edges, every thresh).
* The kernels' exp2 is ``ex2.approx.ftz.f32`` (relative error under
  2^-21): the backward's arithmetic model with every probability off by up
  to 2^-21 gives dq/dk/dv errors against float64 within 1.01x of the
  exact probabilities' (measured: 1.00x), at (2, 800, 4, 64), rate 0.2.
* ``-m cuda``: routes ``k2_dropout_bf16`` and ``k3_bf16`` against the
  plain bf16 pair, each measured against float64: the kernel's max|error|
  at most 2x the plain version's plus 2^-9 * max, at ragged shapes, a
  kv_len = 0 row (zeros), rate 0, T = 65 and T = 833 (one row past a
  64-row tile, which TMA fills with zeros), and (1, 1200), which runs in
  key splits and a merge; a second backward on the same inputs gives the
  same dq, dk, dv bit for bit (no atomics).
"""
import copy
import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from adyolo_tpu.ops.flash_mhsa import flash_mhsa
from adyolo_tpu_torch.config import Config
from adyolo_tpu_torch.data.labels import encode_adyolo, pad_yolo_targets
from adyolo_tpu_torch.models import resnet_conformer as port_rc
from adyolo_tpu_torch.models import wrapper as port_wrapper
from adyolo_tpu_torch.models.wrapper import make_grid_geometry
from adyolo_tpu_torch.ops import attention, hopper_attention
from adyolo_tpu_torch.ops.features import FeatureFrontend
from adyolo_tpu_torch.parallel.train_step import build_train_step

from tests.test_torch_config import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

RATE = 0.2
RATIO = 2.0  # the port's (or the kernel's) bf16 error at most this x the reference's
HALF_STEP = 2.0 ** -9  # half a bfloat16 step, relative to a max


def _bf16(rng, shape, scale=1.0):
    return torch.tensor(rng.standard_normal(shape) * scale, dtype=torch.float32).bfloat16()


def _jax_seed(key):
    return torch.tensor(np.asarray(jax.random.bits(key, (1,), jnp.uint32).astype(jnp.int32)))


def _truth(q, k, v, kv, do, seed, rate=RATE):
    """The forward and gradients in float64 on the same (bf16) inputs."""
    a = [x.double() for x in (q, k, v)]
    out = attention.mhsa_attention(*a, kv, rate=rate, seed=seed)
    return (out, *attention.mhsa_attention_bwd(*a, kv, do.double(), rate=rate, seed=seed))


def _max_err(x, truth, rows):
    return float((x.double()[rows] - truth[rows]).abs().max())


def test_plain_bf16_pair_matches_k2_k3_interpret():
    B, T, H, dh = 3, 96, 4, 64
    lens = (96, 50, 0)
    rng = np.random.default_rng(12)
    q, k, v, do = (_bf16(rng, (B, T, H, dh)) for _ in range(4))
    kv = torch.tensor(lens, dtype=torch.int32)
    key = jax.random.PRNGKey(9)
    seed = _jax_seed(key)
    mask = jnp.asarray(np.arange(T)[None, :] < np.asarray(lens)[:, None])
    jq, jk, jv = (jnp.asarray(x.float().numpy()).astype(jnp.bfloat16) for x in (q, k, v))
    jdo = jnp.asarray(do.float().numpy())

    def f(q_, k_, v_):
        return flash_mhsa(q_, k_, v_, mask, rate=RATE, rng_key=key, interpret=True)

    jout = f(jq, jk, jv)
    assert jout.dtype == jnp.bfloat16
    jgrads = jax.grad(lambda *a: jnp.sum(f(*a).astype(jnp.float32) * jdo), (0, 1, 2))(jq, jk, jv)
    want = [torch.tensor(np.asarray(x.astype(jnp.float32))) for x in (jout, *jgrads)]

    args = [x.clone().requires_grad_(True) for x in (q, k, v)]
    before = dict(hopper_attention.LAUNCHES)
    out = hopper_attention.flash_attention(*args, kv, rate=RATE, seed=seed)
    out.backward(do)
    assert hopper_attention.LAUNCHES == before  # the CPU route launches nothing
    got = [out.detach(), *(a.grad for a in args)]
    assert all(x.dtype == torch.bfloat16 for x in got)
    written = attention.mhsa_attention_bwd(q, k, v, kv, do, rate=RATE, seed=seed)
    for g, w in zip(got[1:], written):
        assert torch.equal(g, w)  # autograd runs the written-out backward

    truth = _truth(q, k, v, kv, do, seed)
    rows = [b for b, n in enumerate(lens) if n > 0]
    for name, g, j, t in zip(("out", "dq", "dk", "dv"), got, want, truth):
        err, err_jax = _max_err(g, t, rows), _max_err(j, t, rows)
        floor = HALF_STEP * float(t[rows].abs().max())
        assert err <= RATIO * err_jax + floor, (name, err, err_jax, floor)
        assert all(bool((g[b] == 0).all()) for b, n in enumerate(lens) if n == 0), name


def test_bf16_attention_runs_only_on_the_training_route():
    """A rate above 0 takes the training route in any grad mode; an eval
    call (rate 0, autograd not recording) takes the eval op, on bfloat16
    too (bf16 serving): the plain bf16 attention on the CPU."""
    rng = np.random.default_rng(13)
    q, k, v = (_bf16(rng, (2, 16, 2, 64)) for _ in range(3))
    with torch.no_grad():
        out = hopper_attention.flash_attention(q, k, v)  # eval
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, attention.mhsa_attention(q, k, v))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        hopper_attention.flash_attention(q, k.float(), v)
    seed = torch.tensor([3], dtype=torch.int32)
    with torch.no_grad():  # a rate above 0 is the training route, grad or not
        out = hopper_attention.flash_attention(q, k, v, None, rate=RATE, seed=seed)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, attention.mhsa_attention(q, k, v, None, rate=RATE, seed=seed))


def _bwd_model(q, k, v, kv, do, seed, D, p_rel_err=None):
    """The bf16 backward's arithmetic with a given D (B, H, T), and each
    probability times (1 + p_rel_err) when given."""
    B, T, H, dh = q.shape
    f, scale = torch.float32, dh ** -0.5
    p = attention._probs(q, k, attention._key_mask(kv, T, q.device), scale)
    if p_rel_err is not None:
        p = p * (1 + p_rel_err)
    dpd = torch.einsum("bqhd,bkhd->bhqk", do.to(f), v.to(f))
    keep, ks = attention._keep(B, H, T, attention.dropout_thresh(RATE), seed)
    pd, dp = torch.where(keep, p * ks, 0.0), torch.where(keep, dpd * ks, 0.0)
    ds = (p * (dp - D[..., None]) * scale).bfloat16().to(f)
    pd = pd.bfloat16().to(f)
    return (torch.einsum("bhqk,bkhd->bqhd", ds, k.to(f)).bfloat16(),
            torch.einsum("bhqk,bqhd->bkhd", ds, q.to(f)).bfloat16(),
            torch.einsum("bhqk,bqhd->bkhd", pd, do.to(f)).bfloat16())


def test_bf16_backward_takes_D_from_the_float32_output():
    rng = np.random.default_rng(0)
    q, k = (_bf16(rng, (2, 800, 4, 64), 3.0) for _ in range(2))
    v, do = (_bf16(rng, (2, 800, 4, 64)) for _ in range(2))
    kv = torch.tensor([800, 517], dtype=torch.int32)
    seed = torch.tensor([7], dtype=torch.int32)
    truth = _truth(q, k, v, kv, do, seed)
    rowsum = lambda o: (do.double() * o.double()).sum(-1).transpose(1, 2).float()  # noqa: E731
    outs = {"exact": truth[0],
            "float32": attention.mhsa_attention(q.float(), k.float(), v.float(), kv,
                                                rate=RATE, seed=seed),
            "bfloat16": attention.mhsa_attention(q, k, v, kv, rate=RATE, seed=seed)}
    assert outs["bfloat16"].dtype == torch.bfloat16
    rows = [0, 1]
    errs = {n: [_max_err(g, t, rows) for g, t in zip(
        _bwd_model(q, k, v, kv, do, seed, rowsum(o)), truth[1:3])] for n, o in outs.items()}
    for i in range(2):  # dq, dk
        assert errs["float32"][i] <= 1.05 * errs["exact"][i], errs
        assert errs["bfloat16"][i] > 1.5 * errs["exact"][i], errs


@pytest.mark.parametrize("thresh", [1, 51, 128, 255])
def test_keep_test_without_the_last_xorshift(thresh):
    rng = np.random.default_rng(thresh)
    x = np.concatenate([rng.integers(0, 2 ** 32, 1 << 16, dtype=np.uint64),
                        [0, 2 ** 32 - 1]] + [[(t << 24) - 1, t << 24, (t << 24) + 0xFFFFFF]
                                             for t in range(1, 256)]).astype(np.uint32)
    t24 = np.uint32(thresh << 24)
    assert np.array_equal((x ^ (x >> np.uint32(16))) >= t24, x >= t24)


def test_bf16_backward_tolerates_ex2_approx():
    rng = np.random.default_rng(5)
    q, k, v, do = (_bf16(rng, (2, 800, 4, 64)) for _ in range(4))
    kv = torch.tensor([800, 517], dtype=torch.int32)
    seed = torch.tensor([7], dtype=torch.int32)
    truth = _truth(q, k, v, kv, do, seed)
    o32 = attention.mhsa_attention(q.float(), k.float(), v.float(), kv, rate=RATE, seed=seed)
    D = (do.double() * o32.double()).sum(-1).transpose(1, 2).float()
    err = torch.tensor(rng.uniform(-2.0 ** -21, 2.0 ** -21, (2, 4, 800, 800)),
                       dtype=torch.float32)
    rows = [0, 1]
    for exact, approx, t in zip(_bwd_model(q, k, v, kv, do, seed, D),
                                _bwd_model(q, k, v, kv, do, seed, D, err), truth[1:]):
        assert _max_err(approx, t, rows) <= 1.01 * _max_err(exact, t, rows)


def _step_run(encoder, dtype, remat, blocks=2):
    cfg = Config()
    cfg = dataclasses.replace(
        cfg, args=dataclasses.replace(cfg.args, encoder=encoder),
        train=dataclasses.replace(cfg.train, compute_dtype=dtype, remat=remat))
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(port_wrapper.ENCODERS, "resnet-conformer",
                   functools.partial(port_rc.ResNetConformer, num_layers=blocks))
        model = port_wrapper.build_model(cfg, device="cpu",
                                         generator=torch.Generator().manual_seed(0), train=True)
    if encoder == "resnet-conformer":
        assert model.encoder.remat == remat
    step = build_train_step(cfg, model, FeatureFrontend(cfg.data, device="cpu"))
    rng = np.random.default_rng(2)
    labels = [{1: [[4, 0, 30.0, 10.0]], 5: [[0, 0, -120.0, -20.0]]}, {7: [[12, 0, 90.0, 40.0]]}]
    targets, mask = pad_yolo_targets(
        [encode_adyolo(lab, 10, make_grid_geometry(cfg)) for lab in labels],
        cfg.train.max_targets_per_clip * 2)
    batch = {"audio": (rng.standard_normal((2, 40, 600, 4)) * 1500).astype(np.int16),
             "targets": targets, "target_mask": mask}
    gen = torch.Generator().manual_seed(11)
    loss = step(batch, gen)
    return {"loss": loss, "grads": {n: p.grad.clone() for n, p in model.named_parameters()},
            "state": copy.deepcopy(model.state_dict()), "gen": gen.get_state()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remat_step_equals_the_plain_step_bit_for_bit(dtype):
    plain = _step_run("resnet-conformer", dtype, False)
    remat = _step_run("resnet-conformer", dtype, True)
    assert torch.isfinite(plain["loss"]) and torch.equal(plain["loss"], remat["loss"])
    for group in ("grads", "state"):
        assert plain[group].keys() == remat[group].keys()
        for n, t in plain[group].items():
            assert torch.equal(t, remat[group][n]), (group, n)
    assert any("running_mean" in n for n in plain["state"])
    assert torch.equal(plain["gen"], remat["gen"])


def test_remat_changes_nothing_for_seresnet34():
    plain = _step_run("se-resnet34", "float32", False)
    remat = _step_run("se-resnet34", "float32", True)
    assert torch.equal(plain["loss"], remat["loss"])
    assert all(torch.equal(t, remat["grads"][n]) for n, t in plain["grads"].items())
    assert torch.equal(plain["gen"], remat["gen"])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper attention kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,lens,rate", [(3, 200, (200, 77, 0), RATE),
                                           (2, 48, (48, 33), RATE),
                                           (2, 130, (130, 70), 0.0),
                                           (2, 65, (65, 40), RATE),
                                           (3, 833, (833, 500, 0), RATE),
                                           (1, 1200, (920,), RATE),
                                           (2, 2400, (2400, 1400), RATE)])
def test_bf16_kernels_match_plain_on_cuda(cuda_device, B, T, lens, rate):
    rng = np.random.default_rng(T)
    q, k, v, do = (_bf16(rng, (B, T, 4, 64)).to(cuda_device) for _ in range(4))
    kv = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
    seed = torch.tensor([1234], dtype=torch.int32, device=cuda_device)
    before = dict(hopper_attention.LAUNCHES)
    args = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = hopper_attention.flash_attention(*args, kv, rate=rate, seed=seed)
    out.backward(do)
    torch.cuda.synchronize()
    grown = {n: c - before[n] for n, c in hopper_attention.LAUNCHES.items()}
    assert grown == {"k2": 0, "k4": 0, "k2_dropout": 0, "k3": 0,
                     "k2_dropout_bf16": 1, "k3_bf16": 1, "k2_bf16": 0}, grown
    got = [out.detach(), *(a.grad for a in args)]
    again = torch.autograd.grad(hopper_attention.flash_attention(*args, kv, rate=rate, seed=seed),
                                args, do)
    assert all(torch.equal(a, b) for a, b in zip(got[1:], again))  # deterministic
    plain = [attention.mhsa_attention(q, k, v, kv, rate=rate, seed=seed),
             *attention.mhsa_attention_bwd(q, k, v, kv, do, rate=rate, seed=seed)]
    truth = _truth(q, k, v, kv, do, seed, rate)
    rows = [b for b, n in enumerate(lens) if n > 0]
    for name, g, p, t in zip(("out", "dq", "dk", "dv"), got, plain, truth):
        assert g.dtype == torch.bfloat16 and bool(torch.isfinite(g).all()), name
        err, err_plain = _max_err(g, t, rows), _max_err(p, t, rows)
        assert err <= RATIO * err_plain + HALF_STEP * float(t.abs().max()), (name, err, err_plain)
        assert all(bool((g[b] == 0).all()) for b, n in enumerate(lens) if n == 0), name
