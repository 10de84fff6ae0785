"""Port attention vs the JAX package's attention paths.

The plain PyTorch attention (``adyolo_tpu_torch.ops.attention``) and the
Hopper wrapper's CPU dispatch are held against:

* K2, ``flash_mhsa(..., interpret=True)`` at rate 0, with and without a
  prefix key mask;
* K4, ``flash_mhsa_long(..., interpret=True)``, with trailing all-masked
  key blocks and a ``kv_len == 0`` row (with the prefix masks the model
  makes, the leading key block is all-masked only in that row);
* the JAX ``MHSA.attend`` XLA path, fused and query-blocked;
* with dropout (rate 0.2, thresh 51), K2 and K3: the forward against
  ``flash_mhsa(..., rate=0.2, rng_key=key, interpret=True)`` and the
  gradients, of the plain path by autograd and of ``mhsa_attention_bwd``
  written out, against ``jax.grad`` through it (the K3 custom VJP).  The
  seed is the int32 the JAX wrapper derives from ``key``
  (``flash_mhsa.py:246``); the keep bits are the same hash, so the masks
  agree bit for bit and the outputs agree to float32 rounding.

Tolerance 2e-6 abs / 1e-5 rel for forwards, as ``tests/test_flash_mhsa.py``
holds the TPU kernels to their XLA reference (float32 sums in another
order), 1e-5 abs for gradients.  The kernels themselves run only on a CUDA
device (``-m cuda``); flax is imported inside the tests that need it, so
that the kernel tests run where it is missing.
"""
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from adyolo_tpu.ops.flash_mhsa import flash_mhsa, flash_mhsa_long
from adyolo_tpu_torch.ops import attention, hopper_attention

ATOL, RTOL = 2e-6, 1e-5
GRAD_TOL = 1e-5
KERNEL_TOL = 2e-5  # kernel vs plain on the card, relative to max|plain|
GRAD_KERNEL_TOL = 1e-4  # kernel vs plain gradients, relative to max|grad|
RATE = 0.2


def _qkv(B, T, H, dh, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, T, H, dh)).astype(np.float32)
            for _ in range(3)]


def _mask(T, lens):
    return np.arange(T)[None, :] < np.asarray(lens)[:, None]


def _plain(q, k, v, lens=None):
    kv = None if lens is None else torch.tensor(lens, dtype=torch.int32)
    out = hopper_attention.flash_attention(
        torch.tensor(q), torch.tensor(k), torch.tensor(v), kv)
    return out.numpy()


@pytest.mark.parametrize("dh", [8, 64])
@pytest.mark.parametrize("lens", [None, (48, 33)])
def test_plain_matches_k2_interpret(dh, lens):
    B, T, H = 2, 48, 2
    q, k, v = _qkv(B, T, H, dh, seed=dh)
    mask = None if lens is None else jnp.asarray(_mask(T, lens))
    want = flash_mhsa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask,
                      bq=16, interpret=True)
    np.testing.assert_allclose(_plain(q, k, v, lens), np.asarray(want),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("dh", [8, 64])
def test_plain_matches_k4_interpret(dh):
    """kv_len 96 (all valid), 50 (third 32-key block all masked), 20 (two
    trailing blocks masked) and 0 (every block masked: zeros)."""
    B, T, H = 4, 96, 2
    lens = (96, 50, 20, 0)
    q, k, v = _qkv(B, T, H, dh, seed=10 + dh)
    want = np.asarray(flash_mhsa_long(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(_mask(T, lens)), bq=32, bkv=32, interpret=True))
    got = _plain(q, k, v, lens)
    assert np.isfinite(got).all() and np.all(got[3] == 0) and np.all(want[3] == 0)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    # no mask, T not a multiple of bkv (pad-only masking in K4)
    want = flash_mhsa_long(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           bq=32, bkv=40, interpret=True)
    np.testing.assert_allclose(_plain(q, k, v), np.asarray(want),
                               atol=ATOL, rtol=RTOL)


def _jax_attend(B, T, H, dh, lens):
    """The JAX ``MHSA`` with an identity output projection: its output is
    ``attend``'s context on the q/k/v its own Dense layers make.  Returns
    those q/k/v and that context."""
    from adyolo_tpu.models import resnet_conformer as jax_rc

    D = H * dh
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    m = jax_rc.MHSA(D, heads=H, flash="0")
    variables = m.init(jax.random.PRNGKey(0), jnp.asarray(x), False)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    params["linear"] = {"kernel": np.eye(D, dtype=np.float32),
                        "bias": np.zeros(D, np.float32)}
    qkv = [np.asarray(jnp.dot(jnp.asarray(x), params[n]["kernel"])
                      + params[n]["bias"]).reshape(B, T, H, dh)
           for n in ("query", "key", "value")]
    mask = None if lens is None else jnp.asarray(_mask(T, lens))
    out = m.apply({"params": params}, jnp.asarray(x), False, frame_mask=mask)
    return qkv, np.asarray(out).reshape(B, T, H, dh)


@pytest.mark.parametrize("dh", [8, 64])
@pytest.mark.parametrize("T,threshold", [(48, 2400), (160, 100)])
def test_plain_matches_jax_mhsa_attend(monkeypatch, dh, T, threshold):
    """Fused route (T <= threshold) and query-blocked route (bq = 80), the
    threshold set on both sides."""
    from adyolo_tpu.models import resnet_conformer as jax_rc

    monkeypatch.setattr(jax_rc.MHSA, "BLOCK_THRESHOLD", threshold)
    monkeypatch.setattr(attention, "BLOCK_THRESHOLD", threshold)
    for lens in (None, (T, T - 37)):
        (q, k, v), want = _jax_attend(2, T, 4, dh, lens)
        np.testing.assert_allclose(_plain(q, k, v, lens), want,
                                   atol=ATOL, rtol=RTOL)


def test_fused_and_blocked_routes_agree(monkeypatch):
    q, k, v = _qkv(2, 160, 4, 64, seed=3)
    lens = (160, 101)
    fused = _plain(q, k, v, lens)
    monkeypatch.setattr(attention, "BLOCK_THRESHOLD", 100)
    assert attention.query_block(160) == 80
    blocked = _plain(q, k, v, lens)
    np.testing.assert_allclose(blocked, fused, atol=2e-6, rtol=0)


def test_wrapper_takes_plain_on_cpu_and_checks_inputs():
    q, k, v = (torch.tensor(a) for a in _qkv(2, 16, 2, 64, seed=4))
    kv = torch.tensor([16, 5], dtype=torch.int32)
    before = dict(hopper_attention.LAUNCHES)
    out = hopper_attention.flash_attention(q, k, v, kv)
    assert hopper_attention.LAUNCHES == before
    torch.testing.assert_close(out, attention.mhsa_attention(q, k, v, kv),
                               atol=0, rtol=0)
    assert hopper_attention.route(2400) == "k2"
    assert hopper_attention.route(2401) == "k4"
    with pytest.raises(TypeError):
        hopper_attention.flash_attention(q.double(), k, v, kv)
    with pytest.raises(ValueError, match="shape"):
        hopper_attention.flash_attention(q, k[:, :8], v, kv)
    with pytest.raises(ValueError, match="contiguous"):
        hopper_attention.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                         v.transpose(1, 2), kv)
    with pytest.raises(ValueError, match="kv_len"):
        hopper_attention.flash_attention(q, k, v, kv[:1])
    with pytest.raises(ValueError, match="device"):
        hopper_attention.flash_attention(q.to("meta"), k.to("meta"),
                                         v.to("meta"), None)


def _jax_seed(key):
    """The int32 seed ``flash_mhsa`` derives from ``rng_key`` (``:246``)."""
    return torch.tensor(np.asarray(
        jax.random.bits(key, (1,), jnp.uint32).astype(jnp.int32)))


def _lens_t(lens):
    return None if lens is None else torch.tensor(lens, dtype=torch.int32)


@pytest.mark.parametrize("dh", [8, 64])
@pytest.mark.parametrize("lens", [None, (48, 33)])
def test_plain_dropout_matches_k2_interpret(dh, lens):
    """B=2, T=48 (bq 16, nq 3, Tp 128), H=2."""
    B, T, H = 2, 48, 2
    q, k, v = _qkv(B, T, H, dh, seed=20 + dh)
    key = jax.random.PRNGKey(dh)
    mask = None if lens is None else jnp.asarray(_mask(T, lens))
    want = flash_mhsa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask,
                      rate=RATE, rng_key=key, interpret=True)
    got = hopper_attention.flash_attention(
        torch.tensor(q), torch.tensor(k), torch.tensor(v), _lens_t(lens),
        rate=RATE, seed=_jax_seed(key))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
    # dropout did drop: rate 0 gives another output
    assert float(np.abs(_plain(q, k, v, lens) - np.asarray(want)).max()) > 1e-2


@pytest.mark.parametrize("lens", [None, (48, 33)])
def test_dropout_grads_match_jax_k3(lens):
    B, T, H, dh = 2, 48, 2, 8
    q, k, v = _qkv(B, T, H, dh, seed=30)
    do = np.random.default_rng(31).standard_normal((B, T, H, dh)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    mask = None if lens is None else jnp.asarray(_mask(T, lens))

    def f(q, k, v):
        return jnp.sum(flash_mhsa(q, k, v, mask, rate=RATE, rng_key=key,
                                  interpret=True) * do)

    want = jax.grad(f, (0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    seed = _jax_seed(key)
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = attention.mhsa_attention(tq, tk, tv, _lens_t(lens), rate=RATE, seed=seed)
    (out * torch.tensor(do)).sum().backward()
    written = attention.mhsa_attention_bwd(
        torch.tensor(q), torch.tensor(k), torch.tensor(v), _lens_t(lens),
        torch.tensor(do), rate=RATE, seed=seed)
    for w, auto, wr in zip(want, (tq.grad, tk.grad, tv.grad), written):
        np.testing.assert_allclose(auto.numpy(), np.asarray(w), atol=GRAD_TOL, rtol=0)
        np.testing.assert_allclose(wr.numpy(), np.asarray(w), atol=GRAD_TOL, rtol=0)


def test_dropout_grads_finite_difference():
    """f64 central differences of <out, do> with dropout on: the mask is a
    function of the seed alone, so the loss is smooth in q, k, v."""
    B, T, H, dh = 1, 16, 2, 4
    rng = np.random.default_rng(40)
    q, k, v, do = (torch.tensor(rng.standard_normal((B, T, H, dh)), dtype=torch.float64)
                   for _ in range(4))
    kv, seed = torch.tensor([11], dtype=torch.int32), torch.tensor([77], dtype=torch.int32)
    grads = attention.mhsa_attention_bwd(q, k, v, kv, do, rate=RATE, seed=seed)
    eps = 1e-6
    for x, g in zip((q, k, v), grads):
        for idx in ((0, 3, 1, 2), (0, 10, 0, 0), (0, 15, 1, 3)):
            xp, xm = x.clone(), x.clone()
            xp[idx] += eps
            xm[idx] -= eps
            args_p = [xp if a is x else a for a in (q, k, v)]
            args_m = [xm if a is x else a for a in (q, k, v)]
            fd = ((attention.mhsa_attention(*args_p, kv, rate=RATE, seed=seed) * do).sum()
                  - (attention.mhsa_attention(*args_m, kv, rate=RATE, seed=seed) * do).sum()
                  ) / (2 * eps)
            assert abs(float(fd) - float(g[idx])) <= 1e-7 * max(1.0, abs(float(fd))), idx
    assert float(grads[1][0, 11:].abs().max()) == 0.0  # masked keys: no gradient
    assert float(grads[2][0, 11:].abs().max()) == 0.0


def test_dropout_bits_keep_share_and_full_drop():
    """The hash keeps ~205/256 of the probabilities at thresh 51; rate 1.0
    (thresh 256) gives zeros and zero gradients, as in JAX."""
    bits = attention.dropout_bits(2, 4, 200, torch.tensor([123], dtype=torch.int32))
    share = float((bits >= (51 << 24)).double().mean())
    assert abs(share - 205 / 256) < 0.005, share
    q, k, v = (torch.tensor(a) for a in _qkv(2, 48, 2, 8, seed=50))
    out = hopper_attention.flash_attention(q, k, v, None, rate=1.0, seed=None)
    assert float(out.abs().max()) == 0.0
    want = flash_mhsa(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
                      jnp.asarray(v.numpy()), rate=1.0, interpret=True)
    assert float(np.abs(np.asarray(want)).max()) == 0.0
    assert all(float(g.abs().max()) == 0.0 for g in attention.mhsa_attention_bwd(
        q, k, v, None, q, rate=1.0))
    with pytest.raises(ValueError, match="seed"):
        attention.mhsa_attention(q, k, v, None, rate=RATE)


def _tf32(x):
    """Round float32 to TF32 (10 mantissa bits), to nearest, ties away from
    zero: ``cvt.rna.tf32.f32``."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm_3xtf32(eq, a, b):
    """K3's product in 3xTF32: a = a_hi + a_lo (each TF32), the same for b,
    and a_lo.b_hi + a_hi.b_lo + a_hi.b_hi summed in float32 (the products of
    TF32 values are exact in float32; a_lo.b_lo is dropped)."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return (torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl)) + torch.einsum(eq, ah, bh)


def _mm_1xtf32(eq, a, b):
    return torch.einsum(eq, _tf32(a), _tf32(b))


def _bwd_with(mm, q, k, v, kv_len, do, rate, seed):
    """``mhsa_attention_bwd`` with each of its five products done by ``mm``."""
    B, T, H, dh = q.shape
    scale = dh ** -0.5
    s = mm("bqhd,bkhd->bhqk", q, k) * scale
    s = torch.where(attention._key_mask(kv_len, T, q.device)[:, None, None, :], s,
                    torch.finfo(torch.float32).min)
    p = torch.softmax(s, dim=-1)
    dpd = mm("bqhd,bkhd->bhqk", do, v)
    keep, kscale = attention._keep(B, H, T, attention.dropout_thresh(rate), seed)
    pd = torch.where(keep, p * kscale, 0.0)
    dp = torch.where(keep, dpd * kscale, 0.0)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True)) * scale
    grads = (mm("bhqk,bkhd->bqhd", ds, k), mm("bhqk,bqhd->bkhd", ds, q),
             mm("bhqk,bqhd->bkhd", pd, do))
    return tuple(attention._zero_empty_rows(g, kv_len) for g in grads)


def test_3xtf32_backward_keeps_fp32_accuracy():
    """K3's products emulated in 3xTF32 stay within 1e-5 * max of the plain
    float32 backward at (2, 160, 4, 64), rate 0.2, ragged kv_len; plain
    TF32 does not (it is ~1e-3 * max off)."""
    rng = np.random.default_rng(60)
    q, k, v, do = (torch.tensor(rng.standard_normal((2, 160, 4, 64)), dtype=torch.float32)
                   for _ in range(4))
    kv, seed = torch.tensor([160, 97], dtype=torch.int32), torch.tensor([99], dtype=torch.int32)
    assert float(_tf32(torch.tensor([1.0 + 2.0 ** -11]))) == 1.0 + 2.0 ** -10  # tie: away
    want = attention.mhsa_attention_bwd(q, k, v, kv, do, rate=RATE, seed=seed)
    three = _bwd_with(_mm_3xtf32, q, k, v, kv, do, RATE, seed)
    one = _bwd_with(_mm_1xtf32, q, k, v, kv, do, RATE, seed)
    for g3, g1, w in zip(three, one, want):
        scale = float(w.abs().max())
        assert float((g3 - w).abs().max()) <= 1e-5 * scale
        assert float((g1 - w).abs().max()) > 1e-4 * scale


def _fwd_emulated(mm, q, k, v, kv_len, rate, seed):
    """The forward kernel's arithmetic in torch: 64-key tiles up to
    ceil(L / 64); S and each tile's P.V by ``mm``; the online softmax in the
    log2 domain with the scale in one multiply; the normaliser over the
    undropped probabilities; O = O * alpha + the tile's P.V; an L == 0 row
    gives zeros."""
    B, T, H, dh = q.shape
    c = dh ** -0.5 * 1.4426950408889634
    keep, kscale = attention._keep(B, H, T, attention.dropout_thresh(rate), seed)
    L = kv_len.clamp(0, T)
    m = torch.full((B, H, T), -np.inf)
    lsum = torch.zeros((B, H, T))
    o = torch.zeros((B, H, T, dh))
    for j0 in range(0, T, 64):
        kt, vt = k[:, j0:j0 + 64], v[:, j0:j0 + 64]
        s = mm("bqhd,bkhd->bhqk", q, kt)
        valid = torch.arange(j0, j0 + kt.shape[1])[None, :] < L[:, None]
        s = torch.where(valid[:, None, None, :], s, -np.inf)
        mnew = torch.maximum(m, s.amax(-1) * c)
        alpha = torch.exp2(m - mnew)
        p = torch.exp2(s * c - mnew[..., None])
        lnew = lsum * alpha + p.sum(-1)
        if keep is not None:
            p = torch.where(keep[..., j0:j0 + 64], p, 0.0)
        onew = o * alpha[..., None] + mm("bhqk,bkhd->bhqd", p, vt)
        active = (j0 < L)[:, None, None]  # the kernel stops at ceil(L / 64)
        m = torch.where(active, mnew, m)
        lsum = torch.where(active, lnew, lsum)
        o = torch.where(active[..., None], onew, o)
    out = torch.where((L > 0)[:, None, None, None], o * (kscale / lsum)[..., None], 0.0)
    return out.transpose(1, 2)


@pytest.mark.parametrize("rate", [0.0, RATE])
@pytest.mark.parametrize("lens", [(800, 517), (613, 0)])
def test_3xtf32_forward_matches_k2_interpret(rate, lens):
    """The forward kernel's arithmetic emulated with 3xTF32 products lies
    within the card's bound (2e-5 * max) of ``flash_mhsa(interpret=True)``
    at (2, 800, 4, 64), ragged kv_len, a zero row (zeros, K4's convention),
    at rate 0 and 0.2 with the same seed; with 1xTF32 products it does not,
    so the bound can tell them apart."""
    B, T, H, dh = 2, 800, 4, 64
    q, k, v = _qkv(B, T, H, dh, seed=70)
    key = jax.random.PRNGKey(7)
    want = np.asarray(flash_mhsa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 jnp.asarray(_mask(T, lens)), rate=rate,
                                 rng_key=key, interpret=True))
    seed = _jax_seed(key)
    kv = torch.tensor(lens, dtype=torch.int32)
    tq, tk, tv = (torch.tensor(a) for a in (q, k, v))
    rows = [b for b, n in enumerate(lens) if n > 0]
    scale = float(np.abs(want[rows]).max())
    three = _fwd_emulated(_mm_3xtf32, tq, tk, tv, kv, rate, seed).numpy()
    one = _fwd_emulated(_mm_1xtf32, tq, tk, tv, kv, rate, seed).numpy()
    assert float(np.abs(three[rows] - want[rows]).max()) <= KERNEL_TOL * scale
    assert float(np.abs(one[rows] - want[rows]).max()) > KERNEL_TOL * scale
    for b, n in enumerate(lens):
        if n == 0:
            assert np.all(three[b] == 0)


@pytest.mark.parametrize("grad", [False, True])
def test_long_eval_route_has_no_backward(grad):
    """Eval at T > BLOCK_THRESHOLD (4800 frames) takes the long route in any
    grad mode: the output is the plain attention's, and a backward through
    it raises on the CPU as on the card.  Training there raises."""
    B, T, H, dh = 1, 4800, 2, 8
    q, k, v = (torch.tensor(a, requires_grad=grad) for a in _qkv(B, T, H, dh, seed=80))
    kv = torch.tensor([3000], dtype=torch.int32)
    with torch.no_grad():
        want = attention.mhsa_attention(q, k, v, kv)
    out = hopper_attention.flash_attention(q, k, v, kv)
    torch.testing.assert_close(out.detach(), want, atol=0, rtol=0)
    assert out.requires_grad == grad
    if grad:
        with pytest.raises(NotImplementedError, match="no backward"):
            out.sum().backward()
    with pytest.raises(ValueError, match="training attention needs T <= 2400"):
        hopper_attention.flash_attention(q, k, v, kv, rate=RATE,
                                         seed=torch.tensor([1], dtype=torch.int32))


def test_eval_route_with_grad_below_threshold_has_a_backward():
    """Eval at T <= BLOCK_THRESHOLD under autograd is differentiable (on the
    card: the train pair at rate 0), and its gradients are the plain
    written-out backward's."""
    q, k, v = (torch.tensor(a) for a in _qkv(2, 48, 2, 8, seed=81))
    do = torch.tensor(_qkv(2, 48, 2, 8, seed=82)[0])
    kv = torch.tensor([48, 29], dtype=torch.int32)
    args = [x.clone().requires_grad_(True) for x in (q, k, v)]
    hopper_attention.flash_attention(*args, kv).backward(do)
    for got, want in zip((a.grad for a in args),
                         attention.mhsa_attention_bwd(q, k, v, kv, do)):
        torch.testing.assert_close(got, want, atol=GRAD_TOL, rtol=0)


def test_forward_split_plan_is_kept_per_device(monkeypatch):
    """The forward's key-split plan depends on the card (its SMs and
    occupancy) and on the kernel (float32 or bfloat16), so the wrapper
    keeps one per device, dtype and shape: a shape seen on cuda:0 is
    planned anew on cuda:1, and only once on each; the bfloat16 kernel's
    plan comes from its own entry point."""
    calls = []
    names = {torch.float32: "adyolo_mhsa_fwd_splits",
             torch.bfloat16: "adyolo_mhsa_fwd_bf16_splits"}

    def entry(name):
        assert name in names.values()
        return lambda B, T, H: calls.append((name, B, T, H)) or 1

    monkeypatch.setattr(hopper_attention, "_entry", entry)
    monkeypatch.setattr(hopper_attention, "_plans", {})
    for dev in (0, 0, 1, 1, 0):
        q = types.SimpleNamespace(shape=(1, 1200, 4, 64), dtype=torch.float32,
                                  device=torch.device("cuda", dev))
        assert hopper_attention._fwd_plan(q) == (1, 0, None)
    assert calls == [(names[torch.float32], 1, 1200, 4)] * 2
    assert set(hopper_attention._plans) == {(0, torch.float32, 1, 1200, 4),
                                            (1, torch.float32, 1, 1200, 4)}
    q = types.SimpleNamespace(shape=(1, 1200, 4, 64), dtype=torch.bfloat16,
                              device=torch.device("cuda", 0))
    for _ in range(2):
        assert hopper_attention._fwd_plan(q) == (1, 0, None)
    assert calls[2:] == [(names[torch.bfloat16], 1, 1200, 4)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper attention kernel has no "
                    "CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,lens,rt", [(3, 200, (200, 77, 0), "k2"),
                                         (1, 1200, (920,), "k2"),
                                         (2, 2600, (2600, 1500), "k4")])
def test_kernel_matches_plain_on_cuda(cuda_device, B, T, lens, rt):
    q, k, v = (torch.tensor(a, device=cuda_device)
               for a in _qkv(B, T, 4, 64, seed=T))
    kv = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
    before = hopper_attention.LAUNCHES[rt]
    got = hopper_attention.flash_attention(q, k, v, kv)
    torch.cuda.synchronize()
    assert hopper_attention.LAUNCHES[rt] == before + 1
    want = attention.mhsa_attention(q, k, v, kv)
    assert bool(torch.isfinite(got).all())
    for b, n in enumerate(lens):
        if n == 0:
            assert bool((got[b] == 0).all())
    err = float((got - want).abs().max())
    assert err <= KERNEL_TOL * float(want.abs().max()), err


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,lens,rate", [(3, 200, (200, 77, 0), RATE),
                                           (2, 48, (48, 33), RATE),
                                           (2, 130, (130, 70), 0.0),
                                           (1, 2, (2,), RATE),
                                           (2, 2400, (2400, 1400), RATE)])
def test_train_kernels_match_plain_on_cuda(cuda_device, B, T, lens, rate):
    """Routes k2_dropout (forward) and k3 (backward) against the plain
    version and its autograd: outputs within 2e-5 * max, gradients within
    1e-4 * max; a kv_len == 0 row gets zeros and zero gradients."""
    rng = np.random.default_rng(T)
    q, k, v, do = (torch.tensor(rng.standard_normal((B, T, 4, 64)), dtype=torch.float32,
                                device=cuda_device) for _ in range(4))
    kv = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
    seed = torch.tensor([1234], dtype=torch.int32, device=cuda_device)
    before = dict(hopper_attention.LAUNCHES)
    args = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = hopper_attention.flash_attention(*args, kv, rate=rate, seed=seed)
    out.backward(do)
    torch.cuda.synchronize()
    assert hopper_attention.LAUNCHES["k2_dropout"] == before["k2_dropout"] + 1
    assert hopper_attention.LAUNCHES["k3"] == before["k3"] + 1
    want = attention.mhsa_attention(q, k, v, kv, rate=rate, seed=seed)
    err = float((out - want).abs().max())
    assert err <= KERNEL_TOL * float(want.abs().max()), err
    for got, ref in zip((a.grad for a in args),
                        attention.mhsa_attention_bwd(q, k, v, kv, do, rate=rate, seed=seed)):
        assert bool(torch.isfinite(got).all())
        err = float((got - ref).abs().max())
        assert err <= GRAD_KERNEL_TOL * float(ref.abs().max()), err
        for b, n in enumerate(lens):
            if n == 0:
                assert bool((got[b] == 0).all())


@pytest.mark.cuda
def test_long_eval_route_with_grad_on_cuda(cuda_device):
    """Route k4 at (1, 4800) len 3000 with q/k/v that require grad, outside
    no_grad: the no-grad output, one k4 launch, and a backward that raises."""
    q, k, v = (torch.tensor(a, device=cuda_device) for a in _qkv(1, 4800, 4, 64, seed=90))
    kv = torch.tensor([3000], dtype=torch.int32, device=cuda_device)
    with torch.no_grad():
        want = hopper_attention.flash_attention(q, k, v, kv)
    args = [x.clone().requires_grad_(True) for x in (q, k, v)]
    before = dict(hopper_attention.LAUNCHES)
    out = hopper_attention.flash_attention(*args, kv)
    torch.cuda.synchronize()
    assert hopper_attention.LAUNCHES["k4"] == before["k4"] + 1
    assert hopper_attention.LAUNCHES["k2_dropout"] == before["k2_dropout"]
    assert bool(torch.equal(out.detach(), want))
    with pytest.raises(NotImplementedError, match="no backward"):
        out.sum().backward()


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, RATE])
def test_forward_runs_on_every_device(cuda_device, rate):
    """The forward's shared-memory opt-in and split plan are per device: a
    (1, 1200) len 920 forward, which runs in key splits and a merge, on
    cuda:0, then cuda:1, then cuda:0 again, each on its own card's launch
    and within 2e-5 * max of the plain attention there."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    rt = "k2_dropout" if rate else "k2"
    for i in (0, 1, 0):
        dev = torch.device("cuda", i)
        q, k, v = (torch.tensor(a, device=dev) for a in _qkv(1, 1200, 4, 64, seed=91))
        kv = torch.tensor([920], dtype=torch.int32, device=dev)
        seed = torch.tensor([77], dtype=torch.int32, device=dev)
        before = hopper_attention.LAUNCHES[rt]
        got = hopper_attention.flash_attention(q, k, v, kv, rate=rate, seed=seed)
        torch.cuda.synchronize(dev)
        assert hopper_attention.LAUNCHES[rt] == before + 1
        assert got.device == dev
        want = attention.mhsa_attention(q, k, v, kv, rate=rate, seed=seed)
        err = float((got - want).abs().max())
        assert err <= KERNEL_TOL * float(want.abs().max()), (i, err)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_of_a_head_shard_are_the_full_launchs(cuda_device, dtype):
    """The train routes on heads [2, 4) of 4 (``heads=(2, 4)``, a tensor-
    parallel rank's shard), rate 0.2, a ragged row: against heads [2, 4)
    of the full launch with the same seed (float32: output within 2e-5,
    gradients within 1e-4 of max; bfloat16: within 2^-7 of max, one
    rounding apart), and against the plain version at the same offset
    (float32: the same tolerances; bfloat16: each against float64, the
    kernel's error at most 2x the plain version's + 2^-9 x max)."""
    rng = np.random.default_rng(6)
    q, k, v, do = (torch.tensor(rng.standard_normal((2, 400, 4, 64)), dtype=torch.float32,
                                device=cuda_device).to(dtype) for _ in range(4))
    kv = torch.tensor([400, 233], dtype=torch.int32, device=cuda_device)
    seed = torch.tensor([99], dtype=torch.int32, device=cuda_device)
    heads = (2, 4)

    def run(q, k, v, do, heads=None):
        args = [x.clone().requires_grad_(True) for x in (q, k, v)]
        out = hopper_attention.flash_attention(*args, kv, rate=RATE, seed=seed, heads=heads)
        out.backward(do)
        return [out.detach()] + [a.grad for a in args]

    shard = [x[:, :, 2:].contiguous() for x in (q, k, v, do)]
    got = run(*shard, heads=heads)
    full = [x[:, :, 2:] for x in run(q, k, v, do)]
    torch.cuda.synchronize()
    f32 = dtype == torch.float32
    for i, (g, w) in enumerate(zip(got, full)):
        tol = (KERNEL_TOL if i == 0 else GRAD_KERNEL_TOL) if f32 else 2.0 ** -7
        err = float((g.float() - w.float()).abs().max())
        assert err <= tol * float(w.float().abs().max()), (i, err)
    if f32:
        plain = [attention.mhsa_attention(*shard[:3], kv, rate=RATE, seed=seed, heads=heads),
                 *attention.mhsa_attention_bwd(*shard[:3], kv, shard[3], rate=RATE,
                                               seed=seed, heads=heads)]
        for i, (g, w) in enumerate(zip(got, plain)):
            err = float((g - w).abs().max())
            assert err <= (KERNEL_TOL if i == 0 else GRAD_KERNEL_TOL) * float(w.abs().max())
        return
    a = [x.double() for x in shard]
    truth = [attention.mhsa_attention(*a[:3], kv, rate=RATE, seed=seed, heads=heads),
             *attention.mhsa_attention_bwd(*a[:3], kv, a[3], rate=RATE, seed=seed, heads=heads)]
    plain = [attention.mhsa_attention(*shard[:3], kv, rate=RATE, seed=seed, heads=heads),
             *attention.mhsa_attention_bwd(*shard[:3], kv, shard[3], rate=RATE, seed=seed,
                                           heads=heads)]
    for i, (g, p, t) in enumerate(zip(got, plain, truth)):
        scale = float(t.abs().max())
        e_k, e_p = (float((x.double() - t).abs().max()) for x in (g, p))
        assert e_k <= 2 * e_p + 2.0 ** -9 * scale, (i, e_k, e_p)
