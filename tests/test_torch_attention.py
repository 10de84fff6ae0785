"""Port attention vs the JAX package's attention paths.

The plain PyTorch attention (``adyolo_tpu_torch.ops.attention``) and the
Hopper wrapper's CPU dispatch are held against:

* K2, ``flash_mhsa(..., interpret=True)`` at rate 0, with and without a
  prefix key mask;
* K4, ``flash_mhsa_long(..., interpret=True)``, with trailing all-masked
  key blocks and a ``kv_len == 0`` row (with the prefix masks the model
  makes, the leading key block is all-masked only in that row);
* the JAX ``MHSA.attend`` XLA path, fused and query-blocked.

Tolerance 2e-6 abs / 1e-5 rel, as ``tests/test_flash_mhsa.py`` holds the
TPU kernels to their XLA reference (float32 sums in another order).  The
kernel itself runs only on a CUDA device (``-m cuda``); flax is imported
inside the tests that need it, so that the kernel test runs where it is
missing.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from adyolo_tpu.ops.flash_mhsa import flash_mhsa, flash_mhsa_long
from adyolo_tpu_torch.ops import attention, hopper_attention

ATOL, RTOL = 2e-6, 1e-5
KERNEL_TOL = 2e-5  # kernel vs plain on the card, relative to max|plain|


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
