"""Port STFT vs the JAX package's STFT paths.

The plain PyTorch STFT (``adyolo_tpu_torch.ops.stft``) and the Hopper
wrapper's CPU dispatch are held against JAX ``framed_dft_chunked`` /
``stft`` and the Pallas kernel in interpret mode, within 2e-5 * max|re|
(float32 sums over 1200 taps in different orders; measured ~1e-6).
A numpy model of the kernel's FFT (the radix plan, the float32 table of
``fft_plan``, the pass order and the channel-pair split) is held against
JAX ``framed_dft_chunked`` within the same bound.  The kernel itself runs
only on a CUDA device (``-m cuda``).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from adyolo_tpu.ops import pallas_stft as ps
from adyolo_tpu.ops.dsp import analysis_window, dft_matrices
from adyolo_tpu.ops.stft import framed_dft as jax_framed_dft
from adyolo_tpu.ops.stft import framed_dft_chunked as jax_chunked
from adyolo_tpu.ops.stft import stft as jax_stft
from adyolo_tpu_torch.ops import hopper_stft
from adyolo_tpu_torch.ops import stft as port_stft
from adyolo_tpu_torch.ops.dsp import analysis_window as port_window

HOP, NFFT = 600, 1200
TOL = 2e-5


def _dft(n=NFFT):
    w_re, w_im = dft_matrices(n, analysis_window("han", n, n))
    return w_re, w_im


def _plan(device="cpu", n=NFFT):
    return hopper_stft.fft_plan(port_window("han", n, n), device)


def _audio(B, T, seed, hop=HOP):
    """Hop-block audio whose first hop-block differs from the rest, so the
    t=0 reflect block is exercised."""
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal((B, T, hop, 4)) * 0.1).astype(np.float32)
    a[:, 0] = (rng.uniform(-1, 1, (B, hop, 4)) * 0.8
               + np.linspace(0, 0.5, hop)[None, :, None]).astype(np.float32)
    return a


# plans with a radix-2 pass and frame runs other than the kernel's 2 at
# n_fft 1200: hop -> (radices, frames a block owns = 2400 // n_fft, (B, T))
OTHER_PLANS = {300: ((4, 2, 3, 5, 5), 4, (2, 11)),
               1200: ((4, 4, 2, 3, 5, 5), 1, (1, 3))}


def _close(got, want):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= TOL * scale, (err, scale)


@pytest.mark.parametrize("B,T", [(2, 203), (1, 2)])
def test_hop_block_matches_jax_chunked(B, T):
    w_re, w_im = _dft()
    a = _audio(B, T, seed=T)
    jr, ji = jax_chunked(jnp.asarray(a), jnp.asarray(w_re), jnp.asarray(w_im))
    for tr, ti in (port_stft.stft(torch.tensor(a), torch.tensor(w_re),
                                  torch.tensor(w_im), HOP),
                   hopper_stft.stft_hop_blocks(torch.tensor(a), _plan())):
        _close(tr, jr)
        _close(ti, ji)


@pytest.mark.parametrize("extra", [0, 11, 599])
def test_flat_matches_jax_stft(extra):
    """Flat (B, N, C) input with N not a hop multiple: the wrapper reads
    the hop-block view of the first T*hop samples."""
    w_re, w_im = _dft()
    a = _audio(2, 204, seed=extra).reshape(2, -1, 4)[:, : 203 * HOP + extra]
    a = np.ascontiguousarray(a)
    jr, ji = jax_stft(jnp.asarray(a), NFFT, HOP, NFFT)
    assert jr.shape == (2, 203, 601, 4)
    tr, ti = hopper_stft.stft_hop_blocks(torch.tensor(a), _plan())
    _close(tr, jr)
    _close(ti, ji)
    pr, pi = port_stft.stft(torch.tensor(a), torch.tensor(w_re),
                            torch.tensor(w_im), HOP)
    _close(pr, jr)
    _close(pi, ji)


def test_matches_pallas_interpret():
    """The TPU kernel (interpret mode, at its 200-frame tile) vs the port."""
    from jax.experimental.pallas import tpu as pltpu

    a = _audio(2, 200, seed=5).reshape(2, -1, 4)
    with pltpu.force_tpu_interpret_mode():
        jr, ji = ps.pallas_stft(jnp.asarray(a), NFFT, HOP, NFFT)
    tr, ti = hopper_stft.stft_hop_blocks(torch.tensor(a), _plan())
    _close(tr, jr)
    _close(ti, ji)


def _fft_model(a, plan):
    """K1 as the kernel computes it, in numpy float32/complex64: frames
    from the hop-blocks (frame 0's left half the reflect block), the window
    and the twiddles from ``plan.table``, the 4 channels as two complex
    sequences, Stockham passes in ``plan.radices`` order, then the split
    into the four real channels.  ``a``: (B, T, hop, 4) -> (re, im)."""
    B, T, hop, _ = a.shape
    n = plan.n_fft
    table = plan.table.numpy()
    tw = (table[0:2 * n:2] + 1j * table[1:2 * n:2]).astype(np.complex64)
    win = table[2 * n:]
    flat = a.reshape(B, T * hop, 4)
    left = np.concatenate([flat[:, hop - np.arange(hop)][:, None], a[:, :-1]], axis=1)
    frames = np.concatenate([left, a], axis=2) * win[None, None, :, None]
    x = np.stack([frames[..., 0] + 1j * frames[..., 1],
                  frames[..., 2] + 1j * frames[..., 3]], axis=2).astype(np.complex64)
    ns = 1
    for R in plan.radices:
        m = n // R
        j = np.arange(m)
        k = j % ns
        v = np.stack([x[..., j + r * m] for r in range(R)])
        for r in range(1, R):
            v[r] = v[r] * tw[r * k * (n // (ns * R))]
        w = np.exp(-2j * np.pi * np.outer(np.arange(R), np.arange(R)) / R)
        y = np.einsum("sr,r...->s...", w.astype(np.complex64), v)
        out = np.empty_like(x)
        for r in range(R):
            out[..., (j - k) * R + k + r * ns] = y[r]
        x, ns = out, ns * R
    kk = np.arange(n // 2 + 1)
    z, c = x[..., kk], np.conj(x[..., (-kk) % n])
    xa, xb = (z + c) / 2, (z - c) / 2j  # (B, T, 2, K): channels 0, 2 and 1, 3
    chans = np.stack([xa[:, :, 0], xb[:, :, 0], xa[:, :, 1], xb[:, :, 1]], axis=-1)
    return chans.real.astype(np.float32), chans.imag.astype(np.float32)


@pytest.mark.parametrize("B,T", [(2, 203), (1, 2)])
def test_fft_model_matches_jax_chunked(B, T):
    plan = _plan()
    assert plan.radices == (4, 4, 3, 5, 5)
    w_re, w_im = _dft()
    a = _audio(B, T, seed=T + 1)
    jr, ji = jax_chunked(jnp.asarray(a), jnp.asarray(w_re), jnp.asarray(w_im))
    mr, mi = _fft_model(a, plan)
    _close(mr, jr)
    _close(mi, ji)


@pytest.mark.parametrize("hop", sorted(OTHER_PLANS))
def test_other_plans_match_jax_chunked(hop):
    """The FFT model and the CPU dispatch at the plans that reach the
    radix-2 pass (T not a multiple of the frame run)."""
    radices, frames, (B, T) = OTHER_PLANS[hop]
    plan = _plan(n=2 * hop)
    assert plan.radices == radices and 2400 // plan.n_fft == frames
    assert T % frames != 0 or frames == 1
    w_re, w_im = _dft(2 * hop)
    a = _audio(B, T, seed=hop, hop=hop)
    jr, ji = jax_chunked(jnp.asarray(a), jnp.asarray(w_re), jnp.asarray(w_im))
    for tr, ti in (_fft_model(a, plan), hopper_stft.stft_hop_blocks(torch.tensor(a), plan)):
        _close(tr, jr)
        _close(ti, ji)


def test_cpu_dispatch_builds_the_dft_once():
    plan = _plan()
    window = plan.table[2 * NFFT:]
    first = port_stft.window_dft(window)
    assert port_stft.window_dft(window.clone()) is first
    np.testing.assert_array_equal(first[0].numpy(), _dft()[0])
    np.testing.assert_array_equal(first[1].numpy(), _dft()[1])


def test_fft_model_catches_a_wrong_twiddle_sign():
    """The model fails the bound with the twiddles conjugated, so the
    bound can see the fault the card's mutant check plants."""
    plan = _plan()
    n = plan.n_fft
    bad = _plan()
    bad.table[1:2 * n:2] *= -1
    w_re, w_im = _dft()
    a = _audio(1, 4, seed=9)
    jr, _ = jax_chunked(jnp.asarray(a), jnp.asarray(w_re), jnp.asarray(w_im))
    mr, _ = _fft_model(a, bad)
    assert float(np.abs(mr - np.asarray(jr)).max()) > 100 * TOL * float(np.abs(jr).max())


def test_radix_plan_and_table():
    assert hopper_stft.radix_plan(1200) == (4, 4, 3, 5, 5)
    assert hopper_stft.radix_plan(1024) == (4, 4, 4, 4, 4)
    assert hopper_stft.radix_plan(2 * 3 * 5 * 5) == (2, 3, 5, 5)
    plan = _plan()
    t = plan.table.numpy().astype(np.float64)
    m = np.arange(NFFT)
    np.testing.assert_allclose(t[0:2 * NFFT:2], np.cos(2 * np.pi * m / NFFT), atol=6e-8)
    np.testing.assert_allclose(t[1:2 * NFFT:2], -np.sin(2 * np.pi * m / NFFT), atol=6e-8)
    np.testing.assert_array_equal(t[2 * NFFT:], port_window("han", NFFT, NFFT))


def test_wrapper_rejects_what_the_kernel_does_not_take():
    plan = _plan()
    x = torch.tensor(_audio(2, 4, seed=0))
    with pytest.raises(ValueError, match="channels"):
        hopper_stft.stft_hop_blocks(x[..., :3], plan)
    with pytest.raises(TypeError):
        hopper_stft.stft_hop_blocks(x.double(), plan)
    with pytest.raises(ValueError, match="2 hop-blocks"):
        hopper_stft.stft_hop_blocks(x[:, :1].contiguous(), plan)
    with pytest.raises(ValueError, match="contiguous"):
        hopper_stft.stft_hop_blocks(x.transpose(0, 1), plan)
    with pytest.raises(ValueError, match="n_fft == 2"):
        hopper_stft.stft_hop_blocks(x, hopper_stft.fft_plan(np.ones(1000, np.float32), "cpu"))
    with pytest.raises(ValueError, match="2, 3 and 5"):
        hopper_stft.fft_plan(np.ones(1204, np.float32), "cpu")  # 4 * 7 * 43
    with pytest.raises(ValueError, match="n_fft <= 2400"):
        hopper_stft.fft_plan(np.ones(3000, np.float32), "cpu")
    with pytest.raises(ValueError, match="device"):
        hopper_stft.stft_hop_blocks(x.to("meta"), _plan("meta"))
    with pytest.raises(ValueError, match="device"):
        hopper_stft.stft_hop_blocks(x, _plan("meta"))
    before = hopper_stft.LAUNCHES
    hopper_stft.stft_hop_blocks(x, plan)  # CPU: plain version
    assert hopper_stft.LAUNCHES == before


# flat audio whose length is not a multiple of the hop (203 frames + 17)
FLAT = (2, 203 * HOP + 17)


def _flat_audio(seed):
    return np.ascontiguousarray(_audio(FLAT[0], 204, seed).reshape(FLAT[0], -1, 4)[:, :FLAT[1]])


def test_flat_input_matches_jax_framed_dft():
    """Flat (B, N, 4) audio through the wrapper's CPU dispatch against JAX
    ``framed_dft`` of the reflect-padded first T * hop samples (T = N //
    hop), within 2e-5 * max."""
    a = _flat_audio(seed=12)
    T = FLAT[1] // HOP
    lpad = NFFT // 2
    xp = np.pad(a[:, :T * HOP], ((0, 0), (lpad, 0), (0, 0)), mode="reflect")
    w_re, w_im = _dft()
    jr, ji = jax_framed_dft(jnp.asarray(xp), NFFT, HOP, T, jnp.asarray(w_re), jnp.asarray(w_im))
    re, im = hopper_stft.stft_hop_blocks(torch.tensor(a), _plan())
    assert re.shape == (FLAT[0], T, HOP + 1, 4)
    _close(re, jr)
    _close(im, ji)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper STFT kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B,T", [(3, 803), (2, 2), (1, 2), (2, 7)])
def test_kernel_matches_plain_on_cuda(cuda_device, B, T):
    """(2, 7): T not a multiple of the kernel's 2-frame run."""
    w_re, w_im = (torch.tensor(w, device=cuda_device) for w in _dft())
    x = torch.tensor(_audio(B, T, seed=1), device=cuda_device)
    before = hopper_stft.LAUNCHES
    kr, ki = hopper_stft.stft_hop_blocks(x, _plan(cuda_device))
    torch.cuda.synchronize()
    assert hopper_stft.LAUNCHES == before + 1
    pr, pi = port_stft.stft(x, w_re, w_im, HOP)
    _close(kr.cpu(), pr.cpu())
    _close(ki.cpu(), pi.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("hop", sorted(OTHER_PLANS))
def test_kernel_other_plans_match_plain_on_cuda(cuda_device, hop):
    """The radix-2 pass and runs of 4 and of 1 frames, on the card."""
    _, _, (B, T) = OTHER_PLANS[hop]
    w_re, w_im = (torch.tensor(w, device=cuda_device) for w in _dft(2 * hop))
    x = torch.tensor(_audio(B, T + 4, seed=hop, hop=hop), device=cuda_device)
    kr, ki = hopper_stft.stft_hop_blocks(x, _plan(cuda_device, 2 * hop))
    pr, pi = port_stft.stft(x, w_re, w_im, hop)
    _close(kr.cpu(), pr.cpu())
    _close(ki.cpu(), pi.cpu())


@pytest.mark.cuda
def test_kernel_flat_input_matches_plain_on_cuda(cuda_device):
    """Flat audio (2, 203 * 600 + 17, 4) through the kernel against the
    plain flat framing ``framed_dft_flat`` of the same samples."""
    w_re, w_im = (torch.tensor(w, device=cuda_device) for w in _dft())
    x = torch.tensor(_flat_audio(seed=13), device=cuda_device)
    before = hopper_stft.LAUNCHES
    kr, ki = hopper_stft.stft_hop_blocks(x, _plan(cuda_device))
    torch.cuda.synchronize()
    assert hopper_stft.LAUNCHES == before + 1
    pr, pi = port_stft.framed_dft_flat(x, w_re, w_im, HOP)
    _close(kr.cpu(), pr.cpu())
    _close(ki.cpu(), pi.cpu())
