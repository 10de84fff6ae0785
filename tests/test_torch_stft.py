"""Port STFT vs the JAX package's STFT paths.

The plain PyTorch STFT (``adyolo_tpu_torch.ops.stft``) and the Hopper
wrapper's CPU dispatch are held against JAX ``framed_dft_chunked`` /
``stft`` and the Pallas kernel in interpret mode, within 2e-5 * max|re|
(float32 sums over 1200 taps in different orders; measured ~1e-6).
The kernel itself runs only on a CUDA device (``-m cuda``).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from adyolo_tpu.ops import pallas_stft as ps
from adyolo_tpu.ops.dsp import analysis_window, dft_matrices
from adyolo_tpu.ops.stft import framed_dft_chunked as jax_chunked
from adyolo_tpu.ops.stft import stft as jax_stft
from adyolo_tpu_torch.ops import hopper_stft
from adyolo_tpu_torch.ops import stft as port_stft

HOP, NFFT = 600, 1200
TOL = 2e-5


def _dft():
    w_re, w_im = dft_matrices(NFFT, analysis_window("han", NFFT, NFFT))
    return w_re, w_im


def _audio(B, T, seed):
    """Hop-block audio whose first hop-block differs from the rest, so the
    t=0 reflect block is exercised."""
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal((B, T, HOP, 4)) * 0.1).astype(np.float32)
    a[:, 0] = (rng.uniform(-1, 1, (B, HOP, 4)) * 0.8
               + np.linspace(0, 0.5, HOP)[None, :, None]).astype(np.float32)
    return a


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
    for fn in (lambda x, r, i: port_stft.stft(x, r, i, HOP),
               hopper_stft.stft_hop_blocks):
        tr, ti = fn(torch.tensor(a), torch.tensor(w_re), torch.tensor(w_im))
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
    tr, ti = hopper_stft.stft_hop_blocks(torch.tensor(a), torch.tensor(w_re),
                                         torch.tensor(w_im))
    _close(tr, jr)
    _close(ti, ji)
    pr, pi = port_stft.stft(torch.tensor(a), torch.tensor(w_re),
                            torch.tensor(w_im), HOP)
    _close(pr, jr)
    _close(pi, ji)


def test_matches_pallas_interpret():
    """The TPU kernel (interpret mode, at its 200-frame tile) vs the port."""
    from jax.experimental.pallas import tpu as pltpu

    w_re, w_im = _dft()
    a = _audio(2, 200, seed=5).reshape(2, -1, 4)
    with pltpu.force_tpu_interpret_mode():
        jr, ji = ps.pallas_stft(jnp.asarray(a), NFFT, HOP, NFFT)
    tr, ti = hopper_stft.stft_hop_blocks(torch.tensor(a), torch.tensor(w_re),
                                         torch.tensor(w_im))
    _close(tr, jr)
    _close(ti, ji)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    w_re, w_im = (torch.tensor(w) for w in _dft())
    x = torch.tensor(_audio(2, 4, seed=0))
    with pytest.raises(ValueError, match="channels"):
        hopper_stft.stft_hop_blocks(x[..., :3], w_re, w_im)
    with pytest.raises(TypeError):
        hopper_stft.stft_hop_blocks(x.double(), w_re, w_im)
    with pytest.raises(ValueError, match="2 hop-blocks"):
        hopper_stft.stft_hop_blocks(x[:, :1].contiguous(), w_re, w_im)
    with pytest.raises(ValueError, match="contiguous"):
        hopper_stft.stft_hop_blocks(x.transpose(0, 1), w_re, w_im)
    with pytest.raises(ValueError, match="n_fft == 2"):
        hopper_stft.stft_hop_blocks(x, w_re[:1000], w_im[:1000])
    with pytest.raises(ValueError, match="device"):
        hopper_stft.stft_hop_blocks(x.to("meta"), w_re.to("meta"),
                                    w_im.to("meta"))
    before = hopper_stft.LAUNCHES
    hopper_stft.stft_hop_blocks(x, w_re, w_im)  # CPU: plain version
    assert hopper_stft.LAUNCHES == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper STFT kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B,T", [(3, 803), (2, 2)])
def test_kernel_matches_plain_on_cuda(cuda_device, B, T):
    w_re, w_im = (torch.tensor(w, device=cuda_device) for w in _dft())
    x = torch.tensor(_audio(B, T, seed=1), device=cuda_device)
    before = hopper_stft.LAUNCHES
    kr, ki = hopper_stft.stft_hop_blocks(x, w_re, w_im)
    torch.cuda.synchronize()
    assert hopper_stft.LAUNCHES == before + 1
    pr, pi = port_stft.stft(x, w_re, w_im, HOP)
    _close(kr.cpu(), pr.cpu())
    _close(ki.cpu(), pi.cpu())
