"""Port STFT vs the JAX package's STFT paths.

The plain PyTorch STFT (``adyolo_tpu_torch.ops.stft``) and the Hopper
wrapper's CPU dispatch are held against JAX ``framed_dft_chunked`` /
``stft`` and the Pallas kernel in interpret mode, within 2e-5 * max|re|
(float32 sums over 1200 taps in different orders; measured ~1e-6).
A numpy model of the kernel's FFT (the radix plan, the float32 table of
``fft_plan``, the pass order and the channel-pair split) is held against
JAX ``framed_dft_chunked`` within the same bound.  The frames kernel (flat
audio at any hop): a numpy model of its edge rules and radix plan against
JAX ``framed_dft`` under ``jax.enable_x64`` within 2.5e-7 x max at its four
geometries (a left reflection off by one fails it), and the CPU dispatch
against JAX's front-end STFT within 2e-5 x max.  The launchers' failure
reports are read through a fake library.  The kernels themselves run only
on a CUDA device (``-m cuda``).
"""
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from adyolo_tpu.ops import pallas_stft as ps
from adyolo_tpu.ops.dsp import analysis_window, dft_matrices
from adyolo_tpu.ops.stft import framed_dft as jax_framed_dft
from adyolo_tpu.ops.stft import framed_dft_chunked as jax_chunked
from adyolo_tpu.ops.stft import stft as jax_stft
from adyolo_tpu.ops.features import _stft_re_im as jax_stft_re_im
from adyolo_tpu_torch.ops import hopper_stft
from adyolo_tpu_torch.ops import stft as port_stft
from adyolo_tpu_torch.ops.dsp import analysis_window as port_window
from adyolo_tpu_torch.utils import build

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
    win = plan.table.numpy()[2 * n:]
    flat = a.reshape(B, T * hop, 4)
    left = np.concatenate([flat[:, hop - np.arange(hop)][:, None], a[:, :-1]], axis=1)
    return _fft_passes(np.concatenate([left, a], axis=2) * win[None, None, :, None], plan)


def _fft_passes(frames, plan):
    """The kernels' FFT of windowed ``frames`` (B, T, n_fft, 4) float32:
    the channel pairs, the Stockham passes and the split (see
    :func:`_fft_model`)."""
    n = plan.n_fft
    table = plan.table.numpy()
    tw = (table[0:2 * n:2] + 1j * table[1:2 * n:2]).astype(np.complex64)
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
    with pytest.raises(ValueError, match="n_fft <= 4096"):
        hopper_stft.fft_plan(np.ones(4500, np.float32), "cpu")  # 4 * 9 * 125
    with pytest.raises(ValueError, match="even n_fft"):
        hopper_stft.fft_plan(np.ones(1125, np.float32), "cpu")
    with pytest.raises(ValueError, match="hop-block width"):
        hopper_stft.stft_hop_blocks(x, plan, 300)
    with pytest.raises(ValueError, match="too short"):  # N <= n_fft / 2: no reflection
        hopper_stft.stft_hop_blocks(torch.zeros(1, 1024, 4), _frames_plan(2048, 1200), 600)
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


# (n_fft, hop, win_length) of the frames kernel's cases: the DCASE
# baseline's 2048 / 600 / 1200, n_fft equal to a power-of-two window, a
# 2400 window in its own n_fft, 48-kHz audio's 2400 window in 4096
FRAME_GEOMETRIES = [(2048, 600, 1200), (1024, 600, 1024), (2400, 600, 2400),
                    (4096, 1200, 2400)]
MODEL_TOL = 2.5e-7  # the numpy model against float64 JAX, x max


def _frames_plan(n_fft, win, device="cpu"):
    return hopper_stft.fft_plan(port_window("han", win, n_fft), device)


def _flat_frames_audio(n_fft, hop, seed):
    """(2, 203 hops + 17, 4) audio whose first n_fft samples, the ones the
    reflected left edge reads, are unlike the rest."""
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal((2, 203 * hop + 17, 4)) * 0.1).astype(np.float32)
    a[:, :n_fft] = rng.uniform(-0.8, 0.8, (2, n_fft, 4))
    return a


def _frames_model(x, plan, hop, reflect_shift=0):
    """The frames kernel as it computes, in numpy float32/complex64: frame
    t's sample m reads s = t hop + m - n_fft/2 of the flat clip, x[-s +
    reflect_shift] left of 0 (0: librosa's reflection), zero from N on;
    the table's window; then :func:`_fft_passes`.  ``x``: (B, N, 4)."""
    B, N, _ = x.shape
    n = plan.n_fft
    T = N // hop
    s = np.arange(T)[:, None] * hop + np.arange(n)[None, :] - n // 2
    src = np.where(s < 0, -s + reflect_shift, s)
    frames = np.where((src < N)[None, :, :, None], x[:, np.minimum(src, N - 1)], 0.0)
    return _fft_passes((frames * plan.table.numpy()[2 * n:][None, None, :, None])
                       .astype(np.float32), plan)


def _jax_framed_dft64(x, n_fft, hop, win):
    """JAX's flat-audio STFT (``features._stft_re_im``'s padding, then
    ``framed_dft``) on float64 audio under ``jax.enable_x64``: the sums in
    float64 over the float32 DFT matrices, the result rounded to float32."""
    w_re, w_im = dft_matrices(n_fft, analysis_window("han", win, n_fft))
    B, N, _ = x.shape
    T = N // hop
    with jax.enable_x64():
        xp = jnp.pad(jnp.asarray(x, jnp.float64), ((0, 0), (n_fft // 2, 0), (0, 0)),
                     mode="reflect")
        rpad = (T - 1) * hop + n_fft - xp.shape[1]
        if rpad > 0:
            xp = jnp.pad(xp, ((0, 0), (0, rpad), (0, 0)))
        re, im = jax_framed_dft(xp, n_fft, hop, T, jnp.asarray(w_re, jnp.float64),
                                jnp.asarray(w_im, jnp.float64))
        return np.asarray(re), np.asarray(im)


@pytest.mark.parametrize("n_fft,hop,win", FRAME_GEOMETRIES)
def test_frames_model_matches_jax_framed_dft(n_fft, hop, win):
    """The frames kernel's radix plan and edge rules, modelled, against
    JAX ``framed_dft`` in float64 within 2.5e-7 x max; the same model with
    the left reflection off by one sample is far outside it."""
    plan = _frames_plan(n_fft, win)
    assert plan.radices == hopper_stft.radix_plan(n_fft)
    assert hopper_stft.kernel_of(n_fft, hop) == "stft_frames_fft_kernel"
    a = _flat_frames_audio(n_fft, hop, seed=n_fft)
    jr, ji = _jax_framed_dft64(a, n_fft, hop, win)
    assert jr.shape == (2, 203, n_fft // 2 + 1, 4)
    scale = max(float(np.abs(jr).max()), float(np.abs(ji).max()))
    mr, mi = _frames_model(a, plan, hop)
    err = max(float(np.abs(mr - jr).max()), float(np.abs(mi - ji).max()))
    assert err <= MODEL_TOL * scale, (err, scale)
    br, bi = _frames_model(a, plan, hop, reflect_shift=1)
    bad = max(float(np.abs(br - jr).max()), float(np.abs(bi - ji).max()))
    assert bad > 1e4 * MODEL_TOL * scale, (bad, scale)


@pytest.mark.parametrize("n_fft,hop,win", FRAME_GEOMETRIES)
def test_flat_any_hop_matches_jax_front_end_stft(n_fft, hop, win):
    """The wrapper's CPU dispatch on flat audio at n_fft != 2 * hop (the
    plain flat framing, no launch) against the JAX front-end's STFT of flat
    audio within 2e-5 x max."""
    w_re, w_im = dft_matrices(n_fft, analysis_window("han", win, n_fft))
    a = _flat_frames_audio(n_fft, hop, seed=n_fft + 1)
    jr, ji = jax_stft_re_im(jnp.asarray(a), n_fft, hop, jnp.asarray(w_re), jnp.asarray(w_im))
    before = dict(hopper_stft.KERNELS)
    re, im = hopper_stft.stft_hop_blocks(torch.tensor(a), _frames_plan(n_fft, win), hop)
    assert hopper_stft.KERNELS == before
    assert re.shape == (2, 203, n_fft // 2 + 1, 4)
    _close(re, jr)
    _close(im, ji)


def test_hop_block_audio_needs_n_fft_twice_the_hop():
    """As JAX's ``framed_dft_chunked``: hop-block audio at another n_fft
    raises (flat audio is the input there); the kernel of each geometry."""
    x = torch.tensor(_audio(1, 4, seed=3))
    with pytest.raises(ValueError, match="n_fft == 2\\*hop"):
        hopper_stft.stft_hop_blocks(x, _frames_plan(2048, 1200), HOP)
    with pytest.raises(ValueError, match="n_fft == 2\\*hop"):
        jax_chunked(jnp.asarray(x.numpy()), *map(jnp.asarray, dft_matrices(
            2048, analysis_window("han", 1200, 2048))))
    assert hopper_stft.kernel_of(1200, 600) == "stft_hop_blocks_fft_kernel"
    assert hopper_stft.kernel_of(2400, 1200) == "stft_hop_blocks_fft_kernel"
    # n_fft = 2 * hop above the hop-block kernel's 2400: the frames kernel
    assert hopper_stft.kernel_of(4000, 2000) == "stft_frames_fft_kernel"
    assert hopper_stft.radix_plan(2048) == (4, 4, 4, 4, 4, 2)
    assert hopper_stft.radix_plan(4096) == (4,) * 6
    assert hopper_stft.radix_plan(2400) == (4, 4, 2, 3, 5, 5)


def _fake_library(record):
    """A kernel library whose last failure is ``record``: (entry, site,
    code, name), or None for none recorded."""

    strings = None if record is None else [t.encode() for t in record[:2] + record[3:]]

    def adyolo_last_error(entry, site, code, name):
        if record is None:
            return 0
        # c_char_p points into these bytes, which the closure keeps alive
        entry.contents.value, site.contents.value, name.contents.value = strings
        code.contents.value = record[2]
        return 1

    return types.SimpleNamespace(adyolo_last_error=adyolo_last_error)


def test_launch_errors_name_the_entry_the_site_and_the_error(monkeypatch):
    """A refused launch raises with the C entry point, the failing site and
    the CUDA error's name, as the library recorded them on the thread; with
    no record, the return code alone."""
    rec = ("adyolo_mhsa_bwd_bf16", "head_map(dout): address 0x7f0000000002 is not "
           "16-byte aligned", 1, "cudaErrorInvalidValue")
    monkeypatch.setattr(build, "load_library", lambda: _fake_library(rec))
    err = build.launch_error("attention kernel launch refused", 1)
    assert isinstance(err, build.KernelLaunchError)
    assert (err.entry, err.site, err.code, err.name) == rec
    assert str(err) == ("attention kernel launch refused: adyolo_mhsa_bwd_bf16: "
                        "head_map(dout): address 0x7f0000000002 is not 16-byte aligned: "
                        "cudaErrorInvalidValue (1)")
    monkeypatch.setattr(build, "load_library", lambda: _fake_library(None))
    err = build.launch_error("STFT kernel launch refused", 700)
    assert err.code == 700 and "no failure recorded" in str(err)


def test_every_c_entry_point_records_where_it_failed():
    """Each launcher of csrc/ starts with ``enter`` (a pending error is
    refused, not read as its own) and returns no bare CUDA error: every
    failing return goes through ``fail``, ``fail_driver`` or
    ``check_launch``, and no site reads ``cudaGetLastError`` itself."""
    import os
    import re

    csrc = os.path.join(os.path.dirname(hopper_stft.__file__), os.pardir, "csrc")
    entries = []
    for name in ("attention.cu", "stft.cu"):
        with open(os.path.join(csrc, name)) as f:
            src = f.read()
        assert "return (int)cudaError" not in src and "return (int)e;" not in src
        assert "cudaGetLastError" not in src
        for m in re.finditer(r'extern "C" (?:int|long long) (adyolo_\w+)\(', src):
            body = src[m.end():src.index("\n}\n", m.end())]
            launches = "<<<" in body or "launch_fwd" in body or "fwd_splits" in body
            if launches:
                assert f'enter("{m.group(1)}")' in body, m.group(1)
                entries.append(m.group(1))
    assert sorted(entries) == sorted(
        ["adyolo_stft_fft", "adyolo_stft_frames_fft", "adyolo_mhsa_fwd_splits",
         "adyolo_mhsa_fwd_bf16_splits", "adyolo_mhsa_fwd", "adyolo_mhsa_fwd_train",
         "adyolo_mhsa_bwd", "adyolo_mhsa_fwd_train_bf16", "adyolo_mhsa_fwd_bf16",
         "adyolo_mhsa_bwd_bf16"])


@pytest.mark.cuda
@pytest.mark.parametrize("n_fft,hop,win", FRAME_GEOMETRIES)
def test_frames_kernel_matches_plain_on_cuda(cuda_device, n_fft, hop, win):
    """The frames kernel on flat audio against the plain flat framing of
    the same samples, one launch a call."""
    w_re, w_im = (torch.tensor(w, device=cuda_device)
                  for w in dft_matrices(n_fft, analysis_window("han", win, n_fft)))
    x = torch.tensor(_flat_frames_audio(n_fft, hop, seed=n_fft + 2), device=cuda_device)
    before = hopper_stft.KERNELS["stft_frames_fft_kernel"]
    kr, ki = hopper_stft.stft_hop_blocks(x, _frames_plan(n_fft, win, cuda_device), hop)
    torch.cuda.synchronize()
    assert hopper_stft.KERNELS["stft_frames_fft_kernel"] == before + 1
    pr, pi = port_stft.framed_dft_flat(x, w_re, w_im, hop)
    _close(kr.cpu(), pr.cpu())
    _close(ki.cpu(), pi.cpu())
