"""Port STFT vs the JAX package's STFT paths.

The plain PyTorch STFT (``adyolo_tpu_torch.ops.stft``) and the Hopper
wrapper's CPU dispatch are held against JAX ``framed_dft_chunked`` /
``stft`` and the Pallas kernel in interpret mode, within 2e-5 * max|re|
(float32 sums over 1200 taps in different orders; measured ~1e-6).
A numpy model of the kernel's FFT (the radix plan, the float32 table of
``fft_plan``, the pass order and the channel-pair split) is held against
JAX ``framed_dft_chunked`` within the same bound.  The frames kernel (every
other geometry): a numpy model of its tiles (``hopper_stft.frames_config``:
each tile's span staged from the same index arithmetic, reflected at the
left edge, zeros from N on), its radix plan (register radices as R-point
DFTs after the pass's twiddles, the primes 7 to 31 as prime passes, whose
roots sit at ``r s mod p``), the pair split, and its global route (the
four-step FFT of ``hopper_stft.global_config``: columns of n1 points,
Bluestein's chirp-z from ``hopper_stft.chirp_table`` where n1 is the
product of primes above 31, the W_n^(b c) twiddles, rows of n2 points)
against JAX ``framed_dft`` under ``jax.enable_x64`` within 2.5e-7 x max: at
the four geometries of its first design, at 2204 / 1102 (G3), 4800 / 2400
(G4), 2205 / 1102 (G5), 2402 / 1201 (Bluestein on 1201) and an odd 75 /
30, on the global route at 2205 and 75, and at 7919, 9600, 11274 and 16384;
a left reflection off by one, a root index off by one in a prime pass, or
the chirp's index off by one, fails it.  The in-place passes of Bluestein's
FFTs, emulated, leave the order the filters are stored in.  The CPU
dispatch against JAX's front-end STFT within 2e-5 x max.  The launchers'
failure reports are read through a fake library.  The kernels
themselves run only on a CUDA device (``-m cuda``).
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
    # every n_fft >= 2 has a plan: another prime factor than 2, 3 and 5 (43:
    # Bluestein on the global route), above 4096, odd (at any hop)
    frames = {"stft_frames_fft_kernel": 1}
    for n, radices, kernels in (
            (1204, (4, 7, 43), {"stft_frames_cols_kernel": 1, "stft_frames_rows_kernel": 1}),
            (4500, (4, 3, 3, 5, 5, 5), frames), (1125, (3, 3, 5, 5, 5), frames)):
        p = hopper_stft.fft_plan(np.ones(n, np.float32), "cpu")
        assert p.frames_radices == radices and hopper_stft.kernels_of(n, n // 2) == kernels
    with pytest.raises(ValueError, match="n_fft >= 2"):
        hopper_stft.fft_plan(np.ones(1, np.float32), "cpu")
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
# the geometries only the frames kernel takes: the DCASE preset's 25 / 50 ms
# at 44.1 kHz as n_fft = 2 hop = 2^2 19 29 (G3), at 96 kHz (G4, above the
# first design's 4096), its exact 50-ms window at 44.1 kHz (G5, odd, 3^2 5
# 7^2), a large prime (2402 = 2 x 1201, Bluestein on the global route) and a
# small odd n_fft
NEW_GEOMETRIES = [(2204, 1102, 2204), (4800, 2400, 4800), (2205, 1102, 2205),
                  (2402, 1201, 2402), (75, 30, 60)]
MODEL_TOL = 2.5e-7  # the numpy model against float64 JAX, x max

# the edges of the shared routes: shared_wide at one span slot (8192), then
# the global route: the prime 7919 (Bluestein in two output blocks), 9600
# (100 x 96 in register radices) and 11274 = 1879 x 6 (Bluestein columns)
EDGE_GEOMETRIES = [(8192, 2048, 8192), (7919, 1980, 7919), (9600, 2400, 9600),
                   (11274, 4000, 11274)]
# the global route's model cases (three frames each: float64 DFT matrices
# of 16384 points are 2 GB); the prime 14087 on its whole-frame Bluestein
GLOBAL_GEOMETRIES = [(7919, 1980, 7919), (9600, 2400, 9600), (11274, 4000, 11274),
                     (16384, 4096, 16384), (14087, 3522, 14087)]


def _frames_plan(n_fft, win, device="cpu"):
    return hopper_stft.fft_plan(port_window("han", win, n_fft), device)


def _flat_frames_audio(n_fft, hop, seed, frames=203):
    """(2, frames hops + 17, 4) audio whose first n_fft samples, the ones
    the reflected left edge reads, are unlike the rest."""
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal((2, frames * hop + 17, 4)) * 0.1).astype(np.float32)
    a[:, :n_fft] = rng.uniform(-0.8, 0.8, (2, min(n_fft, a.shape[1]), 4))
    return a


def _frames_model(x, plan, hop, reflect_shift=0, root_shift=0, route=None, chirp_shift=0,
                  whole_m=None):
    """The frames kernel as it computes, in numpy float32/complex64 (the
    prime passes' and Bluestein's sums in complex128): on its shared routes
    tiles of F frames (``frames_config``), each tile's span of (nf - 1) hop
    + n_fft samples staged from signal sample t0 hop - n_fft // 2 on, x[-s +
    reflect_shift] left of 0 (0: librosa's reflection), zero from N on, and
    frame f's sample m read at f hop + m; on the global route (``route`` 2)
    each frame read from the clip by the same rule; the table's window;
    then :func:`_passes` or, on the global route, :func:`_four_step`, and
    :func:`_split`; on the global route's whole-frame Bluestein (or with
    ``whole_m``, that plan at M = ``whole_m`` whatever the route)
    :func:`_chirp_blocks` and the split of its bins and mirrors.
    ``x``: (B, N, 4)."""
    B, N, _ = x.shape
    n = plan.n_fft
    T = N // hop
    cfg = hopper_stft.frames_config(n, hop)
    route = cfg.route if route is None else route
    frames = np.zeros((B, T, n, 4), np.float32)

    def staged(b, first, length):
        s = first + np.arange(length)
        src = np.where(s < 0, -s + reflect_shift, s)
        return np.where((src < N)[:, None], x[b, np.minimum(src, N - 1)], 0.0)

    for b in range(B):
        if route >= 2:  # global, four_step
            for t in range(T):
                frames[b, t] = staged(b, t * hop - n // 2, n)
            continue
        for t0 in range(0, T, cfg.frames):
            nf = min(cfg.frames, T - t0)
            span = staged(b, t0 * hop - n // 2, (nf - 1) * hop + n)
            for f in range(nf):
                frames[b, t0 + f] = span[f * hop:f * hop + n]
    frames = (frames * plan.table.numpy()[2 * n:][None, None, :, None]).astype(np.float32)
    pairs = np.stack([frames[..., 0] + 1j * frames[..., 1],
                      frames[..., 2] + 1j * frames[..., 3]], axis=2).astype(np.complex64)
    if whole_m is not None or (route == 2 and hopper_stft.global_config(n).segments):
        g = (hopper_stft.global_config(n) if whole_m is None
             else hopper_stft._chirp_config(n, whole_m))
        return _split_pairs(*_chirp_blocks(pairs, g, chirp_shift))
    z = (_four_step(pairs, plan, root_shift, chirp_shift) if route >= 2
         else _passes(pairs, plan, n, 1, root_shift))
    return _split(z)


def _table_twiddles(plan):
    n = plan.n_fft
    table = plan.table.numpy()
    return (table[0:2 * n:2] + 1j * table[1:2 * n:2]).astype(np.complex64)


def _passes(x, plan, length, step, root_shift=0):
    """The kernel's Stockham passes of the plan rule's radices over the
    last axis of ``x`` (transforms of ``length`` points; the table's
    twiddles at step ``step``, as ``gather_tables`` reads them): a register
    radix R turns input r of butterfly j by tw[r k stride], k = j mod ns,
    then takes the R-point DFT; a prime p (7 to 31) the same twiddles, then
    output s the sum over r of its input times the root tw[((r s +
    root_shift) mod p) length/p step]."""
    tw = _table_twiddles(plan)
    ns = 1
    for R in hopper_stft._radix_rule(length):
        m = length // R
        j = np.arange(m)
        k = j % ns
        v = np.stack([x[..., j + r * m] * tw[r * k * (length // (ns * R)) * step]
                      for r in range(R)])
        if R in hopper_stft._REGISTER_RADICES:
            w = np.exp(-2j * np.pi * np.outer(np.arange(R), np.arange(R)) / R)
            y = np.einsum("sr,r...->s...", w.astype(np.complex64), v)
        else:
            assert R in hopper_stft._PRIME_RADICES, R
            rs = (np.outer(np.arange(R), np.arange(R)) + root_shift) % R
            y = np.einsum("sr,r...->s...", tw[rs * m * step].astype(np.complex128),
                          v.astype(np.complex128)).astype(np.complex64)
        out = np.empty_like(x)
        for r in range(R):
            out[..., (j - k) * R + k + r * ns] = y[r]
        x, ns = out, ns * R
    return x


def _bluestein(x, g, chirps, chirp_shift=0):
    """Bluestein's chirp-z over the last axis of ``x`` (q points) as the
    kernel computes it from the float32 chirp table: u = x conj(b), zeros
    to M; per output block j, v = IDFT(DFT(u) H_j) with H_j read from the
    table's digit-reversed order; bin s = conj(b_s) v_{s - j S}.
    ``chirp_shift``: the chirp's index one off, (r + 1)^2 for r^2."""
    q, M = g.q, g.m_len
    t = chirps.numpy().astype(np.float64)
    c = t[0::2] + 1j * t[1::2]
    cc = c[:q]
    h = c[q + M:].reshape(g.blocks, M)
    if chirp_shift:
        r = np.arange(q, dtype=np.int64) + chirp_shift
        cc = np.exp(-1j * np.pi * ((r * r) % (2 * q)) / q).astype(np.complex64)
    order = hopper_stft._dif_order(M, g.m_radices)
    u = np.zeros(x.shape[:-1] + (M,), np.complex128)
    u[..., :q] = x * cc
    U = np.fft.fft(u, axis=-1)
    y = np.empty(x.shape, np.complex128)
    for j in range(g.blocks):
        hn = np.empty(M, np.complex128)
        hn[order] = h[j]
        v = np.fft.ifft(U * hn, axis=-1) * M
        s = np.arange(j * g.outs, min(q, (j + 1) * g.outs))
        y[..., s] = cc[s] * v[..., s - j * g.outs]
    return y.astype(np.complex64)


def _chirp_blocks(x, g, chirp_shift=0):
    """The global route's whole-frame Bluestein over the last axis of ``x``
    (n points) as its two kernels compute it, from the chirp table rounded
    to float32 (:func:`hopper_stft._chirp_values`): u = x conj(b); each
    input block i of S = M / 2 samples, zeros to M, transformed; for each
    lower output block s, the sum over i of U_i times the filter of offset
    (s - i) S, transformed back, times conj(b_k) at bins k = sS + t; its
    mirror block the same with the filter of offset n + 1 - (s + i + 1) S,
    read at t' = S - 1 - t for bin n - k.  Returns the bins k <= n/2 and
    their mirrors X[n - k] (X[n] for k = 0).  ``chirp_shift``: the chirp's
    index one off, (r + 1)^2 for r^2."""
    q, M, S, P, O = g.q, g.m_len, g.outs, g.blocks, g.segments
    c = hopper_stft._chirp_values(g).astype(np.complex64).astype(np.complex128)
    cc = c[:q + 1]
    if chirp_shift:
        r = np.arange(q + 1, dtype=np.int64) + chirp_shift
        cc = np.exp(-1j * np.pi * ((r * r) % (2 * q)) / q).astype(np.complex64)
    h = np.empty((2 * (P + O - 1), M), np.complex128)
    h[:, hopper_stft._dif_order(M, g.m_radices)] = c[q + 1 + M:].reshape(-1, M)
    u = np.zeros(x.shape[:-1] + (P, M), np.complex128)
    for i in range(P):
        part = x[..., i * S:(i + 1) * S] * cc[i * S:i * S + S][:x.shape[-1] - i * S]
        u[..., i, :part.shape[-1]] = part
    U = np.fft.fft(u, axis=-1)
    K = q // 2 + 1
    low = np.empty(x.shape[:-1] + (K,), np.complex128)
    mirror = np.empty_like(low)
    for s in range(O):
        k = np.arange(s * S, min(K, (s + 1) * S))
        t = k - s * S
        v = np.fft.ifft(np.einsum("...im,im->...m", U, h[s - np.arange(P) + P - 1]), axis=-1)
        low[..., k] = cc[k] * v[..., t] * M
        v = np.fft.ifft(np.einsum("...im,im->...m", U, h[P + O - 1 + s + np.arange(P)]),
                        axis=-1)
        mirror[..., k] = cc[q - k] * v[..., S - 1 - t] * M
    return low.astype(np.complex64), mirror.astype(np.complex64)


def _four_step_twiddles(tw, e):
    """W_n^e as the kernel forms it from its two-level table
    (``stft.cu::four_step_twiddle``): tw[e mod 128] tw[128 floor(e / 128)],
    multiplied in complex64."""
    return (tw[e % 128] * tw[(e // 128) * 128]).astype(np.complex64)


def _four_step(x, plan, root_shift=0, chirp_shift=0):
    """The global route over the last axis of ``x`` (n_fft points): column
    b of sample n2 a + b, its n1-point transform (the passes, or Bluestein),
    times W_n^(b c) (:func:`_four_step_twiddles`); then row c's n2-point
    transform over b, bin c + n1 d."""
    n = plan.n_fft
    g = hopper_stft.global_config(n)
    n1, n2 = g.n1, g.n2
    tw = _table_twiddles(plan)
    cols = np.swapaxes(x.reshape(x.shape[:-1] + (n1, n2)), -1, -2)  # (..., b, a)
    if g.q:
        y = _bluestein(cols, g, hopper_stft.chirp_table(n, "cpu"), chirp_shift)
    else:
        y = _passes(cols, plan, n1, n2, root_shift)
    y = y * _four_step_twiddles(tw, np.outer(np.arange(n2), np.arange(n1)))
    rows = _passes(np.swapaxes(y, -1, -2), plan, n2, n1, root_shift)  # (..., c, d)
    return np.swapaxes(rows, -1, -2).reshape(x.shape)  # bin c + n1 d


def _split(x):
    """The channel-pair split of Z (..., 2, n) into bins 0..n/2 of the four
    channels, re and im."""
    n = x.shape[-1]
    kk = np.arange(n // 2 + 1)
    return _split_pairs(x[..., kk], x[..., (-kk) % n])


def _split_pairs(z, mirror):
    """The split of bins Z[k] (..., 2, n/2 + 1) and their mirrors Z[n - k]
    into the four channels, re and im."""
    c = np.conj(mirror)
    xa, xb = (z + c) / 2, (z - c) / 2j
    chans = np.stack([xa[:, :, 0], xb[:, :, 0], xa[:, :, 1], xb[:, :, 1]], axis=-1)
    return chans.real.astype(np.float32), chans.imag.astype(np.float32)


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


def _frames_case(n_fft, hop, win, seed):
    """Audio of a frames case (203 frames; 23 at the new geometries, whose
    float64 references cost more; 3 at the global route's) and its float64
    JAX STFT."""
    frames = (203 if (n_fft, hop, win) in FRAME_GEOMETRIES
              else 3 if (n_fft, hop, win) in GLOBAL_GEOMETRIES else 23)
    a = _flat_frames_audio(n_fft, hop, seed=seed, frames=frames)
    jr, ji = _jax_framed_dft64(a, n_fft, hop, win)
    assert jr.shape == (2, frames, n_fft // 2 + 1, 4)
    return a, jr, ji, max(float(np.abs(jr).max()), float(np.abs(ji).max()))


def _model_err(got, jr, ji):
    return max(float(np.abs(got[0] - jr).max()), float(np.abs(got[1] - ji).max()))


@pytest.mark.parametrize("n_fft,hop,win", FRAME_GEOMETRIES + NEW_GEOMETRIES)
def test_frames_model_matches_jax_framed_dft(n_fft, hop, win):
    """The frames kernel's tiles, edge rules and radix plan (on the global
    route at 2402: Bluestein on 1201), modelled, against JAX ``framed_dft``
    in float64 within 2.5e-7 x max; the same model with the left reflection
    off by one sample is far outside it."""
    plan = _frames_plan(n_fft, win)
    assert plan.frames_radices == hopper_stft.frames_radix_plan(n_fft)
    want = ("stft_frames_cols_kernel" if n_fft == 2402 else "stft_frames_fft_kernel")
    assert hopper_stft.kernel_of(n_fft, hop) == want
    a, jr, ji, scale = _frames_case(n_fft, hop, win, seed=n_fft)
    err = _model_err(_frames_model(a, plan, hop), jr, ji)
    assert err <= MODEL_TOL * scale, (err, scale)
    bad = _model_err(_frames_model(a, plan, hop, reflect_shift=1), jr, ji)
    assert bad > 1e4 * MODEL_TOL * scale, (bad, scale)


@pytest.mark.parametrize("n_fft,hop,win", [(2205, 1102, 2205), (75, 30, 60)])
def test_frames_model_global_route_matches_jax(n_fft, hop, win):
    """The global route's four-step model (each frame read from the clip,
    columns of n1 points, twiddles, rows of n2) at geometries the shared
    routes take (2205 = 49 x 45 with prime passes, 75 = 15 x 5), against
    float64 JAX within 2.5e-7 x max."""
    a, jr, ji, scale = _frames_case(n_fft, hop, win, seed=n_fft + 3)
    err = _model_err(_frames_model(a, _frames_plan(n_fft, win), hop, route=2), jr, ji)
    assert err <= MODEL_TOL * scale, (err, scale)


@pytest.mark.parametrize("n_fft,hop,win", GLOBAL_GEOMETRIES)
def test_frames_model_four_step_matches_jax(n_fft, hop, win):
    """Where no tile of frames fits: 9600 on route four_step (120 x 80,
    one frame a block, one launch), and on the global route (two launches)
    7919 (Bluestein, M = 12288 in two output blocks), 11274 (Bluestein
    columns of 1879, M = 4096), 16384 (128 x 128) and the prime 14087
    (whole-frame Bluestein: 4 input and 2 lower output blocks of 4096): the
    model against float64 JAX within 2.5e-7 x max."""
    assert hopper_stft.kernels_of(n_fft, hop) == (
        {"stft_frames_4step_kernel": 1} if n_fft == 9600
        else {"stft_frames_chirp_in_kernel": 1, "stft_frames_chirp_out_kernel": 1}
        if n_fft == 14087 else {"stft_frames_cols_kernel": 1, "stft_frames_rows_kernel": 1})
    a, jr, ji, scale = _frames_case(n_fft, hop, win, seed=n_fft + 5)
    err = _model_err(_frames_model(a, _frames_plan(n_fft, win), hop), jr, ji)
    assert err <= MODEL_TOL * scale, (err, scale)


@pytest.mark.parametrize("n_fft,hop,win,m_len", [(75, 30, 60, 64), (2205, 1102, 2205, 256),
                                                (300, 75, 300, 32)])
def test_frames_model_whole_frame_bluestein_matches_jax(n_fft, hop, win, m_len):
    """The whole-frame Bluestein (its input blocks, lower and mirror output
    blocks and the filters of their offsets) at a small M, so that a frame
    spans several blocks of each (75: 3 input, 2 output blocks; 2205: 18
    and 9; 300: 19 and 10), against float64 JAX within 2.5e-7 x max; the
    chirp's index one off is far outside it."""
    g = hopper_stft._chirp_config(n_fft, m_len)
    assert g.blocks > 2 and g.segments > 1
    plan = _frames_plan(n_fft, win)
    a, jr, ji, scale = _frames_case(n_fft, hop, win, seed=n_fft + 7)
    err = _model_err(_frames_model(a, plan, hop, route=2, whole_m=m_len), jr, ji)
    assert err <= MODEL_TOL * scale, (err, scale)
    bad = _model_err(_frames_model(a, plan, hop, route=2, whole_m=m_len, chirp_shift=1), jr, ji)
    assert bad > 1e4 * MODEL_TOL * scale, (bad, scale)


@pytest.mark.parametrize("n_fft,hop,win", [(2204, 1102, 2204), (2205, 1102, 2205)])
def test_frames_model_catches_a_wrong_root(n_fft, hop, win):
    """A root index one off in a prime pass (``r s + 1`` for ``r s``) puts
    the model far outside the bound, so the bound sees that fault."""
    plan = _frames_plan(n_fft, win)
    assert any(r in hopper_stft._PRIME_RADICES for r in plan.frames_radices)
    a, jr, ji, scale = _frames_case(n_fft, hop, win, seed=n_fft + 4)
    bad = _model_err(_frames_model(a, plan, hop, root_shift=1), jr, ji)
    assert bad > 1e4 * MODEL_TOL * scale, (bad, scale)


@pytest.mark.parametrize("n_fft,hop,win", [(2402, 1201, 2402), (11274, 4000, 11274)])
def test_frames_model_catches_a_wrong_chirp(n_fft, hop, win):
    """Bluestein's chirp with its index one off (``(r + 1)^2`` for ``r^2``)
    puts the model far outside the bound."""
    plan = _frames_plan(n_fft, win)
    assert hopper_stft.global_config(n_fft).q > 0
    a, jr, ji, scale = _frames_case(n_fft, hop, win, seed=n_fft + 6)
    bad = _model_err(_frames_model(a, plan, hop, chirp_shift=1), jr, ji)
    assert bad > 1e4 * MODEL_TOL * scale, (bad, scale)


@pytest.mark.parametrize("m_len", [80, 2560, 3840, 12288])
def test_chirp_passes_leave_the_dif_order(m_len):
    """Bluestein's in-place passes (``stft.cu::chirp_pass``) emulated in
    numpy: decimation in frequency leaves bin ``_dif_order(M)[i]`` at place
    i, and decimation in time of that order gives the DFT in natural order;
    the chirp table's filters are stored in that order."""
    radices = hopper_stft._radix_rule(m_len)
    twm = np.exp(-2j * np.pi * np.arange(m_len) / m_len)
    rng = np.random.default_rng(m_len)
    x = rng.standard_normal(m_len) + 1j * rng.standard_normal(m_len)

    def passes(a, dit):
        a = a.copy()
        spans, L = [], m_len
        for r in radices:
            spans.append((r, L))
            L //= r
        for r, L in (spans[::-1] if dit else spans):
            m = L // r
            for base in range(0, m_len, L):
                j = np.arange(m)
                idx = base + j[None, :] + m * np.arange(r)[:, None]  # (r, m)
                tws = twm[(j[None, :] * np.arange(r)[:, None]) * (m_len // L)]
                v = a[idx] * tws if dit else a[idx]
                v = np.fft.fft(v, axis=0)
                a[idx] = v if dit else v * tws
        return a

    order = hopper_stft._dif_order(m_len, radices)
    want = np.fft.fft(x)
    assert np.abs(passes(x, dit=False) - want[order]).max() <= 1e-9 * m_len
    assert np.abs(passes(x[order], dit=True) - want).max() <= 1e-9 * m_len
    g = hopper_stft.global_config(11274)
    assert g.m_radices == hopper_stft._radix_rule(g.m_len)


def test_frames_routes_and_tiles():
    """Which kernel takes a geometry, decided by the geometry alone: the
    hop-block kernel exactly at n_fft == 2 * hop <= 2400 with factors 2, 3
    and 5; the frames kernel in shared memory (16 or 32 values a thread)
    where every prime is at most 31 and a tile fits, as at every such n_fft
    up to 5,543; route four_step (one frame a block, one launch) where a
    frame of register radices fits a block; elsewhere the global route, two
    launches whatever the radices (the whole-frame Bluestein's two where no
    split fits the tiles, as at the prime 14087); every tile within 227 KB
    and the registers of 256 threads; a route for every n_fft."""
    of = hopper_stft.kernels_of
    glob = {"stft_frames_cols_kernel": 1, "stft_frames_rows_kernel": 1}
    for n, hop in ((1200, 600), (600, 300), (2400, 1200), (1024, 512), (150, 75)):
        assert of(n, hop) == {"stft_hop_blocks_fft_kernel": 1}
    for n, hop in ((2048, 600), (2204, 1102), (2205, 1102), (4800, 2400), (4000, 2000),
                   (1400, 700), (5400, 1800), (8192, 2048)):
        assert of(n, hop) == {"stft_frames_fft_kernel": 1}, (n, hop)
    for n, hop in ((16384, 4096), (14088, 3000), (5643, 1411), (2402, 1201), (1201, 600),
                   (7919, 1980), (11274, 4000), (37, 10), (5544, 1848)):
        assert of(n, hop) == glob, (n, hop)
    for n, hop in ((9600, 2400), (9000, 3000), (12000, 3000)):
        assert of(n, hop) == {"stft_frames_4step_kernel": 1}, (n, hop)
    cfg = hopper_stft.frames_config
    assert cfg(2048, 600)[:3] == (0, 2, 2)
    assert cfg(4800, 2400)[:3] == (1, 1, 2)
    assert [cfg(n, hop)[:3] for n, hop, _ in EDGE_GEOMETRIES] == [
        (1, 1, 1), (2, 0, 0), (3, 1, 1), (2, 0, 0)]
    assert hopper_stft.FRAME_ROUTES[2:] == ("global", "four_step")
    assert hopper_stft.four_step_config(9600)[:4] == (120, 80, 27, 40)
    g = hopper_stft.global_config
    assert g(16384)[:2] == (128, 128)
    assert (g(11274).n1, g(11274).n2, g(11274).q, g(11274).m_len) == (1879, 6, 1879, 4096)
    assert (g(7919).q, g(7919).blocks, g(7919).m_len) == (7919, 2, 12288)
    assert cfg(9000, 3000).route == 3 and cfg(14087, 3000).route == 2
    chirp = {"stft_frames_chirp_in_kernel": 1, "stft_frames_chirp_out_kernel": 1}
    for n, hop in ((14087, 3000), (12707, 3000), (37083, 9000), (65537, 16384)):
        assert of(n, hop) == chirp, (n, hop)
        gc = g(n)
        assert (gc.m_len, gc.outs, gc.blocks, gc.segments) == (
            8192, 4096, -(-n // 4096), -(-(n // 2 + 1) // 4096))
        assert cfg(n, hop).rows_smem_bytes <= 232448
    assert g(12703).segments == 0 and g(12703).q == 12703
    for n in range(2, 5544):
        radices = hopper_stft.frames_radix_plan(n)
        c = cfg(n, max(1, n // 3))
        if all(r <= hopper_stft._PRIME_MAX for r in radices):
            assert c.route in (0, 1) and 1 <= c.frames <= 8 and c.smem_bytes <= 232448
            assert hopper_stft._frames_fit(radices, n, c.frames, hopper_stft._FR_EPT[c.route])
        else:
            gc = g(n)
            assert c.route == 2 and gc.q * gc.n2 == n
            assert gc.m_len >= gc.q + -(-gc.q // gc.blocks) - 1
            assert max(c.smem_bytes, c.rows_smem_bytes) <= 232448
    assert hopper_stft.frames_radix_plan(2048) == (16, 16, 8)
    assert hopper_stft.frames_radix_plan(2204) == (4, 19, 29)
    assert hopper_stft.frames_radix_plan(2205) == (3, 3, 5, 7, 7)
    assert hopper_stft.frames_radix_plan(4800) == (16, 4, 3, 5, 5)


@pytest.mark.parametrize("n_fft,hop,win", FRAME_GEOMETRIES + NEW_GEOMETRIES)
def test_flat_any_hop_matches_jax_front_end_stft(n_fft, hop, win):
    """The wrapper's CPU dispatch on flat audio at n_fft != 2 * hop (the
    plain flat framing, no launch) against the JAX front-end's STFT of flat
    audio within 2e-5 x max."""
    w_re, w_im = dft_matrices(n_fft, analysis_window("han", win, n_fft))
    frames = 203 if (n_fft, hop, win) in FRAME_GEOMETRIES else 23
    a = _flat_frames_audio(n_fft, hop, seed=n_fft + 1, frames=frames)
    jr, ji = jax_stft_re_im(jnp.asarray(a), n_fft, hop, jnp.asarray(w_re), jnp.asarray(w_im))
    before = dict(hopper_stft.KERNELS)
    re, im = hopper_stft.stft_hop_blocks(torch.tensor(a), _frames_plan(n_fft, win), hop)
    assert hopper_stft.KERNELS == before
    assert re.shape == (2, frames, n_fft // 2 + 1, 4)
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
@pytest.mark.parametrize("n_fft,hop,win", FRAME_GEOMETRIES + NEW_GEOMETRIES
                         + EDGE_GEOMETRIES + [(16384, 4096, 16384), (14087, 3522, 14087)])
def test_frames_kernel_matches_plain_on_cuda(cuda_device, n_fft, hop, win):
    """The frames kernel on flat audio against the plain flat framing of
    the same samples, with the launches ``kernels_of`` names (one span slot
    at 8192; 9600 on route four_step; 2402, 7919, 11274 and 16384 on the
    global route, two launches; 14087 on its whole-frame Bluestein)."""
    w_re, w_im = (torch.tensor(w, device=cuda_device)
                  for w in dft_matrices(n_fft, analysis_window("han", win, n_fft)))
    frames = 203 if (n_fft, hop, win) in FRAME_GEOMETRIES else 23
    x = torch.tensor(_flat_frames_audio(n_fft, hop, seed=n_fft + 2, frames=frames),
                     device=cuda_device)
    before = dict(hopper_stft.KERNELS)
    kr, ki = hopper_stft.stft_hop_blocks(x, _frames_plan(n_fft, win, cuda_device), hop)
    torch.cuda.synchronize()
    assert {k: c - before[k] for k, c in hopper_stft.KERNELS.items()
            if c != before[k]} == hopper_stft.kernels_of(n_fft, hop)
    pr, pi = port_stft.framed_dft_flat(x, w_re, w_im, hop)
    _close(kr.cpu(), pr.cpu())
    _close(ki.cpu(), pi.cpu())
