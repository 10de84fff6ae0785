"""The custom ops of ``adyolo_tpu_torch.ops.library`` on the CPU.

* ``torch.library.opcheck`` on ``adyolo::stft`` (hop-block and flat audio;
  flat audio at n_fft 2048, win 1200, hop 600, whose fake gives the
  output shapes at that hop)
  and on ``adyolo::mhsa_eval`` (float32 and bfloat16; every key valid, and
  kv_len < T with a kv_len = 0 row): schema, fake kernel (the output shapes,
  dtypes and strides the kernels write), and tracing.  Their CPU kernels are
  the plain versions, bit for bit.
* The plain bf16 eval attention (the op's CPU kernel on bfloat16 q/k/v)
  against JAX's XLA bf16 path (``adyolo_tpu/models/resnet_conformer.py:
  230-246``), run through the JAX ``MHSA`` module under
  ``force_flash("0")`` with the same weights: the port's bf16 MHSA output no
  farther from a float64 forward (JAX's module in float64) than 2x JAX's
  bf16 output is, plus 2^-9 x max (half a bfloat16 step).
* Eager ``infer`` still runs its STFT and attention through the ops: one
  ``adyolo::stft`` a clip and one ``adyolo::mhsa_eval`` a conformer block
  (a dispatch mode records the ops called).

On the card (``-m cuda``): route ``k2_bf16`` against the plain bf16
attention, each measured against float64.
"""
import collections
import dataclasses
import functools
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from adyolo_tpu_torch.config import Config
from adyolo_tpu_torch.data.io import write_wav
from adyolo_tpu_torch.engine.evaluate import infer, make_frontend
from adyolo_tpu_torch.models import resnet_conformer as port_rc
from adyolo_tpu_torch.models import wrapper as port_wrapper
from adyolo_tpu_torch.ops import attention, hopper_attention, hopper_stft
from adyolo_tpu_torch.ops import stft as plain_stft
from adyolo_tpu_torch.ops.decode import PostProcessor
from adyolo_tpu_torch.ops.dsp import analysis_window

from tests.test_torch_config import one_torch_thread  # noqa: F401

RATIO = 2.0
HALF_STEP = 2.0 ** -9


def _plan(n_fft=1200, win=1200):
    return hopper_stft.fft_plan(analysis_window("hann", win, n_fft), "cpu")


def _audio(shape, seed=0):
    return torch.tensor(np.random.default_rng(seed).standard_normal(shape) * 0.1,
                        dtype=torch.float32)


@pytest.mark.parametrize("shape,n_fft,win", [((2, 7, 600, 4), 1200, 1200),
                                             ((2, 7 * 600 + 17, 4), 1200, 1200),
                                             ((2, 7 * 600 + 17, 4), 2048, 1200)],
                         ids=["hop_blocks", "flat", "flat_n2048"])
def test_opcheck_stft(shape, n_fft, win):
    x, table = _audio(shape), _plan(n_fft, win).table
    torch.library.opcheck(torch.ops.adyolo.stft.default, (x, table, 600))
    re, im = torch.ops.adyolo.stft(x, table, 600)
    assert re.shape == im.shape == (2, 7, n_fft // 2 + 1, 4)
    want = plain_stft.stft(x, *plain_stft.window_dft(table[2 * n_fft:]), 600)
    assert torch.equal(re, want[0]) and torch.equal(im, want[1])


@pytest.mark.parametrize("n_fft,hop", [(2048, 600), (1024, 600), (4096, 1200), (1200, 480)])
def test_stft_fake_shapes_at_any_hop(n_fft, hop):
    """The fake (what a trace sees) gives T = N // hop frames of
    n_fft // 2 + 1 bins on flat audio, the shapes the CPU kernel returns."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    x, table = _audio((1, 9 * hop + 31, 4)), _plan(n_fft, min(n_fft, 1200)).table
    with FakeTensorMode() as mode:
        fre, fim = torch.ops.adyolo.stft(mode.from_tensor(x), mode.from_tensor(table), hop)
    re, im = torch.ops.adyolo.stft(x, table, hop)
    assert tuple(fre.shape) == tuple(fim.shape) == tuple(re.shape) == (1, 9, n_fft // 2 + 1, 4)


def _qkv(dtype, B=3, T=24, seed=1):
    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.standard_normal((B, T, 4, 64)), dtype=torch.float32).to(dtype)
            for _ in range(3)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kv_len", [None, [24, 13, 0]], ids=["all_keys", "kv_len"])
def test_opcheck_mhsa_eval(dtype, kv_len):
    q, k, v = _qkv(dtype)
    kv = None if kv_len is None else torch.tensor(kv_len, dtype=torch.int32)
    torch.library.opcheck(torch.ops.adyolo.mhsa_eval.default, (q, k, v, kv))
    out = torch.ops.adyolo.mhsa_eval(q, k, v, kv)
    assert out.dtype == dtype and out.shape == q.shape and out.is_contiguous()
    assert torch.equal(out, attention.mhsa_attention(q, k, v, kv))
    if kv is not None:
        assert bool((out[2] == 0).all())
    with torch.no_grad():  # the wrapper's eval route is the op
        assert torch.equal(hopper_attention.flash_attention(q, k, v, kv), out)


def _jax_mhsa(x, variables, frame_mask, dtype):
    from adyolo_tpu.models import resnet_conformer as jax_rc  # flax: CPU tests only

    m = jax_rc.MHSA(dim=256, heads=4, dtype=dtype)
    with jax_rc.force_flash("0"):
        return np.asarray(m.apply(variables, jnp.asarray(x, dtype), False, frame_mask),
                          np.float64)


def test_plain_bf16_eval_attention_against_jax_xla_path(one_torch_thread):  # noqa: F811
    """The port's bf16 MHSA (bf16 Dense layers, then the eval op's plain
    bf16 attention) and JAX's XLA bf16 path, each against float64."""
    B, T, D = 2, 40, 256
    lens = [40, 27]
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    port = port_rc.MHSA(D).eval()
    with torch.no_grad():
        for lin in (port.query, port.key, port.value, port.linear):
            lin.weight.copy_(torch.tensor(rng.standard_normal((D, D)) / 16.0))
            lin.bias.copy_(torch.tensor(rng.standard_normal(D) * 0.1))
    lins = {n: getattr(port, n) for n in ("query", "key", "value", "linear")}
    variables = {"params": {n: {"kernel": jnp.asarray(lin.weight.detach().T.numpy()),
                                "bias": jnp.asarray(lin.bias.detach().numpy())}
                            for n, lin in lins.items()}}
    mask = jnp.asarray(np.arange(T)[None, :] < np.asarray(lens)[:, None])
    kv = torch.tensor(lens, dtype=torch.int32)
    with torch.no_grad():
        got = port(torch.tensor(x).bfloat16(), kv)
    assert got.dtype == torch.bfloat16
    want = _jax_mhsa(x, variables, mask, jnp.bfloat16)
    with jax.enable_x64():
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), variables)
        truth = _jax_mhsa(x.astype(np.float64), v64, mask, jnp.float64)
    err = float(np.abs(got.double().numpy() - truth).max())
    err_jax = float(np.abs(want - truth).max())
    floor = HALF_STEP * float(np.abs(truth).max())
    assert err <= RATIO * err_jax + floor, (err, err_jax, floor)
    assert err > 1e-4  # it did compute in bf16


class _RecordOps(TorchDispatchMode):
    """Counts the ``adyolo::`` ops called under it."""

    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == "adyolo":
            self.ops[func.name()] += 1
        return func(*args, **(kwargs or {}))


def test_eager_infer_runs_through_the_ops(tmp_path, one_torch_thread):  # noqa: F811
    mp = pytest.MonkeyPatch()
    mp.setitem(port_wrapper.ENCODERS, "resnet-conformer",
               functools.partial(port_rc.ResNetConformer, num_layers=2))
    try:
        cfg = Config()
        cfg = dataclasses.replace(cfg, args=dataclasses.replace(
            cfg.args, encoder="resnet-conformer"), data=dataclasses.replace(
            cfg.data, data_pth=str(tmp_path)))
        wavs = tmp_path / "wavs"
        os.makedirs(wavs)
        rng = np.random.default_rng(6)
        for i, secs in enumerate((2, 3)):
            write_wav(str(wavs / f"clip{i}.wav"),
                      (rng.standard_normal((secs * 24000 + 77, 4)) * 1500).astype(np.int16),
                      24000)
        model = port_wrapper.build_model(cfg, "cpu", generator=torch.Generator().manual_seed(0))
        with _RecordOps() as rec:
            times = infer(cfg, model, make_frontend(cfg, "cpu"), PostProcessor(cfg),
                          str(wavs), str(tmp_path / "out"))
    finally:
        mp.undo()
    assert len(times) == 2 and len(os.listdir(tmp_path / "out")) == 2
    assert rec.ops == {"adyolo::stft": 2, "adyolo::mhsa_eval": 4}, rec.ops


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA device")
@pytest.mark.parametrize("B,T,lens", [(16, 800, None), (1, 800, [800]),
                                      (1, 2400, [1400]), (4, 800, [800, 513, 0, 64])])
def test_k2_bf16_kernel_against_plain(B, T, lens):
    q, k, v = (x.cuda() for x in _qkv(torch.bfloat16, B, T, seed=7))
    kv = torch.tensor(lens or [T] * B, dtype=torch.int32, device="cuda")
    before = dict(hopper_attention.LAUNCHES)
    out = torch.ops.adyolo.mhsa_eval(q, k, v, kv)
    assert hopper_attention.LAUNCHES["k2_bf16"] == before["k2_bf16"] + 1
    plain = attention.mhsa_attention(q, k, v, kv)
    truth = attention.mhsa_attention(q.double(), k.double(), v.double(), kv)
    rows = [b for b in range(B) if int(kv[b]) > 0]
    err = float((out.double()[rows] - truth[rows]).abs().max())
    err_p = float((plain.double()[rows] - truth[rows]).abs().max())
    assert err <= RATIO * err_p + HALF_STEP * float(truth[rows].abs().max()), (err, err_p)
    for b in range(B):
        if int(kv[b]) == 0:
            assert bool((out[b] == 0).all())
