"""adyolo_tpu_torch/utils/profiling.py.

* The device time a call, read from torch.profiler, or from CUDA events
  where the profiler records no device event.
* ``model_flops``: the closed forms, exactly, for the plain attention,
  ``adyolo::mhsa_eval``, the training attention's forward and backward
  (both CPU routes, and the train pair's ops whatever runs inside them),
  ``adyolo::stft`` (hop-block and flat; the plain STFT called inline is
  billed by its DFT-matrix products), and cuDNN's RNN formulas against
  what the CPU's GRU counts; a model's count (SE-ResNet34 and conformer
  forwards, a bf16 conformer train step) is the same with the custom ops
  as with the plain attention called inline.
* The train pair's ops on the CPU run the plain bfloat16 pair, bit for
  bit.
* ``mfu`` / ``device_peak_flops``: None off the table, the datasheet
  ratio for the H100's names.  ``trace`` writes a Chrome trace,
  ``PhaseTimer`` sums its phases, ``benchmark`` makes warmup + iters calls.
No wall-clock asserts.
"""
import contextlib
import dataclasses
import functools
import json
import os

import numpy as np
import pytest
import torch

from adyolo_tpu_torch.config import Config
from adyolo_tpu_torch.data.labels import encode_adyolo, pad_yolo_targets
from adyolo_tpu_torch.engine.evaluate import build_eval_forward
from adyolo_tpu_torch.models import resnet_conformer as port_rc
from adyolo_tpu_torch.models import wrapper as port_wrapper
from adyolo_tpu_torch.ops import attention, hopper_attention, hopper_stft
from adyolo_tpu_torch.ops import stft as plain_stft
from adyolo_tpu_torch.ops.features import FeatureFrontend, identity_scaler
from adyolo_tpu_torch.parallel.train_step import build_train_step
from adyolo_tpu_torch.utils import profiling
from adyolo_tpu_torch.utils.profiling import (OTHER, PROFILE_GROUPS, attention_flops,
                                              group_ms, model_flops, profile_calls,
                                              rnn_flops, stft_flops)

from tests.test_torch_config import one_torch_thread  # noqa: F401


def _profiled(groups):
    ms = {g: 0.0 for g, _ in PROFILE_GROUPS}
    ms[OTHER] = 0.0
    ms.update(groups)
    return {"source": "profiler", "busy_ms_per_step": sum(ms.values()), "ms_per_step": ms}


def test_group_ms_sums_the_named_groups():
    p = _profiled({"attention fwd": 0.25, "attention bwd": 0.5, OTHER: 1.0})
    assert group_ms(p, "attention fwd") == 0.25
    assert group_ms(p, "attention fwd", "attention bwd") == 0.75


def test_group_ms_takes_the_event_time_without_groups():
    p = {"source": "cuda_events", "busy_ms_per_step": 0.125, "ms_per_step": None}
    assert group_ms(p, "attention fwd", "attention bwd") == 0.125


def test_profile_calls_retries_then_times_with_events(monkeypatch):
    tries, timed = [], []
    monkeypatch.setattr(profiling, "_profiled", lambda fn, n: tries.append(n))
    monkeypatch.setattr(profiling, "_event_timed", lambda fn, n: timed.append(n) or "events")
    assert profile_calls(lambda _: None, 7) == "events"
    assert tries == [7, 7, 7] and timed == [7]


def test_profile_calls_keeps_the_first_profile_with_device_time(monkeypatch):
    results = iter([None, "second"])
    monkeypatch.setattr(profiling, "_profiled", lambda fn, n: next(results))
    monkeypatch.setattr(profiling, "_event_timed", lambda fn, n: pytest.fail("events"))
    assert profile_calls(lambda _: None, 3) == "second"


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA device")
def test_profile_calls_on_cuda():
    x = torch.randn(1024, 1024, device="cuda")
    p = profile_calls(lambda _: x @ x, 5)
    assert p["source"] == "profiler" and p["busy_ms_per_step"] > 0
    assert p["ms_per_step"]["GEMM (cuBLAS)"] > 0
    e = profile_calls(lambda _: x @ x, 5, attempts=0)
    assert e["source"] == "cuda_events" and e["ms_per_step"] is None
    assert group_ms(e, "GEMM (cuBLAS)") == e["busy_ms_per_step"] > 0


# ---- model FLOPs -------------------------------------------------------------

def _qkv(B, T, H=4, dh=64, dtype=torch.float32, grad=False, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(B, T, H, dh, generator=g).to(dtype).requires_grad_(grad)
            for _ in range(3)]


@pytest.mark.parametrize("T,threshold", [(48, 2400), (96, 40)])
def test_plain_and_eval_attention_count_the_closed_form(T, threshold, monkeypatch):
    monkeypatch.setattr(attention, "BLOCK_THRESHOLD", threshold)  # 40: the blocked route
    q, k, v = _qkv(2, T)
    kv_len = torch.tensor([T, T // 2], dtype=torch.int32)
    want = attention_flops(2, T, 4, 64)
    assert model_flops(attention.mhsa_attention, q, k, v, kv_len) == want
    assert model_flops(torch.ops.adyolo.mhsa_eval, q, k, v, kv_len) == want
    assert model_flops(hopper_attention.flash_attention, q, k, v, kv_len) == want


def _fwd_bwd(q, k, v, seed, rate=0.2):
    out = hopper_attention.flash_attention(q, k, v, rate=rate, seed=seed)
    out.float().square().sum().backward()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_training_attention_counts_the_closed_form(dtype):
    q, k, v = _qkv(2, 40, dtype=dtype, grad=True)
    seed = torch.tensor([5], dtype=torch.int32)
    fwd = attention_flops(2, 40, 4, 64)
    bwd = attention_flops(2, 40, 4, 64, backward=True)
    assert bwd == 2 * fwd
    assert model_flops(hopper_attention.flash_attention, q, k, v, rate=0.2, seed=seed) == fwd
    assert model_flops(_fwd_bwd, q, k, v, seed) == fwd + bwd
    # the backward's op counts K3's products; the written-out backward
    # called inline is billed for its recompute of q·kᵀ as well
    q, k, v, do = (x.detach() for x in (q, k, v, torch.ones_like(q)))
    none = torch.empty(0)
    assert model_flops(torch.ops.adyolo.mhsa_train_bwd, q, k, v, None, seed, none, none,
                       do, 0.2, 0, 4) == bwd
    assert model_flops(attention.mhsa_attention_bwd, q, k, v, None, do, rate=0.2,
                       seed=seed) == bwd + fwd // 2


def test_train_ops_on_the_cpu_are_the_plain_bf16_pair():
    q, k, v = _qkv(2, 40, dtype=torch.bfloat16, grad=True, seed=4)
    seed = torch.tensor([9], dtype=torch.int32)
    kv_len = torch.tensor([40, 0], dtype=torch.int32)  # a zero row
    out = hopper_attention.flash_attention(q, k, v, kv_len, rate=0.2, seed=seed)
    plain = [x.detach() for x in (q, k, v)]
    assert torch.equal(out, attention.mhsa_attention(*plain, kv_len, rate=0.2, seed=seed))
    do = torch.randn(out.shape, generator=torch.Generator().manual_seed(5)).bfloat16()
    out.backward(do)
    want = attention.mhsa_attention_bwd(*plain, kv_len, do, rate=0.2, seed=seed)
    assert all(torch.equal(x.grad, w) for x, w in zip((q, k, v), want))
    _, out32, lse = torch.ops.adyolo.mhsa_train(*plain, kv_len, seed, 0.2, 0, 4)
    assert out32.numel() == lse.numel() == 0  # the plain backward recomputes them


def test_hopper_train_pair_counts_the_closed_form_whatever_runs_inside(monkeypatch):
    """The train pair's ops are billed by their formulas, not by what runs
    inside them (on the card, ctypes launches the counter cannot see):
    here their CPU kernels run other products than the closed form's."""
    def fwd(q, k, v, kv_len, **kw):
        return q @ torch.ones(64, 64)

    def bwd(q, k, v, kv_len, do, **kw):
        return tuple(x @ torch.ones(64, 64) for x in (q, k, v))

    monkeypatch.setattr(attention, "mhsa_attention", fwd)
    monkeypatch.setattr(attention, "mhsa_attention_bwd", bwd)
    q, k, v = _qkv(1, 32, grad=True)

    def step():
        hopper_attention._TrainAttention.apply(q, k, v, None, None, 0.0, (0, 4)).sum().backward()

    assert model_flops(step) == 3 * attention_flops(1, 32, 4, 64)


@pytest.mark.parametrize("flat", [False, True])
def test_stft_op_and_plain_stft_count_the_fft_convention(flat):
    """The op counts the FFT convention whichever of its kernels runs (on
    the CPU the plain STFT); the plain STFT called inline is billed by its
    DFT-matrix products, 2 x 2 x n_fft x K a frame."""
    window = np.hanning(1200).astype(np.float32)
    plan = hopper_stft.fft_plan(window, "cpu")
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 7 * 600 + 17, 4, generator=g) if flat else torch.randn(2, 7, 600, 4, generator=g)
    want = stft_flops(2 * 7 * 4, 1200)
    assert want == round(2.5 * 1200 * np.log2(1200) * 56)
    assert model_flops(hopper_stft.stft_hop_blocks, x, plan) == want
    w = plain_stft.window_dft(plan.table[2400:])
    assert model_flops(plain_stft.stft, x, *w, 600) == 4 * 56 * 1200 * 601


def _gru_shapes(x, gru, batch_first=True):
    """The shapes ``aten._cudnn_rnn`` and its backward see for ``gru``."""
    w = [tuple(p.shape) for p in gru._flat_weights]
    h = (gru.num_layers * (2 if gru.bidirectional else 1), x.shape[0], gru.hidden_size)
    return tuple(x.shape), w, h


@pytest.mark.parametrize("input_grad", [True, False])
def test_gru_counts_on_the_cpu_equal_the_cudnn_formulas(input_grad):
    gru = torch.nn.GRU(24, 16, batch_first=True)
    x = torch.randn(3, 7, 24, requires_grad=input_grad)
    xs, ws, hs = _gru_shapes(x, gru)
    fwd = profiling._cudnn_rnn_formula(xs, ws, 4, None, hs, None, 3, 16, 0, 1, True, 0.0,
                                       True, False, [], None)
    bwd = profiling._cudnn_rnn_backward_formula(
        xs, ws, 4, None, hs, None, None, None, None, None, 3, 16, 0, 1, True, 0.0, True,
        False, [], None, None, [input_grad, False, False, True])
    assert fwd == rnn_flops(21, 3, 24, 16, 3) == 2 * 3 * 16 * (24 + 16) * 21

    def fb():
        y, _ = gru(x)
        y.sum().backward()

    assert model_flops(lambda: gru(x)) == fwd
    assert model_flops(fb) == fwd + bwd


def test_bidirectional_stacked_rnn_formula():
    # two layers, two directions: layer 1 reads 2H inputs
    assert rnn_flops(10, 2, 8, 4, 3, layers=2, directions=2) == (
        2 * (2 * 10 * 12 * (8 + 4)) + 2 * (2 * 10 * 12 * (8 + 4)))


def _frontend(cfg):
    d = cfg.data
    return FeatureFrontend(d, identity_scaler(d.mel_bins, n_aux_ch=d.nb_feature_channels - 4),
                           "cpu")


@contextlib.contextmanager
def _plain_inline():
    """The conformer's attention as the plain attention called inline (its
    products counted as autograd runs them) instead of through the custom
    ops; the STFT stays in its op, whose CPU kernel is the plain STFT."""
    mp = pytest.MonkeyPatch()
    mp.setattr(port_rc, "flash_attention", attention.mhsa_attention)
    try:
        yield
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def small_cfg(one_torch_thread):  # noqa: F811
    mp = pytest.MonkeyPatch()
    mp.setitem(port_wrapper.ENCODERS, "resnet-conformer",
               functools.partial(port_rc.ResNetConformer, num_layers=2))
    cfg = Config()
    yield dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, chunk_window_s=2),
                              train=dataclasses.replace(cfg.train, max_targets_per_clip=32))
    mp.undo()


@pytest.mark.parametrize("encoder", ["se-resnet34", "resnet-conformer"])
def test_model_forward_count_is_route_independent(encoder, small_cfg):
    cfg = dataclasses.replace(small_cfg, args=dataclasses.replace(small_cfg.args,
                                                                  encoder=encoder))
    fe = _frontend(cfg)
    model = port_wrapper.build_model(cfg, "cpu", generator=torch.Generator().manual_seed(0))
    fwd = build_eval_forward(model, fe)
    x = torch.randn(2, cfg.data.chunk_feat_frames, 600, 4,
                    generator=torch.Generator().manual_seed(2)) * 0.1
    ops = model_flops(fwd, x)
    with _plain_inline():
        inline = model_flops(fwd, x)
    assert ops == inline > 0
    # the front-end's STFT is there, by the FFT convention
    assert model_flops(fe.stft, x) == stft_flops(2 * cfg.data.chunk_feat_frames * 4, 1200)


def test_bf16_conformer_step_count_is_route_independent(small_cfg):
    cfg = dataclasses.replace(
        small_cfg, args=dataclasses.replace(small_cfg.args, encoder="resnet-conformer"),
        train=dataclasses.replace(small_cfg.train, compute_dtype="bfloat16"))
    fe = _frontend(cfg)
    rng = np.random.default_rng(3)
    geom = port_wrapper.make_grid_geometry(cfg)
    frames = cfg.data.chunk_label_frames
    targets, mask = pad_yolo_targets(
        [encode_adyolo({int(rng.integers(frames)): [[1, 0, 30.0, 10.0]]}, frames, geom)
         for _ in range(2)], 64)
    batch = {"audio": (rng.standard_normal((2, cfg.data.chunk_feat_frames, 600, 4)) * 0.1
                       ).astype(np.float32), "targets": targets, "target_mask": mask}

    def count():
        model = port_wrapper.build_model(cfg, "cpu", generator=torch.Generator().manual_seed(0),
                                         train=True)
        step = build_train_step(cfg, model, fe)
        return model_flops(step, batch, torch.Generator().manual_seed(1))

    ops = count()
    with _plain_inline():
        inline = count()
    assert ops == inline > 0


# ---- MFU, trace, timers --------------------------------------------------------

def test_mfu_against_the_datasheet_peaks():
    assert profiling.mfu(1e12, 1.0, "cpu") is None
    assert profiling.mfu(1e12, 1.0, torch.device("cpu")) is None
    assert profiling.mfu(1e12, 1.0, "TPU v5 lite") is None
    assert profiling.mfu(None, 1.0, "NVIDIA H100 80GB HBM3") is None
    assert profiling.mfu(989.4e12, 2.0, "NVIDIA H100 80GB HBM3") == 0.5
    assert profiling.mfu(756e12, 1.0, "NVIDIA H100 PCIe") == 1.0
    assert profiling.device_peak_flops("NVIDIA H100 80GB HBM3") == 989.4e12


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(None):
        torch.ones(3).sum()
    logdir = str(tmp_path / "tr")
    with profiling.trace(logdir):
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(os.path.join(logdir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


def test_phase_timer_sums_its_phases(monkeypatch):
    clock = iter([0.0, 1.0, 1.0, 3.5, 10.0, 10.25])
    monkeypatch.setattr(profiling.time, "perf_counter", lambda: next(clock))
    timer = profiling.PhaseTimer()
    for name in ("load", "load", "step"):
        with timer.phase(name):
            pass
    assert timer.totals == {"load": 3.5, "step": 0.25}
    assert timer.report() == "load: 3.50s, step: 0.25s"
    assert profiling.throughput_audio_s(16, 20.0, 0.5) == 640.0


def test_benchmark_on_the_cpu_makes_warmup_and_iters_calls():
    calls = []
    t = profiling.benchmark(lambda x: calls.append(1) or x * 2, torch.ones(3), iters=4,
                            warmup=2)
    assert len(calls) == 6 and t > 0
