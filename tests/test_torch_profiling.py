"""adyolo_tpu_torch/utils/profiling.py.

* The device time a call, read from torch.profiler, or from CUDA events
  where the profiler records no device event.  The event summary on
  synthetic events: a profile must hold exactly the kernels the calls
  launched (``KERNELS``, one K4 call a split kernel and a merge); one that
  lost the split kernel's events is profiled again and then comes back
  void, never as the merge's time; user annotations and host events stay
  out of the sums; a reading below its bound or above 1.05 x its single
  call is void; a library call's profile of n calls must hold n times the
  device kernels of one profiled call, else it is void.
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
  ratio for the H100's names.  ``benchmark`` makes warmup + iters calls.
* The program's spans: ``span`` is one shared no-op without a profiler
  and an ``adyolo.<name>`` range under a CPU capture; the train step's
  seven spans nest as they should and leave the loss as it is; the eval
  loader yields the same items under a capture and its ``eval.load``
  ranges hold none of the consumer's work; ``count`` adds to
  ``COUNTERS``, and the decode's counters count its valid label frames
  and the candidates over τ in them.
No wall-clock asserts.
"""
import contextlib
import dataclasses
import functools
import json
import os
import re
import subprocess
import sys

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
from adyolo_tpu_torch.utils.profiling import (OTHER, PROFILE_GROUPS, DeviceEvent,
                                              attention_flops, check_device_ms, group_ms,
                                              missing_kernels, model_flops, profile_calls,
                                              rnn_flops, stft_flops, summarize_events)

from tests.test_torch_config import one_torch_thread, scratch_path  # noqa: F401


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


# ---- the event summary: a profile must hold the calls' kernels ---------------

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
# the names CUPTI gives the kernels of one K4 call at (1, 4800): 4 key
# splits of the forward kernel in one launch, then the merge
SPLIT = "void mhsa_fwd_kernel<false>(float const*, float const*, float const*, int const*)"
MERGE = "void mhsa_fwd_merge_kernel(float const*, float const*, float const*, int const*)"
K4 = hopper_attention.forward_kernels(torch.float32, 4)


def _k4_events(n, split=True):
    """The events of ``n`` K4 calls: 0.290 ms in the split kernel and
    0.020 ms in the merge a call, beside host events, a user annotation on
    the device's timeline and an elementwise kernel; ``split`` False drops
    the split kernel's events, as a profile that lost them reads."""
    ev = []
    for _ in range(n):
        ev += [DeviceEvent("aten::empty", CPU, 3.0),
               DeviceEvent("cudaLaunchKernel", CPU, 5.0),
               DeviceEvent("ProfilerStep#1", CUDA, 900.0, user_annotation=True),
               DeviceEvent("void at::native::vectorized_elementwise_kernel", CUDA, 4.0)]
        ev += [DeviceEvent(SPLIT, CUDA, 290.0)] if split else []
        ev += [DeviceEvent(MERGE, CUDA, 20.0)]
    return ev


def test_wrapper_counts_name_the_kernels_each_launch_runs():
    """One launch a route, one or two device kernels: the split forward and
    its merge, the backward's two passes; each name a kernel of csrc/."""
    assert K4 == {"mhsa_fwd_kernel": 1, "mhsa_fwd_merge_kernel": 1}
    assert hopper_attention.forward_kernels(torch.bfloat16, 1) == {"mhsa_fwd_bf16_kernel": 1}
    assert hopper_attention.backward_kernels(torch.float32) == {
        "mhsa_bwd_dq_kernel": 1, "mhsa_bwd_dkdv_kernel": 1}
    assert hopper_attention.backward_kernels(torch.bfloat16) == {
        "mhsa_bwd_dq_bf16_kernel": 1, "mhsa_bwd_dkdv_bf16_kernel": 1}
    csrc = os.path.join(os.path.dirname(hopper_attention.__file__), os.pardir, "csrc")
    launched = set()
    for name in ("attention.cu", "stft.cu"):
        with open(os.path.join(csrc, name)) as f:
            launched |= set(re.findall(r"(\w+)(?:<[\w, ]+>)?<<<", f.read()))
    assert launched == set(hopper_attention.KERNELS) | set(hopper_stft.KERNELS)
    groups = {k: profiling.group_of(f"void {k}(float const*)") for k in launched}
    assert groups == {k: "K1 STFT" if "stft" in k else
                      "attention bwd" if "bwd" in k else "attention fwd" for k in launched}


def test_kernels_launched_reads_the_counters_over_one_call(monkeypatch):
    monkeypatch.setattr(hopper_attention, "LAUNCHES", dict(hopper_attention.LAUNCHES))
    monkeypatch.setattr(hopper_attention, "KERNELS", dict(hopper_attention.KERNELS))
    before = dict(hopper_attention.LAUNCHES)
    assert profiling.kernels_launched(lambda: hopper_attention._count("k4", K4)) == K4
    assert hopper_attention.LAUNCHES == {**before, "k4": before["k4"] + 1}
    # on CPU tensors the wrappers run their plain versions: no kernel
    q, k, v = _qkv(1, 8)
    assert profiling.kernels_launched(lambda: hopper_attention.flash_attention(q, k, v)) == {}


def test_summary_accepts_a_complete_k4_profile():
    p = summarize_events(_k4_events(10), 10, 40.0, K4)
    assert p["kernel_counts"] == {k: {"seen": 10, "expected": 10} for k in K4}
    assert missing_kernels(p) == {}
    assert group_ms(p, "attention fwd") == pytest.approx(0.310)
    assert p["kernels_per_step"] == 3 and p["kernels_per_step_by_group"] == {
        "attention fwd": 2, OTHER: 1}
    # the user annotation is left out of the sums, the host events too
    assert p["busy_ms_per_step"] == pytest.approx(0.314)
    assert p["idle_share"] == pytest.approx(1 - 0.314 / 4.0)


def test_summary_leaves_out_user_annotations():
    ev = [DeviceEvent("DistributedDataParallel.forward", CUDA, 5000.0, user_annotation=True),
          DeviceEvent(SPLIT, CUDA, 300.0)]
    p = summarize_events(ev, 1, 10.0, {"mhsa_fwd_kernel": 1})
    assert p["busy_ms_per_step"] == pytest.approx(0.3) and p["kernels_per_step"] == 1
    assert summarize_events(ev[:1], 1, 10.0) is None  # no device kernel at all


def _fake_profiles(monkeypatch, results):
    """``profile_calls`` on the given per-attempt summaries; CUDA events
    stand in as ``"events"``."""
    tries, timed = [], []

    def profiled(fn, n, expect, warmup):
        tries.append((n, expect) if warmup else (n, expect, "no warm-up"))
        return next(results)

    monkeypatch.setattr(profiling, "_profiled", profiled)
    monkeypatch.setattr(profiling, "_event_timed", lambda fn, n: timed.append(n) or "events")
    return tries, timed


def test_a_profile_missing_the_split_kernel_is_retried_then_void(monkeypatch):
    """The merge alone reads 0.020 ms a call, below K4's bound: never a
    reading.  Three attempts, then the attention group is void."""
    lost = summarize_events(_k4_events(10, split=False), 10, 40.0, K4)
    assert missing_kernels(lost) == {"mhsa_fwd_kernel": (0, 10)}
    tries, timed = _fake_profiles(monkeypatch, iter([lost] * 3))
    p = profile_calls(lambda _: None, 10, expect=K4)
    assert tries == [(10, K4)] * 3 and timed == []
    assert p["source"] == "void" and group_ms(p, "attention fwd") is None
    assert p["busy_ms_per_step"] is None and p["idle_share"] is None
    assert p["ms_per_step"][OTHER] == pytest.approx(0.004)  # the other groups stay
    assert p["kernel_counts"]["mhsa_fwd_kernel"] == {"seen": 0, "expected": 10}


def test_a_profile_missing_kernels_is_taken_again(monkeypatch):
    lost = summarize_events(_k4_events(10, split=False), 10, 40.0, K4)
    whole = summarize_events(_k4_events(10), 10, 40.0, K4)
    tries, timed = _fake_profiles(monkeypatch, iter([lost, None, whole]))
    p = profile_calls(lambda _: None, 10, expect=K4)
    assert p is whole and len(tries) == 3 and timed == []
    # a profile holding more events than the calls launched is no reading either
    extra = summarize_events(_k4_events(10) + [DeviceEvent(SPLIT, CUDA, 290.0)], 10, 40.0, K4)
    assert missing_kernels(extra) == {"mhsa_fwd_kernel": (11, 10)}


def test_profile_calls_retries_then_times_with_events(monkeypatch):
    """Zero device events in every attempt: CUDA events time the calls."""
    no_kernel = summarize_events([DeviceEvent("aten::mm", CPU, 9.0)], 7, 1.0, K4)
    assert no_kernel is None
    tries, timed = _fake_profiles(monkeypatch, iter([no_kernel] * 3))
    assert profile_calls(lambda _: None, 7, expect=K4) == "events"
    assert tries == [(7, K4)] * 3 and timed == [7]


def test_profile_calls_keeps_the_first_profile_with_device_time(monkeypatch):
    second = summarize_events(_k4_events(3), 3, 12.0)
    tries, timed = _fake_profiles(monkeypatch, iter([None, second]))
    assert profile_calls(lambda _: None, 3, warmup=False) is second
    assert tries == [(3, None, "no warm-up")] * 2 and timed == []


def test_ranks_retake_or_void_a_collective_profile_together(scratch_path):
    """Two gloo ranks profile a call that all-reduces over both
    (``profile_calls(every_rank=True)``, ``tests/torch_profile_ranks.py``):
    an attempt whole on one rank and not on the other is taken again by
    both; what stays incomplete on one rank is void on both; CUDA events
    time the calls only where no rank recorded a device event.  Every rank
    makes as many calls as the other, or the calls' all-reduces pair with
    another collective."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo, OMP_NUM_THREADS="1")
    rdv = str(scratch_path / "rendezvous")
    logs = [open(scratch_path / f"r{r}.log", "w") for r in range(2)]
    procs = [subprocess.Popen([sys.executable, "-m", "tests.torch_profile_ranks", str(r), "2",
                               rdv, str(scratch_path)], cwd=repo, env=env, stdout=logs[r],
                              stderr=subprocess.STDOUT) for r in range(2)]
    try:
        for p in procs:
            p.wait(timeout=240)
    finally:
        for p, f in zip(procs, logs):
            if p.poll() is None:
                p.kill()
                p.wait()
            f.close()
    for r, p in enumerate(procs):
        assert p.returncode == 0, (scratch_path / f"r{r}.log").read_text()[-4000:]
    got = [json.loads((scratch_path / f"profile.r{r}.json").read_text()) for r in range(2)]
    calls = {"whole_at_once": 3, "rank1_whole_late": 6, "rank1_always_lost": 9,
             "rank1_never_traced": 9, "none_anywhere": 11}  # 1 warm-up + 2 an attempt
    source = {"whole_at_once": "profiler", "rank1_whole_late": "profiler",
              "rank1_always_lost": "void", "rank1_never_traced": "void",
              "none_anywhere": "cuda_events"}
    for name, n in calls.items():
        for r in range(2):
            row = got[r][name]
            assert row["calls"] == [n, n] and row["sums"] == [2.0], (name, r, row)
            assert row["source"] == source[name], (name, r, row)
            if source[name] == "profiler":
                assert row["fwd_ms"] == pytest.approx(0.31)
            elif source[name] == "void":
                assert row["fwd_ms"] is None


@pytest.mark.parametrize("ms,want", [(0.033, None), (0.089, 0.089), (0.312, 0.312),
                                     (0.4368, 0.4368), (0.44, None), (None, None)])
def test_check_device_ms_voids_below_the_bound_and_above_the_single_call(ms, want):
    """K4's bound 0.089 ms and a single call of 0.416 ms: 0.033 (the void
    reading of the records) and anything above 1.05 x 0.416 are void."""
    got, why = check_device_ms(ms, 0.089, 0.416)
    assert got == want and (why is None) == (want is not None)
    if ms is not None and want is None:
        assert ("below the bound" in why) == (ms < 0.089)


def _sdpa_dropout_events(n, lose=0, gain=0):
    """A library call's device kernels, n calls: the flash forward, the
    dropout mask, a copy; ``lose`` of the masks missing, ``gain`` stray
    copies more."""
    ev = []
    for i in range(n):
        ev += [DeviceEvent("void pytorch_flash::flash_fwd_kernel<Flash_fwd_traits>", CUDA, 80.0)]
        ev += [] if i < lose else [
            DeviceEvent("void at::native::(anonymous namespace)::fused_dropout_kernel", CUDA, 30.0)]
        ev += [DeviceEvent("void at::native::vectorized_elementwise_kernel", CUDA, 5.0)]
    return ev + [DeviceEvent("void at::native::vectorized_elementwise_kernel", CUDA, 5.0)] * gain


def test_library_readings_are_held_to_their_kernel_count():
    """A library call's kernels are not the port's, so no name says which
    it launches: one profiled call gives its count (3 here), and a profile
    of 10 calls is read only where it holds 30.  One that lost some calls'
    dropout kernels (a lossy profile, whose time a call reads low) or
    gained a stray kernel is void with its reason, and so is a profile with
    no count (timed with CUDA events) or no count of one call."""
    one = summarize_events(_sdpa_dropout_events(1), 1, 1.0)
    per_call = one["kernels_per_step"]
    assert per_call == 3
    whole = summarize_events(_sdpa_dropout_events(10), 10, 20.0)
    assert profiling.library_count_void(whole, per_call) is None
    assert whole["busy_ms_per_step"] == pytest.approx(0.115)
    lossy = summarize_events(_sdpa_dropout_events(10, lose=4), 10, 20.0)
    why = profiling.library_count_void(lossy, per_call)
    assert why == "2.6 device kernels a call, not the 3 of one profiled call"
    assert profiling.library_count_void(summarize_events(_sdpa_dropout_events(10, gain=1), 10,
                                                         20.0), per_call)
    assert "not counted" in profiling.library_count_void(
        {"source": "cuda_events", "kernels_per_step": None}, per_call)
    assert profiling.library_count_void(whole, None) == "no profiled count of one call's kernels"


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
    q = torch.randn(1, 4800, 4, 64, device="cuda")
    kv = torch.tensor([3000], dtype=torch.int32, device="cuda")
    expect = profiling.kernels_launched(lambda: hopper_attention.flash_attention(q, q, q, kv))
    assert expect == K4
    k4 = profile_calls(lambda _: hopper_attention.flash_attention(q, q, q, kv), 10,
                       expect=expect)
    assert k4["source"] == "profiler" and missing_kernels(k4) == {}


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


def test_stft_op_counts_frames_at_any_hop():
    """At n_fft 2048, win 1200, hop 600 on flat audio of 7 hops + 17: 7
    frames a channel, 2 clips x 4 channels, each 2.5 x 2048 x log2(2048) =
    56,320 FLOP, so 56 x 56,320 = 3,153,920 (worked by hand)."""
    window = np.pad(np.hanning(1200), (424, 424)).astype(np.float32)
    plan = hopper_stft.fft_plan(window, "cpu")
    x = torch.randn(2, 7 * 600 + 17, 4, generator=torch.Generator().manual_seed(2))
    assert model_flops(hopper_stft.stft_hop_blocks, x, plan, 600) == 3_153_920
    # the T of the op's formula is N // hop: 480 gives 8 frames a channel
    assert model_flops(hopper_stft.stft_hop_blocks, x, plan, 480) == 64 * 56_320


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


# ---- MFU and the timer --------------------------------------------------------

def test_mfu_against_the_datasheet_peaks():
    assert profiling.mfu(1e12, 1.0, "cpu") is None
    assert profiling.mfu(1e12, 1.0, torch.device("cpu")) is None
    assert profiling.mfu(1e12, 1.0, "TPU v5 lite") is None
    assert profiling.mfu(None, 1.0, "NVIDIA H100 80GB HBM3") is None
    assert profiling.mfu(989.4e12, 2.0, "NVIDIA H100 80GB HBM3") == 0.5
    assert profiling.mfu(756e12, 1.0, "NVIDIA H100 PCIe") == 1.0
    assert profiling.device_peak_flops("NVIDIA H100 80GB HBM3") == 989.4e12


# ---- the program's spans and counters ----------------------------------------

def _spans(prof, prefix=profiling.SPAN_PREFIX):
    """``[(name, start_us, end_us)]`` of the capture's host ranges named
    ``prefix...``, by start."""
    return sorted(((e.name[len(prefix):], e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.name.startswith(prefix)
                   and e.device_type == torch.autograd.DeviceType.CPU),
                  key=lambda sp: (sp[1], -sp[2]))


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _cpu_capture():
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU])


def test_span_is_one_shared_no_op_without_a_profiler():
    assert not torch.autograd.profiler._is_profiler_enabled
    assert profiling.span("train.step") is profiling.span("eval.load")
    with profiling.span("train.step") as inner:
        assert inner is None


def test_span_records_its_name_under_a_cpu_capture():
    with _cpu_capture() as prof:
        with profiling.span("outer"):
            with profiling.span("inner"):
                torch.ones(8).sum()
    spans = _spans(prof)
    assert [n for n, _, _ in spans] == ["outer", "inner"]
    assert _inside(spans[1], spans[0])
    assert profiling.span("outer") is profiling.span("inner")  # off again


def test_count_adds_to_the_counters(monkeypatch):
    monkeypatch.setattr(profiling, "COUNTERS", {})
    profiling.count("decode.candidates", 3)
    profiling.count("decode.candidates")
    profiling.count("decode.label_frames", np.int64(17))
    assert profiling.COUNTERS == {"decode.candidates": 4, "decode.label_frames": 17}
    assert all(type(v) is int for v in profiling.COUNTERS.values())
    assert profiling.throughput_audio_s(16, 20.0, 0.5) == 640.0


TRAIN_SPANS = ("train.step", "train.features", "train.h2d", "train.forward", "train.loss",
               "train.backward", "train.optimizer")


@pytest.mark.parametrize("encoder", ["se-resnet34", "resnet-conformer"])
def test_train_step_spans_nest_and_leave_the_loss_as_it_is(encoder, small_cfg):
    cfg = dataclasses.replace(small_cfg, args=dataclasses.replace(small_cfg.args,
                                                                  encoder=encoder))
    fe = _frontend(cfg)
    rng = np.random.default_rng(5)
    geom = port_wrapper.make_grid_geometry(cfg)
    frames = cfg.data.chunk_label_frames
    targets, mask = pad_yolo_targets(
        [encode_adyolo({int(rng.integers(frames)): [[2, 0, 30.0, 10.0]]}, frames, geom)
         for _ in range(2)], 64)
    batch = {"audio": (rng.standard_normal((2, cfg.data.chunk_feat_frames, 600, 4)) * 3000
                       ).astype(np.int16), "targets": targets, "target_mask": mask}

    def loss(traced):
        model = port_wrapper.build_model(cfg, "cpu", generator=torch.Generator().manual_seed(0),
                                         train=True)
        step = build_train_step(cfg, model, fe)
        gen = torch.Generator().manual_seed(1)
        if not traced:
            return step(batch, gen), None
        with _cpu_capture() as prof:
            out = step(batch, gen)
        return out, _spans(prof)

    plain, _ = loss(False)
    traced, spans = loss(True)
    assert torch.equal(plain, traced)
    names = [n for n, _, _ in spans]
    assert sorted(names) == sorted(TRAIN_SPANS + ("train.h2d",))
    step = spans[names.index("train.step")]
    feats = spans[names.index("train.features")]
    assert all(_inside(sp, step) for sp in spans)
    h2d = [sp for sp in spans if sp[0] == "train.h2d"]
    assert [_inside(sp, feats) for sp in h2d] == [True, False]  # the audio's, the targets'
    for name in ("train.forward", "train.loss", "train.backward", "train.optimizer"):
        sp = spans[names.index(name)]
        assert not _inside(sp, feats) and feats[2] <= sp[1], name
    order = [n for n in names if n not in ("train.step", "train.features")]
    assert order == ["train.h2d", "train.forward", "train.h2d", "train.loss",
                     "train.backward", "train.optimizer"]


def _clip_loader(cfg):
    """``EvalLoader`` over three in-memory int16 clips of different buckets."""
    from adyolo_tpu_torch.data import io
    from adyolo_tpu_torch.data.dataset import EvalLoader, SELDDataset
    from adyolo_tpu_torch.ops.grid import GridGeometry

    rng = np.random.default_rng(7)
    clips = {f"clip{i}": (rng.standard_normal((n * 24000, 4)) * 3000).astype(np.int16)
             for i, n in enumerate((3, 1, 5))}

    class ClipSet(SELDDataset):
        def __init__(self):
            self.cfg, self.loss_nm, self.set_type = cfg, cfg.args.loss, "infer"
            self.is_infer, self.sampler = True, None
            self.filelist = list(clips)
            self.geom = GridGeometry(tuple(cfg.train.grid_size), cfg.train.g_overlap,
                                     cfg.train.nb_anchors)

        def load_clip(self, name, normalize=True, rot_comb=None):
            audio = clips[name]
            return io.normalize_audio(audio), {}, len(audio) // self.cfg.data.label_hop_len

    return EvalLoader(ClipSet(), cfg, buckets=(40, 160, 320))


def _consume(loader):
    """The loader's items, the consumer working (a named range) between two."""
    items = []
    for item in loader:
        with torch.profiler.record_function("consumer"):
            torch.ones(256, 256) @ torch.ones(256, 256)
        items.append(item)
    return items


def test_eval_loader_yields_the_same_items_under_a_capture(small_cfg):
    loader = _clip_loader(small_cfg)
    plain = _consume(loader)
    with _cpu_capture():
        traced = _consume(loader)
    assert [it["name"] for it in plain] == ["clip0", "clip1", "clip2"]
    for a, b in zip(plain, traced):
        assert a.keys() == b.keys()
        for k in a:
            assert np.array_equal(a[k], b[k]), k


def test_eval_load_spans_hold_no_consumer_work(small_cfg):
    loader = _clip_loader(small_cfg)
    with _cpu_capture() as prof:
        _consume(loader)
    spans = _spans(prof)
    loads = [sp for sp in spans if sp[0] == "eval.load"]
    assert len(loads) == 3
    for name in ("eval.normalize", "eval.pad"):
        inner = [sp for sp in spans if sp[0] == name]
        assert len(inner) == 3 and all(any(_inside(sp, ld) for ld in loads) for sp in inner)
    work = _spans(prof, "consumer")
    assert len(work) == 3
    assert all(ld[2] <= w[1] or w[2] <= ld[1] for ld in loads for w in work)


@pytest.mark.parametrize("tau", [0.7, 0.2])  # top-k exact; the guard decodes the full grid
def test_decode_counters_count_the_host_loops_work(tau, monkeypatch):
    from adyolo_tpu_torch.ops.decode import PostProcessor

    cfg = Config()
    pp = PostProcessor(cfg)
    pp.set_conf_thresh(tau)
    K, n = cfg.data.nb_classes, pp.geom.nb_predicts
    T, valid = 24, 17
    logits = torch.randn(1, T, n, K + 3, generator=torch.Generator().manual_seed(11))
    logits[..., 0] -= 2.0  # objectness: a few anchors a frame over 0.7, dozens over 0.2
    logits[..., 1:K + 1] *= 3.0
    logits = logits.reshape(1, T, -1)
    obj = torch.sigmoid(logits[0].reshape(T, n, K + 3)[..., 0])
    per_frame = (obj[:valid] > tau).sum(-1)
    assert (int(per_frame.max()) > cfg.train.decode_topk) == (tau < 0.5)
    monkeypatch.setattr(profiling, "COUNTERS", {})
    dets = pp.postprocess(logits, valid_label_frames=valid)
    assert profiling.COUNTERS["decode.label_frames"] == valid
    assert profiling.COUNTERS["decode.candidates"] == int(per_frame.sum())
    assert sum(len(v) for v in dets.values()) > 0


def test_benchmark_on_the_cpu_makes_warmup_and_iters_calls():
    calls = []
    t = profiling.benchmark(lambda x: calls.append(1) or x * 2, torch.ones(3), iters=4,
                            warmup=2)
    assert len(calls) == 6 and t > 0
