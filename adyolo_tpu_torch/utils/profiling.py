"""Device time by kernel group from ``torch.profiler``.

One helper for every caller that reads device time from the profiler:
``chip_smoke.py`` (the train and serve profiles, the bf16 attention
pair's device time a call) and ``scripts/torch_attention_bf16_check.py``.
"""
from __future__ import annotations

import sys
import time

import torch

__all__ = ["PROFILE_GROUPS", "OTHER", "group_ms", "profile_calls"]

PROFILE_GROUPS = (  # kernel-name substrings, first match wins
    ("K1 STFT", ("stft_hop_blocks",)),
    ("attention fwd", ("mhsa_fwd",)),
    ("attention bwd", ("mhsa_bwd",)),
    ("optimizer", ("multi_tensor", "adam")),
    ("GRU (cuDNN RNN)", ("rnn", "gru", "persist")),
    ("conv (cuDNN)", ("conv", "fprop", "dgrad", "wgrad", "winograd", "implicit",
                      "nchw", "nhwc", "cudnn")),
    ("GEMM (cuBLAS)", ("gemm", "gemv", "cutlass", "xmma", "splitk")),
)
OTHER = "other (elementwise, reductions, copies)"


def profile_calls(fn, n, attempts=3):
    """Device time by kernel group (``ms_per_step``) a call over ``n`` calls
    ``fn(i)`` under torch.profiler, their sum (``busy_ms_per_step``), and
    the device's idle share of the host-clock window.

    The profiler now and then records no device event at all.  It is then
    run again, up to ``attempts`` times; if it never records one, CUDA
    events time the ``n`` calls instead (``source`` ``"cuda_events"``):
    ``busy_ms_per_step`` is then the event time a call, gaps included, and
    the groups, the idle share and the kernel count are None."""
    for _ in range(attempts):
        res = _profiled(fn, n)
        if res is not None:
            return res
        print("torch.profiler recorded no device time; profiling again", file=sys.stderr)
    print(f"torch.profiler recorded no device time in {attempts} attempts; "
          "timing with CUDA events", file=sys.stderr)
    return _event_timed(fn, n)


def group_ms(prof, *groups):
    """Device time a call of the kernel ``groups`` of a ``profile_calls``
    result; all of the event time where CUDA events timed the calls, which
    holds only for a call that launches those groups' kernels alone."""
    if prof["ms_per_step"] is None:
        return prof["busy_ms_per_step"]
    return sum(prof["ms_per_step"][g] for g in groups)


def _profiled(fn, n):
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            fn(i)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    groups = {g: 0.0 for g, _ in PROFILE_GROUPS}
    groups[OTHER] = 0.0
    other = {}
    n_kernels = 0
    for e in prof.events():
        # a user annotation (DDP's forward, a gloo collective) is a span on
        # the device's timeline, not device work
        if e.device_type != torch.autograd.DeviceType.CUDA or getattr(
                e, "is_user_annotation", False):
            continue
        n_kernels += 1
        name = e.name.lower()
        us = e.time_range.elapsed_us()
        grp = next((g for g, keys in PROFILE_GROUPS if any(s in name for s in keys)), OTHER)
        groups[grp] += us / 1e3 / n
        if grp == OTHER:
            other[e.name[:90]] = other.get(e.name[:90], 0.0) + us / 1e3 / n
    if n_kernels == 0:
        return None
    busy = sum(groups.values())
    return {"source": "profiler", "steps": n, "wall_ms_per_step": wall_ms / n,
            "busy_ms_per_step": busy, "idle_share": 1.0 - busy / (wall_ms / n),
            "kernels_per_step": n_kernels / n, "ms_per_step": groups,
            "top_other_ms_per_step": dict(sorted(other.items(), key=lambda kv: -kv[1])[:6])}


def _event_timed(fn, n):
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for i in range(n):
        fn(i)
    end.record()
    end.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    return {"source": "cuda_events", "steps": n, "wall_ms_per_step": wall_ms / n,
            "busy_ms_per_step": start.elapsed_time(end) / n, "idle_share": None,
            "kernels_per_step": None, "ms_per_step": None, "top_other_ms_per_step": {}}
