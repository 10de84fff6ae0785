"""Device time by kernel group from ``torch.profiler``.

One helper for every caller that reads device time from the profiler:
``chip_smoke.py`` (the train and serve profiles, the bf16 attention
pair's device time a call) and ``scripts/torch_attention_bf16_check.py``.
"""
from __future__ import annotations

import time

import torch

__all__ = ["PROFILE_GROUPS", "OTHER", "profile_calls"]

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


def profile_calls(fn, n):
    """Device time by kernel group (``ms_per_step``) a call over ``n`` calls
    ``fn(i)`` under torch.profiler, their sum (``busy_ms_per_step``), and
    the device's idle share of the host-clock window."""
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
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        n_kernels += 1
        name = e.name.lower()
        us = e.time_range.elapsed_us()
        grp = next((g for g, keys in PROFILE_GROUPS if any(s in name for s in keys)), OTHER)
        groups[grp] += us / 1e3 / n
        if grp == OTHER:
            other[e.name[:90]] = other.get(e.name[:90], 0.0) + us / 1e3 / n
    if n_kernels == 0:
        raise RuntimeError("the profiler recorded no device time")
    busy = sum(groups.values())
    return {"steps": n, "wall_ms_per_step": wall_ms / n, "busy_ms_per_step": busy,
            "idle_share": 1.0 - busy / (wall_ms / n), "kernels_per_step": n_kernels / n,
            "ms_per_step": groups,
            "top_other_ms_per_step": dict(sorted(other.items(), key=lambda kv: -kv[1])[:6])}
