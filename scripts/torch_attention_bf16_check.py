#!/usr/bin/env python3
"""Time the bf16 attention pair on one card, beside SDPA and older builds.

Run from the repository root on a machine with an NVIDIA GPU::

    python3 scripts/torch_attention_bf16_check.py [--baseline OLD.cu ...]

1. Builds the kernels and prints ptxas's lines for the bf16 kernels
   (registers, spills, and any wgmma serialisation it reports).
2. At (16, 800, 4, 64) full and (1, 1200, 4, 64) len 920, rate 0.2, in
   turns within the call: device time a launch, 20 back-to-back launches
   between two CUDA events, medians of 5 turns, of the forward and the
   backward entry points (bound as the wrapper binds them), of
   ``F.scaled_dot_product_attention`` in bf16 with ``dropout_p`` 0.2
   (with the key mask, the same function; and, at full length, without
   it) and of its backward alone (``torch.autograd.grad`` with
   ``retain_graph``); the host time a call of each (the same loop on the
   host clock, to the last launch's return); and the device time a call
   of the kernels and of SDPA from ``torch.profiler``, which does not
   count the host (null where the profile does not hold the kernels the
   calls launched, a void reading): 20 back-to-back autograd calls of SDPA's backward are
   host-bound on the card machine.  Each ``--baseline`` adds the kernels
   of an older ``attention.cu`` of the same C interface, or of the one
   before the train entry points took the head range ``(head_offset,
   heads_total)`` (a source without ``heads_total`` is called without
   it), built alone into the build tree (a one-off: ``git show
   f6a829d:adyolo_tpu_torch/csrc/attention.cu > build/attention_pr8.cu``
   gives the first, mma.sync design of this pair), and each baseline's
   forward output is compared with this tree's (its max|difference|).

The kernels' accuracy is checked by ``chip_smoke.py`` and by
``pytest -m cuda tests/test_torch_bf16.py``, not here.  One JSON line per
result.
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from adyolo_tpu_torch.ops import attention, hopper_attention as ha  # noqa: E402
from adyolo_tpu_torch.utils import build  # noqa: E402
from adyolo_tpu_torch.utils.profiling import group_ms, group_of, profile_calls  # noqa: E402

RATE = 0.2
ENTRIES = ("adyolo_mhsa_fwd_train_bf16", "adyolo_mhsa_bwd_bf16", "adyolo_mhsa_fwd_bf16_splits",
           "adyolo_mhsa_fwd_scratch_floats")


def emit(obj):
    print(json.dumps(obj), flush=True)


def bf16(rng, shape):
    return torch.tensor(rng.standard_normal(shape), dtype=torch.float32, device="cuda").bfloat16()


def baseline_library(src):
    """Build ``src`` alone into a fresh directory of the build tree and bind
    the bf16 pair's entry points; returns the library and whether its train
    entry points take the head range (else they have two ints fewer)."""
    with open(src) as f:
        heads = "heads_total" in f.read()
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    so = os.path.join(tempfile.mkdtemp(dir=build.BUILD_DIR), "baseline.so")
    proc = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-shared", "-o", so, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        sys.exit("baseline build failed: " + proc.stderr[-3000:])
    lib = ctypes.CDLL(so)
    for name in ENTRIES:
        fn = getattr(lib, name)
        sig = ha._SIGNATURES[name]
        fn.argtypes = sig if heads or "train" not in name and "bwd" not in name else (
            sig[:-3] + sig[-1:])
        fn.restype = ha._RESTYPES.get(name, ctypes.c_int)
    return lib, heads


def launchers(entry, heads, q, k, v, kv, sd, do, thresh):
    """The forward and backward entry points of one library on these
    inputs, as closures that launch once on the current stream; ``heads``:
    whether its train entry points take the head range."""
    B, T, H, dh = q.shape
    splits = entry("adyolo_mhsa_fwd_bf16_splits")(B, T, H)
    assert splits >= 1, splits
    n = entry("adyolo_mhsa_fwd_scratch_floats")(B, T, H, splits) if splits > 1 else 0
    scratch = torch.empty((max(n, 1),), device="cuda")
    out, dq, dk, dv = (torch.empty_like(q) for _ in range(4))
    out32 = torch.empty(q.shape, device="cuda")
    lse, delta = (torch.empty((B, H, T), device="cuda") for _ in range(2))
    bq, tp = attention.pick_bq(T), -(-T // 128) * 128
    stream = torch.cuda.current_stream().cuda_stream
    fwd_args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), kv.data_ptr(), sd.data_ptr(),
                out.data_ptr(), out32.data_ptr(), lse.data_ptr(),
                scratch.data_ptr() if splits > 1 else 0, B, T, H, dh, thresh, bq, tp,
                *((0, H) if heads else ()), splits, stream)
    bwd_args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), kv.data_ptr(), sd.data_ptr(),
                out32.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                dk.data_ptr(), dv.data_ptr(), B, T, H, dh, thresh, bq, tp,
                *((0, H) if heads else ()), stream)
    fwd_fn, bwd_fn = entry("adyolo_mhsa_fwd_train_bf16"), entry("adyolo_mhsa_bwd_bf16")

    def fwd():
        assert fwd_fn(*fwd_args) == 0

    def bwd():
        assert bwd_fn(*bwd_args) == 0

    fwd()
    torch.cuda.synchronize()
    keep = (scratch, out, dq, dk, dv, out32, lse, delta)  # alive as long as the closures
    return fwd, bwd, keep, splits, out


def device_ms(fn, n=20):
    """Device time a launch, n back-to-back calls between two events, and
    the host time a call (ms) of the same loop."""
    for _ in range(2):
        fn()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    s.record()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host = (time.perf_counter() - t0) * 1e3 / n
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / n, host


def sdpa_fns(q, k, v, kv, do, mask):
    qt, kt, vt = (x.transpose(1, 2).detach().clone().requires_grad_(True) for x in (q, k, v))
    m = None
    if mask:
        T = q.shape[1]
        m = (torch.arange(T, device="cuda")[None, :] < kv[:, None])[:, None, None, :]
    fwd = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=m, dropout_p=RATE)  # noqa
    out = fwd()
    dot = do.transpose(1, 2)
    bwd = lambda: torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True)  # noqa
    return fwd, bwd


def profiled_ms(fn, expect):
    """Device time a call of ``fn`` from the profiler over 10 calls: the
    groups of the attention kernels ``expect`` names (the kernels one call
    launches, which the profile must hold, else None: void), or, when
    ``expect`` is None, all it launches."""
    p = profile_calls(lambda _: fn(), 10, expect=expect)
    if expect is None:
        return p["busy_ms_per_step"]
    return group_ms(p, *sorted({group_of(k) for k in expect}))


def time_case(B, T, lens, libs):
    rng = np.random.default_rng(1)
    q, k, v, do = (bf16(rng, (B, T, 4, 64)) for _ in range(4))
    kv = torch.tensor(lens, dtype=torch.int32, device="cuda")
    sd = torch.tensor([3], dtype=torch.int32, device="cuda")
    thresh = attention.dropout_thresh(RATE)
    fns, keep, info = {}, [], {}
    for name, (entry, heads) in libs.items():
        fwd, bwd, held, splits, out = launchers(entry, heads, q, k, v, kv, sd, do, thresh)
        fns[f"{name}_fwd"], fns[f"{name}_bwd"] = fwd, bwd
        keep.append(held)
        info[f"{name}_splits"] = splits
        if name != "this":  # the older kernels compute the same forward
            ref = keep[0][1]
            info[f"{name}_fwd_max_abs_diff"] = float((out.float() - ref.float()).abs().max())
    # the kernels a call of this tree's entry points launches (ctypes
    # bypasses the wrapper's counters): what its profile must hold
    expect = {"this_fwd": ha.forward_kernels(torch.bfloat16, info["this_splits"]),
              "this_bwd": ha.backward_kernels(torch.bfloat16)}
    fns["sdpa_fwd"], fns["sdpa_bwd"] = sdpa_fns(q, k, v, kv, do, True)
    if min(lens) == T:
        fns["sdpa_nomask_fwd"], fns["sdpa_nomask_bwd"] = sdpa_fns(q, k, v, kv, do, False)
    ms = {n: [] for n in fns}
    host = {n: [] for n in fns}
    for _ in range(5):  # in turns
        for n, fn in fns.items():
            d, h = device_ms(fn)
            ms[n].append(d)
            host[n].append(h)
    emit({"timing": [B, T, 4, 64], "kv_len": lens if B == 1 else "full", "rate": RATE,
          "profiled_ms": {n: profiled_ms(fn, expect.get(n))
                          for n, fn in fns.items() if n.startswith(("this", "sdpa"))},
          "device_ms_per_launch": {n: float(np.median(t)) for n, t in ms.items()},
          "spread_ms": {n: [float(min(t)), float(max(t))] for n, t in ms.items()},
          "host_ms_per_call": {n: float(np.median(t)) for n, t in host.items()},
          "launches_between_events": 20, "turns": 5, **info})


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", action="append", default=[],
                    help="an older attention.cu with this C interface, or the one "
                         "before the head range (repeatable)")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    emit({"card": subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                  "--format=csv,noheader"], capture_output=True,
                                 text=True).stdout.strip()})
    info = build.build()
    emit({"build_s": round(info["seconds"], 1), "ptxas": [
        ln.strip() for ln in info["ptxas"].splitlines()
        if "bf16" in ln or "Used" in ln or "spill" in ln or "setmaxnreg" in ln
        or "wgmma" in ln or "arning" in ln][-40:]})
    libs = {"this": (ha._entry, True)}
    for src in a.baseline:
        lib, heads = baseline_library(src)
        libs[os.path.splitext(os.path.basename(src))[0]] = (
            lambda name, lib=lib: getattr(lib, name), heads)
    time_case(16, 800, [800] * 16, libs)
    time_case(1, 1200, [920], libs)


if __name__ == "__main__":
    main()
