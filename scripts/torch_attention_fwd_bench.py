"""Time the attention forward kernel on one GPU: device time per launch
(20 back-to-back launches between two CUDA events, medians of 5 turns)
beside ``F.scaled_dot_product_attention``, and the wrapper's single-call
time (as ``chip_smoke.py`` takes it) and host time per call.

Run from the repository root on a machine with a card::

    python3 scripts/torch_attention_fwd_bench.py [--baseline OLD.cu]

This tree's kernels are the repository build, bound by the wrapper
(``hopper_attention._entry``).  ``--baseline`` is an older
``attention.cu`` built and timed in the same turns, in one of two C
interfaces that it binds itself, told apart by the source: the FFMA
forward of commit d816c2a (no key splits or scratch: ``git show
d816c2a:adyolo_tpu_torch/csrc/attention.cu > build/attention_old.cu``),
or a source with key splits from before the train forward took the head
range (``git show 1f0ed65:adyolo_tpu_torch/csrc/attention.cu >
build/attention_pr12.cu``).
Cases: routes k2 and
k2_dropout at (16, 800, 4, 64) and (1, 1200, 4, 64) with 920 valid keys,
k4 at (1, 4800, 4, 64) with 3000; each launch is checked against the plain
attention within 2e-5 * max.
"""
import argparse
import ctypes
import os
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.getcwd())
from adyolo_tpu_torch.ops import attention, hopper_attention  # noqa: E402
from adyolo_tpu_torch.utils import build  # noqa: E402

P, I = ctypes.c_void_p, ctypes.c_int


def baseline_library(src):
    """Build ``src`` alone into a fresh directory under the build tree and
    bind its two forward entries: in d816c2a's C interface, or, for a
    source with key splits, in the interface before the head range (the
    library's ``splits`` attribute says which)."""
    with open(src) as f:
        text = f.read()
    splits = "int splits" in text
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    so = os.path.join(tempfile.mkdtemp(dir=build.BUILD_DIR), "baseline.so")
    proc = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-shared", "-o", so, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        sys.exit("baseline build failed: " + proc.stderr[-3000:])
    print("baseline ptxas:", [ln.strip() for ln in proc.stderr.splitlines()
                              if "registers" in ln][:2], flush=True)
    lib = ctypes.CDLL(so)
    lib.adyolo_mhsa_fwd.argtypes = [P] * (5 + splits) + [I] * (4 + splits) + [P]
    lib.adyolo_mhsa_fwd_train.argtypes = [P] * (7 + splits) + [I] * (7 + splits) + [P]
    return types.SimpleNamespace(adyolo_mhsa_fwd=lib.adyolo_mhsa_fwd,
                                 adyolo_mhsa_fwd_train=lib.adyolo_mhsa_fwd_train,
                                 splits=splits, lib=lib)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", help="an older attention.cu: d816c2a's, or one with "
                                       "key splits and no head range")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    libs = {"this": types.SimpleNamespace(**{  # bound as the wrapper binds them
        n: hopper_attention._entry(n) for n in ("adyolo_mhsa_fwd", "adyolo_mhsa_fwd_train")})}
    if args.baseline:
        libs["baseline"] = baseline_library(args.baseline)
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(0)
    seed = torch.tensor([12345], dtype=torch.int32, device="cuda")
    cases = [("k2", 16, 800, [800] * 16, 0), ("k2", 1, 1200, [920], 0),
             ("k4", 1, 4800, [3000], 0), ("k2_dropout", 16, 800, [800] * 16, 51),
             ("k2_dropout", 1, 1200, [920], 51)]
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    for rt, B, T, lens, thresh in cases:
        H = 4
        q, k, v = (torch.tensor(rng.standard_normal((B, T, H, 64)), dtype=torch.float32,
                                device="cuda") for _ in range(3))
        kv = torch.tensor(lens, dtype=torch.int32, device="cuda")
        rate = thresh / 256.0
        want = attention.mhsa_attention(q, k, v, kv, rate=rate, seed=seed)
        scale = float(want.abs().max())
        bq, tp = attention.pick_bq(T), -(-T // 128) * 128
        out = torch.empty_like(q)
        lse = torch.empty((B, H, T), device="cuda")
        runs = {}
        for name, lib in libs.items():
            old = name == "baseline"  # without the head range
            split = not old or lib.splits  # an interface with key splits and scratch
            splits, sp, scratch = hopper_attention._fwd_plan(q) if split else (1, 0, None)
            tail = (splits,) if split else ()
            if thresh or rt == "k2_dropout":
                args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), kv.data_ptr(), seed.data_ptr(),
                        out.data_ptr(), lse.data_ptr(), *((sp,) if split else ()),
                        B, T, H, 64, thresh, bq, tp, *(() if old else (0, H)), *tail)
                fn = lib.adyolo_mhsa_fwd_train
            else:
                args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), kv.data_ptr(), out.data_ptr(),
                        *((sp,) if split else ()), B, T, H, 64, *tail)
                fn = lib.adyolo_mhsa_fwd
            runs[name] = (fn, args, scratch, splits)
            rc = fn(*args, stream())
            torch.cuda.synchronize()
            err = float((out - want).abs().max())
            print(f"{rt} ({B}, {T}) {name}: splits {splits} rc {rc} err/max {err / scale:.2e}"
                  f" {'OK' if rc == 0 and err <= 2e-5 * scale else 'FAIL'}", flush=True)
        mask = (torch.arange(T, device="cuda")[None, :] < kv[:, None])[:, None, None, :]
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,  # noqa: E731
                                                      dropout_p=rate)
        ms = {name: [] for name in runs}
        ms["sdpa"] = []
        for _ in range(5):  # in turns; 20 back-to-back calls between two events
            for name, (fn, args, _, _) in runs.items():
                st = stream()
                for _ in range(2):
                    fn(*args, st)
                s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                s.record()
                for _ in range(20):
                    fn(*args, st)
                e.record()
                e.synchronize()
                ms[name].append(s.elapsed_time(e) / 20)
            sdpa()
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            for _ in range(20):
                sdpa()
            e.record()
            e.synchronize()
            ms["sdpa"].append(s.elapsed_time(e) / 20)
        print(f"{rt} ({B}, {T}) back-to-back ms:",
              {n: round(float(np.median(t)), 4) for n, t in ms.items()}, flush=True)
        # the wrapper (repository build, default flags): single call between
        # events as chip_smoke.py times it, and host time per call
        wrap = lambda: hopper_attention.flash_attention(q, k, v, kv, rate=rate, seed=seed)  # noqa
        for _ in range(3):
            wrap()
        torch.cuda.synchronize()
        single = []
        for _ in range(30):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            wrap()
            e.record()
            e.synchronize()
            single.append(s.elapsed_time(e))
        t0 = time.perf_counter()
        for _ in range(50):
            wrap()
        host = (time.perf_counter() - t0) / 50 * 1e3
        torch.cuda.synchronize()
        print(f"{rt} ({B}, {T}) wrapper: single-call events {float(np.median(single)):.4f} ms,"
              f" host {host:.4f} ms per call", flush=True)


if __name__ == "__main__":
    main()
