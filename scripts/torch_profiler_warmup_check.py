#!/usr/bin/env python3
"""How often torch.profiler loses a call's kernels, by the way the profile
is started, on one card: the experiment behind ``profile_calls``'s warm-up
call (``adyolo_tpu_torch/utils/profiling.py::_profiled``).

Run from the repository root::

    python3 scripts/torch_profiler_warmup_check.py [--reps 4]

Two programs: K4 (the eval attention at (1, 4800) with 3000 valid frames,
a split kernel and a merge a call, 10 calls a profile) and the bench's
SE-ResNet34 + AD-YOLO float32 train step at B=16 and B=32 x 20 s (one K1
a step, 2 steps a profile, after 3 warm-up steps).  Each profile is
started in one of four ways:

* ``none``: the calls are the first the tracer sees;
* ``small_kernel``: one small torch kernel in a discarded warm-up cycle;
* ``call_unsynced``: one call of the program in the warm-up cycle, the
  window opened without a synchronise;
* ``call_synced``: the same with a synchronise, as ``profile_calls`` does
  (the package's own ``_profiled``).

Each profile's summary (``summarize_events``) is held to the kernels one
unprofiled call launched (``kernels_launched``).  Prints, for each program
and way, one JSON line: the profiles whose counts were whole out of
``--reps``, and each profile's counts (seen, expected) and busy time a
call.  The card's name and power limit lead the output.
"""
import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from adyolo_tpu_torch import bench  # noqa: E402
from adyolo_tpu_torch.ops import hopper_attention  # noqa: E402
from adyolo_tpu_torch.parallel.train_step import build_train_step  # noqa: E402
from adyolo_tpu_torch.utils import profiling  # noqa: E402

WAYS = ("none", "small_kernel", "call_unsynced", "call_synced")


def profile_once(fn, n, expect, way):
    """One profile of ``n`` calls of ``fn``, started ``way``."""
    from torch.profiler import ProfilerActivity, profile, schedule

    if way == "call_synced":
        return profiling._profiled(fn, n, expect, True)
    kw = {} if way == "none" else {"schedule": schedule(wait=0, warmup=1, active=1, repeat=1)}
    small = torch.ones(8, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], **kw) as prof:
        if way != "none":
            if way == "small_kernel":
                small.add_(1)
                torch.cuda.synchronize()
            else:
                fn(0)
            prof.step()
        t0 = time.perf_counter()
        for i in range(n):
            fn(i)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        if way != "none":
            prof.step()
    return profiling.summarize_events(
        (profiling.DeviceEvent(e.name, e.device_type, e.time_range.elapsed_us(),
                               getattr(e, "is_user_annotation", False)) for e in prof.events()),
        n, wall_ms, expect)


def trial(name, fn, n, reps, card):
    expect = profiling.kernels_launched(lambda: fn(0))
    for way in WAYS:
        runs = []
        for _ in range(reps):
            s = profile_once(fn, n, expect, way)
            runs.append(None if s is None else {
                "counts": {k: [c["seen"], c["expected"]] for k, c in s["kernel_counts"].items()},
                "busy_ms_per_call": s["busy_ms_per_step"]})
        whole = sum(r is not None and all(a == b for a, b in r["counts"].values()) for r in runs)
        print(json.dumps({"program": name, "way": way, "whole": f"{whole} of {reps}",
                          "profiles": runs, "card": card}), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    q = torch.randn(1, 4800, 4, 64, device="cuda")
    kv = torch.tensor([3000], dtype=torch.int32, device="cuda")
    trial("k4", lambda i: hopper_attention.flash_attention(q, q, q, kv), 10, args.reps, card)
    for batch in (16, 32):
        b = bench.Bench("cuda", bench.Sizes(train_batch=batch))
        cfg = dataclasses.replace(b.cfg, train=dataclasses.replace(b.cfg.train,
                                                                   batch_size=batch))
        step = build_train_step(cfg, b.model(cfg, train=True), b.frontend)
        data, gen = b.train_batch(), torch.Generator(device="cuda").manual_seed(1)
        for _ in range(3):
            step(data, gen)
        torch.cuda.synchronize()
        trial(f"se_step_b{batch}", lambda i: step(data, gen), 2, args.reps, card)
        del step, b
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
