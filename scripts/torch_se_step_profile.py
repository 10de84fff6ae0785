#!/usr/bin/env python3
"""Where SE-ResNet34's train step spends its device time, at B=16 and
B=32 x 20 s, on one card.

Run from the repository root::

    python3 scripts/torch_se_step_profile.py [--cudnn-benchmark] [--bf16]

Builds the bench's train step (``adyolo_tpu_torch.bench``: seeded
SE-ResNet34 + AD-YOLO, Adam, dropout 0.2, synthetic AD-YOLO targets;
float32, or bfloat16 compute with ``--bf16``) at each batch size, takes 3
warm-up steps, then one ``profile_calls`` of 2 steps
(``adyolo_tpu_torch/utils/profiling.py``), which must hold the K1 launch
that one more step makes, and prints one JSON line per batch: the step's
device time by kernel group, the largest kernels outside the named
groups, its busy time and idle share, and the host clock of 3 unprofiled
steps.  A profile that lost K1's events prints ``"source": "void"`` and
null for K1's group, the busy time and the idle share.  The step keeps the port's precision policy
(TF32 off, ``cudnn.benchmark`` off); ``--cudnn-benchmark`` turns
``cudnn.benchmark`` on for a comparison, which the bench never does.
Run each setting in a process of its own: cuDNN keeps the plan it chose
for a convolution's shape for the life of the process, whatever the
flag says later.  The card's name and power limit lead the output.
"""
import dataclasses
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from adyolo_tpu_torch import bench  # noqa: E402
from adyolo_tpu_torch.parallel.train_step import build_train_step  # noqa: E402
from adyolo_tpu_torch.utils.profiling import kernels_launched, profile_calls  # noqa: E402


def run(batch, cudnn_benchmark, dtype):
    b = bench.Bench("cuda", bench.Sizes(train_batch=batch))
    cfg = dataclasses.replace(b.cfg, train=dataclasses.replace(
        b.cfg.train, batch_size=batch, compute_dtype=dtype))
    step = build_train_step(cfg, b.model(cfg, train=True), b.frontend)
    data, gen = b.train_batch(), torch.Generator(device="cuda").manual_seed(1)
    for _ in range(3):
        loss = step(data, gen)
    loss.item()
    host_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        step(data, gen).item()
        host_ms.append((time.perf_counter() - t0) * 1e3)
    prof = profile_calls(lambda i: step(data, gen), 2,
                         expect=kernels_launched(lambda: step(data, gen)))
    return {"batch": batch, "compute_dtype": dtype, "tf32": torch.backends.cudnn.allow_tf32,
            "cudnn_benchmark": cudnn_benchmark, "host_step_ms": host_ms,
            "busy_ms_per_step": prof["busy_ms_per_step"],
            "idle_share": prof["idle_share"], "ms_per_step": prof["ms_per_step"],
            "top_other_ms_per_step": prof["top_other_ms_per_step"],
            "kernels_per_step": prof["kernels_per_step"], "source": prof["source"],
            "kernel_counts": prof.get("kernel_counts"),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


def main():
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    cudnn_benchmark = "--cudnn-benchmark" in sys.argv[1:]
    dtype = "bfloat16" if "--bf16" in sys.argv[1:] else "float32"
    torch.backends.cudnn.benchmark = cudnn_benchmark
    for batch in (16, 32):
        torch.cuda.reset_peak_memory_stats()
        print(json.dumps(run(batch, cudnn_benchmark, dtype)), flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
