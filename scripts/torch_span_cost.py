"""What the port's spans cost (``adyolo_tpu_torch/utils/profiling.py::span``).

A benchmark cell's calls (a train step of ``train.*``, a cycle of clips
of ``serve.*``), set up by the benchmark's driver, are timed on the host
clock between two device synchronises in three modes, in turns
(plain, traced, bare, bare, traced, plain, ...):

* ``plain``: no profiler: each span is one flag read;
* ``traced``: under a ``torch.profiler`` capture of the host's ops and the
  device, the spans recorded;
* ``bare``: under the same capture with the port's spans replaced by a
  no-op, so ``traced`` less ``bare`` is what the spans add to a capture.

It also times a span entered and left with no profiler against an empty
``with``.  Prints one JSON line a cell.  Needs a CUDA device.

    python3 scripts/torch_span_cost.py --cells train.se34.fp32.b16 serve.conformer.starss22
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import sys
import time
import timeit

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from seldbench import registry  # noqa: E402

MODULES = ("adyolo_tpu_torch.parallel.train_step", "adyolo_tpu_torch.engine.evaluate",
           "adyolo_tpu_torch.data.dataset", "adyolo_tpu_torch.ops.decode")


@contextlib.contextmanager
def bare_spans():
    """The port's spans replaced by a no-op in every loaded module that enters them."""
    saved = {m: sys.modules[m].span for m in MODULES if m in sys.modules}
    try:
        for m in saved:
            sys.modules[m].span = lambda name: contextlib.nullcontext()
        yield
    finally:
        for m, f in saved.items():
            sys.modules[m].span = f


def timed(call, n, mode):
    from torch.profiler import ProfilerActivity, profile

    capture = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
        if mode != "plain" else contextlib.nullcontext()
    spans = bare_spans() if mode == "bare" else contextlib.nullcontext()
    with spans, capture:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            call()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n


def off_cost_ns():
    from adyolo_tpu_torch.utils.profiling import span

    def with_span():
        with span("train.step"):
            pass

    def with_nothing():
        with contextlib.nullcontext():
            pass

    n = 200000
    return {k: 1e9 * min(timeit.repeat(f, number=n, repeat=5)) / n
            for k, f in (("span_ns", with_span), ("empty_with_ns", with_nothing))}


def cell_cost(name, seed, rounds, steps):
    cell = registry.cell(name)
    drv = registry.driver(cell["driver"]).Driver(
        cell, registry.config(cell["config"]), registry.traffic(cell["traffic"]), seed,
        "cuda:0")
    drv.setup()
    if cell["driver"] == "train_step":
        call, unit = drv._one, "step"
        drv.calls, drv.losses = 0, []
    else:
        call, unit, steps = drv.serve_cycle, "cycle", 1
    order = ["plain", "traced", "bare", "bare", "traced", "plain"]
    times = {m: [] for m in order}
    for r in range(rounds):
        for mode in order if r % 2 == 0 else order[::-1]:
            times[mode].append(timed(call, steps, mode))
    med = {m: statistics.median(v) for m, v in times.items()}
    return {"cell": name, "unit": unit, "calls_a_reading": steps,
            "ms": {m: [round(1e3 * t, 3) for t in v] for m, v in times.items()},
            "median_ms": {m: round(1e3 * t, 3) for m, t in med.items()},
            "traced_over_plain": med["traced"] / med["plain"],
            "spans_under_capture_ms": 1e3 * (med["traced"] - med["bare"])}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", nargs="+", default=["train.se34.fp32.b16"])
    ap.add_argument("--seed", type=int, default=2 ** 31 + 222)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    print(json.dumps({"device": torch.cuda.get_device_name(0), **off_cost_ns()}), flush=True)
    for name in args.cells:
        print(json.dumps(cell_cost(name, args.seed, args.rounds, args.steps)), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
