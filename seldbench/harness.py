"""One run of one cell.

1. Refuse to run (exit 2, no result) without as many CUDA devices as the
   cell's entry in ``BENCHMARK.json`` asks for.
2. Build the cell's driver (``drivers/<driver>.py``) from its cell,
   configuration and traffic files, and let it set up: weights and inputs
   from ``--seed``, the program built and every shape of the cell warmed.
   ``setup_s`` runs from the process's start to the window's.
3. The window: ``--seconds`` of the cell's traffic.  With ``--trace 1`` a
   short fixed sub-window inside it is profiled, and the cell's per-layer
   metrics are read from it by their readers; with ``--trace 0`` the
   end-to-end metrics are reported.
4. The device's peak memory is read, the program freed, and the driver's
   comparison with the plain reference decides ``correct``.  Each number
   compared is printed beside its limit on standard error, as the last
   lines there, and under ``checks``, the last key of the result.
5. A run whose process holds ``jax``, ``jaxlib``, ``flax`` or
   ``adyolo_tpu`` once the window has closed prints no result and exits 3.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from typing import Optional

import torch

from . import registry

__all__ = ["main", "FORBIDDEN", "forbidden_modules"]

FORBIDDEN = ("jax", "jaxlib", "flax", "adyolo_tpu")


def forbidden_modules() -> list:
    """The modules of ``sys.modules`` whose top-level name, compared whole,
    is one of ``FORBIDDEN``."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _parse(argv):
    ap = argparse.ArgumentParser(prog="python3 -m seldbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def _power_limit(count: int) -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=True).stdout.strip().splitlines()
        return "; ".join(out[:count])
    except (OSError, subprocess.SubprocessError):
        return None


def _entry(bench: dict, kind: str, name: str) -> dict:
    hit = [e for e in bench.get(kind, []) if e["name"] == name]
    if not hit:
        raise KeyError(f"BENCHMARK.json has no {kind} entry {name!r}")
    return hit[0]


def cell_metrics(bench: dict, cell_name: str):
    """The end-to-end and the per-layer entries of ``BENCHMARK.json`` that
    the cell reports: an entry with ``workloads`` where it lists the cell,
    a per-layer one without where the cell reports the metric it moves."""
    e2e = [m for m in bench["end_to_end"] if cell_name in m.get("workloads", [cell_name])]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if cell_name in m["workloads"]] + \
        [m for m in bench["per_layer"] if "workloads" not in m and m["moves"] in names]
    return e2e, per_layer


def main(argv=None, start: Optional[float] = None, device: Optional[str] = None) -> int:
    """The run; ``device`` is for the tests (the CPU) and is never set
    from the command line."""
    start = time.perf_counter() if start is None else start
    args = _parse(argv)
    bench = registry.benchmark()
    work = _entry(bench, "workloads", args.workload)
    chips = int(work["chips"])
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            have = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"seldbench: the cell {args.workload} needs {chips} CUDA device(s); "
                  f"this machine has {have}", file=sys.stderr)
            return 2
        device = "cuda:0"
    cell = registry.cell(args.workload)
    config = registry.config(cell["config"])
    mix = registry.traffic(cell["traffic"])
    drv = registry.driver(cell["driver"]).Driver(cell, config, mix, args.seed, device,
                                                 trace=bool(args.trace), chips=chips)
    drv.setup()
    setup_s = time.perf_counter() - start
    win = drv.window(args.seconds)

    dev = torch.device(device)
    if dev.type == "cuda":
        peak = max(torch.cuda.max_memory_allocated(i) for i in range(chips))
        kind = torch.cuda.get_device_name(dev)
    else:
        peak, kind = 0, "cpu"
    checks = drv.check()
    found = forbidden_modules()
    if found:
        print(f"seldbench: the process holds {', '.join(found)} after the window; "
              "no result", file=sys.stderr)
        return 3

    e2e, per_layer = cell_metrics(bench, args.workload)
    metrics = {}
    breakdown = None
    if args.trace:
        ctx = {"window": win, "profile": win.get("profile"), "driver": drv, "cell": cell,
               "config": config}
        for m in per_layer:
            spec = registry.metric(m["name"])
            value = registry.reader(spec["reader"]).read(ctx, **spec.get("params", {}))
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        prof, ops = win.get("profile"), win.get("ops")
        if prof is not None:  # the gaps named by the capture that records the host's spans
            breakdown = {"device_ops": prof.top_kernels(10),
                         "idle_gaps": (ops if ops is not None else prof).idle_gaps(10)}
    else:
        values = {**win["e2e"], "setup_s": setup_s}
        for m in e2e:
            metrics[m["name"]] = {"value": float(values[m["name"]]), "unit": m["unit"]}

    correct = all(math.isfinite(v) and v <= lim for v, lim in checks.values()) and \
        win["failed"] == 0
    device_rec = {"platform": "gpu" if dev.type == "cuda" else "cpu", "kind": kind,
                  "count": chips, "memory_peak_bytes": int(peak)}
    if dev.type == "cuda":
        device_rec["power_limit"] = _power_limit(chips)
    if args.trace:
        prof = win.get("profile")
        device_rec["busy_s"] = prof.busy_s() if prof is not None else 0.0
        device_rec["window_s"] = prof.wall_s if prof is not None else 0.0
    for line in drv.notes():
        print(f"seldbench: {line}", file=sys.stderr)
    for name, (value, limit) in checks.items():
        print(f"check {name} = {value!r} (limit {limit!r})", file=sys.stderr)
    result = {"correct": bool(correct), "attempted": int(win["attempted"]),
              "failed": int(win["failed"]), "metrics": metrics, "device": device_rec}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {n: {"value": v, "limit": lim} for n, (v, lim) in checks.items()}
    print(json.dumps(result), flush=True)
    return 0
