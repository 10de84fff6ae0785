"""Rank processes of ``tests/test_torch_profiling.py``'s collective case:
torch and the port's profiling helpers only, on the CPU, joined by a gloo
group through a ``file://`` rendezvous::

    python -m tests.torch_profile_ranks <rank> <world> <rendezvous> <out_dir>

For each scenario of :data:`SCENARIOS` (what each rank's profiler records
in its successive attempts), ``profile_calls(every_rank=True)`` of a call
that is itself an all-reduce over the ranks, with ``_profiled`` replaced by
a fake that makes the calls an attempt makes and returns a synthetic
summary.  After each scenario the ranks gather how many calls each made:
a rank that retried alone would have paired its calls' all-reduces with
another rank's gather.  Each rank writes its results to
``profile.r<rank>.json``.
"""
import datetime
import json
import os
import sys

import torch
import torch.distributed as dist

from adyolo_tpu_torch.parallel import mesh
from adyolo_tpu_torch.utils import profiling
from adyolo_tpu_torch.utils.profiling import DeviceEvent, summarize_events

CUDA = torch.autograd.DeviceType.CUDA
EXPECT = {"mhsa_fwd_kernel": 1, "mhsa_fwd_merge_kernel": 1}
N = 2
# scenario: each rank's attempts, "whole", "lost" (the split kernel's
# events dropped) or "none" (no device event)
SCENARIOS = {
    "whole_at_once": (["whole"], ["whole"]),
    "rank1_whole_late": (["whole", "whole"], ["lost", "whole"]),
    "rank1_always_lost": (["whole"] * 3, ["lost"] * 3),
    "rank1_never_traced": (["whole"] * 3, ["none"] * 3),
    "none_anywhere": (["none"] * 3, ["none"] * 3),
}


def _summary(kind, n):
    if kind == "none":
        return None
    ev = []
    for _ in range(n):
        ev += [DeviceEvent("void mhsa_fwd_kernel<false>", CUDA, 290.0)] if kind == "whole" else []
        ev += [DeviceEvent("void mhsa_fwd_merge_kernel", CUDA, 20.0)]
    return summarize_events(ev, n, 40.0, EXPECT)


def main(rank, world, rdv, out):
    dist.init_process_group("gloo", init_method=f"file://{rdv}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=60))
    try:
        mesh.init_distributed("cpu")
        results = {}
        for name, kinds in SCENARIOS.items():
            kinds = iter(kinds[rank])
            calls = []

            def step(i):  # a collective call, as a data-parallel step is
                t = torch.ones(1)
                dist.all_reduce(t)
                calls.append(float(t))

            def profiled(fn, n, expect, warmup):
                for i in range(n + warmup):
                    fn(i)
                return _summary(next(kinds), n)

            def event_timed(fn, n):
                for i in range(n):
                    fn(i)
                return {"source": "cuda_events", "ms_per_step": None, "busy_ms_per_step": 1.0}

            profiling._profiled, profiling._event_timed = profiled, event_timed
            p = profiling.profile_calls(step, N, expect=EXPECT, every_rank=True)
            made = [None] * world
            dist.all_gather_object(made, len(calls))
            results[name] = {"source": p["source"], "calls": made,
                             "sums": sorted(set(calls)),
                             "fwd_ms": profiling.group_ms(p, "attention fwd")}
        with open(os.path.join(out, f"profile.r{rank}.json"), "w") as f:
            json.dump(results, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
