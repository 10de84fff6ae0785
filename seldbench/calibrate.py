"""The readings that the limits of ``correct`` are set from, on the chip, at
each cell's own size (``python3 -m seldbench.calibrate <cell> <seed> ...``;
one JSON line a seed on standard output).

Training cells, a seed each: the numbers of :mod:`seldbench.checks` for
the program's first steps (the lower reading), for the control (the plain
reference with TF32 on, in the program's place) and for the fault "half
of the batch left out" planted in the program's batches; all against the
plain reference at float32 with TF32 off.  A step that leaves the state
unchanged reads 1 on ``change_gap`` by construction and needs no run.

The serving cell, a seed each: the driver's own check over one cycle of
the mix (every clip, not a sample), the control's ``logit_gap`` (the
reference with TF32 on against it at float32), the run's tau, and the
check's notes (each clip's detections, and the detections and rendered
events a label frame).

The benchmark's own runs do not run this.
"""
from __future__ import annotations

import json
import sys
import time

import torch

from . import checks, registry
from .drivers.serve_clips import logit_gap
from .drivers.train_step import half_batch


def train_readings(cell_name: str, seed: int) -> dict:
    cell = registry.cell(cell_name)
    config = registry.config(cell["config"])
    drv = registry.driver(cell["driver"]).Driver(cell, config, registry.traffic(cell["traffic"]),
                                                 seed, "cuda:0")
    drv.setup()
    prog = drv.prog
    drv.free_program()
    ref = drv.reference_run()
    control = drv.reference_run(tf32=True)
    half = drv.program_run(transform=half_batch)
    drv.free_program()
    return {"program": checks.train_numbers(prog, ref),
            "control": checks.train_numbers(control, ref),
            "half_batch": checks.train_numbers(half, ref),
            "step_loss_gaps": {"program": checks.step_loss_gaps(prog, ref),
                               "control": checks.step_loss_gaps(control, ref)},
            "losses": {"program": prog["losses"], "reference": ref["losses"]}}


def serve_readings(cell_name: str, seed: int) -> dict:
    cell = registry.cell(cell_name)
    config = registry.config(cell["config"])
    drv = registry.driver(cell["driver"]).Driver(cell, config, registry.traffic(cell["traffic"]),
                                                 seed, "cuda:0")
    drv.setup()
    drv.sample = list(range(len(drv.clips)))
    drv.reset()
    drv.serve_cycle()
    prog = {name: value for name, (value, _) in drv.check().items()}
    ctrl = max(logit_gap(drv.reference_logits(k, tf32=True), drv.reference_logits(k))
               for k in drv.sample)
    return {"program": prog, "control": {"logit_gap": ctrl}, "tau": drv.tau,
            "notes": drv.notes()}


def main(argv):
    cell_name, seeds = argv[0], [int(s) for s in argv[1:]]
    kind = registry.cell(cell_name)["driver"]
    for seed in seeds:
        t0 = time.perf_counter()
        res = (serve_readings if kind == "serve_clips" else train_readings)(cell_name, seed)
        print(json.dumps({"cell": cell_name, "seed": seed, **res,
                          "seconds": time.perf_counter() - t0}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
