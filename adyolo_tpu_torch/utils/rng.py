"""RNG discipline: seeding and checkpointable state (counterpart of
:mod:`adyolo_tpu.utils.rng`).

Three streams, as in the JAX package, with a ``torch.Generator`` in place
of its PRNG key:

* python ``random``: the epoch pool sampler, the loader's shuffle and the
  rotation draws (host side, order-dependent, must be bit-restorable);
* numpy's global RNG: host-side numeric helpers;
* one ``torch.Generator`` on the model's device: every dropout bit and
  every SpecAugment draw of the train step.

``get_rng_state`` / ``set_rng_state`` round-trip all of them, so a resumed
run continues the streams where the checkpoint left them (reference
``src/train.py:150,159,245``).
"""
from __future__ import annotations

import os
import random
from typing import Any, Dict

import numpy as np
import torch

__all__ = ["seed_init", "get_rng_state", "set_rng_state"]


def seed_init(seed: int, device="cuda") -> torch.Generator:
    """Seed the host RNGs and return the step generator on ``device``
    (reference ``utility.py:22-30``)."""
    random.seed(seed)
    np.random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    return torch.Generator(device=device).manual_seed(seed)


def get_rng_state(generator: torch.Generator) -> Dict[str, Any]:
    """The state of every stream; the generator's (a CPU byte tensor, also
    for a CUDA generator) as a numpy array."""
    return {
        "rand_state": random.getstate(),
        "numpy_state": np.random.get_state(),
        "torch_generator": generator.get_state().numpy().copy(),
        "os_hash_state": os.environ.get("PYTHONHASHSEED", ""),
    }


def set_rng_state(state: Dict[str, Any], generator: torch.Generator) -> torch.Generator:
    """Restore :func:`get_rng_state`'s ``state``; ``generator`` is set in
    place and returned."""
    random.setstate(state["rand_state"])
    np.random.set_state(state["numpy_state"])
    os.environ["PYTHONHASHSEED"] = str(state["os_hash_state"])
    generator.set_state(torch.from_numpy(np.asarray(state["torch_generator"], np.uint8)))
    return generator
