"""Seeded weights, made on the device in a few large draws.

Every parameter and buffer of the reference model gets its value from one
``torch.randn`` and one ``torch.rand`` over all of them, drawn from a
``torch.Generator`` on ``device`` seeded from the run's seed, then
sliced and scaled a tensor at a time:

* conv and linear weights: ``N(0, 1 / fan_in)`` (the head's and the
  conformer FFNs': ``N(0, 2 / (fan_in + fan_out))``);
* GRU weights and biases: ``U(-1/sqrt(H), 1/sqrt(H))``, torch's own;
* other biases: ``N(0, 0.02^2)``;
* norms: weight 1, bias 0; BatchNorm running mean 0, running variance 1;
* the configuration's ``init`` overrides: ``std`` of a named weight, and
  ``objectness_prior`` ``p``: the AD-YOLO head's objectness biases at
  ``log(p / (1 - p))``, YOLO's usual start (every anchor's first output of
  ``nb_classes + 3``), so that random weights neither flood nor empty the
  decode.

The same dict is loaded into the program and the reference.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

__all__ = ["seeded_state"]


def _kind(name: str, shape) -> str:
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "running_mean" or leaf == "num_batches_tracked":
        return "zero"
    if leaf == "running_var":
        return "one"
    if ".gru." in f".{name}" or "_fwd." in name or "_bwd." in name:
        return "gru"
    norm = any(k in name for k in ("bn", "norm", "ln.", "_ln.", "pool_norm"))
    if norm and len(shape) == 1:
        return "one" if leaf == "weight" else "zero"
    if leaf == "bias":
        return "bias"
    return "weight"


def seeded_state(template: Dict[str, torch.Tensor], seed: int, device,
                 init: dict = None) -> Dict[str, torch.Tensor]:
    """Values for every entry of ``template`` (a state dict's names and
    shapes; float32), drawn as the module docstring says."""
    init = init or {}
    kinds = {n: _kind(n, t.shape) for n, t in template.items()}
    n_normal = sum(t.numel() for n, t in template.items() if kinds[n] in ("weight", "bias"))
    n_unif = sum(t.numel() for n, t in template.items() if kinds[n] == "gru")
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    normal = torch.randn(n_normal, generator=gen, device=device)
    unif = torch.rand(n_unif, generator=gen, device=device) * 2.0 - 1.0
    out, i, j = {}, 0, 0
    for name, t in template.items():
        k, shape, n = kinds[name], tuple(t.shape), t.numel()
        if k == "zero":
            out[name] = torch.zeros(shape, device=device, dtype=t.dtype)
        elif k == "one":
            out[name] = torch.ones(shape, device=device, dtype=t.dtype)
        elif k == "gru":
            hidden = template[name.rsplit(".", 1)[0] + ".weight_hh_l0"].shape[1]
            out[name] = unif[j:j + n].view(shape) / math.sqrt(hidden)
            j += n
        else:
            x = normal[i:i + n].view(shape)
            i += n
            if k == "bias":
                out[name] = x * 0.02
            else:
                fan_in = n // shape[0]
                std = math.sqrt(2.0 / (fan_in + shape[0])) if (
                    name.startswith("head.") or ".ffn" in name) else math.sqrt(1.0 / fan_in)
                out[name] = x * init.get("std", {}).get(name, std)
    prior = init.get("objectness_prior")
    if prior is not None:
        bias = out[init["objectness_bias"]]
        bias.view(-1, init["outputs_per_anchor"])[:, 0] = math.log(prior / (1.0 - prior))
    return out
