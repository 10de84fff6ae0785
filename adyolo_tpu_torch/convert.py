"""Weight bridge between the JAX package's flax variables and the port.

``state_dict_from_flax`` maps a ``{"params", "batch_stats"}`` tree of numpy
arrays (as :func:`adyolo_tpu_torch.engine.checkpoint.load_jax_checkpoint`
returns it) onto :class:`adyolo_tpu_torch.models.wrapper.SELDModel`:

* conv ``kernel`` HWIO -> ``weight`` OIHW; Dense ``kernel`` (in, out) ->
  ``weight`` (out, in);
* BatchNorm ``scale/bias`` + ``batch_stats`` ``mean/var`` ->
  ``weight/bias/running_mean/running_var``; LayerNorm ``scale`` -> ``weight``;
* GRU ``w_ih`` (D, 3H) -> ``weight_ih_l0`` (3H, D), likewise ``w_hh``;
  ``b_ih/b_hh`` -> ``bias_ih_l0/bias_hh_l0``; gate order r | z | n in both;
* the conformer conv module's depthwise ``dw_kernel`` (3, D) and
  ``dw_bias`` (D,) -> ``dw_conv.weight`` (D, 1, 3), ``w[k, c] ->
  weight[c, 0, k]``, and ``dw_conv.bias``;
* the heads' Dense layers keep their flax names (``head/sed_fc1``,
  ``head/doa_fc2``, ``head/accdoa_fc1``, ``head/adpit_fc2``,
  ``head/yolo_fc1`` ...): the port's heads name their Linears so;
* auto-named flax modules: ``Dense_0/Dense_1`` -> ``fc1/fc2`` and
  ``LayerNorm_0`` -> ``ln``, everywhere.  The names hold in both encoders
  because the port names its modules to fit them: the SE block's
  squeeze-excite linears and the conformer FFN's linears are both
  ``fc1/fc2``, the FFN's and the conv module's LayerNorm are ``ln``.

Conversion is strict and depends on the encoder and the loss (which picks
the head): a flax leaf with no place in that model, or a model entry that
no leaf fills, raises.
:func:`flax_from_state_dict` is the exact inverse.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

__all__ = ["state_dict_from_flax", "module_state_dict", "flax_from_state_dict",
           "expected_keys"]

_GRU = {"w_ih": "weight_ih_l0", "w_hh": "weight_hh_l0",
        "b_ih": "bias_ih_l0", "b_hh": "bias_hh_l0"}
_GRU_INV = {v: k for k, v in _GRU.items()}
_MODULE = {"Dense_0": "fc1", "Dense_1": "fc2", "LayerNorm_0": "ln"}
_MODULE_INV = {v: k for k, v in _MODULE.items()}
_STATS = {"mean": "running_mean", "var": "running_var"}
_STATS_INV = {v: k for k, v in _STATS.items()}


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def expected_keys(encoder: str = "se-resnet34", loss: str = "adyolo") -> set:
    """The state-dict keys of the ported model with ``encoder`` and the head
    of ``loss`` (independent of the class count and grid, which only change
    shapes)."""
    from .models.wrapper import SELDModel

    with torch.device("meta"):
        return set(SELDModel(encoder, loss).state_dict().keys())


def _to_torch(collection: str, path: Tuple[str, ...], a: np.ndarray):
    *mods, leaf = path
    mods = [_MODULE.get(m, m) for m in mods]
    if collection == "batch_stats":
        if leaf not in _STATS:
            raise KeyError(f"unknown batch_stats leaf {'/'.join(path)}")
        return ".".join(mods + [_STATS[leaf]]), a
    if leaf == "dw_kernel":
        if a.ndim != 2:
            raise KeyError(f"dw_kernel of rank {a.ndim} at {'/'.join(path)}")
        return ".".join(mods + ["dw_conv", "weight"]), a.T[:, None, :]
    if leaf == "dw_bias":
        return ".".join(mods + ["dw_conv", "bias"]), a
    if leaf in _GRU:
        return ".".join(mods + [_GRU[leaf]]), a.T if a.ndim == 2 else a
    if leaf == "kernel":
        if a.ndim == 4:
            return ".".join(mods + ["weight"]), a.transpose(3, 2, 0, 1)
        if a.ndim == 2:
            return ".".join(mods + ["weight"]), a.T
        raise KeyError(f"kernel of rank {a.ndim} at {'/'.join(path)}")
    if leaf == "scale":
        return ".".join(mods + ["weight"]), a
    if leaf == "bias":
        return ".".join(mods + ["bias"]), a
    raise KeyError(f"unknown leaf {'/'.join(path)}")


def _convert(variables: Dict, want: Optional[set]) -> Dict[str, torch.Tensor]:
    unknown = set(variables) - {"params", "batch_stats"}
    if unknown:
        raise KeyError(f"unused flax collections: {sorted(unknown)}")
    out: Dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats"):
        for path, a in _leaves(variables.get(collection, {})):
            key, arr = _to_torch(collection, path, a)
            if want is not None and key not in want:
                raise KeyError(f"unused flax leaf {collection}/{'/'.join(path)}"
                               f" (would map to {key!r})")
            if key in out:
                raise KeyError(f"two flax leaves map to {key!r}")
            out[key] = torch.tensor(arr, dtype=torch.float32)
    if want is not None:
        missing = want - set(out)
        if missing:
            raise KeyError(f"missing flax leaves for {sorted(missing)}")
    return out


def state_dict_from_flax(variables: Dict, encoder: str = "se-resnet34",
                         loss: str = "adyolo") -> Dict[str, torch.Tensor]:
    """flax ``{"params", "batch_stats"}`` (nested dicts of arrays) of a
    ``SELDModel`` with ``encoder`` and the head of ``loss`` -> the port's
    state dict, float32 CPU tensors."""
    return _convert(variables, expected_keys(encoder, loss))


def module_state_dict(variables: Dict) -> Dict[str, torch.Tensor]:
    """flax variables of any one ported module (a conformer block, an MHSA
    ...) -> its state dict.  A leaf the bridge cannot place raises; load the
    result with ``strict=True`` to hold it against the module."""
    return _convert(variables, None)


def flax_from_state_dict(state_dict: Dict[str, torch.Tensor]) -> Dict:
    """Inverse of :func:`state_dict_from_flax`: the port's state dict ->
    flax ``{"params", "batch_stats"}`` of float32 numpy arrays."""
    tree: Dict = {"params": {}, "batch_stats": {}}
    for key, t in state_dict.items():
        *mods, leaf = key.split(".")
        mods = [_MODULE_INV.get(m, m) for m in mods]
        a = t.detach().cpu().numpy().astype(np.float32)
        collection = "params"
        if mods and mods[-1] == "dw_conv":
            mods = mods[:-1]
            if leaf == "weight":
                leaf, a = "dw_kernel", a[:, 0, :].T
            elif leaf == "bias":
                leaf = "dw_bias"
            else:
                raise KeyError(f"unknown state-dict entry {key!r}")
        elif leaf in _STATS_INV:
            collection, leaf = "batch_stats", _STATS_INV[leaf]
        elif leaf in _GRU_INV:
            leaf = _GRU_INV[leaf]
            a = a.T if a.ndim == 2 else a
        elif leaf == "weight":
            if a.ndim == 4:
                leaf, a = "kernel", a.transpose(2, 3, 1, 0)
            elif a.ndim == 2:
                leaf, a = "kernel", a.T
            else:
                leaf = "scale"
        elif leaf != "bias":
            raise KeyError(f"unknown state-dict entry {key!r}")
        node = tree[collection]
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = np.ascontiguousarray(a)
    return tree
