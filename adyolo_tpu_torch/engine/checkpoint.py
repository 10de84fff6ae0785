"""Checkpoint files: the JAX package's format, read and written without
JAX, and the port's own resumable training checkpoint.

A ``model_best.ckpt`` (``adyolo_tpu/engine/checkpoint.py:55-68``) is a
pickle of ``{"arrays": <flax msgpack bytes>, "host": {...}}``.  The bytes
are flax's msgpack encoding of ``{"params", "batch_stats", "opt_state",
"step"}``: ext type 1 is an ndarray packed as ``(shape, dtype name, C-order
buffer)``, ext type 3 a numpy scalar packed the same way.  Plain
``msgpack`` decodes it.  The port's trainer writes its best model in this
format (:func:`save_jax_checkpoint`), with the optimizer's state in
optax's structure for the config's optimizer (:func:`optax_state`), so
either package's ``val`` / ``test`` / ``infer`` reads what either trainer
wrote: the JAX package loads the file into its full ``init_state``
template.

A ``model_ckpt.ckpt`` (:func:`save_train_checkpoint`) is the port's own:
a ``torch.save`` of the model's state dict (weights and BatchNorm running
stats), the optimizer's state dict and the trainer's host state (the RNG
streams, the sampler pool, ``best_log``, the next epoch, the confidence
threshold), from which ``cli train --resume_pth`` continues.  Under tensor
parallelism both files hold the full model, gathered from the ranks'
shards, so either is read at any ``--model_parallel``.

Every file is written to a process-unique temporary file and renamed into
place, so a preemption mid-write leaves the previous file whole.
"""
from __future__ import annotations

import os
import pickle
from typing import Any, Dict, Optional, Tuple

import msgpack
import numpy as np
import torch

from ..convert import flax_from_state_dict
from ..parallel import mesh

__all__ = ["load_jax_checkpoint", "save_jax_checkpoint", "optax_state",
           "save_train_checkpoint", "load_train_checkpoint"]

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


def _array_from_bytes(data: bytes) -> np.ndarray:
    shape, dtype_name, buf = msgpack.unpackb(data, raw=True)
    name = dtype_name.decode()
    if name == "bfloat16":
        raise NotImplementedError("bfloat16 checkpoint arrays are not supported")
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape).copy()


def _ext_hook(code: int, data: bytes):
    if code == _EXT_NDARRAY:
        return _array_from_bytes(data)
    if code == _EXT_NPSCALAR:
        return _array_from_bytes(data)[()]
    raise ValueError(f"unsupported msgpack ext type {code} in checkpoint")


def _ext_default(obj):
    if isinstance(obj, np.ndarray):
        return msgpack.ExtType(_EXT_NDARRAY, msgpack.packb(
            (obj.shape, obj.dtype.name, obj.tobytes("C")), use_bin_type=True))
    if isinstance(obj, np.generic):
        a = np.asarray(obj)
        return msgpack.ExtType(_EXT_NPSCALAR, msgpack.packb(
            (a.shape, a.dtype.name, a.tobytes("C")), use_bin_type=True))
    raise TypeError(f"cannot serialise {type(obj)}")


def _check_unchunked(tree):
    if isinstance(tree, dict):
        if "__msgpack_chunked_array__" in tree:
            raise NotImplementedError("chunked (>1 GiB) checkpoint arrays")
        for v in tree.values():
            _check_unchunked(v)


def load_jax_checkpoint(path: str) -> Tuple[Dict, Dict[str, Any]]:
    """Returns ``(variables, host)``: ``variables = {"params": ...,
    "batch_stats": ...}`` as nested dicts of numpy arrays, ``host`` the
    checkpoint's host state (``epoch_nb``, ``confidence_thresh``, ...).
    The file must come from this project's trainer: it is unpickled."""
    with open(path, "rb") as f:
        payload = pickle.load(f)
    tree = msgpack.unpackb(payload["arrays"], ext_hook=_ext_hook, raw=False)
    _check_unchunked(tree)
    variables = {"params": tree["params"],
                 "batch_stats": tree.get("batch_stats", {})}
    return variables, payload["host"]


def optax_state(optim: str, weight_decay: float, optimizer_state: Dict,
                params: Dict[str, torch.Tensor]) -> Tuple[Dict, np.ndarray]:
    """``(opt_state, step)`` of the JAX package's ``TrainState`` from the
    port's optimizer: optax's state of the chain that
    ``adyolo_tpu/parallel/train_step.py:86-104`` builds for ``optim`` and
    ``weight_decay``, as flax serialises it, and the step count.

    ``optimizer_state``: the state dict of the optimizer
    (:func:`~adyolo_tpu_torch.parallel.train_step.make_optimizer`) over
    ``params`` (name -> full parameter, in the optimizer's order; under
    tensor parallelism the gathered state).  Adam's ``mu`` / ``nu`` are its
    ``exp_avg`` / ``exp_avg_sq`` on the flax paths of their parameters
    (zeros for a parameter never stepped) and its ``count`` the step of
    its state; ``step`` is the train step's count of optimizer steps
    (``param_groups[0]["steps"]``).  A count of parameters, or a moment's
    shape, that differs from ``params`` raises.  The chains, written out
    per optimizer:

    * ``Adam``: ``adam`` -> ``{"0": adam, "1": {}}``; with weight decay
      ``chain(add_decayed_weights, adam)`` -> ``{"0": {}, "1": <adam's>}``;
    * ``AdamW``: ``adamw`` -> ``{"0": adam, "1": {}, "2": {}}``;
    * ``SGD``: ``sgd`` -> ``{"0": {}, "1": {}}``; with weight decay
      ``{"0": {}, "1": <sgd's>}``.
    """
    step = np.asarray(optimizer_state["param_groups"][0].get("steps", 0), np.int32)
    if optim == "SGD":
        tx = {"0": {}, "1": {}}
        return ({"0": {}, "1": tx} if weight_decay else tx), step
    if optim not in ("Adam", "AdamW"):
        raise NotImplementedError(optim)
    names = list(params)
    order = [i for g in optimizer_state["param_groups"] for i in g["params"]]
    if len(order) != len(names):
        raise ValueError(f"the optimizer holds {len(order)} parameters, params "
                         f"{len(names)}")
    moments = {"exp_avg": {}, "exp_avg_sq": {}}
    count = 0
    for name, idx in zip(names, order):
        st = optimizer_state["state"].get(idx, {})
        for k, tree in moments.items():
            m = st.get(k, torch.zeros_like(params[name]))
            if m.shape != params[name].shape:
                raise ValueError(f"{k} of {name}: shape {tuple(m.shape)}, the "
                                 f"parameter's {tuple(params[name].shape)}")
            tree[name] = m
        count = max(count, int(st.get("step", 0)))
    adam = {"count": np.asarray(count, np.int32),
            "mu": flax_from_state_dict(moments["exp_avg"])["params"],
            "nu": flax_from_state_dict(moments["exp_avg_sq"])["params"]}
    if optim == "AdamW":
        return {"0": adam, "1": {}, "2": {}}, step
    tx = {"0": adam, "1": {}}
    return ({"0": {}, "1": tx} if weight_decay else tx), step


def save_jax_checkpoint(path: str, variables: Dict, host: Dict[str, Any],
                        opt_state: Dict, step: np.ndarray) -> None:
    """Write ``variables`` (``{"params", "batch_stats"}`` of numpy arrays),
    the optimizer's ``opt_state`` and ``step`` (:func:`optax_state`) and
    ``host`` in the checkpoint file format."""
    tree = {"params": variables["params"],
            "batch_stats": variables.get("batch_stats", {}),
            "opt_state": opt_state, "step": np.asarray(step, np.int32)}
    payload = {"arrays": msgpack.packb(tree, default=_ext_default,
                                       use_bin_type=True),
               "host": host}
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, path)


def save_train_checkpoint(path: str, model_state: Dict[str, torch.Tensor],
                          optimizer_state: Dict, host: Dict[str, Any]) -> None:
    """Write the resumable state of a training run: the full model's state
    dict and its optimizer's (under tensor parallelism, gathered from the
    ranks' shards) and the host state."""
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save({"model": model_state, "optimizer": optimizer_state, "host": host}, tmp)
    os.replace(tmp, path)


def load_train_checkpoint(path: str, model: torch.nn.Module,
                          optimizer: torch.optim.Optimizer,
                          plan: Optional[mesh.TPPlan] = None,
                          tp_rank: int = 0) -> Dict[str, Any]:
    """Load :func:`save_train_checkpoint`'s model and optimizer state into
    ``model`` and ``optimizer`` (onto their device) and return the host
    state.  A model sharded by ``plan`` (the train step's) takes rank
    ``tp_rank``'s shard of the full state, its optimizer's moments cut the
    same way (:mod:`adyolo_tpu_torch.parallel.mesh`).  The file must come
    from this project's trainer: it is unpickled."""
    payload = torch.load(path, map_location="cpu", weights_only=False)
    model_state, optimizer_state = payload["model"], payload["optimizer"]
    if plan is not None and plan.sharded:
        names = [n for n, _ in model.named_parameters()]
        model_state = mesh.shard_state_dict(model_state, plan, tp_rank)
        optimizer_state = mesh.shard_optimizer_state(optimizer_state, names, plan, tp_rank)
    model.load_state_dict(model_state, strict=True)
    optimizer.load_state_dict(optimizer_state)
    return payload["host"]
