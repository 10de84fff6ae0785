"""The process-group layer of data parallelism (counterpart of
:mod:`adyolo_tpu.parallel.mesh`).

The port runs data parallelism as one process per card under ``torchrun``
(``torchrun --nproc_per_node N -m adyolo_tpu_torch.cli train ...``); the
JAX package's device mesh becomes a ``torch.distributed`` group:

* :func:`init_distributed` reads torchrun's variables and initialises the
  default group (NCCL for CUDA, gloo for the CPU), or uses the group its
  caller initialised as it is; rank r takes ``cuda:LOCAL_RANK``;
* two more groups over the same ranks: the **batch group**, which carries
  the collectives inside the forward and the loss (BatchNorm's moments,
  AD-YOLO's counts) so that they never interleave with the gradient
  buckets that ``DistributedDataParallel`` all-reduces asynchronously on
  the default group during the backward; and the **control group**, gloo
  on the host, for the trainer's decisions (:func:`broadcast_object`,
  :func:`any_rank`, :func:`on_main`), so that ranks waiting for rank 0's
  evaluation block on a socket, not in a kernel on their card;
* :func:`all_reduce_sum`, a sum all-reduce that autograd differentiates
  (its backward all-reduces the gradient), and :func:`all_reduce_counts`
  for tensors without a gradient.

With no group (a plain ``python -m`` run) every function here is the
single-process identity and no collective runs.  The JAX ``make_mesh``'s
trimming of surplus devices is not ported: with one process per card, a
global batch that the world size does not divide is refused instead
(:func:`check_batch`).
"""
from __future__ import annotations

import datetime
import os
from typing import Any, Callable, Optional, Tuple

import torch
import torch.distributed as dist

__all__ = ["PG_TIMEOUT", "init_distributed", "shutdown", "rank", "world_size",
           "is_main", "batch_group", "all_reduce_sum",
           "all_reduce_counts", "broadcast_object", "any_rank", "on_main",
           "check_batch"]

# How long a collective may wait: the other ranks wait for rank 0's
# threshold scan, val and test in one broadcast, so it covers a full eval.
PG_TIMEOUT = datetime.timedelta(hours=2)

_groups: Optional[Tuple[Any, Any]] = None  # (batch group, control group)
_owned = False  # init_distributed created the default group


def _active() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if _active() else 0


def world_size() -> int:
    return dist.get_world_size() if _active() else 1


def is_main() -> bool:
    return rank() == 0


def _rank_device(device) -> torch.device:
    """``cuda`` without an index becomes ``cuda:LOCAL_RANK``; a LOCAL_RANK
    past the visible cards is refused (two ranks never share a card
    silently)."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    local = int(os.environ.get("LOCAL_RANK", "0"))
    n = torch.cuda.device_count()
    if local >= n:
        raise RuntimeError(
            f"LOCAL_RANK {local} has no card of its own: {n} CUDA device(s) "
            "visible; start at most one process per card (torchrun "
            "--nproc_per_node <= the card count)")
    return torch.device("cuda", local)


def init_distributed(device="cuda"):
    """Join the data-parallel group; returns this rank's device.

    A group that the caller initialised is used as it is, on ``device``.
    Otherwise torchrun's ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``MASTER_ADDR`` and ``MASTER_PORT`` start one (NCCL on ``cuda``, gloo
    on the CPU) with :data:`PG_TIMEOUT`, on ``cuda:LOCAL_RANK``; without
    them the run is single-process and ``device`` is returned unchanged.
    :func:`shutdown` ends a group that this function started."""
    global _owned
    if not dist.is_available() or (not _active() and "WORLD_SIZE" not in os.environ):
        return device
    if _active():
        _ensure_groups()
        return device
    dev = _rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method="env://", timeout=PG_TIMEOUT)
    _owned = True
    _ensure_groups()
    return dev


def shutdown() -> None:
    """Destroy the group if :func:`init_distributed` started it."""
    global _owned, _groups
    if _owned and _active():
        dist.destroy_process_group()
        _owned, _groups = False, None


def _ensure_groups():
    """Create the batch and control groups, once; every rank creates them
    in the same order (``new_group`` is itself a collective)."""
    global _groups
    if _groups is None:
        _groups = (dist.new_group(timeout=PG_TIMEOUT),
                   dist.new_group(backend="gloo", timeout=PG_TIMEOUT))
    return _groups


def batch_group():
    """The group of the collectives inside the forward and the loss."""
    return _ensure_groups()[0]


def _control_group():
    """The host-side gloo group of the trainer's decisions."""
    return _ensure_groups()[1]


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks.  Every rank's loss term depends on the sum, so
    the gradient of a rank's input is the sum over ranks of the sum's
    gradient: the backward is the same all-reduce."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        g = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x`` summed over the ranks of ``group`` (the batch group), with a
    gradient; ``x`` itself with no group."""
    if not _active():
        return x
    return _AllReduceSum.apply(x, batch_group() if group is None else group)


@torch.no_grad()
def all_reduce_counts(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ranks of the batch group, without autograd
    (counts and reported losses)."""
    if not _active():
        return x
    y = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, group=batch_group())
    return y


def broadcast_object(obj):
    """Rank 0's picklable ``obj`` on every rank (the JAX package's
    ``_broadcast_str``, for any object)."""
    if not _active():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0, group=_control_group())
    return box[0]


def any_rank(flag: bool) -> bool:
    """True on every rank when ``flag`` is true on any."""
    if not _active():
        return bool(flag)
    t = torch.tensor([int(bool(flag))], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=_control_group())
    return bool(t.item())


def on_main(fn: Callable[[], Any]) -> Any:
    """``fn()`` on rank 0, its result on every rank.  The other ranks wait
    for it; if it raises, every rank raises (rank 0 the error itself, the
    others a ``RuntimeError`` naming it), so no rank is left waiting in a
    collective that rank 0 will never reach."""
    if not _active():
        return fn()
    out, err = None, None
    if is_main():
        try:
            out = fn()
        except BaseException as e:
            err = e
    out, failed = broadcast_object((out, None if err is None else repr(err)))
    if err is not None:
        raise err
    if failed is not None:
        raise RuntimeError(f"rank 0 failed: {failed}")
    return out


def check_batch(batch_size: int, n: Optional[int] = None) -> None:
    """Refuse a global batch that the ``n`` ranks (the world size) do not
    divide (``adyolo_tpu/data/dataset.py:259``)."""
    n = world_size() if n is None else n
    if batch_size % n:
        raise ValueError(f"batch_size {batch_size} does not divide across "
                         f"{n} ranks: each rank takes batch_size / world_size clips")
