"""The process-group layer of data and tensor parallelism (counterpart of
:mod:`adyolo_tpu.parallel.mesh`).

The port runs one process per card under ``torchrun`` (``torchrun
--nproc_per_node N -m adyolo_tpu_torch.cli train ...``); the JAX package's
device mesh becomes ``torch.distributed`` groups:

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

Tensor parallelism (``--model_parallel N``, :func:`set_model_parallel`):
the ranks form a ``(dp, tp)`` grid in the JAX mesh's layout, rank ``r =
dp_index * N + tp_index`` (``make_mesh``: consecutive devices form a model
group).  Each model group is a **TP group**, whose ranks hold the
conformer's shards and run Megatron's two collectives on it
(:func:`copy_to_tp`, :func:`reduce_from_tp`) and average the gradients
of the parameters they all hold (:func:`average_replicated_grads`); the
ranks of one
``tp_index`` form a **DP group**, over which ``DistributedDataParallel``
averages that shard's gradients, and a second group over the same ranks
is the batch group (BatchNorm's moments and AD-YOLO's counts are summed
over the data replicas, not over TP peers).  :func:`tp_plan` decides, for
a model and N, which of each conformer block's modules are sharded and
which are kept whole on every rank of the group (the counterpart of JAX's
``_tp_spec`` / ``state_shardings``, which shard a leaf only where N
divides it and replicate the others); its :class:`TPPlan` is what every
reader of the layout takes: :func:`shard_state_dict` and
:func:`gather_state_dict` carry weights and optimizer moments between a
full state dict (the checkpoint, in JAX's order) and a rank's shard, and
:func:`average_replicated_grads` finds the parameters held whole.  An
encoder without conformer blocks (SE-ResNet34) is held whole: the ranks
of a model group repeat one another's work on their replica's clips, as
JAX's model axis does.  At N = 1 nothing of this exists and the groups
are data parallelism's alone.

With no group (a plain ``python -m`` run) every function here is the
single-process identity and no collective runs.  The JAX ``make_mesh``'s
trimming of surplus devices is not ported: with one process per card, a
global batch that the data replicas do not divide is refused instead
(:func:`check_batch`).
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import re
from typing import Any, Callable, Dict, FrozenSet, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = ["PG_TIMEOUT", "init_distributed", "set_model_parallel", "shutdown", "rank",
           "world_size", "is_main", "tp_rank", "tp_size", "dp_rank", "dp_size",
           "tp_group", "dp_group", "batch_group", "all_reduce_sum", "all_reduce_counts",
           "copy_to_tp", "reduce_from_tp", "average_replicated_grads",
           "broadcast_object", "any_rank", "on_main", "check_batch",
           "check_model_parallel", "TPPlan", "tp_plan", "shard_tensor", "join_tensor",
           "shard_state_dict", "gather_state_dict", "shard_optimizer_state",
           "gather_optimizer_state"]

# How long a collective may wait: the other ranks wait for rank 0's
# threshold scan, val and test in one broadcast, so it covers a full eval.
PG_TIMEOUT = datetime.timedelta(hours=2)

_groups: Optional[Tuple[Any, Any]] = None  # (batch group, control group)
_owned = False  # init_distributed created the default group
# model_parallel N > 1: {"n": N, "tp": TP group, "dp": DDP's group, "batch":
# the batch group}, this rank's groups of the (dp, tp) grid; None at N = 1
_tp: Optional[Dict[str, Any]] = None
_tp_made: Dict[int, Dict[str, Any]] = {}  # the grids made so far, by N


def _active() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if _active() else 0


def world_size() -> int:
    return dist.get_world_size() if _active() else 1


def is_main() -> bool:
    return rank() == 0


def tp_size() -> int:
    """Ranks in a model group (``--model_parallel``)."""
    return 1 if _tp is None else _tp["n"]


def tp_rank() -> int:
    """This rank's index in its model group: which shard it holds."""
    return rank() % tp_size()


def dp_size() -> int:
    """Data replicas: the ranks that take disjoint shards of the batch."""
    return world_size() // tp_size()


def dp_rank() -> int:
    """This rank's data replica."""
    return rank() // tp_size()


def tp_group():
    """The group of this rank's model group (None at N = 1)."""
    return None if _tp is None else _tp["tp"]


def dp_group():
    """The group over which ``DistributedDataParallel`` averages this rank's
    gradients: the ranks holding the same shard; None (the default group)
    at N = 1."""
    return None if _tp is None else _tp["dp"]


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


def init_distributed(device="cuda", model_parallel: int = 1):
    """Join the process group; returns this rank's device.

    A group that the caller initialised is used as it is, on ``device``.
    Otherwise torchrun's ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``MASTER_ADDR`` and ``MASTER_PORT`` start one (NCCL on ``cuda``, gloo
    on the CPU) with :data:`PG_TIMEOUT`, on ``cuda:LOCAL_RANK``; without
    them the run is single-process and ``device`` is returned unchanged.
    ``model_parallel`` > 1 builds the (dp, tp) grid's groups
    (:func:`set_model_parallel`).  :func:`shutdown` ends a group that this
    function started."""
    global _owned
    if not dist.is_available() or (not _active() and "WORLD_SIZE" not in os.environ):
        set_model_parallel(model_parallel)
        return device
    if _active():
        _ensure_groups()
        set_model_parallel(model_parallel)
        return device
    dev = _rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method="env://", timeout=PG_TIMEOUT)
    _owned = True
    _ensure_groups()
    set_model_parallel(model_parallel)
    return dev


def check_model_parallel(n: int, world: Optional[int] = None) -> None:
    """Refuse a model-parallel size ``n`` below 1 or that the ranks
    (``world``, the world size when None) do not divide: each model group
    holds N consecutive ranks (JAX's ``make_mesh`` asserts the same).  Any
    other N is taken: :func:`tp_plan` keeps whole what N does not cut."""
    world = world_size() if world is None else world
    if n < 1:
        raise ValueError(f"model_parallel {n}: must be at least 1")
    if world % n:
        raise ValueError(f"model_parallel {n} does not divide the {world} ranks "
                         "(WORLD_SIZE): each model group is N consecutive ranks")


def set_model_parallel(n: int = 1) -> None:
    """Make the groups of the (dp, tp) grid for ``n`` ranks a model group;
    a collective of every rank.  Every rank creates every group, in one
    order (``new_group`` is itself a collective: a rank that skipped a
    group it is not in would leave the others waiting): the TP groups, then
    DDP's DP groups, then the batch groups; a grid made before is taken
    again.  N = 1 leaves data parallelism's groups alone."""
    global _tp
    check_model_parallel(n)
    if n == 1 or n in _tp_made:
        _tp = _tp_made.get(n)
        return
    world, me = world_size(), rank()
    grid = [list(range(i * n, (i + 1) * n)) for i in range(world // n)]
    mine = {}
    for key, members in (("tp", grid), ("dp", [list(c) for c in zip(*grid)]),
                         ("batch", [list(c) for c in zip(*grid)])):
        for ranks in members:
            g = dist.new_group(ranks, timeout=PG_TIMEOUT)
            if me in ranks:
                mine[key] = g
    _tp = _tp_made[n] = {"n": n, **mine}


def shutdown() -> None:
    """Destroy the group if :func:`init_distributed` started it."""
    global _owned, _groups, _tp
    if _owned and _active():
        dist.destroy_process_group()
        _owned, _groups, _tp = False, None, None
        _tp_made.clear()


def _ensure_groups():
    """Create the batch and control groups, once; every rank creates them
    in the same order (``new_group`` is itself a collective)."""
    global _groups
    if _groups is None:
        _groups = (dist.new_group(timeout=PG_TIMEOUT),
                   dist.new_group(backend="gloo", timeout=PG_TIMEOUT))
    return _groups


def batch_group():
    """The group of the collectives inside the forward and the loss: the
    data replicas (every rank at N = 1)."""
    return _ensure_groups()[0] if _tp is None else _tp["batch"]


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
    """Refuse a global batch that the ``n`` data replicas (:func:`dp_size`)
    do not divide (``adyolo_tpu/data/dataset.py:259``)."""
    n = dp_size() if n is None else n
    if batch_size % n:
        raise ValueError(f"batch_size {batch_size} does not divide across "
                         f"{n} ranks: each data replica takes batch_size / "
                         "(world_size / model_parallel) clips")


# ---- tensor parallelism: the collectives ------------------------------------

def _acc(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


class _CopyToTP(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the TP group
    (every rank's shard of the next product contributes to it), in at
    least float32."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        g = grad.to(_acc(grad.dtype)).contiguous()
        if g is grad:
            g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g.to(grad.dtype), None


class _ReduceFromTP(torch.autograd.Function):
    """Sum over the TP group of the ranks' partial products, in at least
    float32 (returned so: the caller adds the bias and rounds once);
    identity backward, since every rank's loss sees the same sum."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.dtype = x.dtype
        y = x.to(_acc(x.dtype)).contiguous()
        if y is x:
            y = y.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        return grad.to(ctx.dtype), None


def copy_to_tp(x: torch.Tensor, group) -> torch.Tensor:
    """The input of a column-parallel product (Megatron's ``f``): ``x``
    itself, whose gradient is summed over ``group``; ``x`` with no group."""
    return x if group is None else _CopyToTP.apply(x, group)


def reduce_from_tp(x: torch.Tensor, group) -> torch.Tensor:
    """The output of a row-parallel product (Megatron's ``g``): the sum of
    the ranks' partials over ``group``, in at least float32."""
    return x if group is None else _ReduceFromTP.apply(x, group)


@torch.no_grad()
def average_replicated_grads(module: torch.nn.Module, plan: TPPlan, group=None) -> None:
    """Replace the gradient of every parameter that ``plan`` holds whole by
    its mean over the TP group (one all-reduce of them all).  The ranks
    compute those gradients from the same inputs, but on the card not to the
    same bits (cuDNN's convolution backward and the loss's gather backward
    sum with atomics), and the replicated weights must stay equal on every
    rank.  Where the ranks' gradients are equal the mean is that gradient.
    DDP has averaged them over the DP group before: the two groups cross,
    so each gradient is averaged once over every rank."""
    group = tp_group() if group is None else group
    grads = [p.grad for n, p in module.named_parameters()
             if p.grad is not None and plan.rule(n) is None]
    if group is None or not grads:
        return
    flat = torch.cat([g.reshape(-1).to(_acc(g.dtype)) for g in grads])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


# ---- tensor parallelism: the rules ------------------------------------------

# (module, leaf) -> how a rank's shard is cut from the full tensor (torch
# layouts: a Linear's weight is (out, in)):
#   "col": dim 0 in N contiguous pieces (a column-parallel product's
#          weight and bias, a per-channel vector);
#   "row": dim 1 (a row-parallel product's weight; its bias is replicated
#          and added once, after the sum);
#   "glu": dim 0 of a (2d, ...) tensor whose halves a | b the GLU pairs
#          elementwise: rank r holds a's piece r then b's piece r, so
#          a * sigmoid(b) stays on the rank.  (JAX cuts the 2d axis in N
#          contiguous pieces and GSPMD regathers the halves.)
# JAX's rules (adyolo_tpu/parallel/mesh.py:92-110) through convert.py's
# names: Dense_0 / Dense_1 -> fc1 / fc2, dw_kernel / dw_bias -> dw_conv,
# scale -> weight, mean / var -> running_mean / running_var.
_TP_RULES = {
    ("query", "weight"): "col", ("key", "weight"): "col", ("value", "weight"): "col",
    ("query", "bias"): "col", ("key", "bias"): "col", ("value", "bias"): "col",
    ("linear", "weight"): "row",
    ("fc1", "weight"): "col", ("fc1", "bias"): "col", ("fc2", "weight"): "row",
    ("pw1", "weight"): "glu", ("pw1", "bias"): "glu",
    **{("bn1", leaf): "glu" for leaf in ("weight", "bias", "running_mean", "running_var")},
    ("dw_conv", "weight"): "col", ("dw_conv", "bias"): "col",
    **{("bn2", leaf): "col" for leaf in ("weight", "bias", "running_mean", "running_var")},
    ("pw2", "weight"): "row",
}
# the rules fire only inside a conformer block's FFNs, MHSA and conv module
# (the ResNet blocks' bn1 / bn2 and the heads stay replicated), and only in
# the modules that the plan shards
_TP_SCOPE = re.compile(r"(?:^|\.)conformer\d+\.(ffn1|ffn2|mhsa|conv)\.(\w+)\.(\w+)$")
_BLOCK = re.compile(r"(?:^|\.)conformer\d+$")


@dataclasses.dataclass(frozen=True)
class TPPlan:
    """How a model is laid out over a TP group of ``n`` ranks: the conformer
    modules (``"ffn1"``, ``"ffn2"``, ``"mhsa"``, ``"conv"``, the same in
    every block) that are ``sharded``; everything else is held whole on
    every rank.  Made by :func:`tp_plan`."""

    n: int = 1
    sharded: FrozenSet[str] = frozenset()

    def rule(self, name: str) -> Optional[str]:
        """How the state-dict entry ``name`` is cut ("col", "row", "glu"), or
        None when it is held whole."""
        m = _TP_SCOPE.search(name)
        if m is None or m.group(1) not in self.sharded:
            return None
        return _TP_RULES.get(m.group(2, 3))


def tp_plan(model: torch.nn.Module, n: int) -> TPPlan:
    """The layout of ``model`` (a full, unsharded model or encoder) over a
    TP group of ``n`` ranks: the one decision of which conformer modules are
    sharded.  Each module is sharded where N cuts it cleanly and kept whole
    on every rank otherwise:

    * an FFN where N divides its hidden width (JAX's ``Dense_0`` /
      ``Dense_1`` test);
    * the conv module where N divides ``emb_dim``, so that each rank holds
      matching pieces of the GLU's two halves;
    * the MHSA where N divides the heads: each rank runs whole heads
      through the attention kernels, with the full model's dropout bits.

    JAX shards q/k/v and the output ``linear`` wherever N divides
    ``emb_dim``, through a head when N does not divide the heads (N = 8 at
    ``emb_dim`` 256), and GSPMD regathers them; the port keeps that MHSA
    whole instead.  The arithmetic is the same; only the layout differs.
    An encoder without conformer blocks (SE-ResNet34) is held whole."""
    blocks = [m for name, m in model.named_modules() if _BLOCK.search(name)]
    if n == 1 or not blocks:
        return TPPlan(n)
    block = blocks[0]
    hidden = block.ffn1.fc1.weight.shape[0]
    dim = block.conv.pw2.weight.shape[0]
    fits = {"ffn1": hidden % n == 0, "ffn2": block.ffn2.fc1.weight.shape[0] % n == 0,
            "mhsa": block.mhsa.heads % n == 0, "conv": dim % n == 0}
    return TPPlan(n, frozenset(k for k, ok in fits.items() if ok))


def shard_tensor(t: torch.Tensor, kind: str, tp_rank: int, n: int) -> torch.Tensor:
    """Rank ``tp_rank``'s piece of the full tensor ``t`` (a view)."""
    if kind == "row":
        return t.chunk(n, 1)[tp_rank]
    if kind == "col":
        return t.chunk(n, 0)[tp_rank]
    a, b = t.chunk(2, 0)
    return torch.cat([a.chunk(n, 0)[tp_rank], b.chunk(n, 0)[tp_rank]])


def join_tensor(pieces: Sequence[torch.Tensor], kind: str) -> torch.Tensor:
    """The full tensor from the ranks' pieces, in rank order."""
    if kind == "row":
        return torch.cat(list(pieces), 1)
    if kind == "col":
        return torch.cat(list(pieces), 0)
    halves = [p.chunk(2, 0) for p in pieces]
    return torch.cat([h[0] for h in halves] + [h[1] for h in halves])


def shard_state_dict(full: Dict[str, torch.Tensor], plan: TPPlan, tp_rank: int
                     ) -> Dict[str, torch.Tensor]:
    """Rank ``tp_rank``'s state dict from the full one: the entries that
    ``plan`` shards cut by :data:`_TP_RULES`, the others as they are."""
    return {k: (shard_tensor(v, kind, tp_rank, plan.n).contiguous()
                if (kind := plan.rule(k)) else v) for k, v in full.items()}


def _gather(t: torch.Tensor, kind: str, group) -> torch.Tensor:
    t = t.detach().contiguous()
    pieces = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(pieces, t, group=group)
    return join_tensor(pieces, kind)


def gather_state_dict(state: Dict[str, torch.Tensor], plan: TPPlan,
                      group=None) -> Dict[str, torch.Tensor]:
    """The full state dict (weights, BatchNorm stats, or any tensors keyed
    by parameter names, e.g. gradients) from every rank's ``state`` over
    the TP group (this rank's when None), on every rank: a collective when
    ``plan`` shards anything.  An entry held whole is this rank's as it is.
    The GLU's pairing is undone, so the result is in the unsharded model's
    (and JAX's) order."""
    group = tp_group() if group is None else group
    return {k: (_gather(v, kind, group) if (kind := plan.rule(k)) else v)
            for k, v in state.items()}


def _map_moments(osd: Dict, names: List[str], plan: TPPlan, fn) -> Dict:
    """``osd`` (an optimizer's state dict over parameters named ``names``,
    in order) with every per-element state tensor of a parameter that
    ``plan`` shards replaced by ``fn(tensor, kind)``; scalars such as
    Adam's step stay."""
    state = {}
    for idx, st in osd["state"].items():
        kind = plan.rule(names[idx])
        state[idx] = {k: (fn(v, kind) if kind and torch.is_tensor(v) and v.ndim else v)
                      for k, v in st.items()}
    return {**osd, "state": state}


def shard_optimizer_state(osd: Dict, names: List[str], plan: TPPlan, tp_rank: int) -> Dict:
    """Rank ``tp_rank``'s optimizer state dict from the full one: Adam's
    moments follow their parameters' layout in ``plan``."""
    return _map_moments(osd, names, plan,
                        lambda v, kind: shard_tensor(v, kind, tp_rank, plan.n).contiguous())


def gather_optimizer_state(osd: Dict, names: List[str], plan: TPPlan, group=None) -> Dict:
    """The full optimizer state dict from every rank's over the TP group: a
    collective, as :func:`gather_state_dict`."""
    group = tp_group() if group is None else group
    return _map_moments(osd, names, plan, lambda v, kind: _gather(v, kind, group))
