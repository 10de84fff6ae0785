"""ResNet34 + Conformer SELD encoder (counterpart of
:mod:`adyolo_tpu.models.resnet_conformer`), eval and training.

* stem: 7x7 conv, stride (1, 2), no bias -> ReLU -> BN (the reverse of the
  blocks' order, as in the reference) -> 3x3 max-pool, stride (1, 2), with
  padded frames at ``finfo.min`` so they behave like the pool's own padding
* 4 stages of torchvision BasicBlocks [3, 4, 5, 3] x [64, 128, 256, 512],
  frequency-only stride 2 at each stage entry: F 64 -> 1, T unchanged
* bottleneck Linear 512 -> 256, no bias
* 8 Conformer blocks: half-step FFN, 4-head MHSA, GLU + depthwise conv
  module with dilation ``2**i``, half-step FFN, LayerNorm
* mean over 4 frames, then LayerNorm (``pool_norm``)

Every MHSA goes through :func:`adyolo_tpu_torch.ops.hopper_attention.
flash_attention`: the hand-written Hopper kernels on CUDA (eval routes
``k2`` for T <= 2400 frames and ``k4`` above, ``k2_bf16`` on bfloat16
q/k/v in bf16 serving; in training the forward with dropout
``k2_dropout`` and the backward ``k3``, or ``k2_dropout_bf16`` and
``k3_bf16`` on bfloat16 q/k/v), the plain PyTorch attention on the CPU.
The eval forward is the custom op ``adyolo::mhsa_eval``, so a traced
serving program (:mod:`adyolo_tpu_torch.engine.export`) runs it too.
The JAX package's packed convolutions, ``force_flash`` and its
``ADYOLO_*`` switches are TPU-only and not ported.

Training: BatchNorm uses the batch statistics and updates its running
stats; dropout at rate 0.2 sits where the JAX package has it (the FFN's two
sites, the attention probabilities, after the MHSA, after the conv
module's pw2), its bits drawn from the ``generator`` passed to
``forward`` (each MHSA draws one int32 attention seed per call).
Training chunks must be T <= 2400 frames, as in the JAX package, whose
longer chunks would take the XLA attention; the attention raises on longer
ones.  An eval forward takes its route by length, not by the grad mode.

``dtype`` (the compute dtype, bfloat16 in bf16 training and serving)
casts the stem's input, so the stem, the ResNet stages, the bottleneck and
every conformer block run in it (LayerNorms normalise in float32 and return it; the
attention scores and softmax are float32 inside the attention); the
encoder output is cast back to float32 before the time pooling and
``pool_norm`` (``resnet_conformer.py:375-432``).

``remat=True`` checkpoints each conformer block
(``torch.utils.checkpoint``, non-reentrant): the backward recomputes the
block from its input instead of keeping its activations.  The recompute
draws the same dropout bits (a copy of the generator from the block's
start state; the step's generator advances once, as without remat) and
leaves the BatchNorm running stats alone, so a remat step equals the
plain step bit for bit.

Tensor parallelism (:func:`shard_conformer_`, ``--model_parallel N``):
each conformer block's FFNs, MHSA and conv module that N cuts cleanly
(:func:`adyolo_tpu_torch.parallel.mesh.tp_plan`) are cut Megatron's way
over a TP group by :mod:`adyolo_tpu_torch.parallel.mesh`'s rules: every
product that widens (q/k/v, fc1, pw1) keeps its output columns, every
product that narrows back to ``d`` (the MHSA output, fc2, pw2) its input
rows, and one sum over the group closes each module.  A rank of a
sharded MHSA holds ``4 / N`` heads and runs the attention kernels on them
with the full model's keep bits; every dropout draws the full model's
bits, so a sharded step is the unsharded step up to the order of the
sums.  A module that N does not cut is kept whole on every rank.

Input ``(B, T, F, C)`` channel-last, as in the JAX package; the conv stack
runs NCHW.  DCASE shapes: (B, 800, 64, 7) -> (B, 200, 256).
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.hopper_attention import flash_attention
from ..parallel import mesh
from .layers import (BatchNorm, Conv1d, Conv2d, Conv3x3, LayerNorm, Linear,
                     U8Dropout, apply_frame_mask, frozen_running_stats,
                     pool_mask, stats_dtype)

__all__ = ["TVBasicBlock", "FeedForwardModule", "MHSA",
           "ConformerConvModule", "ConformerBlock", "ResNetConformer",
           "shard_conformer_"]

_LAYERS = (3, 4, 5, 3)
_FILTERS = (64, 128, 256, 512)
_DROPOUT = 0.2
HEADS = 4  # each MHSA's


def _swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def _row_parallel(linear: Linear, x: torch.Tensor, group) -> torch.Tensor:
    """``linear(x)``; under tensor parallelism (``group``), ``x`` and the
    weight hold this rank's rows of the product: the partial product is
    taken in at least float32 on x's dtype's values, summed over the group
    in it, the (replicated) bias added once, and the sum rounded to x's
    dtype once."""
    if group is None:
        return linear(x)
    acc = stats_dtype(x.dtype)
    y = mesh.reduce_from_tp(F.linear(x.to(acc), linear.weight.to(x.dtype).to(acc)), group)
    if linear.bias is not None:
        y = y + linear.bias.to(x.dtype).to(acc)
    return y.to(x.dtype)


class TVBasicBlock(nn.Module):
    """torchvision BasicBlock: conv3x3 (stride (1, f_stride)) -> BN -> ReLU
    -> conv3x3 -> BN (+ 1x1 conv + BN when the stride or width changes)
    -> ReLU; padded frames re-zeroed after each BN.  NCHW."""

    def __init__(self, in_ch: int, planes: int, f_stride: int = 1):
        super().__init__()
        self.conv1 = Conv2d(in_ch, planes, 3, stride=(1, f_stride),
                            padding=1, bias=False)
        self.bn1 = BatchNorm(planes)
        self.conv2 = Conv3x3(planes, planes)
        self.bn2 = BatchNorm(planes)
        if f_stride != 1 or in_ch != planes:
            self.down_conv = Conv2d(in_ch, planes, 1, stride=(1, f_stride),
                                    bias=False)
            self.down_bn = BatchNorm(planes)
        else:
            self.down_conv = None

    def forward(self, x: torch.Tensor, frame_mask=None) -> torch.Tensor:
        out = apply_frame_mask(F.relu(self.bn1(self.conv1(x))), frame_mask, 2)
        out = apply_frame_mask(self.bn2(self.conv2(out)), frame_mask, 2)
        residual = x
        if self.down_conv is not None:
            residual = apply_frame_mask(self.down_bn(self.down_conv(x)),
                                        frame_mask, 2)
        return apply_frame_mask(F.relu(out + residual), frame_mask, 2)


class FeedForwardModule(nn.Module):
    """LN -> Linear(d -> 4d) -> swish -> dropout -> Linear(4d -> d) ->
    dropout.  The linears are named ``fc1``/``fc2`` on purpose: the flax
    tree's auto-named ``Dense_0``/``Dense_1`` map onto them
    (:mod:`adyolo_tpu_torch.convert`).  ``tp``: the TP group of a sharded
    module (:func:`shard_conformer_`)."""

    tp = None

    def __init__(self, dim: int, expansion: int = 4):
        super().__init__()
        self.ln = LayerNorm(dim, eps=1e-5)
        self.fc1 = Linear(dim, dim * expansion)
        self.drop1 = U8Dropout(_DROPOUT)
        self.fc2 = Linear(dim * expansion, dim)
        self.drop2 = U8Dropout(_DROPOUT)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.drop1(_swish(self.fc1(mesh.copy_to_tp(self.ln(x), self.tp))), generator)
        return self.drop2(_row_parallel(self.fc2, x, self.tp), generator)


class MHSA(nn.Module):
    """Multi-head self-attention, heads split as ``reshape(B, T, H, dh)``;
    keys past ``kv_len[b]`` are masked (``kv_len`` None: all valid).  In
    training, dropout at rate ``self.dropout`` on the probabilities, its
    int32 seed drawn from ``generator``.  An eval forward longer than 2400
    frames takes route k4 in any grad mode (and has no backward).  Sharded
    (``tp``), it holds ``heads`` of the model's heads, from ``head_range =
    (head_offset, heads_total)``."""

    tp = None
    head_range = None  # (head_offset, heads_total) of a shard; None: all heads

    def __init__(self, dim: int, heads: int = HEADS):
        super().__init__()
        self.heads = heads
        self.dropout = _DROPOUT
        self.query = Linear(dim, dim)
        self.key = Linear(dim, dim)
        self.value = Linear(dim, dim)
        self.linear = Linear(dim, dim)

    def forward(self, x: torch.Tensor, kv_len: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        B, T, _ = x.shape
        rate, seed = 0.0, None
        if self.training:
            rate = self.dropout
            seed = torch.randint(-2 ** 31, 2 ** 31, (1,), dtype=torch.int32,
                                 device=x.device, generator=generator)
        x = mesh.copy_to_tp(x, self.tp)
        q = self.query(x)
        shape = (B, T, self.heads, q.shape[-1] // self.heads)
        ctx = flash_attention(q.reshape(shape), self.key(x).reshape(shape),
                              self.value(x).reshape(shape), kv_len,
                              rate=rate, seed=seed, heads=self.head_range)
        return _row_parallel(self.linear, ctx.reshape(B, T, -1), self.tp)


class ConformerConvModule(nn.Module):
    """LN -> pw1 (d -> 2d) -> BN -> GLU -> mask -> depthwise dilated conv
    (k=3) + bias -> BN -> swish -> pw2 -> dropout -> mask, on ``(B, T, d)``.
    Sharded (``tp``), it holds its channels' share of pw1's GLU halves, the
    depthwise conv and both BatchNorms, and pw2's matching rows."""

    tp = None

    def __init__(self, dim: int, dilation: int = 1):
        super().__init__()
        self.ln = LayerNorm(dim, eps=1e-5)
        self.pw1 = Linear(dim, 2 * dim)
        self.bn1 = BatchNorm(2 * dim, channel_last=True)
        self.dw_conv = Conv1d(dim, dim, 3, groups=dim, dilation=dilation,
                              padding=dilation)
        self.bn2 = BatchNorm(dim, channel_last=True)
        self.pw2 = Linear(dim, dim)
        self.drop = U8Dropout(_DROPOUT)

    def forward(self, x: torch.Tensor, frame_mask=None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        a, b = self.bn1(self.pw1(mesh.copy_to_tp(self.ln(x), self.tp))).chunk(2, dim=-1)
        x = apply_frame_mask(a * torch.sigmoid(b), frame_mask)  # GLU
        x = self.dw_conv(x.transpose(1, 2)).transpose(1, 2)
        x = self.drop(_row_parallel(self.pw2, _swish(self.bn2(x)), self.tp), generator)
        return apply_frame_mask(x, frame_mask)


class ConformerBlock(nn.Module):
    """FFN (x0.5) -> MHSA + dropout (x0.5) -> conv module -> FFN (x0.5) ->
    LN."""

    def __init__(self, dim: int, dilation: int):
        super().__init__()
        self.ffn1 = FeedForwardModule(dim)
        self.mhsa_ln = LayerNorm(dim, eps=1e-5)
        self.mhsa = MHSA(dim)
        self.mhsa_drop = U8Dropout(_DROPOUT)
        self.conv = ConformerConvModule(dim, dilation)
        self.ffn2 = FeedForwardModule(dim)
        self.final_ln = LayerNorm(dim, eps=1e-5)

    def forward(self, x: torch.Tensor, frame_mask=None,
                kv_len: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = x + 0.5 * self.ffn1(x, generator)
        h = self.mhsa(self.mhsa_ln(x), kv_len, generator)
        x = x + 0.5 * self.mhsa_drop(h, generator)
        x = x + self.conv(x, frame_mask, generator)
        x = x + 0.5 * self.ffn2(x, generator)
        return self.final_ln(x)


def _remat_block(block: ConformerBlock, x: torch.Tensor, frame_mask,
                 kv_len, generator: Optional[torch.Generator]) -> torch.Tensor:
    """``block(x, frame_mask, kv_len, generator)`` under a non-reentrant
    checkpoint.  The forward and the backward's recompute each draw their
    dropout bits from a fresh copy of ``generator`` at the block's start
    state, and ``generator`` then takes the state the forward left, so it
    advances once.  With no generator (the device's default one), the
    checkpoint saves and restores the default generators itself.  The
    recompute leaves the BatchNorm running stats alone."""
    start = None if generator is None else generator.get_state()
    end = []  # the generator state the forward leaves, from the first call

    def run(x):
        recompute = bool(end)
        g = None
        if start is not None:
            g = torch.Generator(device=generator.device)
            g.set_state(start)
        with frozen_running_stats(block) if recompute else contextlib.nullcontext():
            y = block(x, frame_mask, kv_len, g)
        if not recompute:
            end.append(None if g is None else g.get_state())
        return y

    y = checkpoint(run, x, use_reentrant=False, preserve_rng_state=generator is None)
    if generator is not None:
        generator.set_state(end[0])
    return y


class ResNetConformer(nn.Module):
    def __init__(self, in_channels: int = 7, emb_dim: int = 256,
                 num_layers: int = 8, time_pool: int = 4, remat: bool = False):
        super().__init__()
        self.time_pool = time_pool
        self.num_layers = num_layers
        self.remat = remat
        self.conv1 = Conv2d(in_channels, _FILTERS[0], 7, stride=(1, 2),
                            padding=3, bias=False)
        self.bn1 = BatchNorm(_FILTERS[0])
        self.blocks = []
        in_ch = _FILTERS[0]
        for stage, (n_blocks, planes) in enumerate(zip(_LAYERS, _FILTERS)):
            for b in range(n_blocks):
                name = f"layer{stage + 1}_block{b}"
                self.add_module(name, TVBasicBlock(in_ch, planes,
                                                   f_stride=2 if b == 0 else 1))
                self.blocks.append(name)
                in_ch = planes
        self.bottleneck = Linear(in_ch, emb_dim, bias=False)
        for i in range(num_layers):
            self.add_module(f"conformer{i}", ConformerBlock(emb_dim, 2 ** i))
        self.pool_norm = nn.LayerNorm(emb_dim, eps=1e-5)

    def forward(self, x: torch.Tensor,
                feat_lengths: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """x: (B, T, F, C), ``T % time_pool == 0``; feat_lengths: optional
        (B,) valid frame counts; generator: the dropout bits' source in
        training; dtype: the compute dtype (None: x's).  Returns
        (B, T // time_pool, emb_dim) in at least float32."""
        frame_mask = kv_len = None
        if feat_lengths is not None:
            t = torch.arange(x.shape[1], device=x.device)
            frame_mask = t[None, :] < feat_lengths.to(x.device)[:, None]
            kv_len = frame_mask.sum(1, dtype=torch.int32)  # stays on device
            x = apply_frame_mask(x, frame_mask)

        if dtype is not None:
            x = x.to(dtype)
        x = x.permute(0, 3, 1, 2).contiguous()  # (B, C, T, F)
        x = self.bn1(F.relu(self.conv1(x)))
        if frame_mask is not None:
            x = torch.where(frame_mask[:, None, :, None], x,
                            torch.finfo(x.dtype).min)
        x = F.max_pool2d(x, 3, stride=(1, 2), padding=1)
        x = apply_frame_mask(x, frame_mask, 2)
        for name in self.blocks:
            x = getattr(self, name)(x, frame_mask)
        B, C, T, Fq = x.shape
        x = self.bottleneck(x.permute(0, 2, 3, 1).reshape(B, T, Fq * C))

        remat = self.remat and self.training and torch.is_grad_enabled()
        for i in range(self.num_layers):
            block = getattr(self, f"conformer{i}")
            if remat:
                x = _remat_block(block, x, frame_mask, kv_len, generator)
            else:
                x = block(x, frame_mask, kv_len, generator)

        x = x.to(stats_dtype(x.dtype))  # the encoder output: >= float32
        x = x.reshape(B, T // self.time_pool, self.time_pool, -1).mean(dim=2)
        x = self.pool_norm(x)
        return apply_frame_mask(x, pool_mask(frame_mask, self.time_pool))


@torch.no_grad()
def shard_conformer_(encoder: nn.Module, group, tp_rank: int, plan: mesh.TPPlan
                     ) -> nn.Module:
    """Shard the conformer blocks of an initialised full ``encoder`` in
    place for rank ``tp_rank`` of a TP group laid out by ``plan``
    (:func:`adyolo_tpu_torch.parallel.mesh.tp_plan` of the full model):
    narrow the parameters and BatchNorm stats of the modules it shards,
    give a sharded MHSA its ``heads / n`` heads and their offset, a sharded
    conv module's depthwise conv its channels, a sharded FFN's first
    dropout its columns' share of the full bits, and route their products
    through the group's collectives.  A module kept whole (and everything
    outside the blocks) keeps no group: it runs the whole model's
    computation on the replica's batch and generator, and its gradients
    are averaged over the group after the backward.  An encoder without
    conformer blocks (SE-ResNet34) is left as it is.  Build the optimizer
    after this, so its state holds the shards."""
    if not plan.sharded:
        return encoder
    n = plan.n
    for name, mod in encoder.named_modules():
        for store in (mod._parameters, mod._buffers):
            for leaf, t in store.items():
                kind = plan.rule(f"{name}.{leaf}")
                if kind is None or t is None:
                    continue
                piece = mesh.shard_tensor(t.detach(), kind, tp_rank, n).clone()
                store[leaf] = nn.Parameter(piece) if store is mod._parameters else piece
    for i in range(encoder.num_layers):
        block = getattr(encoder, f"conformer{i}")
        if "mhsa" in plan.sharded:
            mhsa = block.mhsa
            heads = mhsa.heads // n
            mhsa.head_range, mhsa.heads = (tp_rank * heads, mhsa.heads), heads
        if "conv" in plan.sharded:
            dw = block.conv.dw_conv
            dw.groups = dw.in_channels = dw.out_channels = dw.weight.shape[0]
        for key in ("ffn1", "ffn2"):
            if key in plan.sharded:
                getattr(block, key).drop1.shard = (tp_rank, n)
        for key in plan.sharded:
            getattr(block, key).tp = group
    return encoder
