"""The reference encoders and the AD-YOLO head, in plain PyTorch
(sadPororo/AD-YOLO ``src/models/backbones/resnet.py``,
``resnet_conformer.py``, ``src/models/linearheads.py``).

Parameter names follow the model's published module names, so one state
dict loads into the program and into this reference.  Input ``(B, T, F,
C)`` features; the conv stacks run NCHW; every clip is taken at its own
length (no padding, no frame mask).  In training mode BatchNorm
normalises by the batch's biased moments (``F.batch_norm``), and dropout
keeps an element when its uint8 bits (``torch.randint`` from the step's
generator, in the model's order) are at least ``round(rate * 256)``,
scaled by ``256 / (256 - t)``; the attention's dropout keeps a
probability by the splitmix32 position hash of :func:`attention_keep`, from
one int32 seed an attention call.  The GRU is written out step by step.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["SEResNet34", "ResNetConformer", "SELDModel", "attention_keep", "u8_dropout"]

_M32 = 0xFFFFFFFF


def u8_dropout(x, rate, training, generator):
    t = int(round(rate * 256.0))
    if not training or t <= 0:
        return x
    bits = torch.randint(0, 256, x.shape, dtype=torch.uint8, device=x.device,
                         generator=generator)
    scale = float(torch.tensor(256.0 / (256.0 - t), dtype=x.dtype))
    return torch.where(bits >= t, x * scale, 0.0)


def _mul32(x, c):
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def attention_keep(B, H, T, seed, thresh):
    """The keep mask ``(B, H, T, T)`` of the attention's dropout: the
    splitmix32 hash of (seed, clip, head, query block, query row, key)
    with query blocks of the first of (512, 400, 256, 200, 160, 128, 80,
    64, 40, 32, 16, 8) frames that divides T, rows padded to 128, against
    ``thresh << 24``."""
    dev = seed.device
    bq = next((min(c, T) for c in (512, 400, 256, 200, 160, 128, 80, 64, 40, 32, 16, 8)
               if T % c == 0), T)
    Tp = -(-T // 128) * 128
    q = torch.arange(T, device=dev, dtype=torch.int64)
    b = torch.arange(B, device=dev, dtype=torch.int64).reshape(B, 1, 1, 1)
    h = torch.arange(H, device=dev, dtype=torch.int64).reshape(1, H, 1, 1)
    lane = (b * H + h) * (T // bq) + (q // bq)[:, None]
    base = _mul32(seed.reshape(()).to(torch.int64) & _M32, 0x9E3779B9) + _mul32(lane & _M32,
                                                                              0x85EBCA6B)
    x = ((q % bq)[:, None] * Tp + q[None, :] + base) & _M32
    x = _mul32(x ^ (x >> 16), 0x7FEB352D)
    x = _mul32(x ^ (x >> 15), 0x846CA68B)
    return (x ^ (x >> 16)) >= (thresh << 24)


class BN(nn.Module):
    """BatchNorm over dim 1 (or the last dim with ``last``)."""

    def __init__(self, c, last=False):
        super().__init__()
        self.last = last
        self.weight, self.bias = nn.Parameter(torch.ones(c)), nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x):
        y = x.transpose(1, -1) if self.last else x
        stats = (None, None) if self.training else (self.running_mean, self.running_var)
        y = F.batch_norm(y, *stats, self.weight, self.bias, self.training, 0.0, 1e-5)
        return y.transpose(1, -1) if self.last else y


class SEBlock(nn.Module):
    def __init__(self, cin, planes):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, planes, 3, padding=1, bias=False)
        self.bn1 = BN(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = BN(planes)
        self.se = nn.Module()
        self.se.fc1 = nn.Linear(planes, planes // 8)
        self.se.fc2 = nn.Linear(planes // 8, planes)
        self.down = cin != planes
        if self.down:
            self.down_conv = nn.Conv2d(cin, planes, 1, bias=False)
            self.down_bn = BN(planes)

    def forward(self, x):
        out = self.bn1(F.relu(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        w = torch.sigmoid(self.se.fc2(F.relu(self.se.fc1(out.mean(dim=(2, 3))))))
        out = out * w[:, :, None, None]
        res = self.down_bn(self.down_conv(x)) if self.down else x
        return F.relu(out + res)


class GRUDir(nn.Module):
    """One direction of one GRU layer, ``nn.GRU``'s parameters and gate
    order (r, z, n), unrolled over time."""

    def __init__(self, cin, hidden):
        super().__init__()
        self.weight_ih_l0 = nn.Parameter(torch.empty(3 * hidden, cin))
        self.weight_hh_l0 = nn.Parameter(torch.empty(3 * hidden, hidden))
        self.bias_ih_l0 = nn.Parameter(torch.empty(3 * hidden))
        self.bias_hh_l0 = nn.Parameter(torch.empty(3 * hidden))

    def forward(self, x):  # (B, T, I) -> (B, T, H)
        gi = F.linear(x, self.weight_ih_l0, self.bias_ih_l0)
        H = self.weight_hh_l0.shape[1]
        h = x.new_zeros(x.shape[0], H)
        outs = []
        for t in range(x.shape[1]):
            gh = F.linear(h, self.weight_hh_l0, self.bias_hh_l0)
            r = torch.sigmoid(gi[:, t, :H] + gh[:, :H])
            z = torch.sigmoid(gi[:, t, H:2 * H] + gh[:, H:2 * H])
            n = torch.tanh(gi[:, t, 2 * H:] + r * gh[:, 2 * H:])
            h = (1.0 - z) * n + z * h
            outs.append(h)
        return torch.stack(outs, dim=1)


class SEResNet34(nn.Module):
    """SE-ResNet34 [3, 4, 6, 3] x [32, 64, 128, 256] (2x2 average pools
    before stages 2 and 3), attention pooling over frequency, a 2-layer
    BiGRU (dropout between the layers) and LayerNorm + tanh."""

    def __init__(self, m: dict, cin: int):
        super().__init__()
        self.m = m
        f = m["filters"]
        self.conv1 = nn.Conv2d(cin, f[0], 3, padding=1, bias=True)
        self.bn1 = BN(f[0])
        self.order = []
        c = f[0]
        for s, (n, planes) in enumerate(zip(m["blocks"], f)):
            for b in range(n):
                name = f"layer{s + 1}_block{b}"
                self.add_module(name, SEBlock(c, planes))
                self.order.append((name, b == 0 and s in m["pool_before_stages"]))
                c = planes
        self.attention = nn.Module()
        self.attention.W = nn.Linear(c, 1)
        self.gru = nn.Module()
        hid = m["gru_hidden"]
        for i in range(m["gru_layers"]):
            d = c if i == 0 else 2 * hid
            setattr(self.gru, f"l{i}_fwd", GRUDir(d, hid))
            setattr(self.gru, f"l{i}_bwd", GRUDir(d, hid))
        self.norm = nn.LayerNorm(2 * hid, eps=1e-5)

    def forward(self, x, generator=None):
        x = x.permute(0, 3, 1, 2)
        x = self.bn1(F.relu(self.conv1(x)))
        for name, pool in self.order:
            if pool:
                x = F.avg_pool2d(x, 2)
            x = getattr(self, name)(x)
        x = x.permute(0, 2, 3, 1)  # (B, T, F, C)
        a = torch.softmax(self.attention.W(x)[..., 0], dim=-1)
        x = (x * a[..., None]).sum(dim=2)
        for i in range(self.m["gru_layers"]):
            fwd = getattr(self.gru, f"l{i}_fwd")(x)
            bwd = getattr(self.gru, f"l{i}_bwd")(torch.flip(x, (1,))).flip(1)
            x = torch.cat([fwd, bwd], dim=-1)
            if i < self.m["gru_layers"] - 1:
                x = u8_dropout(x, self.m["gru_dropout"], self.training, generator)
        return torch.tanh(self.norm(x))


class TVBlock(nn.Module):
    def __init__(self, cin, planes, fs):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, planes, 3, stride=(1, fs), padding=1, bias=False)
        self.bn1 = BN(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = BN(planes)
        self.down = fs != 1 or cin != planes
        if self.down:
            self.down_conv = nn.Conv2d(cin, planes, 1, stride=(1, fs), bias=False)
            self.down_bn = BN(planes)

    def forward(self, x):
        out = self.bn2(self.conv2(F.relu(self.bn1(self.conv1(x)))))
        return F.relu(out + (self.down_bn(self.down_conv(x)) if self.down else x))


def _swish(x):
    return x * torch.sigmoid(x)


class ConformerBlock(nn.Module):
    """Half-step FFN, MHSA, GLU + depthwise dilated conv module, half-step
    FFN, LayerNorm."""

    def __init__(self, d, heads, dilation, rate, expansion):
        super().__init__()
        self.heads, self.rate = heads, rate
        for name in ("ffn1", "ffn2"):
            ffn = nn.Module()
            ffn.ln = nn.LayerNorm(d, eps=1e-5)
            ffn.fc1 = nn.Linear(d, expansion * d)
            ffn.fc2 = nn.Linear(expansion * d, d)
            setattr(self, name, ffn)
        self.mhsa_ln = nn.LayerNorm(d, eps=1e-5)
        self.mhsa = nn.Module()
        for name in ("query", "key", "value", "linear"):
            setattr(self.mhsa, name, nn.Linear(d, d))
        self.conv = nn.Module()
        self.conv.ln = nn.LayerNorm(d, eps=1e-5)
        self.conv.pw1 = nn.Linear(d, 2 * d)
        self.conv.bn1 = BN(2 * d, last=True)
        self.conv.dw_conv = nn.Conv1d(d, d, 3, groups=d, dilation=dilation, padding=dilation)
        self.conv.bn2 = BN(d, last=True)
        self.conv.pw2 = nn.Linear(d, d)
        self.final_ln = nn.LayerNorm(d, eps=1e-5)

    def _ffn(self, ffn, x, g):
        x = u8_dropout(_swish(ffn.fc1(ffn.ln(x))), self.rate, self.training, g)
        return u8_dropout(ffn.fc2(x), self.rate, self.training, g)

    def _mhsa(self, x, g, q_block):
        B, T, d = x.shape
        H = self.heads
        seed = None
        if self.training:
            seed = torch.randint(-2 ** 31, 2 ** 31, (1,), dtype=torch.int32, device=x.device,
                                 generator=g)
        m = self.mhsa
        q, k, v = (getattr(m, n)(x).reshape(B, T, H, d // H) for n in ("query", "key", "value"))
        scale = (d // H) ** -0.5
        if self.training and self.rate > 0:
            t = int(round(self.rate * 256.0))
            p = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k) * scale, dim=-1)
            p = torch.where(attention_keep(B, H, T, seed, t), p * (256.0 / (256.0 - t)), 0.0)
            ctx = torch.einsum("bhqk,bkhd->bqhd", p, v)
        else:
            ctx = torch.cat([torch.einsum(
                "bhqk,bkhd->bqhd", torch.softmax(torch.einsum(
                    "bqhd,bkhd->bhqk", q[:, i:i + q_block], k) * scale, dim=-1), v)
                for i in range(0, T, q_block)], dim=1)
        return m.linear(ctx.reshape(B, T, d))

    def forward(self, x, g=None, q_block=1 << 30):
        x = x + 0.5 * self._ffn(self.ffn1, x, g)
        x = x + 0.5 * u8_dropout(self._mhsa(self.mhsa_ln(x), g, q_block), self.rate,
                                 self.training, g)
        c = self.conv
        a, b = c.bn1(c.pw1(c.ln(x))).chunk(2, dim=-1)
        h = c.dw_conv((a * torch.sigmoid(b)).transpose(1, 2)).transpose(1, 2)
        x = x + u8_dropout(c.pw2(_swish(c.bn2(h))), self.rate, self.training, g)
        x = x + 0.5 * self._ffn(self.ffn2, x, g)
        return self.final_ln(x)


class ResNetConformer(nn.Module):
    """7x7 stem (stride (1, 2)) -> ReLU -> BN -> 3x3 max pool (stride (1, 2))
    -> torchvision BasicBlocks [3, 4, 5, 3] x [64, 128, 256, 512] with a
    frequency stride of 2 at each stage's entry -> bottleneck Linear ->
    Conformer blocks (dilation 2^i) -> mean over ``time_pool`` frames ->
    LayerNorm."""

    def __init__(self, m: dict, cin: int):
        super().__init__()
        self.m = m
        f = m["filters"]
        self.conv1 = nn.Conv2d(cin, f[0], 7, stride=(1, 2), padding=3, bias=False)
        self.bn1 = BN(f[0])
        self.order = []
        c = f[0]
        for s, (n, planes) in enumerate(zip(m["blocks"], f)):
            for b in range(n):
                name = f"layer{s + 1}_block{b}"
                self.add_module(name, TVBlock(c, planes, 2 if b == 0 else 1))
                self.order.append(name)
                c = planes
        d = m["emb_dim"]
        self.bottleneck = nn.Linear(c * m["freq_out"], d, bias=False)
        for i in range(m["conformer_blocks"]):
            self.add_module(f"conformer{i}", ConformerBlock(d, m["heads"], 2 ** i, m["dropout"],
                                                            m["ffn_expansion"]))
        self.pool_norm = nn.LayerNorm(d, eps=1e-5)

    def forward(self, x, generator=None, q_block=1 << 30):
        x = self.bn1(F.relu(self.conv1(x.permute(0, 3, 1, 2))))
        x = F.max_pool2d(x, 3, stride=(1, 2), padding=1)
        for name in self.order:
            x = getattr(self, name)(x)
        B, C, T, Fq = x.shape
        x = self.bottleneck(x.permute(0, 2, 3, 1).reshape(B, T, Fq * C))
        for i in range(self.m["conformer_blocks"]):
            x = getattr(self, f"conformer{i}")(x, generator, q_block)
        tp = self.m["time_pool"]
        return self.pool_norm(x.reshape(B, T // tp, tp, -1).mean(dim=2))


class SELDModel(nn.Module):
    """Encoder + the AD-YOLO head: two Linears (``yolo_fc1``, ``yolo_fc2``)
    to ``G0 * G1 * A * (K + 3)`` raw logits a label frame."""

    def __init__(self, config: dict):
        super().__init__()
        m, tr, d = config["model"], config["train"], config["data"]
        enc = {"se-resnet34": SEResNet34, "resnet-conformer": ResNetConformer}[config["encoder"]]
        self.encoder = enc(m, m["in_channels"])
        g0, g1 = (math.ceil(360 / tr["grid_size"][0]), math.ceil(180 / tr["grid_size"][1]))
        out = g0 * g1 * tr["nb_anchors"] * (d["nb_classes"] + 3)
        self.head = nn.Module()
        self.head.yolo_fc1 = nn.Linear(m["enc_out_dim"], m["head_dim"])
        self.head.yolo_fc2 = nn.Linear(m["head_dim"], out)

    def forward(self, feat, generator=None, q_block: Optional[int] = None):
        kw = {} if q_block is None or not isinstance(self.encoder, ResNetConformer) else \
            {"q_block": q_block}
        x = self.encoder(feat, generator, **kw)
        return self.head.yolo_fc2(self.head.yolo_fc1(x))
