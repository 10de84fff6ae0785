"""Model and criterion factories (counterpart of
:mod:`adyolo_tpu.models.wrapper`).

Both encoders are ported, SE-ResNet34 and ResNet-Conformer, each with the
head its loss names (SED-DOA for ``seddoa`` and ``masked-seddoa``, ACCDOA,
ADPIT, AD-YOLO; ``adyolo_tpu/models/wrapper.py:59-70``), for serving and
for training in float32 or bfloat16 (bf16 serving: ``build_model(...,
serve_dtype="bfloat16")``).
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch
import torch.nn as nn

from ..config import Config
from ..ops.grid import GridGeometry
from . import losses
from .heads import ACCDOAHead, ADPITHead, ADYOLOHead, SEDDOAHead
from .layers import BatchNorm
from .resnet_conformer import ResNetConformer
from .seresnet34 import SEResNet34

__all__ = ["SELDModel", "build_model", "init_params", "make_grid_geometry",
           "make_criterion"]

# flax lecun_normal: truncated normal at +-2 std, rescaled to variance 1/fan_in
_TRUNC_STD = 0.87962566103423978

ENCODERS = {"se-resnet34": SEResNet34, "resnet-conformer": ResNetConformer}
DTYPES = {"float32": None, "bfloat16": torch.bfloat16}  # None: the input's


class SELDModel(nn.Module):
    """Encoder + the head of ``loss``.  ``forward(feat, feat_lengths=None,
    generator=None)``: feat (B, T, F, C) -> the head's float32 output
    (B, T // 4, D): D = 4K (SED-DOA), 3K (ACCDOA), 9K (ADPIT) or
    G0*G1*A*(K+3) raw AD-YOLO logits; ``generator`` drives dropout in
    training.

    ``compute_dtype`` (None or ``torch.bfloat16``) is the encoder's compute
    dtype in training mode, ``serve_dtype`` its compute dtype in eval mode
    (None: the input's, float32 for val, test and infer; bfloat16 for bf16
    serving, JAX's ``build_model(cfg, compute_dtype=serve_dtype)``).  The
    weights stay float32, and the encoders' tails (SE-ResNet34's attention
    pooling, BiGRU and LayerNorm; the conformer's time pooling and
    ``pool_norm``) and the head run in float32, so the logits are float32
    either way.  ``remat``
    checkpoints the conformer's blocks; SE-ResNet34 has none to checkpoint
    and ignores it, as in JAX (``wrapper.py:48-55``)."""

    def __init__(self, encoder: str = "se-resnet34", loss: str = "adyolo",
                 nb_classes: int = 13,
                 grid_size: Tuple[float, float] = (45.0, 45.0),
                 nb_anchors: int = 5, in_channels: int = 7,
                 enc_out_dim: int = 256,
                 compute_dtype: Optional[torch.dtype] = None,
                 remat: bool = False,
                 serve_dtype: Optional[torch.dtype] = None):
        super().__init__()
        if encoder not in ENCODERS:
            raise NotImplementedError(f"encoder: {encoder!r}")
        kw = {"remat": remat} if encoder == "resnet-conformer" else {}
        self.encoder = ENCODERS[encoder](in_channels, enc_out_dim, **kw)
        if loss in ("seddoa", "masked-seddoa"):
            self.head = SEDDOAHead(nb_classes, enc_out_dim, enc_out_dim)
        elif loss == "accdoa":
            self.head = ACCDOAHead(nb_classes, enc_out_dim, enc_out_dim)
        elif loss == "adpit":
            self.head = ADPITHead(nb_classes, enc_out_dim, enc_out_dim)
        elif loss == "adyolo":
            self.head = ADYOLOHead(nb_classes, grid_size, nb_anchors, enc_out_dim,
                                   enc_out_dim)
        else:
            raise NotImplementedError(f"loss: {loss!r}")
        self.compute_dtype = compute_dtype
        self.serve_dtype = serve_dtype

    def forward(self, feat: torch.Tensor,
                feat_lengths: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        dtype = self.compute_dtype if self.training else self.serve_dtype
        return self.head(self.encoder(feat, feat_lengths, generator, dtype))


@torch.no_grad()
def init_params(model: SELDModel, generator: torch.Generator) -> SELDModel:
    """Seeded random init with the JAX package's initialisers: lecun-normal
    conv / Dense kernels (the depthwise conv's fan-in is its 3 taps),
    xavier-uniform head and conformer FFN, U(-1/sqrt(H), 1/sqrt(H)) GRU,
    zero biases, identity norms."""
    g = generator
    for name, mod in model.named_modules():
        if isinstance(mod, (nn.Conv1d, nn.Conv2d, nn.Linear)):
            if name.startswith("head.") or ".ffn" in name:
                nn.init.xavier_uniform_(mod.weight, generator=g)
            else:
                fan_in = mod.weight[0].numel()
                std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
                nn.init.trunc_normal_(mod.weight, 0.0, std, -2 * std, 2 * std,
                                      generator=g)
            if mod.bias is not None:
                nn.init.zeros_(mod.bias)
        elif isinstance(mod, nn.GRU):
            k = 1.0 / math.sqrt(mod.hidden_size)
            for p in mod.parameters():
                nn.init.uniform_(p, -k, k, generator=g)
        elif isinstance(mod, (BatchNorm, nn.LayerNorm)):
            nn.init.ones_(mod.weight)
            nn.init.zeros_(mod.bias)
    return model


def make_grid_geometry(cfg: Config) -> GridGeometry:
    return GridGeometry(grid_size=tuple(cfg.train.grid_size),
                        g_overlap=cfg.train.g_overlap,
                        nb_anchors=cfg.train.nb_anchors)


def make_criterion(cfg: Config,
                   reduce_counts: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
                   ) -> Callable:
    """``loss_fn(output, target, target_mask=None, frame_mask=None) ->
    scalar`` for the config's loss (``adyolo_tpu/models/wrapper.py:90-121``).

    For AD-YOLO ``target`` is the padded (M, 7) tensor and ``target_mask``
    its validity; the dense formats ignore the mask.  ``frame_mask``
    ((B, T) bool) restricts every mean to the valid frames: the loss of
    the output and targets cut to them.  ``reduce_counts`` (data
    parallelism) makes AD-YOLO's denominators the global batch's
    (:func:`losses.adyolo_loss`); the dense formats' means need none."""
    nb = cfg.data.nb_classes
    name = cfg.args.loss
    if name in ("seddoa", "masked-seddoa"):
        masked = name == "masked-seddoa"
        return lambda o, t, m=None, fm=None: losses.seddoa_loss(
            o, t, nb, masked_mse=masked, frame_mask=fm)
    if name == "accdoa":
        return lambda o, t, m=None, fm=None: losses.accdoa_loss(o, t, frame_mask=fm)
    if name == "adpit":
        return lambda o, t, m=None, fm=None: losses.adpit_loss(o, t, nb, frame_mask=fm)
    if name == "adyolo":
        geom = make_grid_geometry(cfg)
        gains = cfg.train.loss_gains
        taus = tuple(cfg.train.train_unify)

        def loss_fn(o, t, m, fm=None):
            return losses.adyolo_loss(o, t, m, geom, nb, taus, gains, frame_mask=fm,
                                      reduce_counts=reduce_counts)

        return loss_fn
    raise NotImplementedError(f"loss: {name!r}")


def build_model(cfg: Config, device="cuda",
                generator: Optional[torch.Generator] = None,
                train: bool = False, serve_dtype: str = "float32") -> SELDModel:
    """The model for ``cfg`` on ``device``, in eval mode or, with
    ``train``, in training mode, with the config's training compute dtype
    (``cfg.train.compute_dtype``), ``cfg.train.remat`` and the eval compute
    dtype ``serve_dtype`` ('float32' or 'bfloat16').  With ``generator``
    the weights are a seeded random init (drawn on the CPU); otherwise they
    are to be loaded (:mod:`adyolo_tpu_torch.convert`)."""
    for what, name in (("compute_dtype", cfg.train.compute_dtype),
                       ("serve_dtype", serve_dtype)):
        if name not in DTYPES:
            raise ValueError(f"{what} {name!r}: one of {sorted(DTYPES)}")
    model = SELDModel(encoder=cfg.args.encoder, loss=cfg.args.loss,
                      nb_classes=cfg.data.nb_classes,
                      grid_size=tuple(cfg.train.grid_size),
                      nb_anchors=cfg.train.nb_anchors,
                      in_channels=cfg.data.nb_feature_channels,
                      compute_dtype=DTYPES[cfg.train.compute_dtype],
                      remat=cfg.train.remat, serve_dtype=DTYPES[serve_dtype])
    if generator is not None:
        init_params(model, generator)
    return model.to(device).train(train)
