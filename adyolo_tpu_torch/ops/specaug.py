"""On-device SpecAugment (counterpart of :mod:`adyolo_tpu.ops.specaug`):
random time and frequency masks on a feature batch, one mask pair per
(clip, feature block), mask value 0.

The reference's axis quirk is kept (``src/utils/augmentations.py:6-33``):
it feeds (C, T, F) tensors to torchaudio's masking, so its "time" mask is
up to ``time_mask_param`` wide on one axis and its "frequency" mask up to
``freq_mask_param`` on the other; each is applied with probability
``thresh``.  The JAX package draws six uniforms per (clip, block) from its
PRNG key; here they come from a ``torch.Generator``, and the mask is a plain
function of those draws (:func:`block_masks`), so the same draws give the
JAX package's masks.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

__all__ = ["block_masks", "apply_block_masks", "draw_uniforms", "spec_augment"]


def _axis_keep(on, u_width, u_start, size, param, thresh):
    """(..., size) bool, False on the masked span when ``on <= thresh``."""
    width = u_width * param
    start = u_start * (size - width)
    idx = torch.arange(size, dtype=torch.float32, device=on.device)
    cut = (idx >= start[..., None]) & (idx < (start + width)[..., None])
    return ~(cut & (on <= thresh)[..., None])


def block_masks(u: torch.Tensor, T: int, F: int, time_param: int,
                freq_param: int, thresh: float) -> torch.Tensor:
    """``(..., T, F)`` float32 multiplicative masks from ``u`` (..., 6), the
    uniform draws in ``[0, 1)`` in the JAX package's order
    (``specaug.py:29-45``): time mask on, its width, its start; frequency
    mask on, its width, its start.  A width is ``u * param`` and a start
    ``u * (size - width)``; the span ``[start, start + width)`` is zeroed."""
    t_keep = _axis_keep(u[..., 0], u[..., 1], u[..., 2], T, time_param, thresh)
    f_keep = _axis_keep(u[..., 3], u[..., 4], u[..., 5], F, freq_param, thresh)
    return (t_keep[..., :, None] & f_keep[..., None, :]).to(torch.float32)


def apply_block_masks(feat: torch.Tensor, masks: torch.Tensor,
                      block_sizes: Sequence[int]) -> torch.Tensor:
    """``feat`` (B, T, F, C) times ``masks`` (B, blocks, T, F), each mask
    on the channels of its block."""
    sizes = torch.tensor(block_sizes, device=feat.device)
    per_channel = torch.repeat_interleave(  # (B, C, T, F); no host sync
        masks, sizes, dim=1, output_size=sum(block_sizes))
    return feat * per_channel.permute(0, 2, 3, 1)


def draw_uniforms(B: int, n_blocks: int, generator: Optional[torch.Generator],
                  device) -> torch.Tensor:
    """The ``(B, n_blocks, 6)`` uniforms of :func:`block_masks`."""
    return torch.rand((B, n_blocks, 6), generator=generator, device=device)


def spec_augment(feat: torch.Tensor, generator: Optional[torch.Generator] = None,
                 block_sizes: Sequence[int] = (4, 3), time_mask_param: int = 40,
                 freq_mask_param: int = 40, thresh: float = 0.5) -> torch.Tensor:
    """``feat`` (B, T, F, C) with each channel block of ``block_sizes``
    (FOA: 4 log-mel + 3 IV) masked independently; the draws come from
    ``generator`` (the device's default one when None), on ``feat``'s
    device."""
    B, T, F, C = feat.shape
    if sum(block_sizes) != C:
        raise ValueError(f"block sizes {tuple(block_sizes)} do not cover {C} channels")
    u = draw_uniforms(B, len(block_sizes), generator, feat.device)
    masks = block_masks(u, T, F, time_mask_param, freq_mask_param, thresh)
    return apply_block_masks(feat, masks, block_sizes)
