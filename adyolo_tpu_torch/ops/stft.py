"""Plain PyTorch STFT: the reference the Hopper kernel is held against.

Counterpart of :mod:`adyolo_tpu.ops.stft`.  The STFT is a contraction of
hop-strided frames against window-folded DFT matrices
(:func:`adyolo_tpu.ops.dsp.dft_matrices`), with librosa ``center=True``
reflect padding on the left and ``T = N // hop`` frames kept.  Output is
channel-last ``(B, T, K, C)``, ``K = 1 + n_fft // 2``, in float32.

On a CUDA device the serving path does not run this module: it goes
through :func:`adyolo_tpu_torch.ops.hopper_stft.stft_hop_blocks`, whose
kernel computes :func:`framed_dft_chunked` without building any frame.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from .dsp import dft_matrices

__all__ = ["window_dft", "framed_dft_chunked", "framed_dft_flat", "stft"]


@functools.lru_cache(maxsize=8)
def _window_dft(window_bytes: bytes):
    window = np.frombuffer(window_bytes, np.float32)
    return tuple(torch.as_tensor(w) for w in dft_matrices(window.shape[0], window))


def window_dft(window: torch.Tensor):
    """``(w_re, w_im)``, CPU tensors, of the window-folded DFT matrices of
    a float32 CPU ``window``; built once per window."""
    return _window_dft(window.numpy().astype(np.float32).tobytes())


def _slab(part: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    # (B, T, n, C) x (n, K) -> (B, T, K, C), float32 accumulation
    return torch.einsum("btnc,nk->btkc", part, w)


def framed_dft_chunked(chunks: torch.Tensor, w_re: torch.Tensor,
                       w_im: torch.Tensor):
    """Windowed DFT of hop-block audio ``(B, T, hop, C)`` -> ``(re, im)``.

    Needs ``n_fft == 2 * hop`` (the DCASE geometry, 1200/600).  Frame ``t``
    is then ``[p_t, p_{t+1}]`` over the padded blocks ``p_0 = reflect``,
    ``p_j = chunks[j - 1]``; the reflect block is computed from the index,
    ``refl[i] = x_flat[hop - i]``, instead of padding the signal
    (counterpart of ``adyolo_tpu/ops/stft.py::framed_dft_chunked``).
    """
    B, T, hop, C = chunks.shape
    n_fft = w_re.shape[0]
    if n_fft != 2 * hop:
        raise ValueError(
            f"framed_dft_chunked needs n_fft == 2*hop, got {n_fft}/{hop}")
    if T < 2:
        raise ValueError(f"need at least 2 hop-blocks, got T={T}")
    # x_flat[1 : hop + 1] = chunk-0 samples 1.. plus chunk-1 sample 0
    seg = torch.cat([chunks[:, 0, 1:], chunks[:, 1, :1]], dim=1)
    refl = torch.flip(seg, dims=(1,))[:, None]  # (B, 1, hop, C)
    outs = []
    for w in (w_re, w_im):
        s0, s1 = w[:hop], w[hop:]
        first = _slab(refl, s0)                 # frame 0
        body = _slab(chunks[:, : T - 1], s0)    # frames 1..T-1
        outs.append(torch.cat([first, body], dim=1) + _slab(chunks, s1))
    return outs[0], outs[1]


def framed_dft_flat(x: torch.Tensor, w_re: torch.Tensor, w_im: torch.Tensor,
                    hop: int):
    """STFT of flat audio ``(B, N, C)``: reflect-pad ``n_fft // 2`` on the
    left, zero-pad on the right where the last frame needs it, frame, and
    contract (counterpart of ``adyolo_tpu/ops/stft.py:147-158``)."""
    B, N, C = x.shape
    n_fft = w_re.shape[0]
    n_frames = N // hop
    lpad = n_fft // 2
    xt = F.pad(x.transpose(1, 2), (lpad, 0), mode="reflect")  # (B, C, L)
    rpad = (n_frames - 1) * hop + n_fft - xt.shape[-1]
    if rpad > 0:
        xt = F.pad(xt, (0, rpad))
    frames = xt.unfold(-1, n_fft, hop)[:, :, :n_frames]  # (B, C, T, n_fft)
    re = torch.einsum("bctn,nk->btkc", frames, w_re)
    im = torch.einsum("bctn,nk->btkc", frames, w_im)
    return re, im


def stft(x: torch.Tensor, w_re: torch.Tensor, w_im: torch.Tensor, hop: int):
    """``(re, im)``, each ``(B, T, K, C)`` float32, of hop-block audio
    ``(B, T, hop, C)`` or flat audio ``(B, N, C)`` (``T = N // hop``)."""
    if x.ndim == 4:
        if x.shape[2] != hop:
            raise ValueError(f"hop-block width {x.shape[2]} != hop {hop}")
        re, im = framed_dft_chunked(x, w_re, w_im)
    elif x.ndim == 3:
        re, im = framed_dft_flat(x, w_re, w_im, hop)
    else:
        raise ValueError(f"audio must be (B, T, hop, C) or (B, N, C), got "
                         f"{tuple(x.shape)}")
    return re.contiguous(), im.contiguous()
