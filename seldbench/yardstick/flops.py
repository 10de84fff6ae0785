"""FLOP and byte counts, from shapes alone.

* :func:`stft_flops`, :func:`rnn_flops`: copied from
  ``adyolo_tpu_torch/utils/profiling.py`` at commit 4ed7d29 (the FFT
  convention ``2.5 n log2 n`` a real frame a channel; an RNN's gate
  products).
* :func:`attn_flop`, :func:`attn_bytes`: ``chip_smoke.py``'s at the same
  commit, with one change: queries are counted over the valid frames as
  keys are, so padded query rows of a bucketed clip are not billed as work.
* :func:`model_flops`: the benchmark's reference model
  (:mod:`seldbench.reference`) run on the ``meta`` device under
  ``torch.utils.flop_counter.FlopCounterMode``: its convolutions and
  products, the attention's two einsums and the GRU's per-step products
  included, forward and (with ``backward``) backward.  Nothing runs on a
  device and nothing of the program is counted.
* :func:`frontend_flops`, :func:`frontend_bytes`: the least work of the
  front-end stage (int16 audio read once, the features written once; the
  FFTs, the power, the sparse mel projection and the intensity vectors).
"""
from __future__ import annotations

import math
from typing import Sequence

import torch

__all__ = ["stft_flops", "rnn_flops", "attn_flop", "attn_bytes", "model_flops",
           "frontend_flops", "frontend_bytes", "frontend_model_flops"]


def stft_flops(frames: int, n_fft: int) -> int:
    """FLOPs of the real FFTs of ``frames`` frames of ``n_fft`` samples (a
    frame a channel): ``2.5 * n_fft * log2(n_fft)`` each."""
    return round(2.5 * n_fft * math.log2(n_fft) * frames)


def rnn_flops(rows: int, input_size: int, hidden: int, gates: int,
              layers: int = 1, directions: int = 1) -> int:
    """FLOPs of an RNN's gate products over ``rows`` (time step, clip)
    pairs, forward: ``2 * G * (I + H)`` a row, a direction and a layer."""
    G = gates * hidden
    total = 0
    for layer in range(layers):
        ins = input_size if layer == 0 else directions * hidden
        total += directions * 2 * rows * G * (ins + hidden)
    return total


def attn_flop(heads: int, q_lens: Sequence[int], k_lens: Sequence[int],
              per: int = 4, dh: int = 64) -> float:
    """FLOP of attention over the valid queries and keys: ``per`` x q x k x
    dh for each (clip, head); 4 forward (q.k and p.v), 10 backward (s
    recomputed, dO.v, dq, dk, dv)."""
    return float(per) * heads * dh * float(sum(q * k for q, k in zip(q_lens, k_lens)))


def attn_bytes(heads: int, q_lens: Sequence[int], k_lens: Sequence[int], q_rows: int,
               kv_reads: int, kv_writes: int = 0, stats: int = 0, el: int = 4,
               dh: int = 64) -> float:
    """Bytes attention must move: ``q_rows`` query-side tensors (q, out, dO,
    dq), ``kv_reads`` key-side tensors read and ``kv_writes`` written (dk,
    dv) over the valid rows, each element ``el`` bytes; ``stats`` float32
    rows a query and head (the logsumexp)."""
    row = float(el) * heads * dh
    q, k = float(sum(q_lens)), float(sum(k_lens))
    return row * (q_rows * q + kv_reads * k + kv_writes * k) + 4.0 * heads * q * stats


def model_flops(build_model, feat_shape, backward: bool, **forward_kw) -> int:
    """The FLOPs of one call of the reference model ``build_model()`` (built
    here on the meta device) on a features tensor of ``feat_shape``: the
    forward, and with ``backward`` the backward of the output's sum as well
    (the input needs no gradient, as in a train step)."""
    from torch.utils.flop_counter import FlopCounterMode

    with torch.device("meta"):
        model = build_model()
        feat = torch.zeros(feat_shape)
    counter = FlopCounterMode(display=False)
    with counter:
        out = model(feat, **forward_kw)
        if backward:
            out.sum().backward()
    return counter.get_total_flops()


def frontend_model_flops(clips: int, frames: int, n_fft: int, mel_bins: int,
                         mel_ch: int = 4, aux_ch: int = 3) -> int:
    """The front-end's FLOPs as the reference computes them, for a model-FLOP
    count: the FFTs by :func:`stft_flops` and the dense mel projections of
    the power (``mel_ch`` channels) and the intensity vectors (``aux_ch``)."""
    K = 1 + n_fft // 2
    rows = clips * frames
    return stft_flops(rows * mel_ch, n_fft) + 2 * rows * K * mel_bins * (mel_ch + aux_ch)


def frontend_flops(clips: int, frames: int, n_fft: int, mel_nnz: int,
                   mel_ch: int = 4, aux_ch: int = 3) -> int:
    """The least FLOPs of the front-end stage: the real FFTs, the power (3 a
    bin and channel), the mel projection over the filterbank's ``mel_nnz``
    nonzero weights (2 a weight, each of the ``mel_ch + aux_ch`` channels),
    and the intensity vectors (12 a bin: 3 products and the energy)."""
    K = 1 + n_fft // 2
    rows = clips * frames
    return (stft_flops(rows * mel_ch, n_fft) + 3 * rows * K * mel_ch
            + 2 * rows * mel_nnz * (mel_ch + aux_ch) + 12 * rows * K)


def frontend_bytes(clips: int, samples: int, frames: int, mel_bins: int,
                   channels: int = 4, feat_ch: int = 7, in_bytes: int = 2) -> float:
    """The front-end stage's bytes: the audio read once (int16: 2 bytes) and
    the float32 features ``(clips, frames, mel_bins, feat_ch)`` written once."""
    return float(clips * samples * channels * in_bytes
                 + clips * frames * mel_bins * feat_ch * 4)

