"""The eval paths of the Hopper kernels as custom operators
(``torch.library.custom_op``), one op each in a traced graph.

* ``adyolo::stft(x, table, hop) -> (re, im)``: K1, the windowed DFT of
  hop-block ``(B, T, hop, 4)`` audio (``n_fft == 2 * hop``) or of the
  librosa ``center=True`` frames of flat ``(B, N, 4)`` float32 audio at
  any ``hop``, with the twiddle-and-window ``table`` of an
  :class:`~adyolo_tpu_torch.ops.hopper_stft.FFTPlan` (``3 * n_fft``
  floats); re and im ``(B, T, n_fft // 2 + 1, 4)`` float32, ``T = N //
  hop`` for flat audio.
* ``adyolo::mhsa_eval(q, k, v, kv_len) -> out``: the eval attention of
  ``(B, T, H, 64)`` float32 or bfloat16 q/k/v with the first ``kv_len[b]``
  keys valid (``kv_len`` None: all), on routes ``k2``, ``k4`` and
  ``k2_bf16`` (:func:`~adyolo_tpu_torch.ops.hopper_attention.eval_forward`);
  out has q's shape and dtype.
* ``adyolo::mhsa_train(q, k, v, kv_len, seed, rate, head_offset,
  heads_total) -> (out, out32, lse)`` and ``adyolo::mhsa_train_bwd(q, k,
  v, kv_len, seed, out32, lse, dout, rate, head_offset, heads_total) ->
  (dq, dk, dv)``: the training attention's forward and backward with
  dropout ``rate`` on heads ``[head_offset, head_offset + H)`` of a
  model's ``heads_total``, on routes ``k2_dropout`` / ``k3`` (float32)
  and ``k2_dropout_bf16`` / ``k3_bf16`` (bfloat16).  ``out32`` is the
  forward's float32 output and ``lse`` its row logsumexp ``(B, H, T)``,
  which the backward reads; on the CPU, whose plain backward recomputes
  them, and for float32 ``out32`` (``out`` is float32), they have 0
  elements.  Called from the autograd function of
  :func:`~adyolo_tpu_torch.ops.hopper_attention.flash_attention`.

Each op dispatches by its tensors' device: on CUDA it launches the
hand-written kernel, through the ctypes launch of
:mod:`~adyolo_tpu_torch.ops.hopper_stft` or
:mod:`~adyolo_tpu_torch.ops.hopper_attention`, whose ``LAUNCHES`` count
it; on the CPU it runs the plain version
(:func:`adyolo_tpu_torch.ops.stft.stft`,
:func:`adyolo_tpu_torch.ops.attention.mhsa_attention` and
:func:`~adyolo_tpu_torch.ops.attention.mhsa_attention_bwd`); other devices
have no kernel.  One op a kernel is also one entry of the FLOP count
(:func:`adyolo_tpu_torch.utils.profiling.model_flops`), whichever of the
two runs.  The eval ops have a fake kernel, which gives the output
shapes and dtypes for tracing, so a traced program (``torch.export``) holds one call of each op
whose body is opaque: the serving artifact of
:mod:`adyolo_tpu_torch.engine.export` runs the Hopper kernels on the card
and the plain versions on the CPU.  A process that loads such an artifact
must import this module first (``import adyolo_tpu_torch.ops`` does).

The ops have no autograd formula: the wrappers call the eval ops on eval
paths only, where autograd does not record, and the train pair inside a
``torch.autograd.Function``.  Their arguments are tensors: the
kernels' host-side plans (the FFT's radix passes, the attention's key
splits) are looked up inside the CUDA kernels.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import attention, hopper_attention, hopper_stft
from . import stft as plain_stft

__all__ = ["stft", "mhsa_eval", "mhsa_train", "mhsa_train_bwd"]


@torch.library.custom_op("adyolo::stft", mutates_args=(), device_types="cpu")
def stft(x: torch.Tensor, table: torch.Tensor, hop: int
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    n_fft = table.shape[0] // 3
    return plain_stft.stft(x, *plain_stft.window_dft(table[2 * n_fft:]), hop)


@stft.register_kernel("cuda")
def _stft_cuda(x, table, hop):
    return hopper_stft.launch(x, table, hop)


@stft.register_fake
def _stft_fake(x, table, hop):
    T = x.shape[1] if x.ndim == 4 else x.shape[1] // hop
    shape = (x.shape[0], T, table.shape[0] // 3 // 2 + 1, x.shape[-1])
    return x.new_empty(shape), x.new_empty(shape)


@torch.library.custom_op("adyolo::mhsa_eval", mutates_args=(), device_types="cpu")
def mhsa_eval(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              kv_len: Optional[torch.Tensor]) -> torch.Tensor:
    # contiguous, as the kernels write it (the einsum's layout is (B, H, T, dh))
    return attention.mhsa_attention(q, k, v, kv_len).contiguous()


@mhsa_eval.register_kernel("cuda")
def _mhsa_eval_cuda(q, k, v, kv_len):
    return hopper_attention.eval_forward(q, k, v, kv_len)


@mhsa_eval.register_fake
def _mhsa_eval_fake(q, k, v, kv_len):
    return torch.empty_like(q)


def _no_residual(q):
    return q.new_empty((0,), dtype=torch.float32)


@torch.library.custom_op("adyolo::mhsa_train", mutates_args=(), device_types="cpu")
def mhsa_train(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               kv_len: Optional[torch.Tensor], seed: Optional[torch.Tensor], rate: float,
               head_offset: int, heads_total: int
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    out = attention.mhsa_attention(q, k, v, kv_len, rate=rate, seed=seed,
                                   heads=(head_offset, heads_total))
    return out.contiguous(), _no_residual(q), _no_residual(q)


@mhsa_train.register_kernel("cuda")
def _mhsa_train_cuda(q, k, v, kv_len, seed, rate, head_offset, heads_total):
    return hopper_attention.train_forward(q, k, v, kv_len, seed, rate,
                                          (head_offset, heads_total))


@torch.library.custom_op("adyolo::mhsa_train_bwd", mutates_args=(), device_types="cpu")
def mhsa_train_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   kv_len: Optional[torch.Tensor], seed: Optional[torch.Tensor],
                   out32: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor, rate: float,
                   head_offset: int, heads_total: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return attention.mhsa_attention_bwd(q, k, v, kv_len, dout, rate=rate, seed=seed,
                                        heads=(head_offset, heads_total))


@mhsa_train_bwd.register_kernel("cuda")
def _mhsa_train_bwd_cuda(q, k, v, kv_len, seed, out32, lse, dout, rate, head_offset,
                         heads_total):
    return hopper_attention.train_backward(q, k, v, kv_len, seed, out32, lse, dout, rate,
                                           (head_offset, heads_total))
