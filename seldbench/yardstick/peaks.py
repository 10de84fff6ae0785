"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
without sparsity, at the full 700 W power limit), and the roofline bounds
built on them.

Copied from ``chip_smoke.py`` (``FP32_FLOPS`` .. ``HBM_BYTES_S``, ``bound``,
``attn_bound``) at commit 4ed7d29, so that a later change to
the program cannot move them.  ``BF16_TC_FLOPS`` is 989.4e12, the figure of
``adyolo_tpu_torch/utils/profiling.py::_PEAK_FLOPS`` that every MFU divides
by: a float32 step reads low against it by construction, and can never read
above 100 %.
"""
from __future__ import annotations

__all__ = ["FP32_FLOPS", "TF32_TC_FLOPS", "BF16_TC_FLOPS", "HBM_BYTES_S", "bound", "attn_bound"]

FP32_FLOPS = 67e12  # float32 FFMA outside the tensor cores
TF32_TC_FLOPS = 494.7e12  # dense TF32 tensor cores
BF16_TC_FLOPS = 989.4e12  # dense bfloat16 tensor cores: the MFU denominator
HBM_BYTES_S = 3.35e12


def bound(flop: float, nbytes: float) -> dict:
    """The least time (ms) the card could take for ``flop`` fp32 FLOP that
    move ``nbytes``, and which of the two bounds it."""
    t_op, t_mem = flop / FP32_FLOPS, nbytes / HBM_BYTES_S
    return {"bound_ms": max(t_op, t_mem) * 1e3,
            "bound_by": "operations" if t_op >= t_mem else "bytes"}


def attn_bound(flop: float, nbytes: float) -> dict:
    """A float32 attention route's bound: the lesser of the fp32 FFMA bound
    and the 3xTF32 tensor-core bound (3 x ``flop`` at the TF32 peak)."""
    ffma = bound(flop, nbytes)
    t_op, t_mem = 3.0 * flop / TF32_TC_FLOPS, nbytes / HBM_BYTES_S
    tc = {"bound_ms": max(t_op, t_mem) * 1e3,
          "bound_by": "operations" if t_op >= t_mem else "bytes"}
    return tc if tc["bound_ms"] <= ffma["bound_ms"] else ffma
