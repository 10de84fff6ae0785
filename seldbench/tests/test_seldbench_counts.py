"""The yardstick's FLOP and byte counts against hand counts at small shapes."""
from __future__ import annotations


import numpy as np
import pytest
import torch

from seldbench.reference.frontend import mel_bank
from seldbench.reference.models import GRUDir
from seldbench.yardstick import flops, peaks


def test_stft_flops_is_the_fft_convention():
    assert flops.stft_flops(10, 1024) == round(2.5 * 1024 * 10 * 10)


def test_attention_counts_by_hand():
    # two clips, 3 heads, valid lengths 5 and 7, dh 64
    assert flops.attn_flop(3, [5, 7], [5, 7], 4) == 4 * 3 * 64 * (25 + 49)
    assert flops.attn_bytes(3, [5, 7], [5, 7], q_rows=2, kv_reads=2, stats=1) == \
        4 * 3 * 64 * (2 * 12 + 2 * 12) + 4 * 3 * 12


def test_model_flops_counts_the_attention_einsums():
    B, T, H, dh = 2, 6, 4, 64

    class Att(torch.nn.Module):
        def forward(self, x):
            q = x.reshape(B, T, H, dh)
            p = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, q), -1)
            return torch.einsum("bhqk,bkhd->bqhd", p, q)

    assert flops.model_flops(Att, (B, T, H * dh), backward=False) == \
        flops.attn_flop(H, [T] * B, [T] * B, 4, dh)


def test_model_flops_counts_the_gru_gate_products():
    B, T, I, H = 2, 5, 8, 4
    n = flops.model_flops(lambda: GRUDir(I, H), (B, T, I), backward=False)
    assert n == flops.rnn_flops(B * T, I, H, 3)


def test_frontend_bytes_and_flops_by_hand():
    assert flops.frontend_bytes(2, 1200, 2, 64) == 2 * 1200 * 4 * 2 + 2 * 2 * 64 * 7 * 4
    nnz = int(np.count_nonzero(mel_bank(24000, 1200, 64)))
    K = 601
    assert flops.frontend_flops(1, 1, 1200, nnz) == (
        flops.stft_flops(4, 1200) + 3 * K * 4 + 2 * nnz * 7 + 12 * K)
    assert nnz < 2 * K  # a bin lies in at most two filters


def test_bounds_take_the_larger_side():
    b = peaks.bound(67e12, 0.0)
    assert b["bound_ms"] == pytest.approx(1e3) and b["bound_by"] == "operations"
    b = peaks.bound(0.0, 3.35e12)
    assert b["bound_ms"] == pytest.approx(1e3) and b["bound_by"] == "bytes"
    assert peaks.attn_bound(67e12, 0.0)["bound_ms"] == pytest.approx(3e3 * 67 / 494.7)
