#!/usr/bin/env python3
"""Check and time the bf16 attention pair on one card.

Run from the repository root on a machine with an NVIDIA GPU::

    python3 scripts/torch_attention_bf16_check.py

Builds the kernels, runs routes ``k2_dropout_bf16`` and ``k3_bf16``
through ``hopper_attention.flash_attention`` at (3, 200), (2, 48),
(2, 130) rate 0, (16, 800), (1, 1200) and (2, 2400) and prints, per
output, the kernel's and the plain bf16 version's max|error| against
float64 on the same inputs (one JSON line per shape); then the float32
k2 at (1, 1200) against plain, and the mean time of 20 back-to-back calls
of the bf16 and float32 train pairs at (16, 800, 4, 64) (CUDA events).
"""
import sys, os, time, json
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import torch, numpy as np
from adyolo_tpu_torch.utils import build
from adyolo_tpu_torch.ops import attention, hopper_attention as ha
t0 = time.time()
info = build.build(force=True)
print("build s", round(info["seconds"], 1))
for ln in info["ptxas"].splitlines():
    if "bf16" in ln or "merge" in ln or "Used" in ln or "spill" in ln:
        print(ln)
torch.backends.cuda.matmul.allow_tf32 = False
def run(B, T, lens, rate, seed=7):
    rng = np.random.default_rng(T + B)
    q, k, v, do = (torch.tensor(rng.standard_normal((B, T, 4, 64)), dtype=torch.float32, device="cuda").bfloat16() for _ in range(4))
    kv = torch.tensor(lens, dtype=torch.int32, device="cuda")
    sd = torch.tensor([seed], dtype=torch.int32, device="cuda")
    args = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = ha.flash_attention(*args, kv, rate=rate, seed=sd)
    out.backward(do)
    torch.cuda.synchronize()
    plain = attention.mhsa_attention(q, k, v, kv, rate=rate, seed=sd)
    pg = attention.mhsa_attention_bwd(q, k, v, kv, do, rate=rate, seed=sd)
    truth = attention.mhsa_attention(q.double(), k.double(), v.double(), kv, rate=rate, seed=sd)
    tg = attention.mhsa_attention_bwd(q.double(), k.double(), v.double(), kv, do.double(), rate=rate, seed=sd)
    res = {"shape": [B, T], "rate": rate}
    def e(a, b): return float((a.double() - b).abs().max())
    res["out"] = {"kernel": e(out.detach(), truth), "plain": e(plain, truth), "k_vs_p": e(out.detach(), plain.double()), "max": float(truth.abs().max()), "dtype": str(out.dtype)}
    for n, g, p_, t_ in zip(("dq", "dk", "dv"), (a.grad for a in args), pg, tg):
        res[n] = {"kernel": e(g, t_), "plain": e(p_, t_), "max": float(t_.abs().max()), "dtype": str(g.dtype), "finite": bool(torch.isfinite(g).all())}
    for b_, n_ in enumerate(lens):
        if n_ == 0:
            res["zero_row"] = bool((out[b_] == 0).all()) and all(bool((a.grad[b_] == 0).all()) for a in args)
    print(json.dumps(res), flush=True)
print(dict(ha.LAUNCHES))
run(3, 200, (200, 77, 0), 0.2)
run(2, 48, (48, 33), 0.2)
run(2, 130, (130, 70), 0.0)
run(16, 800, [800] * 16, 0.2)
run(1, 1200, (920,), 0.2)
run(2, 2400, (2400, 1400), 0.2)
print(dict(ha.LAUNCHES))
# f32 routes still right after the merge change
rng = np.random.default_rng(0)
q, k, v = (torch.tensor(rng.standard_normal((1, 1200, 4, 64)), dtype=torch.float32, device="cuda") for _ in range(3))
kv = torch.tensor([920], dtype=torch.int32, device="cuda")
with torch.no_grad():
    got = ha.flash_attention(q, k, v, kv)
want = attention.mhsa_attention(q, k, v, kv)
print("f32 k2 split err", float((got - want).abs().max()), float(want.abs().max()))
# timing at (16, 800)
def ms(fn, n=20):
    for _ in range(3): fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True); e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(n): fn()
    e.record(); e.synchronize()
    return s.elapsed_time(e) / n
rng = np.random.default_rng(1)
q, k, v, do = (torch.tensor(rng.standard_normal((16, 800, 4, 64)), dtype=torch.bfloat16, device="cuda") for _ in range(4))
kv = torch.full((16,), 800, dtype=torch.int32, device="cuda")
sd = torch.tensor([3], dtype=torch.int32, device="cuda")
args = [x.clone().requires_grad_(True) for x in (q, k, v)]
out = ha.flash_attention(*args, kv, rate=0.2, seed=sd)
print("bf16 fwd ms", ms(lambda: ha.flash_attention(*args, kv, rate=0.2, seed=sd)))
print("bf16 bwd ms", ms(lambda: torch.autograd.grad(out, args, do, retain_graph=True)))
q32 = [x.float().clone().requires_grad_(True) for x in (q, k, v)]
out32 = ha.flash_attention(*q32, kv, rate=0.2, seed=sd)
print("f32 fwd ms", ms(lambda: ha.flash_attention(*q32, kv, rate=0.2, seed=sd)))
print("f32 bwd ms", ms(lambda: torch.autograd.grad(out32, q32, do.float(), retain_graph=True)))
print("total s", time.time() - t0)
