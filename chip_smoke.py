#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and exits non-zero
before the last line:

1. env     -- a CUDA device must be present; card name and power limit
              (nvidia-smi), torch / CUDA / nvcc versions.
2. build   -- compile ``adyolo_tpu_torch/csrc/*.cu`` with nvcc for sm_90a,
              one nvcc per source, all at once.
3. kernel  -- the Hopper STFT kernel vs its plain PyTorch version at the
              serving shape (16, 800, 600, 4) and a ragged (3, 803) case:
              max|kernel - plain| <= 2e-5 * max|plain|; median times over
              30 runs each, CUDA events.
4. attn_kernel -- the Hopper attention kernel vs the plain attention at
              (B, T, 4, 64): (16, 800) all keys valid and with random
              kv_len (one row 0), (1, 1200) len 920, (1, 2400) len 1400
              (route k2); (1, 4800) len 3000, (1, 9600) len 8000 (route
              k4): max|kernel - plain| <= 2e-5 * max|plain| over all rows,
              finite, zeros on the kv_len == 0 row; medians of 30 runs in
              turns with the plain version at (16, 800) and (1, 4800).
5. forward -- FeatureFrontend + SE-ResNet34 + AD-YOLO at full width (13
              classes, seeded random init, eval, fp32) on 16 x 20-s clips:
              finite (16, 200, 2560) logits, the kernel launched, and
              within 1e-3 * max|logit| of the same model on plain-STFT
              features (DCASE2022 scaler stats); audio-seconds per second.
6. forward_conformer -- the same with ResNet-Conformer + AD-YOLO (emb 256,
              8 blocks, 4 heads): the STFT kernel launched once and the
              attention kernel 8 times (route k2), within 1e-3 *
              max|logit| of the model on plain STFT and plain attention.
7. serve   -- three odd-length FOA wavs (23, 28, 35 s) through
              ``engine.evaluate.infer`` and then ``cli.main(["infer",
              ...])`` on an SE-ResNet34 experiment dir written in the JAX
              checkpoint format: three CSVs each, the same detections, the
              STFT kernel launched once per clip; p50 per-clip latency.
8. serve_conformer -- the same on a ResNet-Conformer experiment dir with
              wavs of 23, 35 and 75 s (buckets 1200, 2400, 4800): the STFT
              kernel once per clip, route k2 at least 16 times and route
              k4 at least 8 times in the CLI run.

Then one line ``{"kernels": [...]}`` (``launches`` counted over a
``cli.main`` run only: the SE-ResNet34 one for the STFT, the conformer one
for attention), the card's nvidia-smi line, and last
``{"ok": true, "device": {...}}``.
"""
import contextlib
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from adyolo_tpu.config import Config, save_config, with_conf_thresh  # noqa: E402
from adyolo_tpu.data.io import write_wav  # noqa: E402
from adyolo_tpu.ops.grid import GridGeometry  # noqa: E402
from adyolo_tpu_torch import cli  # noqa: E402
from adyolo_tpu_torch.convert import flax_from_state_dict  # noqa: E402
from adyolo_tpu_torch.engine.checkpoint import save_jax_checkpoint  # noqa: E402
from adyolo_tpu_torch.engine.evaluate import (build_eval_forward, infer,  # noqa: E402
                                              make_frontend)
from adyolo_tpu_torch.models import resnet_conformer  # noqa: E402
from adyolo_tpu_torch.models.wrapper import build_model  # noqa: E402
from adyolo_tpu_torch.ops import attention, hopper_attention, hopper_stft  # noqa: E402
from adyolo_tpu_torch.ops import stft as plain_stft  # noqa: E402
from adyolo_tpu_torch.ops.decode import PostProcessor, _device_decode  # noqa: E402
from adyolo_tpu_torch.utils import build  # noqa: E402

HOP = 600
KERNEL_TOL = 2e-5
FORWARD_TOL = 1e-3


def emit(obj):
    print(json.dumps(obj), flush=True)


def require(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, n):
    """Per-run times (ms) of ``fn`` with CUDA events, after two warm-ups."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(n):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        out.append(s.elapsed_time(e))
    return out


def zero_counts():
    hopper_stft.LAUNCHES = 0
    hopper_attention.LAUNCHES.update(k2=0, k4=0)


def counts():
    return {"stft": hopper_stft.LAUNCHES, **hopper_attention.LAUNCHES}


@contextlib.contextmanager
def plain_attention():
    """The conformer's MHSA on the plain attention, for a reference pass."""
    resnet_conformer.flash_attention = attention.mhsa_attention
    try:
        yield
    finally:
        resnet_conformer.flash_attention = hopper_attention.flash_attention


def foa_audio(rng, shape):
    """int16-range noise normalised like the loaders (/32768 + 1e-8)."""
    a = (rng.standard_normal(shape) * 1500).astype(np.int16)
    return (a / 32768.0 + 1e-8).astype(np.float32)


def phase_env():
    require(torch.cuda.is_available(), "no CUDA device; this script runs "
            "only on a GPU machine")
    smi = nvidia_smi_line()
    print(smi, flush=True)
    nvcc = subprocess.run([build.nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True, timeout=60).stdout
    mods = {}
    for m in ("yaml", "msgpack"):
        try:
            __import__(m)
            mods[m] = True
        except ImportError:
            mods[m] = False
    emit({"phase": "env", "card": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "nvcc": nvcc.strip().splitlines()[-1],
          "device_count": torch.cuda.device_count(), "imports": mods})
    return smi


def phase_build():
    info = build.build(force=True)
    regs = [ln.strip() for ln in info["ptxas"].splitlines() if "registers" in ln]
    emit({"phase": "build", "seconds": round(info["seconds"], 3),
          "library": os.path.relpath(info["path"]), "ptxas": regs})


def phase_kernel(smi, fe):
    rng = np.random.default_rng(0)
    res = {}
    for tag, (B, T) in (("serving", (16, 800)), ("ragged", (3, 803))):
        a = foa_audio(rng, (B, T, HOP, 4))
        a[:, 0] = rng.uniform(-0.5, 0.5, (B, HOP, 4))  # t=0 reflect block
        x = torch.tensor(a, device="cuda")
        kr, ki = hopper_stft.stft_hop_blocks(x, fe.w_re, fe.w_im)
        pr, pi = plain_stft.stft(x, fe.w_re, fe.w_im, HOP)
        torch.cuda.synchronize()
        errs = {}
        for nm, k, p in (("re", kr, pr), ("im", ki, pi)):
            err = float((k - p).abs().max())
            scale = float(p.abs().max())
            require(np.isfinite(err) and err <= KERNEL_TOL * scale,
                    f"STFT kernel {tag} {nm}: max err {err} > "
                    f"{KERNEL_TOL} * {scale}")
            errs[nm] = (err, scale)
        del kr, ki, pr, pi
        row = {"phase": "kernel", "case": tag, "shape": [B, T, HOP, 4],
               "max_abs_err": max(e for e, _ in errs.values()),
               "max_abs_plain": max(s for _, s in errs.values()),
               "tol_rel": KERNEL_TOL}
        if tag == "serving":
            k_ms, p_ms = [], []
            for _ in range(3):  # in turns: kernel, plain, ...
                k_ms += cuda_ms(lambda: hopper_stft.stft_hop_blocks(x, fe.w_re, fe.w_im), 10)
                p_ms += cuda_ms(lambda: plain_stft.stft(x, fe.w_re, fe.w_im, HOP), 10)
            flop = 2.0 * (B * T * 4) * (2 * HOP) * (2 * (HOP + 1))
            row.update({"ms": float(np.median(k_ms)), "plain_ms": float(np.median(p_ms)),
                        "runs": len(k_ms), "tflops": flop / (np.median(k_ms) * 1e-3) / 1e12,
                        "plain_tflops": flop / (np.median(p_ms) * 1e-3) / 1e12,
                        "card": smi})
        res[tag] = row
        emit(row)
        del x
    return res


def phase_attn_kernel(smi):
    """The attention kernel against the plain attention, per route."""
    torch.backends.cuda.matmul.allow_tf32 = False  # plain version in fp32
    rng = np.random.default_rng(3)
    lens16 = rng.integers(1, 801, 16)
    lens16[3] = 0  # a batch row with no valid key
    cases = (("k2", 16, 800, [800] * 16, True), ("k2", 16, 800, lens16, False),
             ("k2", 1, 1200, [920], False), ("k2", 1, 2400, [1400], False),
             ("k4", 1, 4800, [3000], True), ("k4", 1, 9600, [8000], False))
    res = {"k2": {"max_abs_err": 0.0}, "k4": {"max_abs_err": 0.0}}
    for rt, B, T, lens, timed in cases:
        require(hopper_attention.route(T) == rt, f"T={T} routes to "
                f"{hopper_attention.route(T)}, not {rt}")
        q, k, v = (torch.tensor(rng.standard_normal((B, T, 4, 64)),
                                dtype=torch.float32, device="cuda")
                   for _ in range(3))
        kv = torch.tensor(np.asarray(lens), dtype=torch.int32, device="cuda")
        got = hopper_attention.flash_attention(q, k, v, kv)
        want = attention.mhsa_attention(q, k, v, kv)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        require(bool(torch.isfinite(got).all()), f"attention {rt} T={T}: non-finite")
        require(np.isfinite(err) and err <= KERNEL_TOL * scale,
                f"attention {rt} ({B}, {T}): max err {err} > {KERNEL_TOL} * {scale}")
        for b, n in enumerate(lens):
            if n == 0:
                require(bool((got[b] == 0).all()), f"attention {rt}: kv_len 0 row not 0")
        row = {"phase": "attn_kernel", "route": rt, "shape": [B, T, 4, 64],
               "kv_len": [int(n) for n in lens] if B == 1 else
               {"min": int(min(lens)), "max": int(max(lens))},
               "max_abs_err": err, "max_abs_plain": scale, "tol_rel": KERNEL_TOL}
        res[rt]["max_abs_err"] = max(res[rt]["max_abs_err"], err)
        if timed:
            k_ms, p_ms = [], []
            for _ in range(3):  # in turns: kernel, plain, ...
                k_ms += cuda_ms(lambda: hopper_attention.flash_attention(q, k, v, kv), 10)
                p_ms += cuda_ms(lambda: attention.mhsa_attention(q, k, v, kv), 10)
            flop = 4.0 * 4 * T * float(np.sum(lens)) * 64
            row.update({"ms": float(np.median(k_ms)), "plain_ms": float(np.median(p_ms)),
                        "runs": len(k_ms),
                        "tflops": flop / (np.median(k_ms) * 1e-3) / 1e12,
                        "plain_tflops": flop / (np.median(p_ms) * 1e-3) / 1e12,
                        "card": smi})
            res[rt].update(ms=row["ms"], plain_ms=row["plain_ms"])
        emit(row)
        del q, k, v, got, want
    return res


def phase_forward(smi, fe, model, phase):
    """Features + model on 16 x 20-s clips, against the same model on the
    plain STFT and (conformer) the plain attention."""
    fwd = build_eval_forward(model, fe)  # fp32: TF32 off for convs and matmuls
    rng = np.random.default_rng(1)
    x = torch.tensor(foa_audio(rng, (16, 800, HOP, 4)), device="cuda")
    zero_counts()
    logits = fwd(x)
    torch.cuda.synchronize()
    launched = counts()
    require(launched["stft"] == 1, f"{phase}: STFT kernel launched {launched['stft']}x")
    if phase == "forward_conformer":
        require(launched["k2"] == 8 and launched["k4"] == 0,
                f"{phase}: attention launched {launched}, want k2 8x (one per block)")
    require(tuple(logits.shape) == (16, 200, 2560), f"logits {tuple(logits.shape)}")
    require(bool(torch.isfinite(logits).all()), "non-finite logits")
    with torch.inference_mode(), plain_attention():
        re, im = plain_stft.stft(x, fe.w_re, fe.w_im, HOP)
        ref = model(fe.features_from_stft(re, im))
        del re, im
    err = float((logits - ref).abs().max())
    scale = float(ref.abs().max())
    require(err <= FORWARD_TOL * scale,
            f"{phase} vs the all-plain forward: {err} > {FORWARD_TOL} * {scale}")
    ms = cuda_ms(lambda: fwd(x), 10)
    t = float(np.median(ms))
    emit({"phase": phase, "shape": list(logits.shape), "launches": launched,
          "max_abs_err": err, "max_abs_logit": scale, "tol_rel": FORWARD_TOL,
          "ms": t, "audio_s_per_s": 16 * 20.0 / (t * 1e-3),
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "card": smi})
    return logits


def pick_threshold(cfg, logits):
    """A confidence threshold that 0.1 % of the (frame, anchor, class)
    confidences of the forward phase clear: some anchors pass, most not."""
    geom = GridGeometry(tuple(cfg.train.grid_size), cfg.train.g_overlap,
                        cfg.train.nb_anchors)
    cls, _, _ = _device_decode(logits, geom, cfg.data.nb_classes)
    flat = cls.reshape(-1)
    return float(torch.topk(flat, flat.numel() // 1000).values[-1])


def read_csvs(d):
    out = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name)) as f:
            out[name] = [ln.strip().split(",") for ln in f if ln.strip()]
    return out


def serve(cfg, fe, model, tau, tmp, secs, exp_id):
    """Odd-length wavs of ``secs`` seconds through ``engine.evaluate.infer``
    and then the CLI on an experiment dir in the JAX file format; the two
    must write the same CSVs.  The launch counts of the CLI run (the main
    path) are set to 0 just before it and read just after."""
    sr = cfg.data.sr
    rng = np.random.default_rng(2)
    wav_dir = os.path.join(tmp, exp_id, "wavs")
    os.makedirs(wav_dir)
    for i, s in enumerate(secs):
        n = s * sr + 137 * (i + 1)
        a = (rng.standard_normal((n, 4)) * 1500).astype(np.int16)
        write_wav(os.path.join(wav_dir, f"clip{i}.wav"), a, sr)
    cfg = dataclasses.replace(
        cfg, args=dataclasses.replace(cfg.args, exp_id=exp_id))
    cfg = with_conf_thresh(cfg, tau)

    pp = PostProcessor(cfg)
    infer(cfg, model, fe, pp, wav_dir, os.path.join(tmp, exp_id, "warm"))  # warm-up
    before = counts()
    times = infer(cfg, model, fe, pp, wav_dir, os.path.join(tmp, exp_id, "engine"))
    engine = {k: n - before[k] for k, n in counts().items()}
    engine_csv = read_csvs(os.path.join(tmp, exp_id, "engine"))
    require(len(engine_csv) == len(secs), f"engine.infer wrote {len(engine_csv)} CSVs")
    n_rows = sum(len(v) for v in engine_csv.values())
    n_slots = sum(int(s * 10) for s in secs) * cfg.data.nb_classes
    require(0 < n_rows < n_slots, f"{n_rows} detections of {n_slots} slots")

    results = os.path.join(tmp, exp_id, "results")
    exp = os.path.join(results, exp_id)
    save_config(cfg, os.path.join(exp, "hyp_exp.yaml"))
    save_jax_checkpoint(os.path.join(exp, "model_best.ckpt"),
                        flax_from_state_dict(model.state_dict()),
                        {"epoch_nb": 0, "confidence_thresh": tau})
    zero_counts()  # the main path's count starts here
    t0 = time.perf_counter()
    rc = cli.main(["infer", "--eval_pth", exp_id, "--infer_pth", wav_dir,
                   "--results_dir", results, "--device", "cuda"])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = counts()
    require(rc == 0, f"cli.main returned {rc}")
    cli_csv = read_csvs(os.path.join(exp, "output_infer"))
    require(sorted(cli_csv) == sorted(engine_csv), "CLI and engine clip sets differ")
    for name, rows in engine_csv.items():
        got = cli_csv[name]
        require([r[:3] for r in got] == [r[:3] for r in rows],
                f"{name}: CLI detections differ from engine.infer")
        if rows:
            d = np.abs(np.asarray(got, float)[:, 3:] - np.asarray(rows, float)[:, 3:])
            require(float(d.max()) <= 1e-4, f"{name}: xyz differ by {d.max()}")
    lat = [s for _, s in times]
    return {"clips": len(times), "clip_secs": list(secs), "csv_rows": n_rows,
            "conf_thresh": tau, "engine_launches": engine, "cli_launches": launches,
            "p50_clip_s": float(np.median(lat)), "clip_s": lat, "cli_total_s": cli_s}


def phase_serve(smi, cfg, fe, model, tau, tmp):
    row = serve(cfg, fe, model, tau, tmp, (23, 28, 35), "chip-smoke")
    require(row["engine_launches"]["stft"] == 3 and row["cli_launches"]["stft"] == 3,
            f"serve: STFT kernel not once per clip: {row}")
    emit({"phase": "serve", **row, "card": smi})
    return row["cli_launches"]


def phase_serve_conformer(smi, cfg, fe, model, tau, tmp):
    row = serve(cfg, fe, model, tau, tmp, (23, 35, 75), "chip-smoke-conformer")
    n = row["cli_launches"]
    require(n["stft"] == 3, f"serve_conformer: STFT kernel launched {n['stft']}x for 3 clips")
    require(n["k2"] >= 16 and n["k4"] >= 8,
            f"serve_conformer: attention routes launched {n}, want k2 >= 16, k4 >= 8")
    emit({"phase": "serve_conformer", **row, "card": smi})
    return n


def main():
    smi = phase_env()
    phase_build()

    # the repository's DCASE2022 scaler stats, found from any working dir
    data = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        "DCASE2022_SELD")
    require(os.path.isfile(os.path.join(data, "scaler_wts.pkl")),
            f"no scaler stats under {data}")
    cfg = Config()
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, data_pth=data, name_pth=os.path.join(data, "classes.txt")))
    conf_cfg = dataclasses.replace(
        cfg, args=dataclasses.replace(cfg.args, encoder="resnet-conformer"))
    fe = make_frontend(cfg, "cuda")
    stft_k = phase_kernel(smi, fe)
    attn_k = phase_attn_kernel(smi)
    model = build_model(cfg, "cuda", generator=torch.Generator().manual_seed(0))
    tau = pick_threshold(cfg, phase_forward(smi, fe, model, "forward"))
    conformer = build_model(conf_cfg, "cuda",
                            generator=torch.Generator().manual_seed(0))
    conf_tau = pick_threshold(conf_cfg, phase_forward(smi, fe, conformer,
                                                      "forward_conformer"))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        se = phase_serve(smi, cfg, fe, model, tau, tmp)
        conf = phase_serve_conformer(smi, conf_cfg, fe, conformer, conf_tau, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    require("jax" not in sys.modules and "flax" not in sys.modules,
            "JAX was imported")
    k = stft_k["serving"]
    attn = {"name": "flash_attention", "route": "cuda",
            "source": "adyolo_tpu_torch/csrc/attention.cu"}
    emit({"kernels": [
        {"name": "stft_hop_blocks", "route": "cuda",
         "source": "adyolo_tpu_torch/csrc/stft.cu",
         "replaces": "adyolo_tpu/ops/pallas_stft.py:68",
         "launches": se["stft"], "max_abs_err": k["max_abs_err"],
         "ms": k["ms"], "plain_ms": k["plain_ms"]},
        {**attn, "name": "flash_attention/k2",
         "replaces": "adyolo_tpu/ops/flash_mhsa.py:180",
         "launches": conf["k2"], **attn_k["k2"]},
        {**attn, "name": "flash_attention/k4",
         "replaces": "adyolo_tpu/ops/flash_mhsa.py:358",
         "launches": conf["k4"], **attn_k["k4"]}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
