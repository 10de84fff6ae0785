#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and exits non-zero
before the last line:

1. env     -- a CUDA device must be present; card name and power limit
              (nvidia-smi), torch / CUDA / nvcc versions.
2. build   -- compile ``adyolo_tpu_torch/csrc/*.cu`` with nvcc for sm_90a.
3. kernel  -- the Hopper STFT kernel vs its plain PyTorch version at the
              serving shape (16, 800, 600, 4) and a ragged (3, 803) case:
              max|kernel - plain| <= 2e-5 * max|plain|; median times over
              30 runs each, CUDA events.
4. forward -- FeatureFrontend + SE-ResNet34 + AD-YOLO at full width (13
              classes, seeded random init, eval, fp32) on 16 x 20-s clips:
              finite (16, 200, 2560) logits, the kernel launched, and
              within 1e-3 * max|logit| of the same model on plain-STFT
              features (DCASE2022 scaler stats); audio-seconds per second.
5. serve   -- three odd-length FOA wavs through ``engine.evaluate.infer``
              and then ``cli.main(["infer", ...])`` on an experiment dir
              written in the JAX checkpoint format: three CSVs each, the
              same detections, the kernel launched once per clip; p50
              per-clip latency.

Then one line ``{"kernels": [...]}`` (``launches`` counted over the
``cli.main`` run only), the card's nvidia-smi line, and last
``{"ok": true, "device": {...}}``.
"""
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
from adyolo_tpu_torch.models.wrapper import build_model  # noqa: E402
from adyolo_tpu_torch.ops import hopper_stft  # noqa: E402
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


def phase_forward(smi, cfg, fe, model):
    fwd = build_eval_forward(model, fe)  # fp32: TF32 off for convs and matmuls
    rng = np.random.default_rng(1)
    x = torch.tensor(foa_audio(rng, (16, 800, HOP, 4)), device="cuda")
    before = hopper_stft.LAUNCHES
    logits = fwd(x)
    torch.cuda.synchronize()
    launched = hopper_stft.LAUNCHES - before
    require(launched >= 1, "forward did not launch the STFT kernel")
    require(tuple(logits.shape) == (16, 200, 2560), f"logits {tuple(logits.shape)}")
    require(bool(torch.isfinite(logits).all()), "non-finite logits")
    with torch.inference_mode():
        re, im = plain_stft.stft(x, fe.w_re, fe.w_im, HOP)
        ref = model(fe.features_from_stft(re, im))
        del re, im
    err = float((logits - ref).abs().max())
    scale = float(ref.abs().max())
    require(err <= FORWARD_TOL * scale,
            f"forward vs plain-STFT forward: {err} > {FORWARD_TOL} * {scale}")
    ms = cuda_ms(lambda: fwd(x), 10)
    t = float(np.median(ms))
    emit({"phase": "forward", "shape": list(logits.shape), "launches": launched,
          "max_abs_err": err, "max_abs_logit": scale, "tol_rel": FORWARD_TOL,
          "ms": t, "audio_s_per_s": 16 * 20.0 / (t * 1e-3), "card": smi})
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


def phase_serve(smi, cfg, fe, model, tau, tmp):
    sr = cfg.data.sr
    rng = np.random.default_rng(2)
    wav_dir = os.path.join(tmp, "wavs")
    os.makedirs(wav_dir)
    for i, secs in enumerate((23, 28, 35)):  # buckets of 1200 and 2400 frames
        n = secs * sr + 137 * (i + 1)
        a = (rng.standard_normal((n, 4)) * 1500).astype(np.int16)
        write_wav(os.path.join(wav_dir, f"clip{i}.wav"), a, sr)
    cfg = dataclasses.replace(
        cfg, args=dataclasses.replace(cfg.args, exp_id="chip-smoke"))
    cfg = with_conf_thresh(cfg, tau)

    pp = PostProcessor(cfg)
    infer(cfg, model, fe, pp, wav_dir, os.path.join(tmp, "warm"))  # warm-up
    before = hopper_stft.LAUNCHES
    times = infer(cfg, model, fe, pp, wav_dir, os.path.join(tmp, "engine"))
    engine_launches = hopper_stft.LAUNCHES - before
    engine_csv = read_csvs(os.path.join(tmp, "engine"))
    require(len(engine_csv) == 3, f"engine.infer wrote {len(engine_csv)} CSVs")
    require(engine_launches >= 3, f"engine.infer launched the kernel {engine_launches}x")
    n_rows = sum(len(v) for v in engine_csv.values())
    n_slots = sum(int(s * 10) for s in (23, 28, 35)) * cfg.data.nb_classes
    require(0 < n_rows < n_slots, f"{n_rows} detections of {n_slots} slots")

    # the CLI on an experiment dir in the JAX trainer's file format
    results = os.path.join(tmp, "results")
    exp = os.path.join(results, "chip-smoke")
    save_config(cfg, os.path.join(exp, "hyp_exp.yaml"))
    save_jax_checkpoint(os.path.join(exp, "model_best.ckpt"),
                        flax_from_state_dict(model.state_dict()),
                        {"epoch_nb": 0, "confidence_thresh": tau})
    hopper_stft.LAUNCHES = 0  # the main path's count starts here
    t0 = time.perf_counter()
    rc = cli.main(["infer", "--eval_pth", "chip-smoke", "--infer_pth", wav_dir,
                   "--results_dir", results, "--device", "cuda"])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = hopper_stft.LAUNCHES
    require(rc == 0, f"cli.main returned {rc}")
    require(launches >= 3, f"cli infer launched the STFT kernel {launches}x")
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
    emit({"phase": "serve", "clips": len(times), "csv_rows": n_rows,
          "conf_thresh": tau, "engine_launches": engine_launches,
          "cli_launches": launches, "p50_clip_s": float(np.median(lat)),
          "clip_s": lat, "cli_total_s": cli_s, "card": smi})
    return launches


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
    fe = make_frontend(cfg, "cuda")
    kern = phase_kernel(smi, fe)
    model = build_model(cfg, "cuda", generator=torch.Generator().manual_seed(0))
    logits = phase_forward(smi, cfg, fe, model)
    tau = pick_threshold(cfg, logits)
    del logits
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        launches = phase_serve(smi, cfg, fe, model, tau, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    require("jax" not in sys.modules and "flax" not in sys.modules,
            "JAX was imported")
    k = kern["serving"]
    emit({"kernels": [{
        "name": "stft_hop_blocks", "route": "cuda",
        "source": "adyolo_tpu_torch/csrc/stft.cu",
        "replaces": "adyolo_tpu/ops/pallas_stft.py:68",
        "launches": launches, "max_abs_err": k["max_abs_err"],
        "ms": k["ms"], "plain_ms": k["plain_ms"]}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
