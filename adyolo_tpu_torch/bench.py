"""The benchmark lines of the repository's ``bench.py``, measured on the
port (counterpart of its ``main``, ``bench.py:201-437``).

Run::

    python -m adyolo_tpu_torch.bench [--all] [--config NAME ...] [--device cpu]

Each line is one JSON object printed as soon as it is measured:
``metric`` (the JAX bench's ``METRIC_OF`` string of the config, letter for
letter), ``value``, ``unit``, ``vs_baseline`` (value / 500, the
500x-real-time north star, on the two headline lines), ``tflops_per_s``
(:func:`~adyolo_tpu_torch.utils.profiling.model_flops` of one call over
its time), ``mfu`` (against the card's dense bf16 peak; left out where the
peak is unknown, as on the CPU) and ``device`` (the card's name and power
limit as ``nvidia-smi`` gives them, or ``cpu``).

Default lines: ``headline`` and ``headline-bf16`` (features + forward,
SE-ResNet34 + AD-YOLO, B=16 x 20 s, fp32 and the bf16 serving encoder),
``train-f32``, ``train-bf16`` and ``train-conformer-bf16`` (the train
step, Adam, dropout 0.2, B=32 x 20 s, synthetic AD-YOLO targets).
``--all`` adds ``infer-latency`` (p50 of single-clip features + forward +
decode, host clock), ``scaler-pass`` (``raw_mel_aux`` on flat audio),
``mic-gcc`` (the MIC front-end + forward) and ``eval-fwd-accdoa`` /
``eval-fwd-adyolo``.  Weights are a seeded init (``torch.Generator`` seed
0), audio ``np.random.default_rng(0)`` noise in the hop-block layout.
Forwards are timed by :func:`~adyolo_tpu_torch.utils.profiling.benchmark`
(CUDA events over back-to-back calls); train steps by the host clock over
15 steps after 3 warm-ups, closed by ``loss.item()``.  A line's FLOP count
is taken once, outside its timed window.

The bench keeps the precision policy of the code it measures: the eval
forward and the train step turn TF32 off, and ``cudnn.benchmark`` stays
off.  Everything runs in one process.  A config that raises is a fault:
every measured line is printed, then one ``{"metric": "bench-errors",
...}`` line, and the process exits 1.  The JAX bench's worker processes,
retries, deadlines and A/B lines are not ported.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import subprocess
import sys
import time
import traceback
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from .config import Config
from .data.labels import encode_adyolo, pad_yolo_targets
from .engine.evaluate import build_eval_forward, make_frontend
from .models.wrapper import build_model, make_grid_geometry
from .ops.decode import PostProcessor
from .ops.features import FeatureFrontend, identity_scaler
from .parallel.train_step import build_train_step
from .utils.profiling import (benchmark, device_name, mfu, model_flops,
                              throughput_audio_s)

__all__ = ["METRIC_OF", "DEFAULT_CONFIGS", "ALL_CONFIGS", "Sizes", "Bench", "run",
           "main"]

METRIC_OF = {
    "headline": "audio-sec/sec/chip (features+forward, se-resnet34+adyolo)",
    "headline-bf16": "audio-sec/sec/chip (features+forward, bf16 serving)",
    "train-f32": "train-step throughput (fwd+bwd+adam, B=32)",
    "train-bf16": "train-step throughput (fwd+bwd+adam, B=32, bf16 compute)",
    "train-conformer-bf16": "train-step throughput (resnet-conformer, B=32, bf16)",
    "infer-latency": "p50 per-clip infer latency (fwd+decode, 20 s clip)",
    "scaler-pass": "scaler-pass feature kernel throughput",
    "mic-gcc": "MIC/GCC-PHAT features+forward",
    "eval-fwd-accdoa": "eval forward (accdoa head)",
    "eval-fwd-adyolo": "eval forward (adyolo head)",
}
DEFAULT_CONFIGS = ("headline", "headline-bf16", "train-f32", "train-bf16",
                   "train-conformer-bf16")
ALL_CONFIGS = DEFAULT_CONFIGS + ("infer-latency", "scaler-pass", "mic-gcc",
                                 "eval-fwd-accdoa", "eval-fwd-adyolo")
NORTH_STAR = 500.0  # audio-s/s: the headline's vs_baseline denominator
EVENTS_PER_CLIP = 12  # synthetic AD-YOLO events of a training clip
TARGET_ROWS = 8192  # the padded AD-YOLO target rows of a training batch
SCALER_CLIPS = 8  # clips of the scaler pass
LATENCY_THRESH = 0.9  # the infer line's confidence threshold


@dataclasses.dataclass(frozen=True)
class Sizes:
    """The bench's sizes; the defaults are the JAX bench's."""
    batch: int = 16  # clips of a serving call
    train_batch: int = 32
    clip_s: int = 20  # the DCASE2022 chunk window
    iters: int = 20  # timed calls of a forward line
    warmup: int = 3
    train_warmup: int = 3
    train_steps: int = 15
    latency_calls: int = 20


def _card(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them (its
    name alone where ``nvidia-smi`` does not answer), or ``cpu``."""
    if device.type != "cuda":
        return device.type
    index = device.index if device.index is not None else torch.cuda.current_device()
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader", f"--id={index}"],
                             capture_output=True, text=True, check=True, timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return f"{device_name(device)}, power limit not read"


class Bench:
    """What the lines share: the DCASE2022 config at ``sizes.clip_s``, the
    FOA front-end on ``device``, the synthetic audio and training batch
    (drawn once, from one seeded generator), and the card's description."""

    def __init__(self, device="cuda", sizes: Sizes = Sizes()):
        self.device = torch.device(device)
        self.sizes = sizes
        cfg = Config()
        self.cfg = dataclasses.replace(cfg, data=dataclasses.replace(
            cfg.data, chunk_window_s=sizes.clip_s))
        self.frontend = make_frontend(self.cfg, self.device)
        self.card = _card(self.device)
        self.rng = np.random.default_rng(0)
        self._audio: Dict[int, torch.Tensor] = {}
        self._batch = None

    def audio(self, B: int) -> torch.Tensor:
        """``(B, N / hop, hop, 4)`` float32 noise on the device."""
        if B not in self._audio:
            d = self.cfg.data
            a = (self.rng.standard_normal((B, d.chunk_samples, 4)) * 0.1).astype(np.float32)
            self._audio[B] = torch.tensor(a.reshape(B, -1, d.hop_length, 4),
                                          device=self.device)
        return self._audio[B]

    def train_batch(self) -> Dict[str, torch.Tensor]:
        """The train steps' batch: ``sizes.train_batch`` clips of audio and
        their AD-YOLO targets, 12 random events a clip, padded to 8192
        rows."""
        if self._batch is None:
            B, frames = self.sizes.train_batch, self.cfg.data.chunk_label_frames
            geom = make_grid_geometry(self.cfg)
            per_clip = []
            for _ in range(B):
                label = {}
                for _ in range(EVENTS_PER_CLIP):
                    t = int(self.rng.integers(frames))
                    label.setdefault(t, []).append([
                        int(self.rng.integers(self.cfg.data.nb_classes)), 0,
                        float(self.rng.uniform(-180, 180)),
                        float(self.rng.uniform(-90, 90))])
                per_clip.append(encode_adyolo(label, frames, geom))
            targets, mask = pad_yolo_targets(per_clip, TARGET_ROWS)
            d = self.cfg.data
            audio = (self.rng.standard_normal((B, d.chunk_samples, 4)) * 0.1
                     ).astype(np.float32).reshape(B, -1, d.hop_length, 4)
            self._batch = {"audio": torch.tensor(audio, device=self.device),
                           "targets": torch.tensor(targets, device=self.device),
                           "target_mask": torch.tensor(mask, device=self.device)}
        return self._batch

    def model(self, cfg: Config, **kw):
        return build_model(cfg, device=self.device,
                           generator=torch.Generator().manual_seed(0), **kw)

    def line(self, name: str, value: float, unit: str, flops: float,
             seconds: float) -> Dict:
        """One line of config ``name``: ``flops`` of one call taking
        ``seconds``."""
        rec = {"metric": METRIC_OF[name], "value": float(value), "unit": unit}
        if name.startswith("headline"):
            rec["vs_baseline"] = float(value) / NORTH_STAR
        rec["tflops_per_s"] = flops / seconds / 1e12
        m = mfu(flops, seconds, self.device)
        if m is not None:
            rec["mfu"] = m
        rec["device"] = self.card
        return rec

    # ---- the lines ---------------------------------------------------

    def forward_line(self, name: str, cfg: Optional[Config] = None,
                     frontend=None, **model_kw) -> Dict:
        """Features + forward of ``sizes.batch`` clips, audio-s/s."""
        fwd = build_eval_forward(self.model(cfg or self.cfg, **model_kw),
                                 frontend or self.frontend)
        x = self.audio(self.sizes.batch)
        flops = model_flops(fwd, x)
        dt = benchmark(fwd, x, iters=self.sizes.iters, warmup=self.sizes.warmup)
        rate = throughput_audio_s(self.sizes.batch, self.sizes.clip_s, dt)
        return self.line(name, rate, "audio_s/s", flops, dt)

    def train_line(self, name: str, encoder: str, compute_dtype: str) -> Dict:
        """The train step of ``encoder`` in ``compute_dtype`` on the
        training batch, audio-s/s: 3 warm-up steps, then the mean of 15
        steps on the host clock, each window closed by ``loss.item()``."""
        cfg = self.cfg
        cfg = dataclasses.replace(
            cfg, args=dataclasses.replace(cfg.args, encoder=encoder),
            train=dataclasses.replace(cfg.train, batch_size=self.sizes.train_batch,
                                      compute_dtype=compute_dtype))
        step = build_train_step(cfg, self.model(cfg, train=True), self.frontend)
        batch = self.train_batch()
        gen = torch.Generator(device=self.device).manual_seed(1)
        flops = model_flops(step, batch, gen)
        for _ in range(self.sizes.train_warmup):
            loss = step(batch, gen)
        loss.item()
        t0 = time.perf_counter()
        for _ in range(self.sizes.train_steps):
            loss = step(batch, gen)
        loss.item()
        dt = (time.perf_counter() - t0) / self.sizes.train_steps
        rate = throughput_audio_s(self.sizes.train_batch, self.sizes.clip_s, dt)
        return self.line(name, rate, "audio_s/s", flops, dt)

    def infer_latency(self) -> Dict:
        """p50 (ms) of features + forward + decode of one clip at
        confidence threshold 0.9, host clock, after 2 warm-up calls."""
        fwd = build_eval_forward(self.model(self.cfg), self.frontend)
        pp = PostProcessor(self.cfg)
        pp.set_conf_thresh(LATENCY_THRESH)
        x = self.audio(self.sizes.batch)[:1]

        def call(a):
            pp.postprocess(fwd(a))
            if a.is_cuda:
                torch.cuda.synchronize(a.device)

        flops = model_flops(call, x)
        call(x)
        call(x)
        lat = []
        for _ in range(self.sizes.latency_calls):
            t0 = time.perf_counter()
            call(x)
            lat.append(time.perf_counter() - t0)
        p50 = float(np.percentile(lat, 50))
        return self.line("infer-latency", p50 * 1e3, "ms", flops, p50)

    def scaler_pass(self) -> Dict:
        """``raw_mel_aux`` (K1's flat path, log-mel and intensity vectors) of
        8 flat clips, audio-s/s."""
        d = self.cfg.data
        raw = torch.tensor((self.rng.standard_normal((SCALER_CLIPS, d.chunk_samples, 4))
                            * 0.1).astype(np.float32), device=self.device)
        fn = torch.no_grad()(self.frontend.raw_mel_aux)
        flops = model_flops(fn, raw)
        dt = benchmark(fn, raw, iters=self.sizes.iters, warmup=self.sizes.warmup)
        return self.line("scaler-pass", throughput_audio_s(SCALER_CLIPS, self.sizes.clip_s, dt),
                         "audio_s/s", flops, dt)

    def mic_gcc(self) -> Dict:
        """The MIC front-end (log-mel + GCC-PHAT; identity scaler stats: the
        repository holds FOA stats only) + forward, audio-s/s."""
        cfg = dataclasses.replace(self.cfg, data=dataclasses.replace(
            self.cfg.data, audio_format="mic"))
        d = cfg.data
        frontend = FeatureFrontend(d, identity_scaler(d.mel_bins, n_aux_ch=d.nb_feature_channels - 4),
                                   self.device)
        return self.forward_line("mic-gcc", cfg, frontend)

    def eval_forward(self, loss: str) -> Dict:
        cfg = dataclasses.replace(self.cfg, args=dataclasses.replace(self.cfg.args,
                                                                     loss=loss))
        return self.forward_line(f"eval-fwd-{loss}", cfg)

    def lines(self) -> Dict[str, Callable[[], Dict]]:
        return {
            "headline": lambda: self.forward_line("headline"),
            "headline-bf16": lambda: self.forward_line("headline-bf16",
                                                       serve_dtype="bfloat16"),
            "train-f32": lambda: self.train_line("train-f32", "se-resnet34", "float32"),
            "train-bf16": lambda: self.train_line("train-bf16", "se-resnet34", "bfloat16"),
            "train-conformer-bf16": lambda: self.train_line(
                "train-conformer-bf16", "resnet-conformer", "bfloat16"),
            "infer-latency": self.infer_latency,
            "scaler-pass": self.scaler_pass,
            "mic-gcc": self.mic_gcc,
            "eval-fwd-accdoa": lambda: self.eval_forward("accdoa"),
            "eval-fwd-adyolo": lambda: self.eval_forward("adyolo"),
        }


def _error(config: str, exc: BaseException) -> Dict:
    traceback.print_exc()
    return {"config": config, "error": f"{type(exc).__name__}: {exc}"[:500]}


def run(names, device="cuda", sizes: Sizes = Sizes(), emit=print) -> List[Dict]:
    """Measure the configs ``names`` in order, passing each line's JSON to
    ``emit`` as it is measured; returns the failures (``config``,
    ``error``), each with its traceback on stderr."""
    try:
        bench = Bench(device, sizes)
    except Exception as exc:  # noqa: BLE001 -- reported as the setup's failure
        return [_error("setup", exc)]
    lines, errors = bench.lines(), []
    for name in names:
        try:
            emit(json.dumps(lines[name]()))
        except Exception as exc:  # noqa: BLE001 -- a failed config is reported
            errors.append(_error(name, exc))
        finally:
            gc.collect()
            if bench.device.type == "cuda":
                torch.cuda.empty_cache()
    return errors


def main(argv=None, sizes: Sizes = Sizes()) -> int:
    ap = argparse.ArgumentParser(prog="python -m adyolo_tpu_torch.bench",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--all", action="store_true",
                    help="also the infer-latency, scaler-pass, mic-gcc and eval-fwd lines")
    ap.add_argument("--config", action="append", choices=ALL_CONFIGS, metavar="NAME",
                    help=f"run only this config (repeatable): {', '.join(ALL_CONFIGS)}")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA device; pass --device cpu to run on the CPU")
    names = args.config or (ALL_CONFIGS if args.all else DEFAULT_CONFIGS)
    errors = run(names, args.device, sizes, emit=lambda s: print(s, flush=True))
    if errors:
        print(json.dumps({"metric": "bench-errors", "value": len(errors),
                          "unit": "failed_configs", "errors": errors}), flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
