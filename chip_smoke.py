#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and exits non-zero
before the last line:

1. env     -- a CUDA device must be present; card name and power limit
              (nvidia-smi), torch / CUDA / nvcc versions.
2. build   -- compile ``adyolo_tpu_torch/csrc/*.cu`` with nvcc for sm_90a,
              one nvcc per source, all at once; per kernel its registers,
              spills and shared memory (ptxas, and the dynamic size the
              launch asks for); the frames kernel's route, tile, span
              slots and shared memory (on the global route its split,
              units, Bluestein blocks and input slots) by its C rule
              against the wrapper's ``frames_config`` at every n_fft of
              FRAMES_RULE_SWEEP.
3. kernel  -- the Hopper STFT kernel (an FFT) vs its plain PyTorch
              version at the serving shape (16, 800, 600, 4), a ragged
              (3, 803) case, the shortest (1, 2) and (2, 1201), whose last
              2-frame run holds one frame; and the plans with a radix-2
              pass, hop 300 (4-frame runs, (2, 403)) and hop 1200 (1-frame
              runs, (2, 201)); and flat audio (2, 203 * 600 + 17, 4),
              against the plain flat framing of the same samples
              (``framed_dft_flat``): max|kernel - plain| <= 2e-5 *
              max|plain|; median times over 30 runs each, CUDA events, in
              turns with the plain version and ``torch.stft`` (the library
              yardstick, checked to compute the same function within
              1e-4 * max).  Then K1's frames kernel (every other
              geometry): (2, 203 * hop + 17, 4) at (n_fft, hop, win) =
              (2048, 600, 1200), (1024, 600, 1024), (2400, 600, 2400),
              (4096, 1200, 2400), G3 (2204, 1102, 2204), G4 (4800, 2400,
              4800), G5 (2205, 1102, 2205) (prime passes at G3 and G5),
              (8192, 2048, 8192) (one span slot), (9600, 2400, 9600) on
              route four_step (one frame a block), and on the global route
              (two launches, the four-step FFT) (2402, 1201, 2402) and
              (7919, 1980, 7919) (Bluestein), (11274, 4000, 11274)
              (Bluestein columns) and (16384, 4096, 16384), and the prime
              (14087, 3522, 14087) on the global route's whole-frame
              Bluestein (two launches),
              against ``framed_dft_flat`` within 2e-5 * max, with the
              launches ``hopper_stft.kernels_of`` names; the timed rows
              ``frames_serving`` at (16, 800 * 600, 4), n_fft 2048, win
              1200 (G1), and ``frames_G3``, ``frames_G5``, ``frames_G4``,
              ``frames_G6``, ``frames_G7``, ``frames_N16384`` and
              ``frames_N14087`` at 16 x
              20 s of 44.1- and 96-kHz audio, each beside the plain
              version and ``torch.stft`` (held to the function on the
              frames before the last: its right edge is reflected, JAX's
              zeros).
4. attn_kernel -- the Hopper attention kernel (3xTF32 tensor cores) vs
              the plain attention at (B, T, 4, 64): (16, 800) all keys
              valid and with random kv_len (one row 0), (1, 1200) len 920,
              (1, 2400) len 1400 (route k2); (1, 4800) len 3000, (1, 9600)
              len 8000 (route k4): max|kernel - plain| <= 2e-5 *
              max|plain| over all rows, finite, zeros on the kv_len == 0
              row; medians of 30 runs in turns with the plain version and
              SDPA at (16, 800), (1, 1200) and (1, 4800).  Then route k4
              at (1, 4800) with q/k/v that require grad, outside no_grad:
              one k4 launch, the no-grad output, a backward that raises.
5. attn_train_kernel -- routes k2_dropout (forward, rate 0.2) and k3
              (backward, 3xTF32 tensor cores) vs the plain attention and
              its written-out backward at (16, 800, 4, 64), all keys valid
              and random kv_len with one row 0, and at (1, 1200) len 920
              and (1, 2400) len 1400: output within 2e-5 * max|plain|,
              dq/dk/dv within 1e-4 * max|plain grad|, zeros on the empty
              row, keep share 205/256 +- 0.005, rate 0 equal to route k2;
              medians of 30 runs of forward, backward and both, in turns
              with the plain version and SDPA (dropout_p 0.2); the forward
              alone also at (1, 1200) len 920.
4b. attn_launch_order -- in a process of its own (this script with
              ``--attn-launch-order``): the plain fp32 attention at (1,
              9600, 4, 64) with 8000 keys valid, then, the first kernel
              calls on autograd's device thread, the bf16 train pair and
              the fp32 train pair at (16, 800, 4, 64), rate 0.2, through
              autograd, held with the rules of phases
              attn_train_bf16_kernel and attn_train_kernel (the bf16
              backward's tensor-map encode once failed in that order).
6. forward -- FeatureFrontend + SE-ResNet34 + AD-YOLO at full width (13
              classes, seeded random init, eval, fp32) on 16 x 20-s clips:
              finite (16, 200, 2560) logits, the kernel launched, and
              within 1e-3 * max|logit| of the same model on plain-STFT
              features (DCASE2022 scaler stats); audio-seconds per second;
              then a ``torch.profiler`` breakdown of two more forwards.
              Then forward_b1: one 30-s clip (B = 1 x 1200 frames, the
              ``cli infer`` bucket), the same checks, the CUDA-event median
              of 10 and a profile of 5 forwards.  Then
              forward_other_geometry: the same model at n_fft 2048, win
              1200 on flat 16 x 20-s clips (K1's frames kernel once),
              within 1e-3 * max of the all-plain forward; median of 10, a
              profile of 2 that holds the frames kernel; forward_G3 the
              same at 44.1 kHz, hop 1102, n_fft = win = 2204; forward_G6
              the same at 96 kHz, hop 2400, n_fft = win = 9600 (800
              frames, 200 label frames; the frames kernel's route
              four_step, one launch, held in the profile).
7. forward_conformer -- the same with ResNet-Conformer + AD-YOLO (emb 256,
              8 blocks, 4 heads): the STFT kernel launched once and the
              attention kernel 8 times (route k2), within 1e-3 *
              max|logit| of the model on plain STFT and plain attention;
              forward_conformer_b1 as forward_b1.
              Then forward_conformer_long: one clip in the 4800-frame
              bucket, 3000 frames valid (route k4 8 times), the same
              check, CUDA-event median of 10, and a profiled breakdown of
              two forwards.
8. serve   -- three odd-length FOA wavs (23, 28, 35 s) through
              ``engine.evaluate.infer`` and then ``cli.main(["infer",
              ...])`` on an SE-ResNet34 experiment dir written in the JAX
              checkpoint format: three CSVs each, the same detections, the
              STFT kernel launched once per clip; p50 per-clip latency.
9. serve_conformer -- the same on a ResNet-Conformer experiment dir with
              wavs of 23, 35 and 75 s (buckets 1200, 2400, 4800): the STFT
              kernel once per clip, route k2 at least 16 times and route
              k4 at least 8 times in the CLI run.
10. train_conformer -- ``parallel.train_step`` on ResNet-Conformer +
              AD-YOLO at full width, fp32, Adam lr 1e-3, dropout 0.2 from
              one CUDA generator: 5 steps on B = 16 x 20-s int16 chunks with
              synthetic AD-YOLO targets; every loss finite; per step the
              STFT kernel once, k2_dropout 8 times, k3 8 times; step 1
              within 1e-4 rel (loss) and 1e-3 * max|grad| (every gradient,
              and the global norm within 1e-3 rel) of the same step from
              the same weights and generator seed on the plain attention;
              median step ms, audio-s/s, peak memory; then a
              ``torch.profiler`` breakdown of two more steps.

11. train_cli -- the entry points through ``cli.main`` at full width
              (ResNet-Conformer, fp32) on a synthetic DCASE2022-layout
              set written by the script (16 training chunks of 20 s; val
              and test clips of 23, 35 and 75 s; class tones FOA-encoded
              at their labelled direction over noise): ``train --augment
              --logger --nb_epochs 10 --nb_iters 1 --batch_size 16``
              (epoch 10 scans the confidence threshold), ``val``, ``test``,
              then ``train --resume_pth`` for epoch 11.  Checked: the
              artifacts, one CSV per clip, finite losses and in-range
              SELD metrics in ``logs.jsonl`` for epochs 1-11, the frozen
              threshold equal to the scanned one, per train step the STFT
              kernel once and k2_dropout / k3 8 times each, per eval clip
              the STFT once and k2 (k4 above 2400 frames) 8 times, five
              finite scores per unify threshold, and the resume starting
              at epoch 11 from the stored file list, pool, best_log and
              generator state.  Printed: train / val / test seconds per
              epoch, the engine's audio-s/s beside the bare step's, the
              loader wait per batch, the checkpoint writes, the scan's
              forward and decode + score seconds, the scorer's seconds
              per call, each CLI call's seconds, and a ``torch.profiler``
              breakdown of the resume call (epoch 11 and the final test):
              device time by group and the device's idle share.

Then the bf16 phases (attn_train_bf16_kernel, train_seresnet34,
train_conformer_bf16, train_cli_se_bf16; each function's docstring says
what it holds), cli_other_geometry (``cli train`` 2 epochs x 1 step,
``val``, ``infer`` and ``export`` of SE-ResNet34 at n_fft 2048, win 1200,
every K1 launch the frames kernel; the artifact's served call against the
live forward), cli_G3 (the same at 44.1 kHz, hop 1102, n_fft = win =
2204, on a 44.1-kHz set: the slice's path), and:

12. preprocess_mic -- a DCASE2022-layout MIC set written by the script
              (two 30-s dev-train clips, val and test clips of 23 and 35 s;
              class tones reaching the four capsules of the tetrahedral
              array with their plane-wave delays, over noise) through
              ``cli.main``: ``preprocess chunking`` (the chunk count against
              the window formula, one chunk against its source slice);
              GCC-PHAT on the card against numpy's ``irfft`` on 2 s of a
              clip (1e-3 x max); ``preprocess scaler`` on the card, K1 once
              per clip, 'MEL' (1, 64, 4) and 'GCC' (1, 64, 6) within
              1e-4 x max of the same pass on the CPU; then ``train
              --augment`` (SE-ResNet34 + AD-YOLO, 2 epochs x 1 step of 16 x
              20 s) on those stats, ``val`` and ``test``: finite losses,
              one CSV per clip, K1 once per step and per eval clip.  Timed:
              the MIC and FOA front-ends at 16 x 20 s and 3 bare MIC steps
              (the front-end's share of a step).
13. train_cli_formats -- the dense formats at full width on the FOA set of
              phase 11: each dense loss on the card against a numpy
              float64 version of the reference's (1e-5 rel); for seddoa,
              masked-seddoa, accdoa and adpit on SE-ResNet34, 3 bare steps
              of 16 x 20 s (step 1 against the same step on plain-STFT
              features, 1e-4 rel; median step and peak memory), then
              ``cli.main`` train (2 epochs x 1 step, the last scanning the
              threshold), val and test: finite losses, in-range metrics,
              one CSV per clip, one score block per call (three for adpit),
              K1 once per step and per eval clip; then accdoa on
              ResNet-Conformer through ``cli.main`` train: per step K1 once
              and k2_dropout / k3 8 times each, per eval clip k2 or k4 8
              times.

After the serve phases (8, 9), the export slice:

14. attn_eval_bf16_kernel -- route k2_bf16 (bf16 serving's attention,
              the bf16 forward kernel without dropout) against the plain
              bf16 attention at (16, 800) all keys valid and ragged with a
              kv_len = 0 row, (1, 800) (key splits and the merge), (1,
              2400) len 1400, and a bf16 eval call at (1, 4800) len 3000
              (k4 on float32 copies): each measured against float64, the
              kernel's error at most 2x the plain version's + 2^-9 x max;
              timed at (16, 800) and (1, 800) beside SDPA bf16 (single
              calls and the profiler's device time a call).
15. export -- ``cli.main(["export", ...])`` for SE-ResNet34 and
              ResNet-Conformer in float32 and bf16 (B=1 x 20 s) on
              experiment dirs written with ``save_jax_checkpoint``;
              ``export_model`` of the conformer at B=16 x 20 s and B=1 x
              120 s (route k4) in both dtypes; SE-ResNet34 traced on the
              CPU and served on the card.  One served call of each through
              ``load_exported`` with the plain STFT and attention patched
              to raise (the path ``export``): per call K1 once and, for the
              conformer, k2 / k2_bf16 / k4 8 times; f32 outputs within
              1e-5 x max of the live eval forward, bf16 within JAX's gates
              (max < 0.1, mean < 0.01) of the f32 live forward; served
              against live: B=1 p50 latency, B=16 audio-s/s.

16. ddp -- data parallelism, after the training phases: two ranks
              spawned on the one card in a gloo group (NCCL refuses two
              ranks on one device), each on 8 clips of a B=16 x 20-s global
              batch: (a) SE-ResNet34 + AD-YOLO and (b) ResNet-Conformer +
              AD-YOLO with ``--remat``, fp32, dropout 0, one step each
              against the single-process step on the global batch (loss
              within 1e-4 rel, the gradients' L2 distance within 1e-3 or 2x
              float32's floor measured in the same run, running stats
              within 1e-3 of each one's max; gradients and stats equal on
              both ranks);
              (c) 5 steps of the conformer in bf16 with dropout 0.2, step
              time per rank, the collectives timed alone and a profile of
              2 steps; per rank per step K1 once and the train attention
              pair 8 + 8 times (k2_dropout 16 under remat), with the plain
              versions patched to raise; (d) ``python -m
              adyolo_tpu_torch.cli train --quick_test`` under torchrun's
              variables at world size 1 (NCCL): exit 0, one experiment
              dir, one final test.
17. tp -- tensor parallelism: the train attention routes on a head
              shard, ``heads=(2, 4)``, at (4, 800, 2, 64), rate 0.2, ragged
              kv_len, against their plain versions at the same offset and
              against heads [2, 4) of the full launch (fp32: 2e-5 / 1e-4 x
              max; bf16: against float64 as phase attn_train_bf16_kernel,
              and within 2^-7 x max of the full launch); then two ranks on
              the one card in a gloo group, one model group
              (``model_parallel`` 2, 2 of the 4 heads a rank), the
              full-width conformer + AD-YOLO with dropout 0.2 on B = 4 x
              20 s, against the single-process step on the same batch and
              generator: fp32 loss within 1e-4 rel, the gathered gradients'
              L2 distance within 1e-3 or 2x float32's floor (the
              single-process step, dropout off, on the batch in two clip
              orders), running stats within 1e-3; bf16 loss within 1e-2
              rel; the replicated parameters' gradients equal on both
              ranks; per rank per step K1 once and the train attention pair
              8 + 8 times, with the plain versions patched to raise; the
              step time a rank beside one process's, and one TP
              all-reduce timed alone.
18. tp_replicated -- tensor parallelism where N does not cut every
              module, each part's ranks sharing the one card in a gloo
              group, one model group, dropout 0.2, B = 4 x 20 s, 2 steps
              from the seeded weights, step 1 against the single-process
              step on the same batch and generator with phase tp's gates
              (fp32 loss 1e-4 rel, gradients' L2 distance within 1e-3 or
              2x float32's floor, running stats 1e-3; bf16 loss 1e-2 rel):
              (i) the full conformer at N = 3 (3 ranks; 256, 1024 and the
              4 heads are not divisible by 3, so every module is whole on
              every rank), fp32 and bf16; (ii) SE-ResNet34 at N = 2 (2
              ranks, every parameter whole), fp32; (iii) the conformer
              cut to 2 blocks at N = 8 (8 ranks; the FFNs and conv modules
              sharded 8 ways, each MHSA whole), fp32.  Every rank holds
              each MHSA whole (4 heads, no head range) and rank 0's
              replicated gradients; per rank per step K1 once and the train
              attention pair once a block, with the plain versions
              patched to raise.

19. bench -- the port's bench (``adyolo_tpu_torch/bench.py``), last: its
              five default lines through its own functions (5 timed calls
              after 2 warm-ups, 5 timed train steps after 2): each line a
              finite positive value, its TFLOP/s and 0 < mfu <= 1; per line
              K1 once a call (the FLOP count's call and the warm-ups
              included) and, in the conformer's bf16 step, k2_dropout_bf16
              and k3_bf16 8 times a step, no other route (the path
              ``bench``).  Then the path's kernels at its shapes: K1 on
              (32, 800, 600, 4) against the plain STFT (2e-5 x max), the
              bf16 pair at (32, 800, 4, 64) against float64 as in phase
              attn_train_bf16_kernel; the conformer's B = 32 bf16 step on
              the kernels and on the plain attention from the same weights
              and generator seed: loss within 1e-2 rel, the worst leaf's
              gradient within 0.25 x the largest, ``model_flops`` equal
              (1e-9 rel).  At B = 2 x 2 s: the headline forward's
              ``model_flops`` with the STFT op's CUDA kernel replaced by the
              plain STFT equals the kernels' count, and the card's counts
              equal the CPU's for the SE-ResNet34 forward, its fp32 step
              and the conformer's bf16 step.

Phases 3-5 and 14 also read each kernel's and library call's device time
a call from ``torch.profiler`` (``utils/profiling.py::profile_calls``),
or from CUDA events where the profiler records no device event in three
attempts (the rows' ``device_ms_source``).  A kernel's profile must hold
exactly the device kernels its calls launched, as the wrappers count them
(``KERNELS``; K4 at (1, 4800) runs a split kernel and a merge), or it is
taken again and, after three attempts, void; a reading below its row's
``bound_ms`` or above 1.05 x its own single-call median is void:
``device_ms`` (``library_device_ms``) null beside its reason in
``device_ms_void`` (``library_device_ms_void``).  A library call's
kernels are not the port's: one profiled call counts them, and the
profile of 10 must hold 10 times as many, or its reading is void too.
A void reading is a measurement outcome; the correctness checks stay
fatal.  Every profile of a step or a forward holds the same count of the
kernels one unprofiled call launched, or its groups are void.
Then one line ``{"kernels": [...]}`` (``launches`` counted over each
kernel's main path, phase train_cli, or train_conformer_bf16 for the bf16
training routes, export for k2_bf16, cli_G3 for K1's frames kernel and
forward_G6 for its route four_step, with every path's count beside it in
``launches_by_path``; the frames kernel's entry also carries its other
timed geometries' rows; its global route and the route's whole-frame
Bluestein, on no model's path, count the launches of phase kernel's frames
cases), the card's nvidia-smi line, and
last
``{"ok": true, "device": {...}}``.  Before those two lines the helper
processes that ``multiprocessing`` started for the ranks are ended, and
the script fails if any process it started (a grandchild included: it
reaps its orphans) is still running.
Nothing of JAX or of the JAX package ``adyolo_tpu`` is imported.
"""
import contextlib
import ctypes
import dataclasses
import functools
import json
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
import yaml

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from adyolo_tpu_torch import bench as bench_mod  # noqa: E402
from adyolo_tpu_torch import cli  # noqa: E402
from adyolo_tpu_torch.config import (Config, build_config, load_config,  # noqa: E402
                                     save_config, with_conf_thresh)
from adyolo_tpu_torch.convert import flax_from_state_dict  # noqa: E402
from adyolo_tpu_torch.data.chunking import chunk_clip  # noqa: E402
from adyolo_tpu_torch.data.io import (normalize_audio, read_wav,  # noqa: E402
                                      write_label_csv, write_wav)
from adyolo_tpu_torch.data.labels import (encode_accdoa, encode_adpit,  # noqa: E402
                                          encode_adyolo, encode_seddoa,
                                          pad_yolo_targets)
from adyolo_tpu_torch.data.scaler import compute_scaler_stats  # noqa: E402
from adyolo_tpu_torch.engine.checkpoint import optax_state, save_jax_checkpoint  # noqa: E402
from adyolo_tpu_torch.engine import evaluate as evaluate_mod  # noqa: E402
from adyolo_tpu_torch.engine import train as train_mod  # noqa: E402
from adyolo_tpu_torch.engine.evaluate import (build_eval_forward, infer,  # noqa: E402
                                              load_best_model, make_frontend)
from adyolo_tpu_torch.engine.export import export_model, load_exported  # noqa: E402
from adyolo_tpu_torch.metrics.seld import SegmentScorer  # noqa: E402
from adyolo_tpu_torch.models import resnet_conformer  # noqa: E402
from adyolo_tpu_torch.models import wrapper as wrapper_mod  # noqa: E402
from adyolo_tpu_torch.models.layers import BatchNorm, U8Dropout  # noqa: E402
from adyolo_tpu_torch.models.wrapper import (build_model, make_criterion,  # noqa: E402
                                             make_grid_geometry)
from adyolo_tpu_torch.ops import attention, hopper_attention, hopper_stft  # noqa: E402
from adyolo_tpu_torch.ops import stft as plain_stft  # noqa: E402
from adyolo_tpu_torch.ops.decode import PostProcessor, _device_decode  # noqa: E402
from adyolo_tpu_torch.ops.dsp import analysis_window, dft_matrices  # noqa: E402
from adyolo_tpu_torch.ops.features import FeatureFrontend  # noqa: E402
from adyolo_tpu_torch.parallel import mesh  # noqa: E402
from adyolo_tpu_torch.parallel.train_step import build_train_step, make_optimizer  # noqa: E402
from adyolo_tpu_torch.utils import build  # noqa: E402
from adyolo_tpu_torch.utils.profiling import (check_device_ms, group_ms,  # noqa: E402
                                              group_of, kernels_launched,
                                              library_count_void, model_flops,
                                              profile_calls)

HOP = 600
# the DCASE SELD baseline's geometry at a 600-sample hop: a window of 2 hops
# in the next power of two (seld-dcase2022, cls_feature_class.py), which
# the frames kernel of K1 runs
OTHER_N_FFT, OTHER_WIN = 2048, 1200
# (n_fft, hop, win_length, sr) of the frames kernel's timed geometries: G1
# the baseline's above; the DCASE preset's 25 / 50 ms at 44.1 kHz as n_fft
# = 2 hop = 2^2 19 29 (G3, the slice's path, prime passes) and as the exact
# 50-ms window, odd (G5, 3^2 5 7^2); at 96 kHz (G4, 4800); at 96 kHz, a
# 100-ms window (G6, 9600 = 120 x 80, route four_step, phase forward_G6's
# path); and 11274 / 4000 on the global route (G7, 1879 x 6: Bluestein
# columns)
GEOMETRY = {"G1": (OTHER_N_FFT, HOP, OTHER_WIN, 24000), "G3": (2204, 1102, 2204, 44100),
            "G5": (2205, 1102, 2205, 44100), "G4": (4800, 2400, 4800, 96000),
            "G6": (9600, 2400, 9600, 96000), "G7": (11274, 4000, 11274, 96000)}
# timed beside GEOMETRY in phase kernel, at no model's geometry: the global
# route at 16384 = 128 x 128, and at the prime 14087 its whole-frame
# Bluestein
TIMED_FRAMES = {**GEOMETRY, "N16384": (16384, 4096, 16384, 96000),
                "N14087": (14087, 3522, 14087, 96000)}
# n_fft at which phase build holds the frames kernel's route rule in C (what
# a launch checks) to the wrapper's copy: every n_fft below 300, a stride
# through the rest up to the global route, and each route's edges
FRAMES_RULE_SWEEP = sorted(set(range(2, 300)) | set(range(300, 16500, 97)) | {
    1023, 1201, 2047, 2048, 2204, 2205, 2402, 4096, 4097, 4800, 5534, 5535, 5642, 5643, 7680,
    7681, 7919, 8192, 8193, 9600, 11274, 12703, 12707, 14087, 16384, 37083, 65537})
KERNEL_TOL = 2e-5
GRAD_KERNEL_TOL = 1e-4  # kernel vs plain attention gradients, x max|grad|
LIBRARY_TOL = 1e-4  # torch.stft / SDPA vs the plain version, x max|plain|
FORWARD_TOL = 1e-3
TRAIN_LOSS_TOL = 1e-4  # step 1 on the kernels vs on plain attention, relative
TRAIN_GRAD_TOL = 1e-3  # the same step's gradients, x max|grad|
RATE = 0.2  # the conformer's dropout; thresh 51, keep share 205/256
TRAIN_STEPS = 5

# One H100 SXM (NVIDIA's data sheet): fp32 FFMA peak outside the tensor
# cores, dense TF32 tensor-core peak and HBM3 bandwidth.  A kernel's bound
# is the larger of its FLOP over a peak and its bytes (inputs read once,
# outputs written once) over the bandwidth.  3xTF32 does each product
# three times on the tensor cores, so it counts 3x the FLOP at the TF32
# peak (165 TFLOP/s effective).
FP32_FLOPS = 67e12
TF32_TC_FLOPS = 494.7e12
BF16_TC_FLOPS = 989e12  # dense bfloat16 tensor-core peak
HBM_BYTES_S = 3.35e12
BF16_RATIO = 2.0  # a bf16 kernel's error (vs float64) at most this x the plain version's
BF16_HALF_STEP = 2.0 ** -9  # plus half a bfloat16 step at the truth's max
BF16_LIBRARY_TOL = 2.0 ** -6  # SDPA on bf16 vs the plain bf16 attention, x max
BF16_TRAIN_LOSS_TOL = 1e-2  # bf16 step 1 on the kernels vs on plain attention, relative
SE_BF16_LOSS_TOL = 5e-2  # SE-ResNet34 bf16 step 1 vs f32 from the same weights, relative


def emit(obj):
    print(json.dumps(obj), flush=True)


def require(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def adopt_orphans():
    """Makes this process the reaper of every process it starts, so that a
    grandchild whose parent ended (a rank's own child) is still one of
    :func:`child_processes` (Linux ``PR_SET_CHILD_SUBREAPER``)."""
    libc = ctypes.CDLL(None, use_errno=True)
    libc.prctl(36, 1, 0, 0, 0)


def child_processes():
    """The pids of this process's live children, its zombies reaped."""
    me, pids = os.getpid(), []
    for d in os.listdir("/proc"):
        try:
            with open(f"/proc/{d}/stat") as f:
                stat = f.read()
        except (OSError, ValueError):
            continue
        state, ppid = stat.rsplit(")", 1)[1].split()[:2]
        if int(ppid) != me:
            continue
        if state == "Z":
            with contextlib.suppress(ChildProcessError):
                os.waitpid(int(d), 0)
        else:
            pids.append(int(d))
    return pids


def stop_helper_processes(timeout=30.0):
    """Ends the helpers that ``multiprocessing`` started for the ranks: the
    forkserver of phase tp_replicated, then the resource tracker.  Each
    ends when the pipe this process holds to it closes, which would
    otherwise happen only at this process's exit, and then outlive it for
    the time its own shutdown takes; each is waited for here, and killed
    if it has not ended within ``timeout`` seconds."""
    from multiprocessing import forkserver, resource_tracker

    for helper, pid_attr, fd_attr in (
            (forkserver._forkserver, "_forkserver_pid", "_forkserver_alive_fd"),
            (resource_tracker._resource_tracker, "_pid", "_fd")):
        pid, fd = getattr(helper, pid_attr, None), getattr(helper, fd_attr, None)
        if pid is None:
            continue
        setattr(helper, pid_attr, None)
        setattr(helper, fd_attr, None)
        os.close(fd)
        deadline = time.monotonic() + timeout
        with contextlib.suppress(ChildProcessError):
            while os.waitpid(pid, os.WNOHANG)[0] == 0:
                if time.monotonic() > deadline:
                    os.kill(pid, 9)
                    os.waitpid(pid, 0)
                    break
                time.sleep(0.05)


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


def device_reading(fn, bound_ms, single_ms, kernels=True):
    """Device time a call of ``fn()`` from one ``profile_calls`` of 10
    calls, checked.  ``kernels``: the groups of the port's kernels that one
    unprofiled call launches, counted by the wrappers
    (``kernels_launched``), which the profile must hold exactly; else
    (a library call) all the call launches, which must be 10 times the
    device kernels of one profiled call (``library_count_void``).  A
    reading below ``bound_ms`` or above DEVICE_SLACK x ``single_ms`` (the
    call's median between two CUDA events) is void.  Returns ``ms`` (None
    when void), ``void`` (the reason), ``source`` and the kernel counts
    seen (a library call's: a call's, in one call and in the 10)."""
    expect = kernels_launched(fn) if kernels else None
    require(expect is None or expect, "device_reading: the call launched no kernel")
    groups = sorted({group_of(k) for k in expect}) if kernels else None
    if not kernels:
        one = profile_calls(lambda _: fn(), 1)
        per_call = one["kernels_per_step"] if one["source"] == "profiler" else None
    prof = profile_calls(lambda _: fn(), 10, expect=expect)
    ms, why = check_device_ms(group_ms(prof, *groups) if kernels
                              else prof["busy_ms_per_step"], bound_ms, single_ms)
    counts_seen = prof.get("kernel_counts")
    if not kernels:
        why = library_count_void(prof, per_call) or why
        ms = None if why else ms
        counts_seen = {"one_call": per_call, "a_call_of_10": prof.get("kernels_per_step")}
    return {"ms": ms, "void": why, "source": prof["source"], "kernel_counts": counts_seen}


def device_fields(kernel, library, bound_ms, kernel_ms, library_ms):
    """A row's checked device times a call (:func:`device_reading`) of a
    kernel's call and of its library call, each against the kernel's
    ``bound_ms`` and its own single-call median; a void one is None beside
    its reason."""
    k = device_reading(kernel, bound_ms, kernel_ms)
    lib = device_reading(library, bound_ms, library_ms, kernels=False)
    return {"device_ms": k["ms"], "device_ms_void": k["void"],
            "library_device_ms": lib["ms"], "library_device_ms_void": lib["void"],
            "device_ms_source": [k["source"], lib["source"]],
            "device_ms_kernel_counts": k["kernel_counts"],
            "library_kernel_counts": lib["kernel_counts"]}


DEVICE_KEYS = ("device_ms", "device_ms_void", "library_device_ms", "library_device_ms_void")


def bound(flop, nbytes):
    """The least time (ms) the card could take for ``flop`` fp32 FLOP that
    move ``nbytes``, and which of the two bounds it."""
    t_op, t_mem = flop / FP32_FLOPS, nbytes / HBM_BYTES_S
    return {"bound_ms": max(t_op, t_mem) * 1e3,
            "bound_by": "operations" if t_op >= t_mem else "bytes"}


def bf16_bound(flop, nbytes):
    """A bf16 kernel's bound: ``flop`` at the dense bfloat16 tensor-core
    peak, or its bytes over the bandwidth, whichever is larger."""
    t_op, t_mem = flop / BF16_TC_FLOPS, nbytes / HBM_BYTES_S
    return {"bound_ms": max(t_op, t_mem) * 1e3,
            "bound_by": "operations" if t_op >= t_mem else "bytes",
            "bound_units": "bf16 tensor cores"}


def attn_bound(flop, nbytes):
    """An attention route's bound: the lesser of the fp32 FFMA bound and
    the 3xTF32 tensor-core bound (3 x ``flop`` at the TF32 peak), with the
    units that give it (``bound_units``) and the FFMA figure beside it."""
    ffma = bound(flop, nbytes)
    t_op, t_mem = 3.0 * flop / TF32_TC_FLOPS, nbytes / HBM_BYTES_S
    tc = {"bound_ms": max(t_op, t_mem) * 1e3,
          "bound_by": "operations" if t_op >= t_mem else "bytes"}
    best = tc if tc["bound_ms"] <= ffma["bound_ms"] else ffma
    return {**best, "bound_units": "3xTF32 tensor cores" if best is tc else "fp32 FFMA",
            "bound_ffma_ms": ffma["bound_ms"]}


def zero_counts():
    hopper_stft.LAUNCHES = 0
    for name in hopper_stft.KERNELS:
        hopper_stft.KERNELS[name] = 0
    for rt in hopper_attention.LAUNCHES:
        hopper_attention.LAUNCHES[rt] = 0


def counts():
    """Launches by route: ``stft`` K1's hop-block kernel, ``stft_frames``
    its frames kernel in shared memory (every other geometry),
    ``stft_frames_4step`` its route four_step (one frame a block),
    ``stft_frames_global`` its global route (two launches,
    ``stft_frames_cols_kernel`` and ``stft_frames_rows_kernel``),
    ``stft_frames_chirp`` the global route's whole-frame Bluestein (two
    launches, ``stft_frames_chirp_in_kernel`` and
    ``stft_frames_chirp_out_kernel``), then the attention routes."""
    k = hopper_stft.KERNELS
    return {"stft": k["stft_hop_blocks_fft_kernel"], "stft_frames": k["stft_frames_fft_kernel"],
            "stft_frames_4step": k["stft_frames_4step_kernel"],
            "stft_frames_global": k["stft_frames_cols_kernel"] + k["stft_frames_rows_kernel"],
            "stft_frames_chirp": (k["stft_frames_chirp_in_kernel"]
                                  + k["stft_frames_chirp_out_kernel"]),
            **hopper_attention.LAUNCHES}


def expected_counts(n_fft, hop, calls=1):
    """:func:`counts`' growth over ``calls`` STFT calls at ``(n_fft,
    hop)``, every other route 0 (``hopper_stft.kernels_of``)."""
    want = dict.fromkeys(counts(), 0)
    for name, n in hopper_stft.kernels_of(n_fft, hop).items():
        key = {"stft_hop_blocks_fft_kernel": "stft", "stft_frames_fft_kernel": "stft_frames",
               "stft_frames_4step_kernel": "stft_frames_4step",
               "stft_frames_chirp_in_kernel": "stft_frames_chirp",
               "stft_frames_chirp_out_kernel": "stft_frames_chirp"}
        want[key.get(name, "stft_frames_global")] += calls * n
    return want


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


def foa_audio_cuda(seed, shape):
    """:func:`foa_audio`'s noise made on the card from ``seed`` (a 16 x
    20-s clip batch at 96 kHz is 123 M samples: seconds on the host)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    a = (torch.randn(shape, generator=g, device="cuda") * 1500).to(torch.int16)
    return a.float() / 32768.0 + 1e-8


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


def ptxas_kernels(log):
    """Per kernel: registers, spill bytes and static shared memory from
    nvcc's ``-Xptxas=-v`` report."""
    out, name = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            mangled = ln.split("'")[1]
            name = next(k for k in ("stft_hop_blocks_fft_kernel",
                                    "stft_frames_fft_kernelILi16ELb0E",
                                    "stft_frames_fft_kernelILi16ELb1E",
                                    "stft_frames_fft_kernelILi32ELb0E",
                                    "stft_frames_fft_kernelILi32ELb1E",
                                    "stft_frames_chirp_in_kernel",
                                    "stft_frames_chirp_out_kernel",
                                    "stft_frames_cols_kernelILb0ELb0E",
                                    "stft_frames_cols_kernelILb1ELb0E",
                                    "stft_frames_cols_kernelILb0ELb1E",
                                    "stft_frames_rows_kernelILb0E",
                                    "stft_frames_rows_kernelILb1E",
                                    "stft_frames_4step_kernel", "mhsa_fwd_kernelILb1",
                                    "mhsa_fwd_kernelILb0", "mhsa_fwd_merge_kernel",
                                    "mhsa_bwd_dq_kernel", "mhsa_bwd_dkdv_kernel",
                                    "mhsa_fwd_bf16_kernelILb1", "mhsa_fwd_bf16_kernelILb0",
                                    "mhsa_bwd_dq_bf16_kernel",
                                    "mhsa_bwd_dkdv_bf16_kernel", mangled)
                        if k in mangled)
            name = (name.replace("ILi16ELb0E", "<16, false>").replace("ILi16ELb1E", "<16, true>")
                    .replace("ILi32ELb0E", "<32, false>").replace("ILi32ELb1E", "<32, true>")
                    .replace("ILb0ELb0E", "<false, false>").replace("ILb1ELb0E", "<true, false>")
                    .replace("ILb0ELb1E", "<false, true>")
                    .replace("ILb1E", "<true>").replace("ILb0E", "<false>")
                    .replace("ILb1", "<true>").replace("ILb0", "<false>"))
            out[name] = {}
        elif name and "spill stores" in ln:
            out[name]["spill_store_bytes"] = int(ln.split("bytes spill stores")[0].split(",")[-1])
        elif name and "registers" in ln:
            out[name]["registers"] = int(ln.split("Used ")[1].split(" registers")[0])
            out[name]["static_smem_bytes"] = (int(ln.split(" bytes smem")[0].split(",")[-1])
                                              if "bytes smem" in ln else 0)
    return out


def phase_build():
    info = build.build(force=True)
    lib = build.load_library()
    lib.adyolo_stft_smem_bytes.restype = ctypes.c_longlong
    lib.adyolo_stft_frames_config.restype = ctypes.c_longlong
    lib.adyolo_stft_frames_config.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                                              ctypes.c_int, ctypes.c_void_p]
    lib.adyolo_mhsa_smem_bytes.restype = ctypes.c_longlong
    kernels = ptxas_kernels(info["ptxas"])

    def c_config(n_fft, hop):
        radices, n_pass = hopper_stft._radices_c(hopper_stft.frames_radix_plan(n_fft))
        out = (ctypes.c_int * 12)()
        smem = lib.adyolo_stft_frames_config(n_fft, hop, radices, n_pass, out)
        return None if smem < 0 else hopper_stft.FramesConfig(out[0], out[1], out[2], smem,
                                                              *out[3:12])

    def py_config(n_fft, hop):
        return hopper_stft.frames_config(n_fft, hop)

    # the frames kernel's route, tile, ring and shared memory (on the global
    # route its split, units, Bluestein blocks and slots) by the C rule (what
    # a launch checks) against the wrapper's copy (frames_config, which
    # decides the launches), over FRAMES_RULE_SWEEP
    for n_fft in FRAMES_RULE_SWEEP:
        for hop in sorted({max(1, n_fft // 4), max(1, n_fft // 2), HOP}):
            c, py = c_config(n_fft, hop), py_config(n_fft, hop)
            require(c == py, f"frames kernel at {n_fft}/{hop}: {c} by the C rule, {py} by "
                    "frames_config")
    # the shared memory of each instance at a geometry that runs it
    g7, n16384 = c_config(*GEOMETRY["G7"][:2]), c_config(16384, 4096)
    n14087 = c_config(*TIMED_FRAMES["N14087"][:2])
    # (instances <n, false/true>: without and with the prime passes)
    frames_smem = {"stft_frames_fft_kernel<16, false>": c_config(*GEOMETRY["G1"][:2]).smem_bytes,
                   "stft_frames_fft_kernel<16, true>": c_config(*GEOMETRY["G3"][:2]).smem_bytes,
                   "stft_frames_fft_kernel<32, false>": c_config(*GEOMETRY["G4"][:2]).smem_bytes,
                   "stft_frames_4step_kernel": c_config(*GEOMETRY["G6"][:2]).smem_bytes,
                   "stft_frames_cols_kernel<false, false>": n16384.smem_bytes,
                   "stft_frames_rows_kernel<false>": n16384.rows_smem_bytes,
                   "stft_frames_cols_kernel<false, true>": g7.smem_bytes,
                   "stft_frames_chirp_in_kernel": n14087.smem_bytes,
                   "stft_frames_chirp_out_kernel": n14087.rows_smem_bytes}
    dyn = {"stft_hop_blocks_fft_kernel": lib.adyolo_stft_smem_bytes(), **frames_smem,
           "mhsa_fwd_kernel<true>": lib.adyolo_mhsa_smem_bytes(0),
           "mhsa_fwd_kernel<false>": lib.adyolo_mhsa_smem_bytes(0),
           "mhsa_fwd_merge_kernel": 0,
           "mhsa_bwd_dq_kernel": lib.adyolo_mhsa_smem_bytes(1),
           "mhsa_bwd_dkdv_kernel": lib.adyolo_mhsa_smem_bytes(2),
           "mhsa_fwd_bf16_kernel<true>": lib.adyolo_mhsa_smem_bytes(3),
           "mhsa_fwd_bf16_kernel<false>": lib.adyolo_mhsa_smem_bytes(3),
           "mhsa_bwd_dq_bf16_kernel": lib.adyolo_mhsa_smem_bytes(4),
           "mhsa_bwd_dkdv_bf16_kernel": lib.adyolo_mhsa_smem_bytes(5)}
    for name, n in dyn.items():
        require(name in kernels, f"ptxas reported no kernel {name}: {sorted(kernels)}")
        kernels[name]["dynamic_smem_bytes"] = int(n)
    emit({"phase": "build", "seconds": round(info["seconds"], 3),
          "library": os.path.relpath(info["path"]), "kernels": kernels})


def window_dft(window, win_length, n_fft):
    """The plain STFT's window-folded DFT matrices, on the card."""
    w = analysis_window(window, win_length, n_fft)
    return [torch.as_tensor(m, device="cuda") for m in dft_matrices(n_fft, w)]


def phase_kernel(smi, fe, dft):
    rng = np.random.default_rng(0)
    res = {}
    # hop 300 (n_fft 600: radices 4 2 3 5 5, 4-frame runs) and hop 1200
    # (n_fft 2400: 4 4 2 3 5 5, 1-frame runs) reach the radix-2 pass
    name = fe.cfg.window
    other = {h: (hopper_stft.fft_plan(analysis_window(name, 2 * h, 2 * h), "cuda"),
                 window_dft(name, 2 * h, 2 * h)) for h in (300, 1200)}
    for tag, (B, T), hop in (("serving", (16, 800), HOP), ("ragged", (3, 803), HOP),
                             ("pair", (1, 2), HOP), ("run_tail", (2, 1201), HOP),
                             ("hop300", (2, 403), 300), ("hop1200", (2, 201), 1200),
                             ("flat", (2, 204), HOP)):
        plan, mats = other[hop] if hop != HOP else (fe.fft, dft)
        a = foa_audio(rng, (B, T, hop, 4))
        a[:, 0] = rng.uniform(-0.5, 0.5, (B, hop, 4))  # t=0 reflect block
        if tag == "flat":  # (B, N, 4), N = 203 hops + 17: not a multiple of the hop
            a = np.ascontiguousarray(a.reshape(B, -1, 4)[:, :203 * hop + 17])
        x = torch.tensor(a, device="cuda")
        kr, ki = hopper_stft.stft_hop_blocks(x, plan)
        # the flat case's reference is the plain flat framing of the same samples
        pr, pi = (plain_stft.framed_dft_flat(x, *mats, hop) if tag == "flat"
                  else plain_stft.stft(x, *mats, hop))
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
        row = {"phase": "kernel", "case": tag, "shape": list(a.shape),
               "radices": list(plan.radices),
               "max_abs_err": max(e for e, _ in errs.values()),
               "max_abs_plain": max(s for _, s in errs.values()),
               "tol_rel": KERNEL_TOL}
        if tag == "serving":
            # the library yardstick: torch.stft (cuFFT) over the B*4
            # channels as flat signals, centred with reflect padding; its
            # first T frames are this function
            xs = x.reshape(B, T * HOP, 4).permute(0, 2, 1).reshape(B * 4, T * HOP).contiguous()
            win = torch.as_tensor(analysis_window(fe.cfg.window, fe.cfg.win_length,
                                                  fe.cfg.n_fft), device="cuda")

            def library():
                return torch.stft(xs, n_fft=2 * HOP, hop_length=HOP, window=win,
                                  center=True, pad_mode="reflect", return_complex=True)

            lib = library()[..., :T].reshape(B, 4, HOP + 1, T).permute(0, 3, 2, 1)
            pr, pi = plain_stft.stft(x, *dft, HOP)
            scale = float(torch.maximum(pr.abs().max(), pi.abs().max()))
            lib_err = float(torch.maximum((lib.real - pr).abs().max(),
                                          (lib.imag - pi).abs().max()))
            require(lib_err <= LIBRARY_TOL * scale,
                    f"torch.stft is not the STFT's function: {lib_err} > {LIBRARY_TOL} * {scale}")
            del lib, pr, pi
            k_ms, p_ms, l_ms = [], [], []
            for _ in range(3):  # in turns: kernel, plain, library, ...
                k_ms += cuda_ms(lambda: hopper_stft.stft_hop_blocks(x, fe.fft), 10)
                p_ms += cuda_ms(lambda: plain_stft.stft(x, *dft, HOP), 10)
                l_ms += cuda_ms(library, 10)
            # the bound counts the function's least work: a real FFT per
            # frame and channel, 2.5 n log2 n FLOP (+ the window), audio in
            # and re/im out
            K, n_fft = HOP + 1, 2 * HOP
            fft_flop = B * T * 4 * (2.5 * n_fft * np.log2(n_fft) + n_fft)
            nbytes = 4.0 * (B * T * HOP * 4 + n_fft + 2 * B * T * K * 4)
            row.update({"ms": float(np.median(k_ms)), "plain_ms": float(np.median(p_ms)),
                        "library_ms": float(np.median(l_ms)), "library": "torch.stft",
                        "library_max_abs_err": lib_err, **bound(fft_flop, nbytes),
                        "runs": len(k_ms), "gb_s": nbytes / (np.median(k_ms) * 1e-3) / 1e9,
                        "card": smi})
            # device time a call, from the profiler: the kernel's own group;
            # for torch.stft, all it launches
            row.update(device_fields(lambda: hopper_stft.stft_hop_blocks(x, fe.fft), library,
                                     row["bound_ms"], row["ms"], row["library_ms"]))
            del xs
        res[tag] = row
        emit(row)
        del x
    res["frames"] = phase_kernel_frames(smi, rng, fe.cfg.window)
    return res


# (n_fft, hop, win_length) of the frames kernel's cases: the DCASE
# baseline's 2048 / 600 / 1200, a power-of-two n_fft equal to the window,
# a 2400 window in its own n_fft, 48-kHz audio's 2400 window in 4096; G3,
# G4 and G5 (GEOMETRY, prime passes at G3 and G5); shared_wide at one span
# slot, 8192; route four_step at 9600, 96-kHz audio's 100-ms window (120 x
# 80); and the global route (two launches) at 2402 = 2 x 1201 and the prime
# 7919 (Bluestein, 7919 in two output blocks), 11274 = 6 x 1879 (Bluestein
# columns) and 16384 (128 x 128); and the whole-frame Bluestein at the prime
# 14087
OTHER_GEOMETRIES = ((OTHER_N_FFT, HOP, OTHER_WIN), (1024, HOP, 1024), (2400, HOP, 2400),
                    (4096, 2 * HOP, 2400), GEOMETRY["G3"][:3], GEOMETRY["G4"][:3],
                    GEOMETRY["G5"][:3], (2402, 1201, 2402), (8192, 2048, 8192),
                    (7919, 1980, 7919), (9600, 2400, 9600), (11274, 4000, 11274),
                    (16384, 4096, 16384), (14087, 3522, 14087))


def frames_row(smi, rng, window, tag, n_fft, hop, win, sr):
    """The frames kernel at one timed geometry, 16 x 20 s of audio at
    ``sr``: within KERNEL_TOL x max of the plain flat framing; single calls
    (CUDA events, in turns with the plain version and ``torch.stft``), the
    profiler's device time a call of each, checked, and the byte bound.
    ``torch.stft`` pads the right edge by reflection where JAX pads zeros,
    so it is held to the function on the frames before the last."""
    plan = hopper_stft.fft_plan(analysis_window(window, win, n_fft), "cuda")
    mats = window_dft(window, win, n_fft)
    x = foa_audio_cuda(int(rng.integers(1 << 31)), (16, 20 * sr, 4))
    B, N = x.shape[:2]
    T, K = N // hop, n_fft // 2 + 1
    kr, ki = hopper_stft.stft_hop_blocks(x, plan, hop)
    pr, pi = plain_stft.framed_dft_flat(x, *mats, hop)
    err = max(float((kr - pr).abs().max()), float((ki - pi).abs().max()))
    scale = max(float(pr.abs().max()), float(pi.abs().max()))
    require(np.isfinite(err) and err <= KERNEL_TOL * scale,
            f"STFT frames kernel {tag} at {(B, N, 4)}: max err {err} > {KERNEL_TOL} * {scale}")
    del kr, ki
    xs = x.permute(0, 2, 1).reshape(B * 4, N).contiguous()
    win_t = torch.as_tensor(analysis_window(window, win, n_fft), device="cuda")

    def library():
        return torch.stft(xs, n_fft=n_fft, hop_length=hop, window=win_t, center=True,
                          pad_mode="reflect", return_complex=True)

    lib = library()[..., :T].reshape(B, 4, K, T).permute(0, 3, 2, 1)
    lib_err = float(torch.maximum((lib.real - pr)[:, :T - 1].abs().max(),
                                  (lib.imag - pi)[:, :T - 1].abs().max()))
    require(lib_err <= LIBRARY_TOL * scale,
            f"torch.stft is not the STFT's function before the last frame at {tag}: {lib_err} "
            f"> {LIBRARY_TOL} * {scale}")
    del lib, pr, pi
    k_ms, p_ms, l_ms = [], [], []
    plain_runs = 10 if n_fft <= 4800 else 1  # the plain contraction takes 0.2-0.4 s above
    for _ in range(3):  # in turns: kernel, plain, library, ...
        k_ms += cuda_ms(lambda: hopper_stft.stft_hop_blocks(x, plan, hop), 10)
        p_ms += cuda_ms(lambda: plain_stft.framed_dft_flat(x, *mats, hop), plain_runs)
        l_ms += cuda_ms(library, 10)
    # the function's least work: a real FFT per frame and channel, audio in
    # once, re/im out once
    fft_flop = B * T * 4 * (2.5 * n_fft * np.log2(n_fft) + n_fft)
    nbytes = 4.0 * (B * N * 4 + 3 * n_fft + 2 * B * T * K * 4)
    cfg = hopper_stft.frames_config(n_fft, hop)
    route = {"route": hopper_stft.FRAME_ROUTES[cfg.route], "frames_a_tile": cfg.frames,
             "span_slots": cfg.ring, "smem_bytes": cfg.smem_bytes}
    if cfg.route == hopper_stft.FRAME_ROUTES.index("global"):
        g = hopper_stft.global_config(n_fft)
        route.update({"n1": g.n1, "n2": g.n2, "columns_a_unit": g.cols, "rows_a_unit": g.rows,
                      "bluestein": {"q": g.q, "m_len": g.m_len, "blocks": g.blocks,
                                    "whole_frame_output_blocks": g.segments} if g.q
                      else None, "input_slots": [g.ring_cols, g.ring_rows],
                      "smem_bytes": [g.smem_cols, g.smem_rows]})
    row = {"phase": "kernel", "case": "frames_serving" if tag == "G1" else f"frames_{tag}",
           "shape": [B, N, 4], "geometry": {"n_fft": n_fft, "hop": hop, "win_length": win,
                                            "sr": sr},
           "radices": list(plan.frames_radices), "kernels": hopper_stft.kernels_of(n_fft, hop),
           "frames_route": route,
           "max_abs_err": err, "max_abs_plain": scale,
           "tol_rel": KERNEL_TOL, "ms": float(np.median(k_ms)),
           "plain_ms": float(np.median(p_ms)), "library_ms": float(np.median(l_ms)),
           "library": "torch.stft", "library_max_abs_err_before_last_frame": lib_err,
           **bound(fft_flop, nbytes), "runs": len(k_ms),
           "gb_s": nbytes / (np.median(k_ms) * 1e-3) / 1e9, "card": smi}
    row.update(device_fields(lambda: hopper_stft.stft_hop_blocks(x, plan, hop), library,
                             row["bound_ms"], row["ms"], row["library_ms"]))
    emit(row)
    del x, xs
    return row


def phase_kernel_frames(smi, rng, window):
    """K1's frames kernel (every geometry but the hop-block kernel's)
    against the plain flat framing ``framed_dft_flat`` of the same samples,
    within KERNEL_TOL x max: (2, 203 hops + 17, 4) at each of
    OTHER_GEOMETRIES, with the launches ``hopper_stft.kernels_of`` names;
    then the timed rows at G1 (``frames_serving``), G3, G5 and G4
    (:func:`frames_row`).  G1's row is the kernel's headline; the others
    stand under ``geometries``."""
    res = {"max_abs_err": 0.0}
    first = counts()
    for n_fft, hop, win in OTHER_GEOMETRIES:
        plan = hopper_stft.fft_plan(analysis_window(window, win, n_fft), "cuda")
        mats = window_dft(window, win, n_fft)
        a = foa_audio(rng, (2, 203 * hop + 17, 4))
        a[:, :n_fft] = rng.uniform(-0.5, 0.5, (2, n_fft, 4))  # the reflected left edge
        x = torch.tensor(a, device="cuda")
        before = counts()
        kr, ki = hopper_stft.stft_hop_blocks(x, plan, hop)
        torch.cuda.synchronize()
        grown = {n: c - before[n] for n, c in counts().items()}
        require(grown == expected_counts(n_fft, hop),
                f"STFT frames kernel {n_fft}/{hop}: launches {grown}, want "
                f"{expected_counts(n_fft, hop)}")
        pr, pi = plain_stft.framed_dft_flat(x, *mats, hop)
        err = max(float((kr - pr).abs().max()), float((ki - pi).abs().max()))
        scale = max(float(pr.abs().max()), float(pi.abs().max()))
        require(kr.shape == (2, 203, n_fft // 2 + 1, 4) and np.isfinite(err)
                and err <= KERNEL_TOL * scale,
                f"STFT frames kernel {n_fft}/{hop}/{win}: shape {tuple(kr.shape)}, max err "
                f"{err} > {KERNEL_TOL} * {scale}")
        res["max_abs_err"] = max(res["max_abs_err"], err)
        cfg = hopper_stft.frames_config(n_fft, hop)
        emit({"phase": "kernel", "case": f"frames_{n_fft}_{hop}_{win}", "shape": list(a.shape),
              "radices": list(plan.frames_radices), "launches": grown,
              "frames_route": hopper_stft.FRAME_ROUTES[cfg.route], "max_abs_err": err,
              "max_abs_plain": scale, "tol_rel": KERNEL_TOL})
        del x, kr, ki, pr, pi, mats
    res["launches"] = {n: c - first[n] for n, c in counts().items()}

    res["geometries"] = {}
    for tag, (n_fft, hop, win, sr) in TIMED_FRAMES.items():
        row = frames_row(smi, rng, window, tag, n_fft, hop, win, sr)
        res["max_abs_err"] = max(res["max_abs_err"], row["max_abs_err"])
        keep = {n: row[n] for n in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                                    "geometry", "frames_route", "radices", "kernels")
                + DEVICE_KEYS}
        if tag == "G1":
            res.update(keep)
        else:
            res["geometries"][tag] = {**keep, "max_abs_err": row["max_abs_err"]}
    return res


def attn_flop(H, T, lens, per=4):
    """FLOP of attention over the valid keys: ``per`` x T x L x 64 for each
    (b, h); 4 forward (q.k and p.v), 10 backward (s recomputed, dO.v, dq,
    dk, dv)."""
    return float(per) * H * T * float(np.sum(lens)) * 64


def attn_bytes(B, T, H, lens, q_rows, kv_reads, kv_writes=0, stats=0, el=4):
    """Bytes attention must move: ``q_rows`` full (B, T, H, 64) tensors
    (q, out, dO, dq), ``kv_reads`` key-side tensors over the valid keys
    only, ``kv_writes`` full key-side outputs (dk, dv), all of ``el`` bytes
    an element; ``stats`` (B, H, T) float32 rows (the logsumexp), and
    kv_len."""
    row = float(el) * H * 64
    return (row * (q_rows * B * T + kv_reads * float(np.sum(lens)) + kv_writes * B * T)
            + 4.0 * (B * H * T * stats + B))


def sdpa(q, k, v, kv, dropout_p=0.0):
    """One ``F.scaled_dot_product_attention`` call on the same (B, T, H, dh)
    inputs (transposed views) with a boolean key mask: the library yardstick,
    timed here and used nowhere in the port."""
    T = q.shape[1]
    mask = (torch.arange(T, device=q.device)[None, :] < kv[:, None])[:, None, None, :]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                  dropout_p=dropout_p)


def phase_attn_kernel(smi):
    """The attention kernel against the plain attention, per route."""
    torch.backends.cuda.matmul.allow_tf32 = False  # plain version in fp32
    rng = np.random.default_rng(3)
    lens16 = rng.integers(1, 801, 16)
    lens16[3] = 0  # a batch row with no valid key
    # timed: "kernels" = the times of the kernels line, "extra" = timed beside it
    cases = (("k2", 16, 800, [800] * 16, "kernels"), ("k2", 16, 800, lens16, None),
             ("k2", 1, 1200, [920], "extra"), ("k2", 1, 2400, [1400], None),
             ("k4", 1, 4800, [3000], "kernels"), ("k4", 1, 9600, [8000], None))
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
            library = sdpa(q, k, v, kv)
            lib_err = float((library().transpose(1, 2) - want).abs().max())
            require(lib_err <= LIBRARY_TOL * scale,
                    f"SDPA is not attention {rt}'s function: {lib_err} > {LIBRARY_TOL} * {scale}")
            k_ms, p_ms, l_ms = [], [], []
            for _ in range(3):  # in turns: kernel, plain, library, ...
                k_ms += cuda_ms(lambda: hopper_attention.flash_attention(q, k, v, kv), 10)
                p_ms += cuda_ms(lambda: attention.mhsa_attention(q, k, v, kv), 10)
                l_ms += cuda_ms(library, 10)
            flop = attn_flop(4, T, lens)
            row.update({"ms": float(np.median(k_ms)), "plain_ms": float(np.median(p_ms)),
                        "library_ms": float(np.median(l_ms)),
                        "library": "F.scaled_dot_product_attention",
                        "library_max_abs_err": lib_err,
                        **attn_bound(flop, attn_bytes(B, T, 4, lens, q_rows=2, kv_reads=2)),
                        "runs": len(k_ms),
                        "tflops": flop / (np.median(k_ms) * 1e-3) / 1e12,
                        "plain_tflops": flop / (np.median(p_ms) * 1e-3) / 1e12,
                        "card": smi})
            row.update(device_fields(lambda: hopper_attention.flash_attention(q, k, v, kv),
                                     library, row["bound_ms"], row["ms"], row["library_ms"]))
            if timed == "kernels":
                res[rt].update({n: row[n] for n in ("ms", "plain_ms", "library_ms", "bound_ms",
                                                    "bound_by", "bound_units",
                                                    "bound_ffma_ms") + DEVICE_KEYS})
        emit(row)
        del q, k, v, got, want

    # eval on the long route with q/k/v that require grad, outside no_grad:
    # route k4 all the same, the no-grad output, and a backward that raises
    q, k, v = (torch.tensor(rng.standard_normal((1, 4800, 4, 64)), dtype=torch.float32,
                            device="cuda") for _ in range(3))
    kv = torch.tensor([3000], dtype=torch.int32, device="cuda")
    with torch.no_grad():
        want = hopper_attention.flash_attention(q, k, v, kv)
    args = [x.clone().requires_grad_(True) for x in (q, k, v)]
    before = dict(hopper_attention.LAUNCHES)
    got = hopper_attention.flash_attention(*args, kv)
    torch.cuda.synchronize()
    grown = {n: c - before[n] for n, c in hopper_attention.LAUNCHES.items()}
    require(grown == {**{n: 0 for n in grown}, "k4": 1},
            f"attention k4 with grad: launches {grown}, want k4 once")
    require(got.requires_grad and bool(torch.equal(got.detach(), want)),
            "attention k4 with grad differs from the no-grad call")
    try:
        got.sum().backward()
        raised = False
    except NotImplementedError:
        raised = True
    require(raised, "a backward through route k4 did not raise")
    emit({"phase": "attn_kernel", "route": "k4", "case": "grad_enabled",
          "shape": [1, 4800, 4, 64], "kv_len": [3000], "launches": grown,
          "equal_to_no_grad": True, "backward_raises": True})
    return res


def phase_attn_train_kernel(smi):
    """Routes k2_dropout (forward) and k3 (backward) against the plain
    attention and its written-out backward at rate 0.2: (16, 800, 4, 64)
    with all keys valid (also timed) and with random kv_len and one row at
    0; (1, 1200) len 920 and (1, 2400) len 1400, checked for error only."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(4)
    H = 4
    thresh = attention.dropout_thresh(RATE)
    seed = torch.tensor([int(rng.integers(-2 ** 31, 2 ** 31))], dtype=torch.int32,
                        device="cuda")
    lens_r = rng.integers(1, 800 + 1, 16)
    lens_r[5] = 0
    res = {"k2_dropout": {"max_abs_err": 0.0}, "k3": {"max_abs_err": 0.0}}
    for tag, B, T, lens in (("full", 16, 800, [800] * 16), ("ragged", 16, 800, lens_r),
                            ("long", 1, 1200, [920]), ("longer", 1, 2400, [1400])):
        q, k, v, do = (torch.tensor(rng.standard_normal((B, T, H, 64)), dtype=torch.float32,
                                    device="cuda") for _ in range(4))
        kv = torch.tensor(np.asarray(lens), dtype=torch.int32, device="cuda")
        args = [x.clone().requires_grad_(True) for x in (q, k, v)]
        out = hopper_attention.flash_attention(*args, kv, rate=RATE, seed=seed)
        grads = torch.autograd.grad(out, args, do, retain_graph=True)
        want = attention.mhsa_attention(q, k, v, kv, rate=RATE, seed=seed)
        wgrads = attention.mhsa_attention_bwd(q, k, v, kv, do, rate=RATE, seed=seed)
        torch.cuda.synchronize()
        row = {"phase": "attn_train_kernel", "case": tag, "shape": [B, T, H, 64],
               "rate": RATE, "thresh": thresh,
               "kv_len": [int(n) for n in lens] if B == 1 else
               {"min": int(min(lens)), "max": int(max(lens))}}
        err = float((out.detach() - want).abs().max())
        scale = float(want.abs().max())
        require(bool(torch.isfinite(out).all()) and err <= KERNEL_TOL * scale,
                f"k2_dropout {tag}: max err {err} > {KERNEL_TOL} * {scale}")
        row.update(max_abs_err=err, max_abs_plain=scale, tol_rel=KERNEL_TOL)
        res["k2_dropout"]["max_abs_err"] = max(res["k2_dropout"]["max_abs_err"], err)
        for name, g, w in zip(("dq", "dk", "dv"), grads, wgrads):
            gerr = float((g - w).abs().max())
            gscale = float(w.abs().max())
            require(bool(torch.isfinite(g).all()) and gerr <= GRAD_KERNEL_TOL * gscale,
                    f"k3 {tag} {name}: max err {gerr} > {GRAD_KERNEL_TOL} * {gscale}")
            row[name] = {"max_abs_err": gerr, "max_abs_plain": gscale}
            res["k3"]["max_abs_err"] = max(res["k3"]["max_abs_err"], gerr)
        for b, n in enumerate(lens):
            if n == 0:
                require(bool((out[b] == 0).all()) and all(bool((g[b] == 0).all())
                                                          for g in grads),
                        f"k2_dropout/k3 {tag}: the kv_len 0 row is not 0")
        row["grad_tol_rel"] = GRAD_KERNEL_TOL
        if tag == "long":  # the forward at B = 1, timed beside SDPA with dropout
            lib_fwd = sdpa(q, k, v, kv, dropout_p=RATE)
            k_ms, p_ms, l_ms = [], [], []
            for _ in range(3):  # in turns: kernel, plain, library, ...
                k_ms += cuda_ms(lambda: hopper_attention.flash_attention(
                    q, k, v, kv, rate=RATE, seed=seed), 10)
                p_ms += cuda_ms(lambda: attention.mhsa_attention(q, k, v, kv, rate=RATE,
                                                                 seed=seed), 10)
                l_ms += cuda_ms(lib_fwd, 10)
            row.update(ms={"kernel_fwd": float(np.median(k_ms)),
                           "plain_fwd": float(np.median(p_ms)),
                           "library_fwd": float(np.median(l_ms))},
                       runs=len(k_ms),
                       **attn_bound(attn_flop(H, T, lens, 4),
                                    attn_bytes(B, T, H, lens, q_rows=2, kv_reads=2, stats=1)),
                       card=smi)
        if tag == "full":
            share = float((attention.dropout_bits(B, H, T, seed) >= (thresh << 24))
                          .float().mean())
            require(abs(share - (256 - thresh) / 256) <= 0.005,
                    f"keep share {share}, want {(256 - thresh) / 256} +- 0.005")
            with torch.no_grad():
                eval_out = hopper_attention.flash_attention(q, k, v, kv)
            rate0 = hopper_attention.flash_attention(*args, kv, rate=0.0)
            err0 = float((rate0.detach() - eval_out).abs().max())
            require(err0 <= KERNEL_TOL * float(eval_out.abs().max()),
                    f"k2_dropout at rate 0 vs k2: {err0}")
            row.update(keep_share=share, rate0_vs_k2=err0)

            # times: forward, backward, both; kernel, plain, library in turns
            sdpa_args = [x.clone().requires_grad_(True) for x in (q, k, v)]
            lib_fwd = sdpa(*sdpa_args, kv, dropout_p=RATE)
            lib_out = lib_fwd()
            do_t = do.transpose(1, 2)
            fns = {
                "kernel_fwd": lambda: hopper_attention.flash_attention(
                    *args, kv, rate=RATE, seed=seed),
                "kernel_bwd": lambda: torch.autograd.grad(out, args, do, retain_graph=True),
                "kernel_fwd_bwd": lambda: torch.autograd.grad(
                    hopper_attention.flash_attention(*args, kv, rate=RATE, seed=seed),
                    args, do),
                "plain_fwd": lambda: attention.mhsa_attention(q, k, v, kv, rate=RATE,
                                                              seed=seed),
                "plain_bwd": lambda: attention.mhsa_attention_bwd(q, k, v, kv, do,
                                                                  rate=RATE, seed=seed),
                "library_fwd": lib_fwd,
                "library_bwd": lambda: torch.autograd.grad(lib_out, sdpa_args, do_t,
                                                           retain_graph=True),
                "library_fwd_bwd": lambda: torch.autograd.grad(lib_fwd(), sdpa_args, do_t),
            }
            ms = {n: [] for n in fns}
            for _ in range(3):
                for n, fn in fns.items():
                    ms[n] += cuda_ms(fn, 10)
            ms = {n: float(np.median(t)) for n, t in ms.items()}
            fl_f, fl_b = attn_flop(H, T, lens, 4), attn_flop(H, T, lens, 10)
            res["k2_dropout"].update(
                ms=ms["kernel_fwd"], plain_ms=ms["plain_fwd"], library_ms=ms["library_fwd"],
                **attn_bound(fl_f, attn_bytes(B, T, H, lens, q_rows=2, kv_reads=2, stats=1)))
            res["k3"].update(
                ms=ms["kernel_bwd"], plain_ms=ms["plain_bwd"], library_ms=ms["library_bwd"],
                **attn_bound(fl_b, attn_bytes(B, T, H, lens, q_rows=4, kv_reads=2,
                                              kv_writes=2, stats=1)))
            # device time a call: the kernels' own groups; for SDPA, all it launches
            dev = {rt: device_fields(fns[f"kernel_{p}"], fns[f"library_{p}"],
                                     res[rt]["bound_ms"], ms[f"kernel_{p}"], ms[f"library_{p}"])
                   for rt, p in (("k2_dropout", "fwd"), ("k3", "bwd"))}
            for rt, d in dev.items():
                res[rt].update({n: d[n] for n in DEVICE_KEYS})
            row.update(ms=ms, runs=30, device=dev, card=smi)
            row.update(tflops_fwd=fl_f / (ms["kernel_fwd"] * 1e-3) / 1e12,
                       tflops_bwd=fl_b / (ms["kernel_bwd"] * 1e-3) / 1e12)
            del sdpa_args, lib_out
        emit(row)
        del q, k, v, do, args, out, grads, want, wgrads
    return res


def bf16_truth(q, k, v, kv, do, seed, heads=None):
    """Attention and its gradients in float64 on the same bf16 inputs."""
    a = [x.double() for x in (q, k, v)]
    return (attention.mhsa_attention(*a, kv, rate=RATE, seed=seed, heads=heads),
            *attention.mhsa_attention_bwd(*a, kv, do.double(), rate=RATE, seed=seed,
                                          heads=heads))


def bf16_vs_truth(tag, got, plain, truth, lens):
    """The bf16 pair's ``got`` (out, dq, dk, dv) against float64 ``truth``:
    each kernel error at most BF16_RATIO x the plain version's plus
    BF16_HALF_STEP x max|truth| over the rows with keys, and the kv_len = 0
    rows zeros.  Returns each output's errors."""
    rows = [b for b, n in enumerate(lens) if n > 0]
    res = {}
    for name, g, p, t in zip(("out", "dq", "dk", "dv"), got, plain, truth):
        require(g.dtype == torch.bfloat16 and bool(torch.isfinite(g).all()),
                f"bf16 {name} {tag}: dtype {g.dtype} or not finite")
        err = float((g.double()[rows] - t[rows]).abs().max())
        err_p = float((p.double()[rows] - t[rows]).abs().max())
        scale = float(t[rows].abs().max())
        require(err <= BF16_RATIO * err_p + BF16_HALF_STEP * scale,
                f"bf16 {name} {tag}: kernel err {err} > {BF16_RATIO} * plain err "
                f"{err_p} + {BF16_HALF_STEP} * {scale}")
        for b, n in enumerate(lens):
            if n == 0:
                require(bool((g[b] == 0).all()), f"bf16 {name} {tag}: kv_len 0 row not 0")
        res[name] = {"max_abs_err": err, "plain_max_abs_err": err_p, "max_abs_truth": scale}
    return res


# The H100's issue rates beside its tensor cores, assumed from the
# architecture (not measured), at the 1.83 GHz clock its 989 TFLOP/s
# assume: ex2 on the MUFU pipe, 16 a clock an SM; 32-bit integer
# operations (IMAD, shifts, LOP3), 64 a clock an SM.
MUFU_EX2_S = 132 * 16 * 1.83e9
INT32_OPS_S = 132 * 64 * 1.83e9
KEEP_HASH_OPS = 8  # the kernels' keep test a (query, key): add, 2 x (shift, xor, IMAD), compare


def phase_attn_train_bf16_kernel(smi):
    """Routes k2_dropout_bf16 (forward) and k3_bf16 (backward; bf16 wgmma
    fed by TMA) against the plain bf16 attention and its written-out
    backward at rate 0.2: (16, 800, 4, 64) with all keys valid (timed) and
    with random kv_len and one row at 0, and (1, 1200) len 920, which runs
    in key splits and a merge.  Kernel and plain version are each measured
    against float64 on the same bf16 inputs: the kernel's max|error| at
    most BF16_RATIO x the plain version's plus BF16_HALF_STEP x max|truth|,
    over the rows with keys; the kv_len = 0 row is zeros; a second backward
    on the same inputs gives the same dq, dk, dv bit for bit.  Timed at
    (16, 800): single calls between two CUDA events (``ms``) and device
    time a call from the profiler (``device_ms``), each beside SDPA's; and,
    in the phase's row only, the floors of the exp2 (MUFU) and keep-hash
    (integer) work, computed from the assumed issue rates below."""
    rng = np.random.default_rng(8)
    H = 4
    seed = torch.tensor([int(rng.integers(-2 ** 31, 2 ** 31))], dtype=torch.int32,
                        device="cuda")
    lens_r = rng.integers(1, 800 + 1, 16)
    lens_r[2] = 0
    res = {"k2_dropout_bf16": {"max_abs_err": 0.0}, "k3_bf16": {"max_abs_err": 0.0}}
    for tag, B, T, lens in (("full", 16, 800, [800] * 16), ("ragged", 16, 800, lens_r),
                            ("split", 1, 1200, [920])):
        q, k, v, do = (torch.tensor(rng.standard_normal((B, T, H, 64)), dtype=torch.float32,
                                    device="cuda").bfloat16() for _ in range(4))
        kv = torch.tensor(np.asarray(lens), dtype=torch.int32, device="cuda")
        args = [x.clone().requires_grad_(True) for x in (q, k, v)]
        before = counts()
        out = hopper_attention.flash_attention(*args, kv, rate=RATE, seed=seed)
        grads = torch.autograd.grad(out, args, do, retain_graph=True)
        torch.cuda.synchronize()
        grown = {n: c - before[n] for n, c in counts().items()}
        require(grown == {**{n: 0 for n in grown}, "k2_dropout_bf16": 1, "k3_bf16": 1},
                f"attn_train_bf16_kernel {tag}: launches {grown}")
        again = torch.autograd.grad(out, args, do, retain_graph=True)
        require(all(torch.equal(a, b) for a, b in zip(grads, again)),
                f"attn_train_bf16_kernel {tag}: the backward is not deterministic")
        plain = [attention.mhsa_attention(q, k, v, kv, rate=RATE, seed=seed),
                 *attention.mhsa_attention_bwd(q, k, v, kv, do, rate=RATE, seed=seed)]
        truth = bf16_truth(q, k, v, kv, do, seed)
        row = {"phase": "attn_train_bf16_kernel", "case": tag, "shape": [B, T, H, 64],
               "rate": RATE, "kv_len": [int(n) for n in lens] if B == 1 else
               {"min": int(min(lens)), "max": int(max(lens))},
               "tol": {"ratio": BF16_RATIO, "half_step": BF16_HALF_STEP}}
        row.update(bf16_vs_truth(tag, (out.detach(), *grads), plain, truth, lens))
        for name in ("out", "dq", "dk", "dv"):
            rt = "k2_dropout_bf16" if name == "out" else "k3_bf16"
            res[rt]["max_abs_err"] = max(res[rt]["max_abs_err"], row[name]["max_abs_err"])
        if tag == "full":
            # SDPA on the same bf16 inputs computes the function (no dropout)
            library0 = sdpa(q, k, v, kv)
            lib_err = float((library0().transpose(1, 2).double()
                             - attention.mhsa_attention(q, k, v, kv).double()).abs().max())
            require(lib_err <= BF16_LIBRARY_TOL * float(truth[0].abs().max()),
                    f"SDPA bf16 is not the attention's function: {lib_err}")
            sdpa_args = [x.clone().requires_grad_(True) for x in (q, k, v)]
            lib_fwd = sdpa(*sdpa_args, kv, dropout_p=RATE)
            lib_out = lib_fwd()
            do_t = do.transpose(1, 2)
            fns = {
                "kernel_fwd": lambda: hopper_attention.flash_attention(
                    *args, kv, rate=RATE, seed=seed),
                "kernel_bwd": lambda: torch.autograd.grad(out, args, do, retain_graph=True),
                "kernel_fwd_bwd": lambda: torch.autograd.grad(
                    hopper_attention.flash_attention(*args, kv, rate=RATE, seed=seed),
                    args, do),
                "plain_fwd": lambda: attention.mhsa_attention(q, k, v, kv, rate=RATE,
                                                              seed=seed),
                "plain_bwd": lambda: attention.mhsa_attention_bwd(q, k, v, kv, do,
                                                                  rate=RATE, seed=seed),
                "library_fwd": lib_fwd,
                "library_bwd": lambda: torch.autograd.grad(lib_out, sdpa_args, do_t,
                                                           retain_graph=True),
                "library_fwd_bwd": lambda: torch.autograd.grad(lib_fwd(), sdpa_args, do_t),
            }
            ms = {n: [] for n in fns}
            for _ in range(3):
                for n, fn in fns.items():
                    ms[n] += cuda_ms(fn, 10)
            ms = {n: float(np.median(t)) for n, t in ms.items()}
            fl_f, fl_b = attn_flop(H, T, lens, 4), attn_flop(H, T, lens, 10)
            by_f = attn_bytes(B, T, H, lens, q_rows=2, kv_reads=2, stats=1, el=2)
            by_b = attn_bytes(B, T, H, lens, q_rows=4, kv_reads=2, kv_writes=2, stats=1, el=2)
            elems = H * T * float(np.sum(lens))  # (query, key) pairs a pass
            floors = {p: {"floor_exp2_ms": p * elems / MUFU_EX2_S * 1e3,
                          "floor_hash_ms": p * elems * KEEP_HASH_OPS / INT32_OPS_S * 1e3}
                      for p in (1, 2)}  # the forward's pass, the backward's two
            res["k2_dropout_bf16"].update(ms=ms["kernel_fwd"], plain_ms=ms["plain_fwd"],
                                          library_ms=ms["library_fwd"], **bf16_bound(fl_f, by_f))
            res["k3_bf16"].update(ms=ms["kernel_bwd"], plain_ms=ms["plain_bwd"],
                                  library_ms=ms["library_bwd"], **bf16_bound(fl_b, by_b))
            # device time a call: the kernels' own groups; for SDPA, all it launches
            dev = {rt: device_fields(fns[f"kernel_{p}"], fns[f"library_{p}"],
                                     res[rt]["bound_ms"], ms[f"kernel_{p}"], ms[f"library_{p}"])
                   for rt, p in (("k2_dropout_bf16", "fwd"), ("k3_bf16", "bwd"))}
            for rt, d in dev.items():
                res[rt].update({n: d[n] for n in DEVICE_KEYS})
            row.update(ms=ms, runs=30, library="F.scaled_dot_product_attention (bf16, "
                       "dropout_p 0.2)", library_max_abs_err_rate0=lib_err,
                       tflops_fwd=fl_f / (ms["kernel_fwd"] * 1e-3) / 1e12,
                       tflops_bwd=fl_b / (ms["kernel_bwd"] * 1e-3) / 1e12,
                       bound_fwd_ms=res["k2_dropout_bf16"]["bound_ms"],
                       bound_bwd_ms=res["k3_bf16"]["bound_ms"],
                       device=dev, floors_ms={"fwd": floors[1], "bwd": floors[2],
                                  "assumed_per_sm_clock": {"ex2": 16, "int32": 64,
                                                           "ghz": 1.83}}, card=smi)
            del sdpa_args, lib_out
        emit(row)
        del q, k, v, do, args, out, grads, plain, truth
    return res


ORDER_ARG = "--attn-launch-order"  # the argument of phase attn_launch_order's process
ORDER_PLAIN = (1, 9600, 8000)  # the plain attention first: B, T, valid keys
ORDER_TRAIN = (16, 800)  # then the train pairs: B, T


def attn_launch_order_child():
    """Phase attn_launch_order's body, in a process of its own: the plain
    float32 attention at (1, 9600, 4, 64) with 8000 keys valid, which
    leaves ~1.5 GB score blocks in the caching allocator, and then, the
    first kernel calls on autograd's device thread, the bf16 train pair
    (k2_dropout_bf16 + k3_bf16) and the float32 pair (k2_dropout + k3) at
    (16, 800, 4, 64), rate 0.2, all keys valid, through autograd.  The bf16
    pair is held against float64 as in attn_train_bf16_kernel, the float32
    pair against the plain attention and its written-out backward as in
    attn_train_kernel.  Counts are the wrappers' route counts."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(19)
    Bp, Tp, Lp = ORDER_PLAIN
    q, k, v = (torch.tensor(rng.standard_normal((Bp, Tp, 4, 64)), dtype=torch.float32,
                            device="cuda") for _ in range(3))
    big = attention.mhsa_attention(q, k, v, torch.full((Bp,), Lp, dtype=torch.int32,
                                                       device="cuda"))
    torch.cuda.synchronize()
    require(bool(torch.isfinite(big).all()), "attn_launch_order: the plain attention is "
            "not finite")
    del q, k, v, big
    (B, T), H = ORDER_TRAIN, 4
    seed = torch.tensor([int(rng.integers(-2 ** 31, 2 ** 31))], dtype=torch.int32,
                        device="cuda")
    kv = torch.full((B,), T, dtype=torch.int32, device="cuda")
    row = {"phase": "attn_launch_order",
           "before": {"plain_fp32_attention": [Bp, Tp, 4, 64], "kv_len": Lp},
           "shape": [B, T, H, 64], "rate": RATE}
    for dtype, fwd_rt, bwd_rt in ((torch.bfloat16, "k2_dropout_bf16", "k3_bf16"),
                                  (torch.float32, "k2_dropout", "k3")):
        q, k, v, do = (torch.tensor(rng.standard_normal((B, T, H, 64)), dtype=torch.float32,
                                    device="cuda").to(dtype) for _ in range(4))
        args = [x.clone().requires_grad_(True) for x in (q, k, v)]
        before = dict(hopper_attention.LAUNCHES)
        out = hopper_attention.flash_attention(*args, kv, rate=RATE, seed=seed)
        grads = torch.autograd.grad(out, args, do)
        torch.cuda.synchronize()
        grown = {n: c - before[n] for n, c in hopper_attention.LAUNCHES.items()}
        require(grown == {**{n: 0 for n in grown}, fwd_rt: 1, bwd_rt: 1},
                f"attn_launch_order {dtype}: launches {grown}")
        if dtype == torch.bfloat16:
            plain = [attention.mhsa_attention(q, k, v, kv, rate=RATE, seed=seed),
                     *attention.mhsa_attention_bwd(q, k, v, kv, do, rate=RATE, seed=seed)]
            row["bf16"] = {"tol": {"ratio": BF16_RATIO, "half_step": BF16_HALF_STEP},
                           **bf16_vs_truth("attn_launch_order", (out.detach(), *grads), plain,
                                           bf16_truth(q, k, v, kv, do, seed), [T] * B)}
        else:
            want = attention.mhsa_attention(q, k, v, kv, rate=RATE, seed=seed)
            wgrads = attention.mhsa_attention_bwd(q, k, v, kv, do, rate=RATE, seed=seed)
            errs = {}
            for name, g, w, tol in (("out", out.detach(), want, KERNEL_TOL),
                                    *((n, g, w, GRAD_KERNEL_TOL)
                                      for n, g, w in zip(("dq", "dk", "dv"), grads, wgrads))):
                err, scale = float((g - w).abs().max()), float(w.abs().max())
                require(bool(torch.isfinite(g).all()) and err <= tol * scale,
                        f"attn_launch_order fp32 {name}: max err {err} > {tol} * {scale}")
                errs[name] = {"max_abs_err": err, "max_abs_plain": scale, "tol_rel": tol}
            row["fp32"] = errs
        row.setdefault("launches", {}).update({fwd_rt: grown[fwd_rt], bwd_rt: grown[bwd_rt]})
        del q, k, v, do, args, out, grads
    emit(row)


def phase_attn_launch_order(smi):
    """The training attention in a fresh process after a large plain
    attention (:func:`attn_launch_order_child`): the bf16 backward's
    launcher once failed there, the process's history being what made it
    fail, so the phase runs in a process of its own and fails with it."""
    t0 = time.perf_counter()
    child = subprocess.run([sys.executable, os.path.abspath(__file__), ORDER_ARG],
                           capture_output=True, text=True, timeout=600,
                           cwd=os.path.dirname(os.path.abspath(__file__)))
    lines = child.stdout.strip().splitlines()
    require(child.returncode == 0 and lines,
            f"attn_launch_order: the process exited {child.returncode}:\n"
            f"{child.stdout[-4000:]}\n{child.stderr[-4000:]}")
    row = {**json.loads(lines[-1]), "seconds": time.perf_counter() - t0, "card": smi}
    emit(row)
    return row


def synthetic_clips(cfg, rng, B):
    """B 20-s int16 FOA chunks in the hop-block layout (B, 800, 600, 4) and
    each one's AD-YOLO targets, of random events (one to three a label
    frame on 70 % of the frames), from the port's encoder."""
    geom = make_grid_geometry(cfg)
    frames = cfg.data.chunk_label_frames
    per_clip = []
    for _ in range(B):
        label = {}
        for f in range(frames):
            if rng.random() < 0.7:
                label[f] = [[int(rng.integers(cfg.data.nb_classes)), i,
                             float(rng.uniform(-180, 180)), float(rng.uniform(-90, 90))]
                            for i in range(int(rng.integers(1, 4)))]
        per_clip.append(encode_adyolo(label, frames, geom))
    T = cfg.data.chunk_samples // HOP
    return (rng.standard_normal((B, T, HOP, 4)) * 1500).astype(np.int16), per_clip


def clips_batch(cfg, audio, per_clip):
    """The train step's batch of those clips, on the card (targets indexed
    within it, padded to ``max_targets_per_clip`` x its size)."""
    targets, mask = pad_yolo_targets(per_clip, cfg.train.max_targets_per_clip * len(per_clip))
    return {"audio": torch.tensor(audio, device="cuda"),
            "targets": torch.tensor(targets, device="cuda"),
            "target_mask": torch.tensor(mask, device="cuda")}


def synthetic_batch(cfg, rng, B):
    """:func:`synthetic_clips` as one batch on the card."""
    return clips_batch(cfg, *synthetic_clips(cfg, rng, B))


def grads_of(model):
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()}


def profile_steps(step, batches, gen, n):
    """Device time by kernel group over ``n`` steps under torch.profiler, and
    the device's busy and idle share of the host-clock window.  The profile
    must hold the port's kernels that one more, unprofiled step launches
    (``kernels_launched``), or its groups come back void."""
    expect = kernels_launched(lambda: step(batches[0], gen))
    return profile_calls(lambda i: step(batches[i % len(batches)], gen), n, expect=expect)


def phase_train_conformer(smi, cfg, fe):
    """ResNet-Conformer + AD-YOLO train steps at full width, fp32: B = 16 x
    20-s chunks, Adam, dropout 0.2 from one CUDA generator.  The main path:
    TRAIN_STEPS steps with the launch counts set to 0 just before and read
    after each.  Step 1 is held against the same step from the same weights
    and generator seed on the plain attention."""
    B = 16
    rng = np.random.default_rng(5)
    batches = [synthetic_batch(cfg, rng, B) for _ in range(TRAIN_STEPS)]
    model = build_model(cfg, generator=torch.Generator().manual_seed(0), train=True)
    init = {n: t.detach().clone() for n, t in model.state_dict().items()}
    step = build_train_step(cfg, model, fe)
    gen = torch.Generator(device="cuda").manual_seed(1234)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    zero_counts()  # the main path's count starts here
    losses, step_ms, per_step = [], [], []
    for i, b in enumerate(batches):
        before = counts()
        t0 = time.perf_counter()
        loss = float(step(b, gen))  # a device -> host copy: the step is done
        step_ms.append((time.perf_counter() - t0) * 1e3)
        per_step.append({n: c - before[n] for n, c in counts().items()})
        losses.append(loss)
        if i == 0:
            grads1 = grads_of(model)
    launched = counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    require(all(np.isfinite(losses)), f"train_conformer: loss not finite: {losses}")
    for i, n in enumerate(per_step):
        require(n["stft"] == 1 and n["k2_dropout"] == 8 and n["k3"] == 8
                and n["k2"] == 0 and n["k4"] == 0,
                f"train_conformer step {i + 1}: launches {n}, want stft 1, "
                "k2_dropout 8, k3 8")

    # step 1 again from the same weights and generator seed, plain attention
    ref = build_model(cfg, train=True)
    ref.load_state_dict(init)
    ref_step = build_train_step(cfg, ref, fe)
    with plain_attention():
        ref_loss = float(ref_step(batches[0], torch.Generator(device="cuda").manual_seed(1234)))
    ref_grads = grads_of(ref)
    loss_err = abs(losses[0] - ref_loss)
    require(loss_err <= TRAIN_LOSS_TOL * abs(ref_loss),
            f"train_conformer step 1 loss {losses[0]} vs plain {ref_loss}")
    gmax = max(float(g.abs().max()) for g in ref_grads.values())
    grad_err = max(float((grads1[n] - g).abs().max()) for n, g in ref_grads.items())
    require(grad_err <= TRAIN_GRAD_TOL * gmax,
            f"train_conformer step 1 grads: max err {grad_err} > {TRAIN_GRAD_TOL} * {gmax}")
    norm = float(torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g) for g in grads1.values()])))
    ref_norm = float(torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g) for g in ref_grads.values()])))
    require(abs(norm - ref_norm) <= TRAIN_GRAD_TOL * ref_norm,
            f"train_conformer step 1 grad norm {norm} vs plain {ref_norm}")
    del ref, ref_step, ref_grads, grads1

    t = float(np.median(step_ms[1:]))  # step 1 pays cuDNN's first calls
    emit({"phase": "train_conformer", "batch": [B, 800, HOP, 4], "steps": TRAIN_STEPS,
          "losses": losses, "launches": launched, "launches_per_step": per_step,
          "step1_vs_plain": {"loss": [losses[0], ref_loss], "loss_abs_err": loss_err,
                             "grad_max_abs_err": grad_err, "grad_max_abs": gmax,
                             "grad_norm": [norm, ref_norm],
                             "tol": {"loss_rel": TRAIN_LOSS_TOL, "grad_rel": TRAIN_GRAD_TOL}},
          "step_ms": step_ms, "median_step_ms": t,
          "audio_s_per_s": B * 20.0 / (t * 1e-3), "peak_mem_gb": peak_gb, "card": smi})
    # where the time goes: two more steps on the kernels, profiled
    emit({"phase": "train_conformer_profile", **profile_steps(step, batches, gen, 2),
          "card": smi})
    return launched, t


def phase_forward(smi, fe, dft, model, phase):
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
        re, im = plain_stft.stft(x, *dft, HOP)
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
    # where the time goes: two more forwards, profiled
    emit({"phase": phase + "_profile",
          **profile_steps(lambda b, _: fwd(b), [x], None, 2), "card": smi})
    phase_forward_b1(smi, fe, dft, model, fwd, phase)
    return logits


def phase_forward_b1(smi, fe, dft, model, fwd, phase):
    """One 30-s clip, ``cli infer``'s bucket of 1200 frames (B = 1, every
    frame valid): the request a service serves clip by clip.  Its launches
    (K1 once; the conformer's attention 8 times, in key splits and a merge),
    logits against the all-plain forward, the CUDA-event median of 10
    calls, and a profile of 5 more."""
    rng = np.random.default_rng(14)
    x = torch.tensor(foa_audio(rng, (1, 1200, HOP, 4)), device="cuda")
    before = counts()
    logits = fwd(x)
    torch.cuda.synchronize()
    grown = {n: c - before[n] for n, c in counts().items()}
    want = {**{n: 0 for n in grown}, "stft": 1}
    if phase == "forward_conformer":
        want["k2"] = 8
    require(grown == want, f"{phase}_b1: launches {grown}, want {want}")
    require(tuple(logits.shape) == (1, 300, 2560) and bool(torch.isfinite(logits).all()),
            f"{phase}_b1: logits {tuple(logits.shape)}, or not finite")
    with torch.inference_mode(), plain_attention():
        re, im = plain_stft.stft(x, *dft, HOP)
        ref = model(fe.features_from_stft(re, im))
        del re, im
    err = float((logits - ref).abs().max())
    scale = float(ref.abs().max())
    require(err <= FORWARD_TOL * scale,
            f"{phase}_b1 vs the all-plain forward: {err} > {FORWARD_TOL} * {scale}")
    ms = cuda_ms(lambda: fwd(x), 10)
    emit({"phase": phase + "_b1", "shape": [1, 1200, HOP, 4], "launches": grown,
          "max_abs_err": err, "max_abs_logit": scale, "tol_rel": FORWARD_TOL,
          "ms": float(np.median(ms)), "card": smi})
    emit({"phase": phase + "_b1_profile",
          **profile_steps(lambda b, _: fwd(b), [x], None, 5), "card": smi})


def phase_forward_conformer_long(smi, fe, dft, model):
    """The conformer forward on one clip in the 4800-frame bucket with 3000
    frames valid (route k4, in 4 key splits), against the all-plain
    forward; then a ``torch.profiler`` breakdown of two more forwards."""
    fwd = build_eval_forward(model, fe)
    rng = np.random.default_rng(6)
    x = torch.tensor(foa_audio(rng, (1, 4800, HOP, 4)), device="cuda")
    x[:, 3000:] = 0.0  # the bucket's padding
    valid = torch.tensor([3000], dtype=torch.int32, device="cuda")
    zero_counts()
    logits = fwd(x, valid)
    torch.cuda.synchronize()
    launched = counts()
    require(launched["stft"] == 1 and launched["k4"] == 8 and launched["k2"] == 0,
            f"forward_conformer_long: launches {launched}, want stft 1, k4 8")
    require(tuple(logits.shape) == (1, 1200, 2560), f"logits {tuple(logits.shape)}")
    require(bool(torch.isfinite(logits).all()), "non-finite logits")
    with torch.inference_mode(), plain_attention():
        re, im = plain_stft.stft(x, *dft, HOP)
        ref = model(fe.features_from_stft(re, im, valid), valid)
        del re, im
    err = float((logits - ref).abs().max())
    scale = float(ref.abs().max())
    require(err <= FORWARD_TOL * scale,
            f"forward_conformer_long vs the all-plain forward: {err} > {FORWARD_TOL} * {scale}")
    ms = cuda_ms(lambda: fwd(x, valid), 10)
    emit({"phase": "forward_conformer_long", "shape": list(logits.shape),
          "valid_frames": 3000, "launches": launched, "max_abs_err": err,
          "max_abs_logit": scale, "tol_rel": FORWARD_TOL, "ms": float(np.median(ms)),
          "card": smi})
    emit({"phase": "forward_conformer_long_profile",
          **profile_steps(lambda b, _: fwd(b, valid), [x], None, 2), "card": smi})


def other_geometry(cfg, tag="G1"):
    """``cfg`` at STFT geometry ``tag`` of GEOMETRY: G1, the DCASE SELD
    baseline's n_fft 2048 and 1200-sample window at the 600-sample hop (the
    loaders and the export take flat (B, N, 4) audio there); G3, 44.1-kHz
    audio at the preset's 25 / 50 ms (hop 1102, n_fft = window = 2204: flat
    20-s chunks, hop-block eval buckets).  K1 runs its frames kernel."""
    n_fft, hop, win, sr = GEOMETRY[tag]
    return dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, n_fft=n_fft, win_length=win, hop_length=hop, sr=sr))


def phase_forward_other_geometry(smi, cfg, model, tag="G1"):
    """FeatureFrontend + SE-ResNet34 + AD-YOLO (``model``, the phase
    forward's) at geometry ``tag`` (:func:`other_geometry`) on flat 16 x
    20-s clips: K1's frames kernel once, finite (16, 200, 2560) logits
    within FORWARD_TOL x max of the all-plain forward (the plain flat
    framing); the CUDA-event median of 10 forwards and their host p50, and
    a profile of two more, which must hold the frames kernel.  Rows
    ``forward_other_geometry`` (G1) or ``forward_<tag>``."""
    c = other_geometry(cfg, tag)
    phase = "forward_other_geometry" if tag == "G1" else f"forward_{tag}"
    hop = c.data.hop_length
    fe = make_frontend(c)
    fwd = build_eval_forward(model, fe)
    dft = window_dft(c.data.window, c.data.win_length, c.data.n_fft)
    rng = np.random.default_rng(20)
    x = foa_audio_cuda(int(rng.integers(1 << 31)), (16, 20 * c.data.sr, 4))
    zero_counts()
    logits = fwd(x)
    torch.cuda.synchronize()
    launched = counts()
    want = expected_counts(c.data.n_fft, hop)
    require(launched == want, f"{phase}: launches {launched}, want {want}")
    require(tuple(logits.shape) == (16, 200, 2560) and bool(torch.isfinite(logits).all()),
            f"{phase}: logits {tuple(logits.shape)}, or not finite")
    with torch.inference_mode():
        re, im = plain_stft.framed_dft_flat(x, *dft, hop)
        ref = model(fe.features_from_stft(re, im))
        del re, im
    err = float((logits - ref).abs().max())
    scale = float(ref.abs().max())
    require(err <= FORWARD_TOL * scale,
            f"{phase} vs the all-plain forward: {err} > {FORWARD_TOL} * {scale}")
    t = float(np.median(cuda_ms(lambda: fwd(x), 10)))
    prof = profile_steps(lambda b, _: fwd(b), [x], None, 2)
    require(prof["source"] == "cuda_events"
            or set(hopper_stft.kernels_of(c.data.n_fft, hop)) <= set(prof["kernel_counts"] or {}),
            f"{phase}: the profile holds not every frames kernel of "
            f"{hopper_stft.kernels_of(c.data.n_fft, hop)}: {prof['kernel_counts']}")
    emit({"phase": phase, "shape": list(x.shape),
          "geometry": {"n_fft": c.data.n_fft, "hop": hop, "win_length": c.data.win_length,
                       "sr": c.data.sr},
          "launches": launched, "max_abs_err": err, "max_abs_logit": scale,
          "tol_rel": FORWARD_TOL, "ms": t, "host_p50_ms": p50_ms(lambda: fwd(x), 10),
          "audio_s_per_s": 16 * 20.0 / (t * 1e-3), "card": smi})
    emit({"phase": f"{phase}_profile", **prof, "card": smi})
    return launched


OTHER_INFER_SECS = (23, 35)


def phase_cli_other_geometry(smi, cfg, tag="G1"):
    """The entry points at geometry ``tag`` (:func:`other_geometry`: the
    preset's data config rewritten), on a synthetic DCASE2022-layout set
    at its rate: ``cli train``
    (SE-ResNet34, fp32, 2 epochs x 1 step of 16 x 20 s, val and test each
    epoch, the final test), ``val``, ``infer`` on two wavs and ``export``;
    then the artifact served once on flat audio (B = 1 x 20 s) with the
    plain versions patched to raise, within SERVE_TOL x max of the live
    forward of the experiment's best model (and whether bit-equal).
    Every K1 launch is the frames kernel: per train step and eval clip
    once.  The counts of the train call (this path's) are set to 0 just
    before it and read just after.  Rows ``cli_other_geometry`` (G1) or
    ``cli_<tag>``."""
    t_phase = time.perf_counter()
    c = other_geometry(cfg, tag)
    phase = "cli_other_geometry" if tag == "G1" else f"cli_{tag}"
    n_fft, hop, win, sr = GEOMETRY[tag]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_geometry_")
    try:
        data = os.path.join(tmp, "data")
        write_dcase_set(data, c, os.path.join(cfg.data.data_pth, "scaler_wts.pkl"))
        configs = preset_dir(tmp, c, data_pth=data, name_pth=os.path.join(data, "classes.txt"),
                             n_fft=n_fft, win_length=win, hop_length=hop, sr=sr)
        results = os.path.join(tmp, "results")
        exp_id = "chip-geometry"
        exp = os.path.join(results, exp_id)
        seconds = {}

        def run(what, argv):
            before = counts()
            t0 = time.perf_counter()
            rc = cli.main(argv + ["--results_dir", results, "--device", "cuda"])
            torch.cuda.synchronize()
            seconds[what] = time.perf_counter() - t0
            require(rc == 0, f"{phase}: {what} returned {rc}")
            return {n: k - before[n] for n, k in counts().items()}

        zero_counts()
        train = run("train", ["train", "--encoder", "se-resnet34", "--logger", "--nb_epochs", "2",
                              "--nb_iters", "1", "--batch_size", str(CLI_BATCH),
                              "--config_dir", configs, "--exp_id", exp_id])
        frozen = load_config(os.path.join(exp, "hyp_exp.yaml"))
        got = (frozen.data.n_fft, frozen.data.hop_length, frozen.data.win_length, frozen.data.sr)
        require(got == GEOMETRY[tag], f"{phase}: the frozen config's (n_fft, hop, win, sr) "
                f"{got}, want {GEOMETRY[tag]}")
        logs = read_logs(exp)
        for split in ("train", "val", "test"):
            got = logs[f"logs/{split}/loss"]
            require(sorted(got) == [1, 2] and np.isfinite(list(got.values())).all(),
                    f"{phase} {split} loss {got}")
        n_clips = 2 + 2 * 2 * len(EVAL_SECS) + 3 * len(EVAL_SECS)
        require(train == expected_counts(n_fft, hop, n_clips),
                f"{phase} train: launches {train}, want {expected_counts(n_fft, hop, n_clips)}")
        val = run("val", ["val", "--eval_pth", exp_id])
        require(val["stft_frames"] > 0 and val["stft_frames"] % len(EVAL_SECS) == 0
                and val == expected_counts(n_fft, hop, val["stft_frames"]),
                f"{phase} val: launches {val}")
        wav_dir = os.path.join(tmp, "wavs")
        os.makedirs(wav_dir)
        rng = np.random.default_rng(21)
        for i, secs in enumerate(OTHER_INFER_SECS):
            write_wav(os.path.join(wav_dir, f"clip{i}.wav"),
                      (rng.standard_normal((secs * c.data.sr + 91, 4)) * 1500).astype(np.int16),
                      c.data.sr)
        infer_n = run("infer", ["infer", "--eval_pth", exp_id, "--infer_pth", wav_dir])
        require(infer_n == expected_counts(n_fft, hop, len(OTHER_INFER_SECS)),
                f"{phase} infer: launches {infer_n}")
        csvs = read_csvs(os.path.join(exp, "output_infer"))
        require(len(csvs) == len(OTHER_INFER_SECS), f"{phase} infer wrote {sorted(csvs)}")
        run("export", ["export", "--eval_pth", exp_id])
        call, meta = load_exported(os.path.join(exp, "export"))
        require(meta["input_layout"] == "flat" and meta["serve_dtype"] == "float32",
                f"{phase} export: meta {meta}")
        x = torch.tensor(foa_audio(rng, tuple(meta["input_shape"])), device="cuda")
        with plain_versions_raise():
            before = counts()
            served = call(x)
            torch.cuda.synchronize()
            per_call = {n: k - before[n] for n, k in counts().items()}
        require(per_call == expected_counts(n_fft, hop),
                f"{phase}: launches per served call {per_call}")
        model, _ = load_best_model(frozen, exp, "cuda")
        live = build_eval_forward(model, make_frontend(frozen))(x)
        served_vs_live = {**check_served(f"geometry {tag}", served, live, "float32"),
                          "bit_equal": bool(torch.equal(served, live))}
        emit({"phase": phase,
              "geometry": {"n_fft": n_fft, "hop": hop, "win_length": win, "sr": sr},
              "losses": {s: logs[f"logs/{s}/loss"] for s in ("train", "val", "test")},
              "launches": {"train": train, "val": val, "infer": infer_n,
                           "served_call": per_call},
              "served_vs_live": served_vs_live, "tol_rel": SERVE_TOL, "cli_s": seconds,
              "seconds": time.perf_counter() - t_phase, "card": smi})
        return train
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def pick_threshold(cfg, logits):
    """A confidence threshold that 0.1 % of the (frame, anchor, class)
    confidences of the forward phase clear: some anchors pass, most not."""
    cls, _, _ = _device_decode(logits, make_grid_geometry(cfg), cfg.data.nb_classes)
    flat = cls.reshape(-1)
    return float(torch.topk(flat, flat.numel() // 1000).values[-1])


def read_csvs(d):
    out = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name)) as f:
            out[name] = [ln.strip().split(",") for ln in f if ln.strip()]
    return out


def untrained_opt_state(cfg, model):
    """``(opt_state, step)`` of the config's optimizer before its first
    step, for a ``model_best.ckpt`` of seeded weights."""
    opt = make_optimizer(cfg, model.parameters())
    return optax_state(cfg.train.optim, cfg.train.weight_decay, opt.state_dict(),
                       dict(model.named_parameters()))


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
                        {"epoch_nb": 0, "confidence_thresh": tau}, *untrained_opt_state(cfg, model))
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


# ---------------------------------------------------------------------------
# export: the serving artifact and its bf16 eval attention (route k2_bf16)
# ---------------------------------------------------------------------------

SERVE_TOL = 1e-5  # a served f32 output vs the live eval forward, x max|live|
BF16_SERVE_MAX = 0.1  # JAX's bf16 gates against the f32 live forward (tests/test_export.py)
BF16_SERVE_MEAN = 0.01
LONG_SECS = 120  # a 4800-frame clip: the artifact's attention on route k4


def phase_attn_eval_bf16_kernel(smi):
    """Route k2_bf16 (the bf16 eval forward: the bf16 train forward's
    kernel built without dropout) against the plain bf16 attention at
    (16, 800) with all keys valid (timed) and with random kv_len, one row
    at 0; (1, 800) (timed; key splits and the merge), (1, 2400) len 1400;
    and a bf16 eval call at (1, 4800) len 3000, which runs k4 on float32
    copies.  Kernel and plain version are each measured against float64 on
    the same bf16 inputs: the kernel's max|error| at most BF16_RATIO x the
    plain version's plus BF16_HALF_STEP x max|truth|; a kv_len = 0 row is
    zeros.  Timed: single calls (``ms``) and the profiler's device time a
    call (``device_ms``), each beside SDPA's on the same bf16 inputs."""
    rng = np.random.default_rng(9)
    H = 4
    lens_r = rng.integers(1, 800 + 1, 16)
    lens_r[5] = 0
    res = {"max_abs_err": 0.0}
    cases = (("full", 16, 800, [800] * 16, "k2_bf16", True),
             ("ragged", 16, 800, lens_r, "k2_bf16", False),
             ("b1", 1, 800, [800], "k2_bf16", True),
             ("b1_len", 1, 2400, [1400], "k2_bf16", False),
             ("long", 1, 4800, [3000], "k4", False))
    for tag, B, T, lens, rt, timed in cases:
        q, k, v = (torch.tensor(rng.standard_normal((B, T, H, 64)), dtype=torch.float32,
                                device="cuda").bfloat16() for _ in range(3))
        kv = torch.tensor(np.asarray(lens), dtype=torch.int32, device="cuda")
        before = counts()
        with torch.no_grad():
            out = hopper_attention.flash_attention(q, k, v, kv)
        torch.cuda.synchronize()
        grown = {n: c - before[n] for n, c in counts().items()}
        require(grown == {**{n: 0 for n in grown}, rt: 1},
                f"attn_eval_bf16_kernel {tag}: launches {grown}, want {rt} once")
        require(out.dtype == torch.bfloat16 and bool(torch.isfinite(out).all()),
                f"attn_eval_bf16_kernel {tag}: dtype {out.dtype} or not finite")
        plain = attention.mhsa_attention(q, k, v, kv)
        truth = attention.mhsa_attention(q.double(), k.double(), v.double(), kv)
        rows = [b for b, n in enumerate(lens) if n > 0]
        err = float((out.double()[rows] - truth[rows]).abs().max())
        err_p = float((plain.double()[rows] - truth[rows]).abs().max())
        scale = float(truth[rows].abs().max())
        require(err <= BF16_RATIO * err_p + BF16_HALF_STEP * scale,
                f"attn_eval_bf16_kernel {tag}: kernel err {err} > {BF16_RATIO} * plain "
                f"err {err_p} + {BF16_HALF_STEP} * {scale}")
        for b, n in enumerate(lens):
            if n == 0:
                require(bool((out[b] == 0).all()), f"attn_eval_bf16_kernel {tag}: "
                        "kv_len 0 row not 0")
        if rt == "k2_bf16":
            res["max_abs_err"] = max(res["max_abs_err"], err)
        row = {"phase": "attn_eval_bf16_kernel", "case": tag, "route": rt,
               "shape": [B, T, H, 64], "kv_len": [int(n) for n in lens] if B == 1 else
               {"min": int(min(lens)), "max": int(max(lens))}, "max_abs_err": err,
               "plain_max_abs_err": err_p, "max_abs_truth": scale,
               "tol": {"ratio": BF16_RATIO, "half_step": BF16_HALF_STEP}}
        if timed:
            library = sdpa(q, k, v, kv)
            lib_err = float((library().transpose(1, 2).double() - plain.double()).abs().max())
            require(lib_err <= BF16_LIBRARY_TOL * scale,
                    f"SDPA bf16 is not the eval attention's function: {lib_err}")

            def kernel():
                with torch.no_grad():
                    return hopper_attention.flash_attention(q, k, v, kv)

            k_ms, p_ms, l_ms = [], [], []
            for _ in range(3):
                k_ms += cuda_ms(kernel, 10)
                p_ms += cuda_ms(lambda: attention.mhsa_attention(q, k, v, kv), 10)
                l_ms += cuda_ms(library, 10)
            flop = attn_flop(H, T, lens)
            row.update({"ms": float(np.median(k_ms)), "plain_ms": float(np.median(p_ms)),
                        "library_ms": float(np.median(l_ms)),
                        "library": "F.scaled_dot_product_attention (bf16)",
                        "library_max_abs_err": lib_err,
                        **bf16_bound(flop, attn_bytes(B, T, H, lens, q_rows=2, kv_reads=2,
                                                      el=2)),
                        "runs": len(k_ms), "card": smi})
            row.update(device_fields(kernel, library, row["bound_ms"], row["ms"],
                                     row["library_ms"]))
            if tag == "full":
                res.update({n: row[n] for n in ("ms", "plain_ms", "library_ms", "bound_ms",
                                                "bound_by", "bound_units") + DEVICE_KEYS})
        emit(row)
        del q, k, v, out, plain, truth
    return res


@contextlib.contextmanager
def plain_versions_raise():
    """The plain STFT and the plain attention raise while the context is
    open: a served call on the card must run the kernels only."""
    saved = (plain_stft.stft, attention.mhsa_attention)

    def refuse(*_, **__):
        raise RuntimeError("a plain version ran on a kernel path")

    plain_stft.stft = attention.mhsa_attention = refuse
    try:
        yield
    finally:
        plain_stft.stft, attention.mhsa_attention = saved


def p50_ms(fn, n=20):
    """Median host time (ms) of ``n`` calls of ``fn``, each to the end of
    its device work, after two warm-ups: the latency of one request."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(out))


def live_forward(model, fe, dtype):
    """The live eval forward with the encoder in ``dtype`` (the eval
    compute dtype of ``build_model(..., serve_dtype=...)``)."""
    fwd = build_eval_forward(model, fe)

    def call(x):
        prev = model.serve_dtype
        model.serve_dtype = None if dtype == "float32" else torch.bfloat16
        try:
            return fwd(x)
        finally:
            model.serve_dtype = prev

    return call


def check_served(tag, served, live, dtype):
    """A served output against the f32 live forward: f32 within SERVE_TOL
    x max|live|; bf16 within JAX's gates (max and mean |error|)."""
    require(served.dtype == torch.float32 and served.shape == live.shape,
            f"export {tag}: served {served.dtype} {tuple(served.shape)} vs live "
            f"{tuple(live.shape)}")
    require(bool(torch.isfinite(served).all()), f"export {tag}: non-finite output")
    d = (served - live).abs()
    err, mean, scale = float(d.max()), float(d.mean()), float(live.abs().max())
    if dtype == "float32":
        require(err <= SERVE_TOL * scale,
                f"export {tag}: served vs live {err} > {SERVE_TOL} * {scale}")
    else:
        require(err < BF16_SERVE_MAX and mean < BF16_SERVE_MEAN,
                f"export {tag}: bf16 served vs f32 live max {err}, mean {mean}")
    return {"max_abs_err": err, "mean_abs_err": mean, "max_abs_live": scale}


def phase_export(smi, cfg, conf_cfg, fe, model, conformer, tau, conf_tau, tmp):
    """The serving export: ``cli.main(["export", ...])`` on an SE-ResNet34
    and a ResNet-Conformer experiment dir (JAX checkpoint format), each in
    float32 and bfloat16 (B=1 x 20 s); ``export_model`` of the conformer
    at B=16 x 20 s and B=1 x 120 s (4800 frames, route k4) in both
    dtypes; and the SE-ResNet34 traced on the CPU, loaded onto the card.
    The main path: one served call of every artifact through
    ``load_exported``, with the launch counts set to 0 just before and read
    just after, the plain STFT and attention patched to raise.  Checked
    per served call: K1 once; for the conformer 8 launches of k2 (f32),
    k2_bf16 (bf16) or k4 (120 s); the f32 outputs within SERVE_TOL x max of
    the live eval forward, the bf16 ones within JAX's gates of the f32
    live forward.  Timed: served against live at B=1 (p50 latency of a
    request, host clock) and at B=16 (CUDA events, audio-s/s)."""
    rng = np.random.default_rng(10)
    results = os.path.join(tmp, "export_results")
    exps = {"se": (cfg, model, tau), "conformer": (conf_cfg, conformer, conf_tau)}
    for name, (c, m, t) in exps.items():
        exp = os.path.join(results, name)
        save_config(with_conf_thresh(c, t), os.path.join(exp, "hyp_exp.yaml"))
        save_jax_checkpoint(os.path.join(exp, "model_best.ckpt"),
                            flax_from_state_dict(m.state_dict()),
                            {"epoch_nb": 0, "confidence_thresh": t}, *untrained_opt_state(c, m))
    arts, rows = {}, {}
    for name in exps:
        for dtype in ("float32", "bfloat16"):
            t0 = time.perf_counter()
            rc = cli.main(["export", "--eval_pth", name, "--results_dir", results,
                           "--serve_dtype", dtype, "--device", "cuda"])
            require(rc == 0, f"cli export {name} {dtype} returned {rc}")
            d = os.path.join(results, name, f"export_{dtype}")
            os.replace(os.path.join(results, name, "export"), d)
            require(sorted(os.listdir(d)) == ["hyp_exp.yaml", "meta.json", "model.pt2"],
                    f"cli export {name} {dtype} wrote {sorted(os.listdir(d))}")
            arts[(name, dtype, 1, 20)] = d
            rows[(name, dtype, 1, 20)] = {"export_s": time.perf_counter() - t0,
                                          "via": "cli"}
    for B, secs in ((16, 20), (1, LONG_SECS)):
        for dtype in ("float32", "bfloat16"):
            d = os.path.join(tmp, f"export_conformer_{B}x{secs}_{dtype}")
            t0 = time.perf_counter()
            export_model(conf_cfg, conformer, fe, d, batch_size=B, seconds=secs,
                         conf_thresh=conf_tau, serve_dtype=dtype)
            arts[("conformer", dtype, B, secs)] = d
            rows[("conformer", dtype, B, secs)] = {"export_s": time.perf_counter() - t0,
                                                   "via": "export_model"}
    # traced on the CPU, served on the card: the device move
    t0 = time.perf_counter()
    cpu_model = build_model(cfg, device="cpu")
    cpu_model.load_state_dict(model.state_dict())
    d = os.path.join(tmp, "export_se_cpu_traced")
    export_model(cfg, cpu_model, make_frontend(cfg, "cpu"), d, conf_thresh=tau)
    arts[("se-cpu-traced", "float32", 1, 20)] = d
    rows[("se-cpu-traced", "float32", 1, 20)] = {"export_s": time.perf_counter() - t0,
                                                 "via": "export_model on the CPU"}
    del cpu_model

    models = {"se": model, "conformer": conformer, "se-cpu-traced": model}
    audio, calls = {}, {}
    for key, d in arts.items():
        name, dtype, B, secs = key
        call, meta = load_exported(d)  # onto the card, the default device
        require(meta["serve_dtype"] == dtype and meta["output_dtype"] == "float32"
                and meta["platforms"] == ["cuda", "cpu"]
                and meta["input_shape"] == [B, secs * cfg.data.sr, 4]
                and meta["input_layout"] == "hop_blocks",
                f"export {key}: meta {meta}")
        if (B, secs) not in audio:
            audio[(B, secs)] = torch.tensor(foa_audio(rng, (B, secs * cfg.data.sr, 4)),
                                            device="cuda")
        calls[key] = call
        rows[key].update({"meta_output_shape": meta["output_shape"],
                          "artifact_mb": os.path.getsize(os.path.join(d, "model.pt2")) / 1e6})

    # the main path: one served call of every artifact, kernels only
    per_call = {}
    with plain_versions_raise():
        zero_counts()
        served = {}
        for key, call in calls.items():
            before = counts()
            served[key] = call(audio[key[2:]])
            torch.cuda.synchronize()
            per_call[key] = {n: c - before[n] for n, c in counts().items()}
        launched = counts()
    for key, n in per_call.items():
        name, dtype, B, secs = key
        want = {"stft": 1}
        if name == "conformer":
            want[("k4" if secs == LONG_SECS else
                  "k2" if dtype == "float32" else "k2_bf16")] = 8
        require(n == {**{r: 0 for r in n}, **want},
                f"export {key}: launches per served call {n}, want {want}")
    for key in calls:
        name, dtype, B, secs = key
        live = live_forward(models[name], fe, "float32")(
            audio[(B, secs)].reshape(B, -1, HOP, 4))
        rows[key].update(check_served(str(key), served[key], live, dtype))
        require(list(served[key].shape) == rows[key]["meta_output_shape"],
                f"export {key}: output {tuple(served[key].shape)} vs meta")
    del served

    # served against live: B=1 p50 latency, B=16 audio-s/s
    timing = {}
    for key, call in calls.items():
        name, dtype, B, secs = key
        if secs == LONG_SECS or name == "se-cpu-traced":
            continue
        x = audio[(B, secs)]
        xb = x.reshape(B, -1, HOP, 4)
        live = live_forward(models[name], fe, dtype)
        if B == 1:
            s_ms, l_ms = [], []
            for _ in range(2):  # in turns
                s_ms.append(p50_ms(lambda: call(x)))
                l_ms.append(p50_ms(lambda: live(xb)))
            timing[f"{name}/{dtype}/B1"] = {"served_p50_ms": float(np.median(s_ms)),
                                            "live_p50_ms": float(np.median(l_ms))}
        else:
            s_ms, l_ms = [], []
            for _ in range(2):
                s_ms += cuda_ms(lambda: call(x), 5)
                l_ms += cuda_ms(lambda: live(xb), 5)
            s, lv = float(np.median(s_ms)), float(np.median(l_ms))
            timing[f"{name}/{dtype}/B{B}"] = {
                "served_ms": s, "live_ms": lv,
                "served_audio_s_per_s": B * secs / (s * 1e-3),
                "live_audio_s_per_s": B * secs / (lv * 1e-3)}
    emit({"phase": "export", "artifacts": {"/".join(map(str, k)): v for k, v in rows.items()},
          "launches_per_served_call": {"/".join(map(str, k)): v for k, v in per_call.items()},
          "launches": launched, "timing": timing,
          "tol": {"f32_rel": SERVE_TOL, "bf16_max": BF16_SERVE_MAX,
                  "bf16_mean": BF16_SERVE_MEAN}, "card": smi})
    return launched


# ---------------------------------------------------------------------------
# train_cli: the training and evaluation entry points at full width
# ---------------------------------------------------------------------------

LABEL_HOP_S = 0.1
EVAL_SECS = (23, 35, 75)  # buckets 1200, 2400 and 4800 feature frames
TRAIN_CHUNKS = 16
CLI_BATCH = 16
CONFORMER_BLOCKS = 8  # attention launches per conformer forward
CLI_EPOCHS = 10  # epoch 10 runs the threshold scan; the resume runs epoch 11


def render_clip(rng, secs, sr, n_events):
    """int16 FOA: class tones (320 Hz * 2^(c/3)) FOA-encoded at their labelled
    direction, over noise; and the label dict {frame: [[class, 0, azi, ele]]}."""
    n = sr * secs
    hop = int(sr * LABEL_HOP_S)
    audio = rng.standard_normal((n, 4)) * 0.02
    label = {}
    frames = n // hop
    for _ in range(n_events):
        c = int(rng.integers(13))
        azi, ele = float(rng.integers(-180, 180)), float(rng.integers(-60, 61))
        dur = int(rng.integers(5, 15))
        start = int(rng.integers(0, frames - dur))
        t0, t1 = start * hop, (start + dur) * hop
        t = np.arange(t1 - t0) / sr
        tone = 0.35 * np.sin(2 * np.pi * 320.0 * 2 ** (c / 3.0) * t + rng.uniform(0, 6.28))
        a, e = np.radians(azi), np.radians(ele)
        gains = np.array([2 ** -0.5, np.cos(a) * np.cos(e), np.sin(a) * np.cos(e), np.sin(e)])
        audio[t0:t1] += tone[:, None] * gains[None, :]
        for f in range(start, start + dur):
            label.setdefault(f, []).append([c, 0, azi, ele])
    return (np.clip(audio, -0.99, 0.99) * 32767).astype(np.int16), label


def write_dcase_set(root, cfg, scaler_pkl):
    """A DCASE2022-layout set under ``root``: TRAIN_CHUNKS 20-s training
    chunks and three val and three test clips of EVAL_SECS, with their
    metadata CSVs, ``classes.txt`` and the repository's scaler stats."""
    rng = np.random.default_rng(11)
    sr = cfg.data.sr
    sub = f"dev-train-chunked_{cfg.data.chunk_window_s}s_{cfg.data.chunk_stride_s}s"
    splits = [(sub, [(f"train{i:03d}", cfg.data.chunk_window_s) for i in range(TRAIN_CHUNKS)])]
    splits += [(f"dev-{s}", [(f"{s}{i:03d}", secs) for i, secs in enumerate(EVAL_SECS)])
               for s in ("val", "test")]
    for d, clips in splits:
        os.makedirs(os.path.join(root, "foa_dev", d))
        os.makedirs(os.path.join(root, "metadata_dev", d))
        for name, secs in clips:
            audio, label = render_clip(rng, secs, sr, max(2, secs // 3))
            write_wav(os.path.join(root, "foa_dev", d, name + ".wav"), audio, sr)
            write_label_csv(os.path.join(root, "metadata_dev", d, name + ".csv"), label)
    with open(os.path.join(root, "classes.txt"), "w") as f:
        f.write("".join(f"class{c}\n" for c in range(cfg.data.nb_classes)))
    shutil.copy(scaler_pkl, os.path.join(root, "scaler_wts.pkl"))


def probe_record():
    """The lists :func:`engine_probes` fills."""
    return {k: [] for k in ("gen_state", "steps", "evals", "epochs", "loaded", "printed",
                            "scorer_s")}


@contextlib.contextmanager
def engine_probes(rec):
    """Wrap the engine's step, eval forwards, epoch loop, checkpoint reader,
    scorer and score printer to record per-call launch counts, generator
    states, times and scores into ``rec``; restored on exit."""
    orig = {(m, n): getattr(m, n) for m, n in (
        (train_mod, "build_train_step"), (train_mod, "build_eval_forward"),
        (evaluate_mod, "build_eval_forward"), (train_mod, "train_one_epoch"),
        (train_mod, "load_train_checkpoint"), (evaluate_mod, "_print_scores"),
        (SegmentScorer, "get_SELD_Results"))}

    def build_train_step(*a, **kw):
        step = orig[train_mod, "build_train_step"](*a, **kw)

        def counted(batch, gen):
            rec["gen_state"].append(gen.get_state().clone())
            before = counts()
            loss = step(batch, gen)
            rec["steps"].append({n: c - before[n] for n, c in counts().items()})
            return loss

        counted.optimizer, counted.plan = step.optimizer, step.plan
        return counted

    def eval_builder(build):
        def build_eval(*a, **kw):
            fwd = build(*a, **kw)

            def counted(audio, valid=None):
                before = counts()
                out = fwd(audio, valid)
                rec["evals"].append({"frames": int(np.shape(audio)[1]),
                                     **{n: c - before[n] for n, c in counts().items()}})
                return out
            return counted
        return build_eval

    def train_one_epoch(loader, *a, **kw):
        rec["epochs"].append({"files": list(loader.dataset.get_filelist()),
                              "pool": list(loader.dataset.sampler.get_remaining())})
        return orig[train_mod, "train_one_epoch"](loader, *a, **kw)

    def load_train_checkpoint(*a, **kw):
        rec["loaded"].append(orig[train_mod, "load_train_checkpoint"](*a, **kw))
        return rec["loaded"][-1]

    def get_seld(self, *a, **kw):
        t0 = time.perf_counter()
        res = orig[SegmentScorer, "get_SELD_Results"](self, *a, **kw)
        rec["scorer_s"].append(time.perf_counter() - t0)
        return res

    train_mod.build_train_step = build_train_step
    for m in (train_mod, evaluate_mod):
        m.build_eval_forward = eval_builder(orig[m, "build_eval_forward"])
    train_mod.train_one_epoch = train_one_epoch
    train_mod.load_train_checkpoint = load_train_checkpoint
    def print_scores(tag, sc):
        rec["printed"].append([float(v) for v in sc[:5]])
        orig[evaluate_mod, "_print_scores"](tag, sc)

    evaluate_mod._print_scores = print_scores
    SegmentScorer.get_SELD_Results = get_seld
    try:
        yield rec
    finally:
        for (m, n), f in orig.items():
            setattr(m, n, f)


def read_logs(exp):
    with open(os.path.join(exp, "logs.jsonl")) as f:
        logs = [json.loads(ln) for ln in f]
    by = {}
    for r in logs:
        if "step" in r:
            by.setdefault(r["channel"], {})[r["step"]] = r["value"]
    return by


def phase_train_cli(smi, cfg, bare_step_ms):
    """``cli.main`` train (10 epochs x 1 step of 16 x 20 s, --augment,
    --logger; epoch 10 scans the threshold), val, test and a resume for
    epoch 11, on a synthetic DCASE2022-layout set at full width
    (ResNet-Conformer, emb 256, 8 blocks, 4 heads, fp32).  The launch
    counts are set to 0 just before the train run and read just after the
    resume."""
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        data = os.path.join(tmp, "data")
        write_dcase_set(data, cfg, os.path.join(cfg.data.data_pth, "scaler_wts.pkl"))
        set_s = time.perf_counter() - t_phase
        configs = preset_dir(tmp, cfg, data_pth=data, name_pth=os.path.join(data, "classes.txt"))
        results = os.path.join(tmp, "results")
        exp_id = "chip-train"
        exp = os.path.join(results, exp_id)
        rec = probe_record()
        secs, scores = {}, {}
        with engine_probes(rec):
            zero_counts()  # the main path's count starts here
            t0 = time.perf_counter()
            rc = cli.main(["train", "--encoder", "resnet-conformer", "--augment", "--logger",
                           "--nb_epochs", str(CLI_EPOCHS), "--nb_iters", "1",
                           "--batch_size", str(CLI_BATCH), "--config_dir", configs,
                           "--results_dir", results, "--exp_id", exp_id, "--device", "cuda"])
            torch.cuda.synchronize()
            secs["train"] = time.perf_counter() - t0
            require(rc == 0, f"train returned {rc}")
            scan_tau = read_logs(exp)["logs/train/conf_thresh"][CLI_EPOCHS]
            frozen = load_config(os.path.join(exp, "hyp_exp.yaml"))
            require(frozen.train.conf_thresh == scan_tau,
                    f"frozen conf_thresh {frozen.train.conf_thresh} != scanned {scan_tau}")
            for action in ("val", "test"):
                n_printed = len(rec["printed"])
                t0 = time.perf_counter()
                rc = cli.main([action, "--eval_pth", exp_id, "--results_dir", results,
                               "--device", "cuda"])
                torch.cuda.synchronize()
                secs[action] = time.perf_counter() - t0
                require(rc == 0, f"{action} returned {rc}")
                printed = rec["printed"][n_printed:]
                require(len(printed) == 9 and np.isfinite(printed).all(),
                        f"{action}: scores printed {printed}")
                scores[action] = printed[::3]  # the overall five, per unify threshold
                require(len(os.listdir(os.path.join(exp, "output_eval"))) == len(EVAL_SECS),
                        f"{action}: not one CSV per clip")
            stored = torch.load(os.path.join(exp, "model_ckpt.ckpt"), weights_only=False)["host"]
            with open(os.path.join(exp, "hyp_exp.yaml")) as f:
                y = yaml.safe_load(f)
            y["train"]["nb_epochs"] = CLI_EPOCHS + 1
            with open(os.path.join(exp, "hyp_exp.yaml"), "w") as f:
                yaml.safe_dump(y, f, sort_keys=False)
            n_epochs, n_gen = len(rec["epochs"]), len(rec["gen_state"])
            # the resume (epoch 11 and the final test) under the profiler:
            # where an engine epoch's device time goes, and its idle share
            rcs = []
            resume_profile = profile_calls(lambda _: rcs.append(cli.main(
                ["train", "--resume_pth", exp_id, "--results_dir", results,
                 "--device", "cuda"])), 1, warmup=False)
            launched = counts()
        require(rcs == [0], f"resume returned {rcs}")

        # artifacts, losses, scores
        for name in ("hyp_exp.yaml", "model_best.ckpt", "model_ckpt.ckpt", "logs.jsonl"):
            require(os.path.isfile(os.path.join(exp, name)), f"train_cli: no {name}")
        for split in ("val", "test"):
            require(len(os.listdir(os.path.join(exp, f"output_{split}"))) == len(EVAL_SECS),
                    f"train_cli: output_{split} is not one CSV per clip")
        logs = read_logs(exp)
        epochs = list(range(1, CLI_EPOCHS + 2))
        for split in ("train", "val", "test"):
            got = logs[f"logs/{split}/loss"]
            require(sorted(got) == epochs, f"logs hold epochs {sorted(got)} of {split} loss")
            require(np.isfinite(list(got.values())).all(), f"{split} loss not finite: {got}")
        for split in ("val", "test"):
            for m, hi in (("ER", np.inf), ("F1", 100.0), ("LE", 180.0), ("LR", 100.0),
                          ("SELD", np.inf)):
                v = np.array(list(logs[f"logs/{split}/{m}"].values()))
                require(len(v) == len(epochs) and np.isfinite(v).all()
                        and (v >= 0).all() and (v <= hi).all(), f"{split} {m}: {v}")

        # launches: per step, per eval clip
        require(len(rec["steps"]) == CLI_EPOCHS + 1, f"{len(rec['steps'])} train steps")
        nb = CONFORMER_BLOCKS
        for i, n in enumerate(rec["steps"]):
            require(n["stft"] == 1 and n["k2_dropout"] == nb and n["k3"] == nb
                    and n["k2"] == 0 and n["k4"] == 0, f"train step {i + 1}: launches {n}")
        for e in rec["evals"]:
            route = "k4" if e["frames"] > attention.BLOCK_THRESHOLD else "k2"
            other = "k2" if route == "k4" else "k4"
            require(e["stft"] == 1 and e[route] == nb and e[other] == 0
                    and e["k2_dropout"] == 0 and e["k3"] == 0,
                    f"eval clip of {e['frames']} frames: launches {e}")
        require(any(e["frames"] > attention.BLOCK_THRESHOLD for e in rec["evals"]),
                "no eval clip on route k4")
        for name, n in launched.items():  # float32 at n_fft 2 hop: no bf16 route, no frames kernel
            require((n == 0) if name.endswith("_bf16") or name.startswith("stft_frames")
                    else (n > 0),
                    f"train_cli: kernel route {name} launched {n} times")

        # the resume: epoch 11 from the stored pool, file list, best_log, generator
        require(stored["start_epoch_nb"] == CLI_EPOCHS + 1, f"stored {stored['start_epoch_nb']}")
        loaded = rec["loaded"][-1]
        require(loaded["best_log"] == stored["best_log"], "resume: best_log differs")
        first = rec["epochs"][n_epochs]
        require(len(rec["epochs"]) == n_epochs + 1, "resume ran more than epoch 11")
        require(first["files"] == stored["train_file_list"]
                and first["pool"] == stored["train_remaining_file"],
                "resume: epoch 11 did not start from the stored pool and file list")
        require(np.array_equal(rec["gen_state"][n_gen].numpy(),
                               stored["rng_state"]["torch_generator"]),
                "resume: the step generator did not continue from its stored state")

        train_s = [logs["logs/train/time_s"][e] for e in epochs]
        wait_s = [logs["logs/train/loader_wait_s"][e] for e in epochs]
        step_s = [t - w for t, w in zip(train_s, wait_s)]
        step_med = float(np.median(step_s[1:]))  # epoch 1 pays cuDNN's first calls
        audio_s = CLI_BATCH * cfg.data.chunk_window_s
        row = {"phase": "train_cli", "epochs": len(epochs),
               "batch": [CLI_BATCH, cfg.data.chunk_window_s * cfg.data.sr // HOP, HOP, 4],
               "train_s": train_s, "val_s": [logs["logs/val/time_s"][e] for e in epochs],
               "test_s": [logs["logs/test/time_s"][e] for e in epochs],
               "loader_wait_s_per_batch": wait_s,
               "engine_step_s": step_s,
               "engine_audio_s_per_s": audio_s / step_med,
               "engine_audio_s_per_s_with_loader": audio_s / float(np.median(train_s[1:])),
               "bare_step_audio_s_per_s": audio_s / (bare_step_ms * 1e-3),
               "tau_scan": {"tau": scan_tau,
                            "forward_s": logs["logs/train/conf_scan_forward_s"][CLI_EPOCHS],
                            "decode_score_s": logs["logs/train/conf_scan_decode_score_s"][CLI_EPOCHS]},
               "scorer_s_per_call": {"n": len(rec["scorer_s"]),
                                     "median": float(np.median(rec["scorer_s"])),
                                     "max": float(np.max(rec["scorer_s"]))},
               "checkpoint_s": [logs["logs/train/checkpoint_s"][e] for e in epochs],
               "cli_s": secs, "cli_scores": scores,
               "resume_profile": {k: v for k, v in resume_profile.items()
                                  if k not in ("steps",)},
               "final_losses": {s: logs[f"logs/{s}/loss"][CLI_EPOCHS + 1]
                                               for s in ("train", "val", "test")},
               "eval_clips": len(rec["evals"]), "launches": launched,
               "launches_per_step": rec["steps"][0],
               "seconds": {"phase": time.perf_counter() - t_phase, "write_set": set_s},
               "card": smi}
        emit(row)
        return launched
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def with_train(cfg, **kw):
    return dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, **kw))


def run_steps(cfg, fe, batches, steps, seed=1234):
    """``steps`` train steps from the seeded init on ``batches`` in turn:
    the losses, each step's host ms (ending in a device -> host copy),
    each step's launch counts, step 1's gradients, the peak device memory
    and the step (to profile)."""
    model = build_model(cfg, generator=torch.Generator().manual_seed(0), train=True)
    step = build_train_step(cfg, model, fe)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = {"losses": [], "step_ms": [], "per_step": []}
    for i in range(steps):
        before = counts()
        t0 = time.perf_counter()
        out["losses"].append(float(step(batches[i % len(batches)], gen)))
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
        out["per_step"].append({n: c - before[n] for n, c in counts().items()})
        if i == 0:
            out["grads1"] = grads_of(model)
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["median_step_ms"] = float(np.median(out["step_ms"][1:]))  # step 1 pays first calls
    require(all(np.isfinite(out["losses"])), f"train loss not finite: {out['losses']}")
    out["step"], out["gen"], out["model"] = step, gen, model
    return out


def phase_train_seresnet34(smi, cfg, fe):
    """SE-ResNet34 + AD-YOLO train steps at full width, B = 32 x 20-s chunks,
    Adam, GRU dropout 0.3 from one CUDA generator, in float32 and in bf16
    from the same weights: TRAIN_STEPS steps each with the counts set to 0
    just before, read after (the STFT once a step, no attention); step 1's
    bf16 loss within SE_BF16_LOSS_TOL of the float32 one; medians of steps
    2-5, peak memory, and a profile of two more steps each."""
    B = 32
    rng = np.random.default_rng(12)
    batches = [synthetic_batch(cfg, rng, B) for _ in range(2)]
    rows, launched = {}, {}
    for dtype in ("float32", "bfloat16"):
        zero_counts()
        r = run_steps(with_train(cfg, compute_dtype=dtype), fe, batches, TRAIN_STEPS)
        launched[dtype] = counts()
        for i, n in enumerate(r["per_step"]):
            require(n == {**{k: 0 for k in n}, "stft": 1},
                    f"train_seresnet34 {dtype} step {i + 1}: launches {n}")
        prof = profile_steps(r["step"], batches, r["gen"], 2)
        rows[dtype] = {"losses": r["losses"], "step_ms": r["step_ms"],
                       "median_step_ms": r["median_step_ms"],
                       "audio_s_per_s": B * 20.0 / (r["median_step_ms"] * 1e-3),
                       "peak_mem_gb": r["peak_mem_gb"], "launches_per_step": r["per_step"][0],
                       "profile": prof}
        del r
    l32, l16 = rows["float32"]["losses"][0], rows["bfloat16"]["losses"][0]
    require(abs(l16 - l32) <= SE_BF16_LOSS_TOL * abs(l32),
            f"train_seresnet34: bf16 step 1 loss {l16} vs float32 {l32}")
    emit({"phase": "train_seresnet34", "batch": [B, 800, HOP, 4], "steps": TRAIN_STEPS,
          **rows, "step1_bf16_vs_f32_rel": abs(l16 - l32) / abs(l32),
          "tol_rel": SE_BF16_LOSS_TOL, "card": smi})
    return launched["bfloat16"]


def phase_train_conformer_bf16(smi, cfg, fe):
    """ResNet-Conformer + AD-YOLO train steps at full width in bf16, dropout
    0.2 from one CUDA generator.  The main path of the bf16 kernels: B = 16
    x 20-s chunks, TRAIN_STEPS steps with the counts set to 0 just before
    and read after (per step the STFT once, k2_dropout_bf16 and k3_bf16 8
    times each, no other attention route); step 1 within
    BF16_TRAIN_LOSS_TOL of the same step from the same weights and
    generator seed on the plain bf16 attention; a profile of two more
    steps.  Then B = 32 without and with ``remat``: median step and peak
    memory of each, step 1's losses within 1e-3 of each other."""
    bf = with_train(cfg, compute_dtype="bfloat16")
    rng = np.random.default_rng(13)
    batches = [synthetic_batch(cfg, rng, 16) for _ in range(2)]
    zero_counts()  # the main path's count starts here
    r = run_steps(bf, fe, batches, TRAIN_STEPS)
    launched = counts()
    nb = CONFORMER_BLOCKS
    for i, n in enumerate(r["per_step"]):
        require(n == {**{k: 0 for k in n}, "stft": 1, "k2_dropout_bf16": nb, "k3_bf16": nb},
                f"train_conformer_bf16 step {i + 1}: launches {n}")
    with plain_attention():
        ref = run_steps(bf, fe, batches, 1)
    require(abs(r["losses"][0] - ref["losses"][0]) <= BF16_TRAIN_LOSS_TOL * abs(ref["losses"][0]),
            f"train_conformer_bf16 step 1 loss {r['losses'][0]} vs plain {ref['losses'][0]}")
    gmax = max(float(g.abs().max()) for g in ref["grads1"].values())
    grad_err = max(float((r["grads1"][n] - g).abs().max()) for n, g in ref["grads1"].items())
    ref_loss = ref["losses"][0]
    del ref
    prof = profile_steps(r["step"], batches, r["gen"], 2)
    row = {"phase": "train_conformer_bf16", "batch": [16, 800, HOP, 4], "steps": TRAIN_STEPS,
           "losses": r["losses"], "launches": launched, "launches_per_step": r["per_step"],
           "step1_vs_plain": {"loss": [r["losses"][0], ref_loss], "tol_rel": BF16_TRAIN_LOSS_TOL,
                              "grad_max_abs_err": grad_err, "grad_max_abs": gmax},
           "step_ms": r["step_ms"], "median_step_ms": r["median_step_ms"],
           "audio_s_per_s": 16 * 20.0 / (r["median_step_ms"] * 1e-3),
           "peak_mem_gb": r["peak_mem_gb"], "profile": prof, "card": smi}
    del r
    big = [synthetic_batch(cfg, rng, 32) for _ in range(2)]
    for remat in (False, True):
        b32 = run_steps(with_train(bf, remat=remat), fe, big, 3)
        row[f"b32_remat_{str(remat).lower()}"] = {
            "losses": b32["losses"], "step_ms": b32["step_ms"],
            "median_step_ms": b32["median_step_ms"],
            "audio_s_per_s": 32 * 20.0 / (b32["median_step_ms"] * 1e-3),
            "peak_mem_gb": b32["peak_mem_gb"]}
        del b32
    l0, l1 = row["b32_remat_false"]["losses"][0], row["b32_remat_true"]["losses"][0]
    require(abs(l0 - l1) <= 1e-3 * abs(l0), f"B=32 step 1 loss {l0} without remat, {l1} with")
    emit(row)
    return launched


def phase_train_cli_se_bf16(smi, cfg):
    """``cli.main`` train of SE-ResNet34 (the default encoder) in bf16: 2
    epochs x 1 step of 16 x 20 s with val and test each epoch and the final
    test, on a synthetic DCASE2022-layout set; finite losses for both
    epochs, one STFT launch per step and per eval clip, float32 checkpoint
    arrays.  Counts set to 0 just before the call and read just after."""
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_se_bf16_")
    try:
        data = os.path.join(tmp, "data")
        write_dcase_set(data, cfg, os.path.join(cfg.data.data_pth, "scaler_wts.pkl"))
        configs = preset_dir(tmp, cfg, data_pth=data, name_pth=os.path.join(data, "classes.txt"))
        results = os.path.join(tmp, "results")
        exp = os.path.join(results, "chip-se-bf16")
        zero_counts()
        t0 = time.perf_counter()
        rc = cli.main(["train", "--encoder", "se-resnet34", "--compute_dtype", "bfloat16",
                       "--logger", "--nb_epochs", "2", "--nb_iters", "1", "--batch_size", str(CLI_BATCH),
                       "--config_dir", configs, "--results_dir", results,
                       "--exp_id", "chip-se-bf16", "--device", "cuda"])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        launched = counts()
        require(rc == 0, f"train_cli_se_bf16 returned {rc}")
        require(load_config(os.path.join(exp, "hyp_exp.yaml")).train.compute_dtype == "bfloat16",
                "train_cli_se_bf16: the frozen config lost the dtype")
        logs = read_logs(exp)
        for split in ("train", "val", "test"):
            got = logs[f"logs/{split}/loss"]
            require(sorted(got) == [1, 2] and np.isfinite(list(got.values())).all(),
                    f"train_cli_se_bf16 {split} loss {got}")
        # 2 steps; per epoch the val and test clips; the final test, once
        # per unify threshold (15, 30, 45 deg)
        n_clips = 2 + 2 * 2 * len(EVAL_SECS) + 3 * len(EVAL_SECS)
        require(launched == {**{n: 0 for n in launched}, "stft": n_clips},
                f"train_cli_se_bf16: launches {launched}, want stft {n_clips}")
        stored = torch.load(os.path.join(exp, "model_ckpt.ckpt"), weights_only=False)
        require({t.dtype for t in stored["model"].values()} == {torch.float32},
                "train_cli_se_bf16: the checkpoint holds non-float32 arrays")
        emit({"phase": "train_cli_se_bf16", "epochs": 2,
              "losses": {s: logs[f"logs/{s}/loss"] for s in ("train", "val", "test")},
              "train_s": [logs["logs/train/time_s"][e] for e in (1, 2)],
              "val_s": [logs["logs/val/time_s"][e] for e in (1, 2)],
              "cli_s": cli_s, "launches": launched,
              "seconds": time.perf_counter() - t_phase, "card": smi})
        return launched
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---- the dense formats, MIC and preprocessing -------------------------------

MIC_TRAIN_SECS = (30, 30)  # dev-train clips, chunked to 20-s windows every 1 s
MIC_EVAL_SECS = (23, 35)
# the DCASE tetrahedral array: radius 4.2 cm, capsules at (azimuth, elevation)
MIC_DIRS = ((45.0, 35.0), (-45.0, -35.0), (135.0, -35.0), (-135.0, 35.0))
MIC_RADIUS_M = 0.042
SOUND_M_S = 343.0
GCC_REF_TOL = 1e-3  # GCC-PHAT on the card vs numpy's irfft in float64, x max|gcc|
SCALER_DEV_TOL = 1e-4  # the scaler pass on the card vs on the CPU, x max|stat|
DENSE_LOSS_TOL = 1e-5  # a dense loss on the card vs numpy float64, relative
DENSE_LOSSES = ("seddoa", "masked-seddoa", "accdoa", "adpit")
FORMAT_STEPS = 3
FORMAT_EPOCHS = 2  # the last one scans the confidence threshold


def unit(azi, ele):
    a, e = np.radians(azi), np.radians(ele)
    return np.array([np.cos(a) * np.cos(e), np.sin(a) * np.cos(e), np.sin(e)])


def render_mic_clip(rng, secs, sr, n_events):
    """int16 4-mic audio: class tones reaching each capsule of the
    tetrahedral array with its plane-wave delay from the labelled direction,
    over noise; and the label dict {frame: [[class, 0, azi, ele]]}."""
    n = sr * secs
    hop = int(sr * LABEL_HOP_S)
    mics = np.stack([unit(a, e) for a, e in MIC_DIRS]) * MIC_RADIUS_M
    audio = rng.standard_normal((n, 4)) * 0.02
    label = {}
    for _ in range(n_events):
        c = int(rng.integers(13))
        azi, ele = float(rng.integers(-180, 180)), float(rng.integers(-60, 61))
        dur = int(rng.integers(5, 15))
        start = int(rng.integers(0, n // hop - dur))
        t = np.arange(dur * hop) / sr
        lead = mics @ unit(azi, ele) / SOUND_M_S  # seconds a capsule hears it early
        f, ph = 320.0 * 2 ** (c / 3.0), rng.uniform(0, 6.28)
        for m in range(4):
            audio[start * hop:(start + dur) * hop, m] += 0.35 * np.sin(
                2 * np.pi * f * (t + lead[m]) + ph)
        for fr in range(start, start + dur):
            label.setdefault(fr, []).append([c, 0, azi, ele])
    return (np.clip(audio, -0.99, 0.99) * 32767).astype(np.int16), label


def write_mic_set(root, cfg):
    """A DCASE2022-layout MIC set under ``root``: unchunked dev-train clips of
    MIC_TRAIN_SECS, val and test clips of MIC_EVAL_SECS, metadata, classes;
    no scaler stats (``cli preprocess scaler`` writes them)."""
    rng = np.random.default_rng(17)
    sr = cfg.data.sr
    for s, secs in (("train", MIC_TRAIN_SECS), ("val", MIC_EVAL_SECS), ("test", MIC_EVAL_SECS)):
        os.makedirs(os.path.join(root, "mic_dev", f"dev-{s}"))
        os.makedirs(os.path.join(root, "metadata_dev", f"dev-{s}"))
        for i, n in enumerate(secs):
            audio, label = render_mic_clip(rng, n, sr, max(2, n // 3))
            write_wav(os.path.join(root, "mic_dev", f"dev-{s}", f"{s}{i:03d}.wav"), audio, sr)
            write_label_csv(os.path.join(root, "metadata_dev", f"dev-{s}", f"{s}{i:03d}.csv"),
                            label)
    with open(os.path.join(root, "classes.txt"), "w") as f:
        f.write("".join(f"class{c}\n" for c in range(cfg.data.nb_classes)))


def preset_dir(tmp, cfg, **data):
    """A copy of the repository's presets whose DCASE2022 data preset points
    at a set of this run (``data``: its overrides)."""
    configs = os.path.join(tmp, "configs")
    shutil.copytree(os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs"),
                    configs)
    p = os.path.join(configs, f"hyp_data_{cfg.data.dataset}.yaml")
    with open(p) as f:
        d = yaml.safe_load(f)
    d.update(chunk_window_s=cfg.data.chunk_window_s, **data)
    with open(p, "w") as f:
        yaml.safe_dump(d, f)
    return configs


def gcc_reference(audio, n_fft, n_lags):
    """GCC-PHAT lag features of (N, 4) audio in float64 numpy, the DCASE
    SELD baseline's definition: librosa-centred periodic-Hann frames,
    ``R = X_i conj(X_j)`` per mic pair, ``R / (|R| + 1e-8)``, a full
    ``irfft`` and the ``n_lags`` centred lags.  (T, n_lags, 6)."""
    hop = n_fft // 2
    x = np.pad(audio.astype(np.float64), ((hop, hop), (0, 0)), mode="reflect")
    T = len(audio) // hop
    w = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n_fft) / n_fft)
    frames = np.stack([x[t * hop:t * hop + n_fft] for t in range(T)])  # (T, n_fft, 4)
    X = np.fft.rfft(frames * w[None, :, None], axis=1)
    out = []
    for i in range(4):
        for j in range(i + 1, 4):
            R = X[:, :, i] * np.conj(X[:, :, j])
            cc = np.fft.irfft(R / (np.abs(R) + 1e-8), n=n_fft, axis=1)
            out.append(np.concatenate([cc[:, -(n_lags // 2):],
                                       cc[:, :n_lags - n_lags // 2]], axis=1))
    return np.stack(out, axis=-1)


def phase_preprocess_mic(smi, cfg):
    """A MIC set through ``cli.main``: ``preprocess chunking`` (the chunk
    count against the window formula, one chunk against its source slice),
    GCC-PHAT on the card against ``gcc_reference`` on 2 s of a clip,
    ``preprocess scaler`` on the card (K1 once per clip; 'MEL' (1, 64, 4)
    and 'GCC' (1, 64, 6) within SCALER_DEV_TOL of the same pass on the
    CPU), then ``train --augment`` (SE-ResNet34 + AD-YOLO, 2 epochs x 1 step
    of 16 x 20 s) on those stats, ``val`` and ``test``: finite losses, one
    CSV per clip, K1 once per step and per eval clip.  Counts set to 0
    just before the scaler pass and read after the test.  Beside them, the
    MIC and FOA front-ends on one 16 x 20-s batch (CUDA events, median of
    10) and FORMAT_STEPS bare MIC steps: the front-end's share of a step."""
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mic_")
    try:
        data = os.path.join(tmp, "data")
        write_mic_set(data, cfg)
        configs = preset_dir(tmp, cfg, data_pth=data, audio_format="mic",
                             name_pth=os.path.join(data, "classes.txt"))
        dcfg = build_config({"dataset": cfg.data.dataset, "config_dir": configs}).data
        secs = {"write_set": time.perf_counter() - t_phase}
        pre = ["--dataset", cfg.data.dataset, "--config_dir", configs]

        # chunking: (N' - W) // S + 1 windows a clip, N' padded to a stride
        t0 = time.perf_counter()
        require(cli.main(["preprocess", "chunking", *pre]) == 0, "preprocess chunking")
        secs["chunking"] = time.perf_counter() - t0
        sr, W, S = dcfg.sr, dcfg.sr * dcfg.chunk_window_s, dcfg.sr * dcfg.chunk_stride_s
        want = sum(-(-(n * sr - W) // S) + 1 for n in MIC_TRAIN_SECS)
        sub = f"dev-train-chunked_{dcfg.chunk_window_s}s_{dcfg.chunk_stride_s}s"
        chunk_dir = os.path.join(data, "mic_dev", sub)
        chunks = sorted(os.listdir(chunk_dir))
        require(len(chunks) == want, f"preprocess chunking wrote {len(chunks)} chunks, want {want}")
        src = read_wav(os.path.join(data, "mic_dev", "dev-train", "train000.wav"))
        k = want // len(MIC_TRAIN_SECS) // 2  # a middle chunk
        require(np.array_equal(read_wav(os.path.join(chunk_dir, f"train000_chunk{k + 1:03d}.wav")),
                               src[k * S:k * S + W]), f"chunk {k + 1} is not its source slice")
        require(len(chunk_clip(src, {}, dcfg)) == want // len(MIC_TRAIN_SECS),
                "chunk_clip's count")

        # GCC-PHAT on the card against numpy's irfft, 2 s of a clip
        fe = FeatureFrontend(dcfg, device="cuda")
        a = normalize_audio(src[:2 * sr])
        with torch.inference_mode():
            _, gcc = fe.raw_mel_aux(torch.tensor(a[None], device="cuda"))
        gcc = gcc[0].cpu().numpy()
        ref = gcc_reference(a, dcfg.n_fft, dcfg.mel_bins)
        gcc_err = float(np.abs(gcc - ref).max())
        require(gcc.shape == ref.shape and gcc_err <= GCC_REF_TOL * float(np.abs(ref).max()),
                f"GCC-PHAT vs numpy irfft: {gcc_err} > {GCC_REF_TOL} * {np.abs(ref).max()}")

        # the front-end's share of a bare MIC step (16 x 20 s, SE-ResNet34 +
        # AD-YOLO, fp32), beside the FOA front-end on the same audio
        mcfg = dataclasses.replace(cfg, data=dcfg)
        batches = [synthetic_batch(mcfg, np.random.default_rng(23), CLI_BATCH)
                   for _ in range(2)]
        x = batches[0]["audio"].to(torch.float32) / 32768.0 + 1e-8
        fe_foa = make_frontend(cfg)
        with torch.inference_mode():
            front_ms = {"mic": float(np.median(cuda_ms(lambda: fe(x), 10))),
                        "foa": float(np.median(cuda_ms(lambda: fe_foa(x), 10)))}
        r = run_steps(mcfg, fe, batches, FORMAT_STEPS)
        for i, n in enumerate(r["per_step"]):
            require(n == {**{k: 0 for k in n}, "stft": 1}, f"mic bare step {i + 1}: launches {n}")
        mic_step = {"losses": r["losses"], "step_ms": r["step_ms"],
                    "median_step_ms": r["median_step_ms"], "peak_mem_gb": r["peak_mem_gb"],
                    "front_end_ms": front_ms,
                    "front_end_share": front_ms["mic"] / r["median_step_ms"]}
        del r, batches, x, fe_foa

        # the scaler pass on the card, K1 once per clip; against the CPU pass
        rec = probe_record()
        with engine_probes(rec):
            zero_counts()  # the path's count starts here
            t0 = time.perf_counter()
            require(cli.main(["preprocess", "scaler", *pre, "--device", "cuda"]) == 0,
                    "preprocess scaler")
            torch.cuda.synchronize()
            secs["scaler"] = time.perf_counter() - t0
            scaler_launches = counts()
            require(scaler_launches == {**{n: 0 for n in scaler_launches},
                                        "stft": len(MIC_TRAIN_SECS)},
                    f"preprocess scaler: launches {scaler_launches}")
            with open(os.path.join(data, "scaler_wts.pkl"), "rb") as f:
                stats = pickle.load(f)
            cpu = compute_scaler_stats(dcfg, device="cpu", verbose=False)
            require(set(stats) == {"MEL", "GCC"}, f"scaler blocks {sorted(stats)}")
            stat_err = {}
            for block, C in (("MEL", 4), ("GCC", 6)):
                for st in ("mean", "std"):
                    g, w = np.asarray(stats[block][st]), np.asarray(cpu[block][st])
                    require(g.shape == (1, dcfg.mel_bins, C), f"{block} {st}: {g.shape}")
                    stat_err[f"{block}_{st}"] = float(np.abs(g - w).max())
                    require(stat_err[f"{block}_{st}"] <= SCALER_DEV_TOL * float(np.abs(w).max()),
                            f"scaler {block} {st}: card vs CPU {stat_err[f'{block}_{st}']}")

            # train, val and test on the MIC stats
            results = os.path.join(tmp, "results")
            exp = os.path.join(results, "chip-mic")
            t0 = time.perf_counter()
            require(cli.main(["train", "--augment", "--logger", "--nb_epochs", "2",
                              "--nb_iters", "1", "--batch_size", str(CLI_BATCH),
                              "--config_dir", configs, "--results_dir", results,
                              "--exp_id", "chip-mic", "--device", "cuda"]) == 0, "mic train")
            secs["train_cli"] = time.perf_counter() - t0
            for action in ("val", "test"):
                t0 = time.perf_counter()
                require(cli.main([action, "--eval_pth", "chip-mic", "--results_dir", results,
                                  "--device", "cuda"]) == 0, f"mic {action}")
                secs[action] = time.perf_counter() - t0
                require(len(os.listdir(os.path.join(exp, "output_eval"))) == len(MIC_EVAL_SECS),
                        f"mic {action}: not one CSV per clip")
            torch.cuda.synchronize()
            launched = counts()
        logs = read_logs(exp)
        for split in ("train", "val", "test"):
            got = logs[f"logs/{split}/loss"]
            require(sorted(got) == [1, 2] and np.isfinite(list(got.values())).all(),
                    f"mic {split} loss {got}")
        require(len(rec["steps"]) == 2, f"mic: {len(rec['steps'])} train steps")
        for e in rec["steps"] + rec["evals"]:
            n = {k: v for k, v in e.items() if k != "frames"}
            require(n == {**{k: 0 for k in n}, "stft": 1}, f"mic: launches {e}, want K1 once")
        require(len(rec["evals"]) > 0, "mic: no eval clip ran")
        emit({"phase": "preprocess_mic", "chunks": len(chunks), "bare_step": mic_step,
              "gcc_vs_numpy": gcc_err,
              "gcc_tol_rel": GCC_REF_TOL, "scaler_card_vs_cpu": stat_err,
              "scaler_tol_rel": SCALER_DEV_TOL, "scaler_launches": scaler_launches,
              "losses": {s: logs[f"logs/{s}/loss"] for s in ("train", "val", "test")},
              "train_s": [logs["logs/train/time_s"][e] for e in (1, 2)],
              "eval_clips": len(rec["evals"]), "launches": launched, "seconds": secs,
              "phase_s": time.perf_counter() - t_phase, "card": smi})
        return launched
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def dense_reference_loss(loss, out, target, K):
    """A dense format's loss in float64 numpy, as the reference
    (``src/models/loss.py``) writes it: BCE (log clamped at -100) +
    1000 x MSE for SED-DOA (the DOA gated by the activity target when
    masked), MSE for ACCDOA, and for ADPIT the least MSE over the 13 named
    track permutations, each with the pad of the two other groups."""
    o, t = out.astype(np.float64), target.astype(np.float64)
    if loss in ("seddoa", "masked-seddoa"):
        p, y = o[..., :K], t[..., :K]
        with np.errstate(divide="ignore"):
            bce = -(y * np.maximum(np.log(p), -100) + (1 - y) * np.maximum(np.log(1 - p), -100))
        doa = o[..., K:] * (np.concatenate([y, y, y], -1) if loss == "masked-seddoa" else 1)
        return bce.mean() + 1000.0 * ((doa - t[..., K:]) ** 2).mean()
    if loss == "accdoa":
        return ((o - t) ** 2).mean()
    slots = t[:, :, :, 0:1] * t[:, :, :, 1:]  # (B, T, 6, 3, K): A0 B0 B1 C0 C1 C2
    A0, B0, B1, C0, C1, C2 = (slots[:, :, i] for i in range(6))

    def cat(*s):
        return np.concatenate(s, axis=2)

    a = [cat(A0, A0, A0)]
    b = [cat(B0, B0, B1), cat(B0, B1, B0), cat(B0, B1, B1), cat(B1, B0, B0), cat(B1, B0, B1),
         cat(B1, B1, B0)]
    c = [cat(C0, C1, C2), cat(C0, C2, C1), cat(C1, C0, C2), cat(C1, C2, C0), cat(C2, C0, C1),
         cat(C2, C1, C0)]
    tracks = ([x + b[0] + c[0] for x in a] + [x + a[0] + c[0] for x in b]
              + [x + a[0] + b[0] for x in c])
    o9 = o.reshape(o.shape[0], o.shape[1], 9, K)
    return np.stack([((o9 - tr) ** 2).mean(axis=2) for tr in tracks]).min(axis=0).mean()


def dense_targets(loss, cfg, rng, B, frames):
    """(B, frames, ...) float32 dense targets of random labels (one to three
    events on 70 % of the label frames, often of one class) from the port's
    encoders."""
    enc = {"seddoa": encode_seddoa, "masked-seddoa": encode_seddoa,
           "accdoa": encode_accdoa, "adpit": encode_adpit}[loss]
    per_clip = []
    for _ in range(B):
        label = {}
        for f in range(frames):
            if rng.random() < 0.7:
                c = int(rng.integers(cfg.data.nb_classes))
                label[f] = [[c if rng.random() < 0.6 else int(rng.integers(13)), i,
                             float(rng.uniform(-180, 180)), float(rng.uniform(-90, 90))]
                            for i in range(int(rng.integers(1, 4)))]
        per_clip.append(enc(label, frames, cfg.data.nb_classes))
    return np.stack(per_clip)


def dense_batch(loss, cfg, rng, B):
    """B 20-s int16 chunks in hop-block layout and their dense targets, on
    the card."""
    targets = dense_targets(loss, cfg, rng, B, cfg.data.chunk_label_frames)
    T = cfg.data.chunk_samples // HOP
    audio = (rng.standard_normal((B, T, HOP, 4)) * 1500).astype(np.int16)
    return {"audio": torch.tensor(audio, device="cuda"),
            "targets": torch.tensor(targets, device="cuda")}


def check_dense_losses(cfg):
    """Each dense loss on the card (float32, a frame mask) against
    ``dense_reference_loss`` on the frames it keeps."""
    rng = np.random.default_rng(21)
    K = cfg.data.nb_classes
    errs = {}
    for loss in DENSE_LOSSES:
        c = dataclasses.replace(cfg, args=dataclasses.replace(cfg.args, loss=loss))
        t = dense_targets(loss, c, rng, 4, 40)
        width = {"accdoa": 3 * K, "adpit": 9 * K}.get(loss, 4 * K)
        out = np.tanh(rng.normal(0, 1, t.shape[:2] + (width,))).astype(np.float32)
        if loss.endswith("seddoa"):
            out[..., :K] = rng.uniform(0.01, 0.99, out[..., :K].shape)
        valid = 31
        fm = torch.arange(40, device="cuda")[None, :] < valid
        got = float(make_criterion(c)(torch.tensor(out, device="cuda"),
                                      torch.tensor(t, device="cuda"), None,
                                      fm.expand(4, 40)))
        want = float(dense_reference_loss(loss, out[:, :valid], t[:, :valid], K))
        errs[loss] = abs(got - want) / abs(want)
        require(errs[loss] <= DENSE_LOSS_TOL, f"{loss} loss on the card {got} vs reference {want}")
    return errs


def phase_train_cli_formats(smi, cfg):
    """The dense formats at full width (13 classes, fp32) on the FOA set of
    ``write_dcase_set``.  Each dense loss on the card against numpy on a
    small input; then for each of seddoa, masked-seddoa, accdoa, adpit on
    SE-ResNet34: FORMAT_STEPS bare steps of 16 x 20 s (K1 once a step;
    median step, peak memory), step 1 against the same step on
    plain-STFT features (loss within TRAIN_LOSS_TOL rel), then ``cli.main``
    train (FORMAT_EPOCHS epochs x 1 step, the last scanning τ), val and
    test: finite losses, in-range metrics, one CSV per clip, one score
    block per call (three for adpit), K1 once per step and eval clip.
    Then accdoa on ResNet-Conformer through ``cli.main`` train: per step
    K1 once and k2_dropout / k3 8 times, per eval clip k2 or k4 8 times.
    Counts set to 0 before the first CLI call, read after the last of each
    encoder."""
    t_phase = time.perf_counter()
    loss_errs = check_dense_losses(cfg)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_formats_")
    scan_every = train_mod.SCAN_EVERY
    try:
        data = os.path.join(tmp, "data")
        write_dcase_set(data, cfg, os.path.join(cfg.data.data_pth, "scaler_wts.pkl"))
        configs = preset_dir(tmp, cfg, data_pth=data, name_pth=os.path.join(data, "classes.txt"))
        results = os.path.join(tmp, "results")
        train_mod.SCAN_EVERY = FORMAT_EPOCHS
        fe, fe_plain = make_frontend(cfg), make_frontend(cfg)
        dft = window_dft(cfg.data.window, cfg.data.win_length, cfg.data.n_fft)
        fe_plain.stft = lambda x: plain_stft.stft(x, *dft, HOP)
        rng = np.random.default_rng(19)
        rows, launched = {}, {}
        for loss in DENSE_LOSSES + ("accdoa-conformer",):
            name, encoder = loss.split("-conformer")[0], "resnet-conformer" \
                if loss.endswith("-conformer") else "se-resnet34"
            lcfg = dataclasses.replace(cfg, args=dataclasses.replace(
                cfg.args, loss=name, encoder=encoder))
            row = {}
            if encoder == "se-resnet34":
                batches = [dense_batch(name, lcfg, rng, CLI_BATCH) for _ in range(2)]
                r = run_steps(lcfg, fe, batches, FORMAT_STEPS)
                for i, n in enumerate(r["per_step"]):
                    require(n == {**{k: 0 for k in n}, "stft": 1},
                            f"{loss} bare step {i + 1}: launches {n}")
                ref = run_steps(lcfg, fe_plain, batches, 1)
                require(abs(r["losses"][0] - ref["losses"][0])
                        <= TRAIN_LOSS_TOL * abs(ref["losses"][0]),
                        f"{loss} step 1 on K1 {r['losses'][0]} vs plain STFT {ref['losses'][0]}")
                row.update(bare_losses=r["losses"], step1_plain_stft=ref["losses"][0],
                           step_ms=r["step_ms"], median_step_ms=r["median_step_ms"],
                           peak_mem_gb=r["peak_mem_gb"])
                del r, ref, batches
            rec = probe_record()
            exp_id = f"chip-{loss}"
            exp = os.path.join(results, exp_id)
            secs = {}
            with engine_probes(rec):
                zero_counts()  # this run's count starts here
                t0 = time.perf_counter()
                require(cli.main(["train", "--encoder", encoder, "--loss", name, "--logger",
                                  "--nb_epochs", str(FORMAT_EPOCHS), "--nb_iters", "1",
                                  "--batch_size", str(CLI_BATCH), "--config_dir", configs,
                                  "--results_dir", results, "--exp_id", exp_id,
                                  "--device", "cuda"]) == 0, f"{loss} train")
                secs["train_cli"] = time.perf_counter() - t0
                blocks = 3 if name == "adpit" else 1
                actions = ("val", "test") if encoder == "se-resnet34" else ()
                for action in actions:
                    n_printed = len(rec["printed"])
                    t0 = time.perf_counter()
                    require(cli.main([action, "--eval_pth", exp_id, "--results_dir", results,
                                      "--device", "cuda"]) == 0, f"{loss} {action}")
                    secs[action] = time.perf_counter() - t0
                    printed = rec["printed"][n_printed:]
                    require(len(printed) == 3 * blocks and np.isfinite(printed).all(),
                            f"{loss} {action}: printed {printed}")
                    require(len(os.listdir(os.path.join(exp, "output_eval"))) == len(EVAL_SECS),
                            f"{loss} {action}: not one CSV per clip")
                torch.cuda.synchronize()
                grown = counts()
            logs = read_logs(exp)
            epochs = list(range(1, FORMAT_EPOCHS + 1))
            for split in ("train", "val", "test"):
                got = logs[f"logs/{split}/loss"]
                require(sorted(got) == epochs and np.isfinite(list(got.values())).all(),
                        f"{loss} {split} loss {got}")
            for split in ("val", "test"):
                require(len(os.listdir(os.path.join(exp, f"output_{split}"))) == len(EVAL_SECS),
                        f"{loss}: output_{split} is not one CSV per clip")
                for m, hi in (("ER", np.inf), ("F1", 100.0), ("LE", 180.0), ("LR", 100.0),
                              ("SELD", np.inf)):
                    v = np.array(list(logs[f"logs/{split}/{m}"].values()))
                    require(np.isfinite(v).all() and (v >= 0).all() and (v <= hi).all(),
                            f"{loss} {split} {m}: {v}")
            require(FORMAT_EPOCHS in logs.get("logs/train/conf_thresh", {}),
                    f"{loss}: epoch {FORMAT_EPOCHS} did not scan the threshold")
            require(len(rec["steps"]) == FORMAT_EPOCHS, f"{loss}: {len(rec['steps'])} steps")
            nb = CONFORMER_BLOCKS if encoder == "resnet-conformer" else 0
            for i, n in enumerate(rec["steps"]):
                require(n == {**{k: 0 for k in n}, "stft": 1, "k2_dropout": nb, "k3": nb},
                        f"{loss} train step {i + 1}: launches {n}")
            for e in rec["evals"]:
                n = {k: v for k, v in e.items() if k != "frames"}
                route = "k4" if e["frames"] > attention.BLOCK_THRESHOLD else "k2"
                require(n == {**{k: 0 for k in n}, "stft": 1, route: nb},
                        f"{loss} eval clip of {e['frames']} frames: launches {e}")
            launched[loss] = grown
            row.update(losses={s: logs[f"logs/{s}/loss"] for s in ("train", "val", "test")},
                       epoch_s=[logs["logs/train/time_s"][e] + logs["logs/val/time_s"][e]
                                + logs["logs/test/time_s"][e] for e in epochs],
                       val_s=[logs["logs/val/time_s"][e] for e in epochs],
                       test_s=[logs["logs/test/time_s"][e] for e in epochs],
                       cli_s=secs, eval_clips=len(rec["evals"]), launches=grown)
            rows[loss] = row
            emit({"phase": "train_cli_formats", "loss": loss, "encoder": encoder, **row,
                  "card": smi})
        emit({"phase": "train_cli_formats", "dense_loss_vs_reference_rel": loss_errs,
              "tol_rel": DENSE_LOSS_TOL, "seconds": time.perf_counter() - t_phase,
              "card": smi})
        return launched
    finally:
        train_mod.SCAN_EVERY = scan_every
        shutil.rmtree(tmp, ignore_errors=True)


# ---- data parallelism: two ranks on the one card ----------------------------

DDP_WORLD = 2
DDP_BATCH = 16  # the global batch; 8 clips a rank
DDP_STEPS = 5  # phase (c)
DDP_SEED = 21
# The ranks' gradients against the single-process step's: the whole
# gradient's L2 distance, relative to its norm, within TRAIN_GRAD_TOL or
# this many times float32's own distance between two single-process steps
# that sum the batch in another order, whichever is larger.  That floor is
# not small here: on the card the largest element moves by 5.9e-4 (SE-
# ResNet34) and 8.6e-3 (the conformer) of max|grad|, and in L2 by 3.1e-4
# and 5.3e-3 (NVIDIA H100 80GB HBM3, 700.00 W).  The largest element is
# reported, not held: over two orders its maximum wanders by 2x.  In
# float64 the data-parallel and single-process steps agree within 1e-8
# (tests/test_torch_ddp.py, on the CPU).
DDP_FLOOR_RATIO = 2.0


def ddp_cases(cfg, conf_cfg):
    """Phase ddp's step cases: (a) SE-ResNet34 and (b) the conformer with
    ``remat``, fp32, AD-YOLO, dropout 0; (c) the conformer in bf16 with its
    dropout (0.2): name -> (config, dropout on)."""
    return {"se": (cfg, False),
            "conformer_remat": (with_train(conf_cfg, remat=True), False),
            "conformer_bf16": (with_train(conf_cfg, compute_dtype="bfloat16"), True)}


def ddp_model(cfg, dropout):
    """The seeded model in training mode, its dropout off unless asked."""
    model = build_model(cfg, generator=torch.Generator().manual_seed(0), train=True)
    if not dropout:
        for m in model.modules():
            if isinstance(m, U8Dropout):
                m.rate = 0.0
            elif isinstance(m, resnet_conformer.MHSA):
                m.dropout = 0.0
    return model


def ddp_record(model):
    """The gradients and running stats, copied to the host."""
    return {"grads": {n: p.grad.detach().to("cpu", copy=True)
                      for n, p in model.named_parameters()},
            "stats": {f"{n}.{b}": getattr(m, b).detach().to("cpu", copy=True)
                      for n, m in model.named_modules() if isinstance(m, BatchNorm)
                      for b in ("running_mean", "running_var")}}


def ddp_collective_ms(model):
    """The collectives of one data-parallel step, timed alone on the batch
    group (host clock from a synchronised device to the end of the
    collective's device work, median of 5 after a warm-up): one gloo
    all-reduce of all the float32 gradients at once (DDP splits them into
    buckets) and one of a BatchNorm's moments (3 x 512 floats, the widest),
    with the count of the latter a step (one a BatchNorm forward and one
    backward)."""
    n = sum(p.numel() for p in model.parameters())
    n_bn = sum(isinstance(m, BatchNorm) for m in model.modules())
    out = {"grad_floats": n, "bn_allreduces_per_step": 2 * n_bn}
    for key, numel in (("grad_allreduce_ms", n), ("bn_allreduce_ms", 3 * 512)):
        x = torch.ones(numel, device="cuda")
        ms = []
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dist.all_reduce(x, group=mesh.batch_group())
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        out[key] = float(np.median(ms[1:]))
    return out


def ddp_worker(rank, tmp, cfg, conf_cfg):
    """One rank of phase ddp, on ``cuda:0`` beside the other, in a gloo
    group: the data-parallel step of each case on this rank's 8 clips of
    the global batch, the plain STFT and attention patched to raise, the
    launch counts set to 0 just before each case's steps and read just
    after; rank 0 writes its gradients for the parent's comparison; every
    rank checks that it holds rank 0's gradients and running stats (gloo
    broadcasts of CUDA tensors)."""
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous",
                            rank=rank, world_size=DDP_WORLD)
    try:
        mesh.init_distributed("cuda:0")  # the batch and control groups
        fe = make_frontend(cfg)
        out = {}
        for name, (c, dropout) in ddp_cases(cfg, conf_cfg).items():
            audio, per_clip = synthetic_clips(c, np.random.default_rng(DDP_SEED), DDP_BATCH)
            shard = clips_batch(c, audio[rank::DDP_WORLD], per_clip[rank::DDP_WORLD])
            model = ddp_model(c, dropout)
            step = build_train_step(c, model, fe)
            gen = torch.Generator(device="cuda").manual_seed(1234)
            n_steps = DDP_STEPS if name == "conformer_bf16" else 1
            torch.cuda.synchronize()
            losses, step_ms, per_step = [], [], []
            with plain_versions_raise():
                zero_counts()
                for _ in range(n_steps):
                    before = counts()
                    t0 = time.perf_counter()
                    losses.append(float(step(shard, gen)))  # ends in a device -> host copy
                    step_ms.append((time.perf_counter() - t0) * 1e3)
                    per_step.append({n: v - before[n] for n, v in counts().items()})
                launched = counts()
            if name == "conformer_bf16":  # where a rank's step goes
                prof = profile_calls(lambda i: step(shard, gen), 2, every_rank=True,
                                     expect=kernels_launched(lambda: step(shard, gen)))
                collectives = ddp_collective_ms(model)
            rec = ddp_record(model)
            same = True
            for t in list(rec["grads"].values()) + list(rec["stats"].values()):
                mine = t.to("cuda")
                theirs = mine.clone()
                dist.broadcast(theirs, src=0)
                same &= torch.equal(mine, theirs)
            row = {"losses": losses, "step_ms": step_ms, "per_step": per_step,
                   "launched": launched, "same_as_rank0": same}
            if name == "conformer_bf16":
                row.update(profile=prof, collectives=collectives)
            if rank == 0 and name != "conformer_bf16":
                torch.save(rec, os.path.join(tmp, f"{name}.pt"))
            out[name] = row
            del model, step, rec
            torch.cuda.empty_cache()
        with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def grad_distance(got, want):
    """``got``'s step against ``want``'s: the losses and their relative
    distance, the largest gradient error over the largest gradient (and
    the tensor it is in), the whole gradient's L2 distance relative to its
    norm, and the running stats' largest error relative to each one's max."""
    gmax = max(float(g.abs().max()) for g in want["grads"].values())
    err, worst = max((float((got["grads"][n] - g).abs().max()), n)
                     for n, g in want["grads"].items())
    l2 = sum(float(((got["grads"][n] - g) ** 2).sum()) for n, g in want["grads"].items())
    norm = sum(float((g ** 2).sum()) for g in want["grads"].values())
    return {"loss": [got["loss"], want["loss"]],
            "loss_rel": abs(got["loss"] - want["loss"]) / abs(want["loss"]),
            "grad_rel": err / gmax, "grad_worst_tensor": worst, "grad_max_abs": gmax,
            "grad_l2_rel": (l2 / norm) ** 0.5,
            "stats_rel": max(float((got["stats"][n] - t).abs().max()) / float(t.abs().max())
                             for n, t in want["stats"].items())}


def ddp_grad_tol(row):
    """The bound of a data-parallel step's relative L2 gradient distance:
    TRAIN_GRAD_TOL, or DDP_FLOOR_RATIO x float32's floor measured beside
    it (``single_process_batch_order_floor``), whichever is larger."""
    floor = row["single_process_batch_order_floor"]["grad_l2_rel"]
    return max(TRAIN_GRAD_TOL, DDP_FLOOR_RATIO * floor)


def free_port():
    import socket

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def phase_ddp(smi, cfg, conf_cfg):
    """Data-parallel training on two ranks sharing the one card (gloo: NCCL
    refuses two ranks on one device).  The single-process step of cases (a)
    and (b) at B = DDP_BATCH x 20 s is taken first, in this process, on the
    global batch in the ranks' order (and again in its own order: the
    float32 floor of a comparison that sums in another order); then
    two ranks are spawned (the kernels are built already) and take the
    same steps on 8 clips each: the global loss within TRAIN_LOSS_TOL rel,
    the gradients' L2 distance within :func:`ddp_grad_tol` and the running
    stats within TRAIN_GRAD_TOL x each one's max of the single-process
    step's, gradients and stats equal on both ranks; per rank per step K1
    once and, for the conformer, k2_dropout 16 times (remat runs each
    block's forward again in the backward) and k3 8 times, with the plain
    versions patched to raise.  (c) DDP_STEPS bf16 steps with
    dropout: finite losses, k2_dropout_bf16 / k3_bf16 8 each per rank per
    step, step time per rank and the two ranks' audio-s/s.  (d) ``python -m
    adyolo_tpu_torch.cli train --quick_test`` under torchrun's variables at
    world size 1: NCCL's init, rank 0's experiment, evaluation and final
    test; exit 0 and one experiment dir.  The launch counts of the ranks'
    steps (both ranks) are the path ``ddp``."""
    t_phase = time.perf_counter()
    cases = ddp_cases(cfg, conf_cfg)
    fe = make_frontend(cfg)
    ref, floor = {}, {}
    for name in ("se", "conformer_remat"):
        c, dropout = cases[name]
        audio, per_clip = synthetic_clips(c, np.random.default_rng(DDP_SEED), DDP_BATCH)
        # the global batch in the ranks' order (rank 0's clips, then rank
        # 1's), and in its own: float32's distance between the two is the
        # floor of any comparison that sums in another order
        order = [i for r in range(DDP_WORLD) for i in range(r, DDP_BATCH, DDP_WORLD)]
        runs = []
        for idx in (order, list(range(DDP_BATCH))):
            model = ddp_model(c, dropout)
            step = build_train_step(c, model, fe)
            batch = clips_batch(c, audio[idx], [per_clip[i] for i in idx])
            gen = torch.Generator(device="cuda").manual_seed(1234)
            runs.append({"loss": float(step(batch, gen)), **ddp_record(model)})
            del model, step, batch
        ref[name] = runs[0]
        floor[name] = grad_distance(runs[1], runs[0])
    torch.cuda.empty_cache()
    require(os.path.isfile(build.library_path()), "ddp: the kernels are not built")

    tmp = tempfile.mkdtemp(prefix="chip_smoke_ddp_")
    try:
        t0 = time.perf_counter()
        torch.multiprocessing.spawn(ddp_worker, args=(tmp, cfg, conf_cfg),
                                    nprocs=DDP_WORLD, join=True)
        spawn_s = time.perf_counter() - t0
        ranks = []
        for r in range(DDP_WORLD):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        rows = {}
        for name in ("se", "conformer_remat"):
            got = torch.load(os.path.join(tmp, f"{name}.pt"))
            got["loss"] = ranks[0][name]["losses"][0]
            rows[name] = {**grad_distance(got, ref[name]),
                          "single_process_batch_order_floor": floor[name]}
        emit({"phase": "ddp_vs_single_process", **rows, "card": smi})
        for name, row in rows.items():
            require(row["loss_rel"] <= TRAIN_LOSS_TOL,
                    f"ddp {name}: loss {row['loss']} vs single-process")
            tol = ddp_grad_tol(row)
            require(row["grad_l2_rel"] <= tol,
                    f"ddp {name}: grads L2 distance {row['grad_l2_rel']} > {tol}")
            require(row["stats_rel"] <= TRAIN_GRAD_TOL,
                    f"ddp {name}: running stats err {row['stats_rel']}")
        nb = CONFORMER_BLOCKS
        want_step = {"se": {"stft": 1},
                     # remat runs each block's forward again in the backward
                     "conformer_remat": {"stft": 1, "k2_dropout": 2 * nb, "k3": nb},
                     "conformer_bf16": {"stft": 1, "k2_dropout_bf16": nb, "k3_bf16": nb}}
        path = None
        for r, rec in enumerate(ranks):
            for name, want in want_step.items():
                row = rec[name]
                require(row["same_as_rank0"], f"ddp {name}: rank {r} differs from rank 0")
                require(all(np.isfinite(row["losses"])), f"ddp {name} rank {r}: {row['losses']}")
                require(row["losses"] == ranks[0][name]["losses"],
                        f"ddp {name}: the ranks' global losses differ")
                for i, n in enumerate(row["per_step"]):
                    require(n == {**{k: 0 for k in n}, **want},
                            f"ddp {name} rank {r} step {i + 1}: launches {n}, want {want}")
                path = {k: (0 if path is None else path[k]) + v
                        for k, v in row["launched"].items()}
        bf = [rec["conformer_bf16"] for rec in ranks]
        per_rank_ms = [float(np.median(b["step_ms"][1:])) for b in bf]
        rows["conformer_bf16"] = {
            "losses": bf[0]["losses"], "step_ms": [b["step_ms"] for b in bf],
            "profile_rank0": bf[0]["profile"], "collectives_rank0": bf[0]["collectives"],
            "median_step_ms_per_rank": per_rank_ms,
            "audio_s_per_s_two_ranks_sharing_one_card":
                DDP_BATCH * 20.0 / (max(per_rank_ms) * 1e-3)}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # (d) the CLI over NCCL at world size 1
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ddp_cli_")
    try:
        data = os.path.join(tmp, "data")
        write_dcase_set(data, cfg, os.path.join(cfg.data.data_pth, "scaler_wts.pkl"))
        configs = preset_dir(tmp, cfg, data_pth=data, name_pth=os.path.join(data, "classes.txt"))
        results = os.path.join(tmp, "results")
        repo = os.path.dirname(os.path.abspath(__file__))
        env = dict(os.environ, RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()),
                   PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""))
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "adyolo_tpu_torch.cli", "train", "--quick_test",
             "--batch_size", str(CLI_BATCH), "--nb_iters", "1", "--config_dir", configs,
             "--results_dir", results, "--exp_id", "chip-ddp-cli", "--device", "cuda"],
            cwd=repo, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        try:
            out, err = proc.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
        cli_s = time.perf_counter() - t0
        require(proc.returncode == 0, f"ddp cli: exit {proc.returncode} after {cli_s:.0f} s\n"
                f"{out[-3000:]}\n{err[-3000:]}")
        exps = os.listdir(results)
        exp = os.path.join(results, "chip-ddp-cli")
        require(exps == ["chip-ddp-cli"], f"ddp cli: experiment dirs {exps}")
        for f in ("hyp_exp.yaml", "model_best.ckpt", "model_ckpt.ckpt"):
            require(os.path.isfile(os.path.join(exp, f)), f"ddp cli: no {f}")
        final = out.count("FINAL TEST WITH BEST CHECKPOINT")
        require(final == 1, f"ddp cli: the final test ran {final} times")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "ddp", "world": DDP_WORLD, "backend": "gloo, two ranks sharing one card",
          "global_batch": [DDP_BATCH, 800, HOP, 4], **rows, "launches": path,
          "tol": {"loss_rel": TRAIN_LOSS_TOL, "grad_rel": TRAIN_GRAD_TOL},
          "spawn_s": spawn_s, "cli_nccl_world1_s": cli_s,
          "seconds": time.perf_counter() - t_phase, "card": smi})
    return path


# ---- tensor parallelism: two ranks, one model group, on the one card --------

TP_WORLD = 2  # ranks in the model group: 2 of the 4 heads each
TP_BATCH = 4  # clips of 20 s
TP_STEPS = 4  # step 1 is compared; 2-4 are timed
TP_SEED = 22
TP_HEADS = (2, 4)  # the head shard of the kernel checks: heads [2, 4) of 4
TP_BF16_SLICE_TOL = 2.0 ** -7  # bf16 shard vs the full launch's slice, x max


def tp_kernel_checks():
    """Each train route of both dtypes on heads [2, 4) of (4, 800, 4, 64)
    q/k/v (``heads=TP_HEADS``), rate 0.2, one ragged row: against the
    plain version at the same offset and against heads [2, 4) of the full
    launch with the same seed (the slice's errors show that the bits are
    the full model's: a wrong head index draws another mask)."""
    rng = np.random.default_rng(TP_SEED)
    B, T = TP_BATCH, 800
    kv = torch.tensor([800, 800, 611, 800][:B], dtype=torch.int32, device="cuda")
    seed = torch.tensor([4321], dtype=torch.int32, device="cuda")
    h0, ht = TP_HEADS
    rows = {}
    for dtype, fwd, bwd in ((torch.float32, "k2_dropout", "k3"),
                            (torch.bfloat16, "k2_dropout_bf16", "k3_bf16")):
        q, k, v, do = (torch.tensor(rng.standard_normal((B, T, ht, 64)), dtype=torch.float32,
                                    device="cuda").to(dtype) for _ in range(4))
        part = [x[:, :, h0:].contiguous() for x in (q, k, v, do)]

        def run(q, k, v, do, heads):
            args = [x.clone().requires_grad_(True) for x in (q, k, v)]
            out = hopper_attention.flash_attention(*args, kv, rate=RATE, seed=seed,
                                                   heads=heads)
            out.backward(do)
            return [out.detach()] + [a.grad for a in args]

        zero_counts()
        got = run(*part, TP_HEADS)
        full = [x[:, :, h0:] for x in run(q, k, v, do, None)]
        torch.cuda.synchronize()
        require(counts()[fwd] == 2 and counts()[bwd] == 2, f"tp kernels: launches {counts()}")
        names = ("out", "dq", "dk", "dv")
        row = {"shape": [B, T, ht - h0, 64], "heads": list(TP_HEADS),
               "slice_err_rel": {}, "slice_bit_equal": {}}
        for n, g, f in zip(names, got, full):
            scale = float(f.float().abs().max())
            row["slice_err_rel"][n] = float((g.float() - f.float()).abs().max()) / scale
            row["slice_bit_equal"][n] = bool(torch.equal(g, f))
        if dtype == torch.float32:
            plain = [attention.mhsa_attention(*part[:3], kv, rate=RATE, seed=seed,
                                              heads=TP_HEADS),
                     *attention.mhsa_attention_bwd(*part[:3], kv, part[3], rate=RATE,
                                                   seed=seed, heads=TP_HEADS)]
            row["plain_err_rel"] = {n: float((g - w).abs().max()) / float(w.abs().max())
                                    for n, g, w in zip(names, got, plain)}
            for n, err in row["plain_err_rel"].items():
                tol = KERNEL_TOL if n == "out" else GRAD_KERNEL_TOL
                require(err <= tol, f"tp {fwd}/{bwd} at heads {TP_HEADS}: {n} err {err}")
                require(row["slice_err_rel"][n] <= tol,
                        f"tp {fwd}/{bwd}: {n} differs from the full launch's heads "
                        f"[{h0}, {ht}) by {row['slice_err_rel'][n]}")
        else:
            truth = bf16_truth(*part[:3], kv, part[3], seed, TP_HEADS)
            plain = [attention.mhsa_attention(*part[:3], kv, rate=RATE, seed=seed,
                                              heads=TP_HEADS),
                     *attention.mhsa_attention_bwd(*part[:3], kv, part[3], rate=RATE,
                                                   seed=seed, heads=TP_HEADS)]
            row["err_vs_f64"], row["plain_err_vs_f64"] = {}, {}
            for n, g, w, t in zip(names, got, plain, truth):
                scale = float(t.abs().max())
                e_k = float((g.double() - t).abs().max())
                e_p = float((w.double() - t).abs().max())
                row["err_vs_f64"][n], row["plain_err_vs_f64"][n] = e_k / scale, e_p / scale
                require(e_k <= BF16_RATIO * e_p + BF16_HALF_STEP * scale,
                        f"tp {fwd}/{bwd} at heads {TP_HEADS}: {n} err {e_k} vs plain {e_p}")
                require(row["slice_err_rel"][n] <= TP_BF16_SLICE_TOL,
                        f"tp {fwd}/{bwd}: {n} differs from the full launch's heads "
                        f"[{h0}, {ht}) by {row['slice_err_rel'][n]}")
        rows[f"{fwd}+{bwd}"] = row
        del q, k, v, do, part, got, full, plain
    return rows


def tp_cases(conf_cfg):
    return {"fp32": conf_cfg, "bf16": with_train(conf_cfg, compute_dtype="bfloat16")}


def tp_gathered_record(model, plan):
    """After a TP step: the gradients and running stats gathered into the
    full model's shapes (on the host), and whether every rank of the group
    holds rank 0's gradients of the parameters that ``plan`` holds whole
    and rank 0's replicated stats (gloo broadcasts of CUDA tensors)."""
    rec = ddp_record(model)
    mine = torch.cat([t.reshape(-1) for n, t in list(rec["grads"].items())
                      + list(rec["stats"].items()) if plan.rule(n) is None]).to("cuda")
    theirs = mine.clone()
    dist.broadcast(theirs, src=0)  # one collective: each costs a round trip
    same = torch.equal(theirs, mine)
    full = {k: {n: t.cpu() for n, t in mesh.gather_state_dict(
        {n: t.to("cuda") for n, t in rec[k].items()}, plan).items()}
        for k in ("grads", "stats")}
    return full, same


def tp_references(c, fe, dtypes=("fp32",), steps=1):
    """The single-process references of a TP step on phase tp's batch
    (TP_BATCH clips drawn from TP_SEED, dropout on, generator seed 1234):
    per dtype of ``dtypes`` (``"fp32"``, ``"bf16"``) ``steps`` steps' losses
    and times; ``ref``, fp32 step 1's loss, gradients and running stats;
    ``floor``, float32's distance between the step with dropout off on
    the batch in two clip orders."""
    audio, per_clip = synthetic_clips(c, np.random.default_rng(TP_SEED), TP_BATCH)
    out = {}
    for name in dtypes:
        cc = c if name == "fp32" else with_train(c, compute_dtype="bfloat16")
        model = ddp_model(cc, True)
        step = build_train_step(cc, model, fe)
        batch = clips_batch(cc, audio, per_clip)
        gen = torch.Generator(device="cuda").manual_seed(1234)
        losses, ms = [], []
        for i in range(steps):
            t0 = time.perf_counter()
            losses.append(float(step(batch, gen)))
            ms.append((time.perf_counter() - t0) * 1e3)
            if i == 0 and name == "fp32":
                out["ref"] = {"loss": losses[0], **ddp_record(model)}
        out[name] = {"losses": losses, "step_ms": ms}
        del model, step, batch
    runs = []
    for idx in (list(range(TP_BATCH))[::-1], list(range(TP_BATCH))):
        model = ddp_model(c, False)
        step = build_train_step(c, model, fe)
        batch = clips_batch(c, audio[idx], [per_clip[i] for i in idx])
        gen = torch.Generator(device="cuda").manual_seed(1234)
        runs.append({"loss": float(step(batch, gen)), **ddp_record(model)})
        del model, step, batch
    out["floor"] = grad_distance(runs[0], runs[1])
    torch.cuda.empty_cache()
    return out


def tp_allreduce_ms(shape):
    """One all-reduce of a row-parallel product's output (float32,
    ``shape``) on the TP group, timed alone: host clock from a synchronised
    device to the end of its device work, median of 5 after a warm-up."""
    x = torch.ones(shape, device="cuda")
    ms = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dist.all_reduce(x, group=mesh.tp_group())
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ms[1:]))


def tp_worker(rank, tmp, conf_cfg):
    """One rank of phase tp on ``cuda:0`` in a gloo group, one model group
    of TP_WORLD ranks: TP_STEPS steps of each case on the whole batch from
    the seeded weights (the step shards them), the plain versions patched
    to raise, the launch counts set to 0 just before each case's steps and
    read just after.  After step 1 of fp32 the gathered gradients and
    running stats (rank 0 writes them) and whether the ranks hold equal
    gradients of the replicated parameters."""
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous",
                            rank=rank, world_size=TP_WORLD)
    try:
        mesh.init_distributed("cuda:0", model_parallel=TP_WORLD)
        fe = make_frontend(conf_cfg)
        audio, per_clip = synthetic_clips(conf_cfg, np.random.default_rng(TP_SEED), TP_BATCH)
        batch = clips_batch(conf_cfg, audio, per_clip)
        out = {}
        for name, c in tp_cases(conf_cfg).items():
            model = ddp_model(c, True)
            step = build_train_step(c, model, fe)
            gen = torch.Generator(device="cuda").manual_seed(1234)
            torch.cuda.synchronize()
            losses, step_ms, per_step, row = [], [], [], {}
            with plain_versions_raise():
                zero_counts()
                for i in range(TP_STEPS):
                    before = counts()
                    t0 = time.perf_counter()
                    losses.append(float(step(batch, gen)))  # ends in a device -> host copy
                    step_ms.append((time.perf_counter() - t0) * 1e3)
                    per_step.append({n: v - before[n] for n, v in counts().items()})
                    if i == 0 and name == "fp32":
                        full, row["replicated_equal"] = tp_gathered_record(model, step.plan)
                        if rank == 0:
                            torch.save(full, os.path.join(tmp, "fp32.pt"))
                launched = counts()
            row.update(losses=losses, step_ms=step_ms, per_step=per_step, launched=launched)
            if name == "fp32":
                row["allreduce_ms"] = tp_allreduce_ms((TP_BATCH, 800, 256))
            out[name] = row
            del model, step
            torch.cuda.empty_cache()
        with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def phase_tp(smi, conf_cfg):
    """Tensor parallelism on two ranks sharing the one card (gloo: NCCL
    refuses two ranks on one device); see the module docstring, phase 17.
    The single-process references are taken first in this process: the
    fp32 step with dropout (loss, gradients, running stats), float32's
    floor (the step with dropout off on the batch in two clip orders), the
    bf16 step's loss, and each dtype's step time.  The launch counts of the
    ranks' steps (both ranks) are the path ``tp``.  Returns them and the
    references (:func:`tp_references`), which phase tp_replicated shares."""
    t_phase = time.perf_counter()
    kernels = tp_kernel_checks()
    emit({"phase": "tp_kernels", **kernels, "card": smi})
    fe = make_frontend(conf_cfg)
    single = tp_references(conf_cfg, fe, ("fp32", "bf16"), TP_STEPS)
    ref, floor = single["ref"], single["floor"]

    tmp = tempfile.mkdtemp(prefix="chip_smoke_tp_")
    try:
        t0 = time.perf_counter()
        torch.multiprocessing.spawn(tp_worker, args=(tmp, conf_cfg), nprocs=TP_WORLD, join=True)
        spawn_s = time.perf_counter() - t0
        ranks = []
        for r in range(TP_WORLD):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        got = torch.load(os.path.join(tmp, "fp32.pt"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    got["loss"] = ranks[0]["fp32"]["losses"][0]
    fp32 = {**grad_distance(got, ref), "single_process_batch_order_floor": floor}
    bf16_loss = [ranks[0]["bf16"]["losses"][0], single["bf16"]["losses"][0]]
    bf16_rel = abs(bf16_loss[0] - bf16_loss[1]) / abs(bf16_loss[1])
    emit({"phase": "tp_vs_single_process", "fp32": fp32, "bf16_loss": bf16_loss,
          "bf16_loss_rel": bf16_rel, "card": smi})
    require(fp32["loss_rel"] <= TRAIN_LOSS_TOL, f"tp fp32: loss {fp32['loss']}")
    tol = ddp_grad_tol(fp32)
    require(fp32["grad_l2_rel"] <= tol, f"tp fp32: grads L2 distance {fp32['grad_l2_rel']} > {tol}")
    require(fp32["stats_rel"] <= TRAIN_GRAD_TOL, f"tp fp32: running stats err {fp32['stats_rel']}")
    require(bf16_rel <= BF16_TRAIN_LOSS_TOL, f"tp bf16: loss {bf16_loss}")
    nb = CONFORMER_BLOCKS
    want_step = {"fp32": {"stft": 1, "k2_dropout": nb, "k3": nb},
                 "bf16": {"stft": 1, "k2_dropout_bf16": nb, "k3_bf16": nb}}
    path = None
    for r, rec in enumerate(ranks):
        require(rec["fp32"]["replicated_equal"],
                f"tp: rank {r}'s replicated gradients differ from rank 0's")
        for name, want in want_step.items():
            row = rec[name]
            require(all(np.isfinite(row["losses"])), f"tp {name} rank {r}: {row['losses']}")
            require(row["losses"] == ranks[0][name]["losses"],
                    f"tp {name}: the ranks' losses differ")
            for i, n in enumerate(row["per_step"]):
                require(n == {**{k: 0 for k in n}, **want},
                        f"tp {name} rank {r} step {i + 1}: launches {n}, want {want}")
            path = {k: (0 if path is None else path[k]) + v for k, v in row["launched"].items()}
    timing = {name: {"median_step_ms_per_rank": [float(np.median(rec[name]["step_ms"][1:]))
                                                 for rec in ranks],
                     "one_process_median_step_ms": float(np.median(single[name]["step_ms"][1:])),
                     "step_ms": [rec[name]["step_ms"] for rec in ranks],
                     "one_process_step_ms": single[name]["step_ms"]}
              for name in want_step}
    emit({"phase": "tp", "model_parallel": TP_WORLD, "backend": "gloo, two ranks sharing one card",
          "batch": [TP_BATCH, 800, HOP, 4], "fp32": fp32, "bf16_loss": bf16_loss,
          "timing": timing, "allreduce_ms_rank0": ranks[0]["fp32"]["allreduce_ms"],
          "allreduces_per_step": 8 * nb, "allreduce_bytes": TP_BATCH * 800 * 256 * 4,
          "launches": path, "tol": {"loss_rel": TRAIN_LOSS_TOL, "bf16_loss_rel": BF16_TRAIN_LOSS_TOL,
                                    "grad_l2_rel": tol},
          "spawn_s": spawn_s, "seconds": time.perf_counter() - t_phase, "card": smi})
    return path, single


# ---- tensor parallelism of what N does not cut: three layouts on the one card

TPR_STEPS = 2  # step 1 is compared, step 2 timed
# part: (encoder, model_parallel, conformer blocks, dtypes, the modules sharded)
TPR_PARTS = {
    # 256, 1024 and the 4 heads are not divisible by 3: every module whole
    "conformer_n3": ("resnet-conformer", 3, CONFORMER_BLOCKS, ("fp32", "bf16"), []),
    "se_n2": ("se-resnet34", 2, None, ("fp32",), []),
    # the FFNs and conv modules cut 8 ways, each MHSA whole (4 heads)
    "conformer_n8": ("resnet-conformer", 8, 2, ("fp32",), ["conv", "ffn1", "ffn2"]),
}


@contextlib.contextmanager
def conformer_blocks(n):
    """``build_model`` makes the conformer with ``n`` blocks inside (all
    of them for None or :data:`CONFORMER_BLOCKS`)."""
    saved = wrapper_mod.ENCODERS["resnet-conformer"]
    if n not in (None, CONFORMER_BLOCKS):
        wrapper_mod.ENCODERS["resnet-conformer"] = functools.partial(
            resnet_conformer.ResNetConformer, num_layers=n)
    try:
        yield
    finally:
        wrapper_mod.ENCODERS["resnet-conformer"] = saved


def tp_replicated_worker(rank, tmp, part, c, t_spawn):
    """One rank of a part of phase tp_replicated on ``cuda:0`` in a gloo
    group, one model group of all the part's ranks: TPR_STEPS steps of each
    dtype on the whole batch from the seeded weights, the plain versions
    patched to raise, the launch counts set to 0 just before each dtype's
    steps and read just after; after step 1 of fp32 the gathered gradients
    and running stats (rank 0 writes them) and whether the ranks hold equal
    replicated gradients; what the rank holds of conformer block 0; the
    seconds from the spawn (``t_spawn``, host wall clock) to each stage."""
    _, n, blocks, dtypes, _ = TPR_PARTS[part]
    stages = {"started": time.time() - t_spawn}
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous",
                            rank=rank, world_size=n)
    try:
        mesh.init_distributed("cuda:0", model_parallel=n)
        stages["grouped"] = time.time() - t_spawn
        fe = make_frontend(c)
        audio, per_clip = synthetic_clips(c, np.random.default_rng(TP_SEED), TP_BATCH)
        out = {"stages": stages}
        for name in dtypes:
            cc = c if name == "fp32" else with_train(c, compute_dtype="bfloat16")
            with conformer_blocks(blocks):
                model = ddp_model(cc, True)
            step = build_train_step(cc, model, fe)
            batch = clips_batch(cc, audio, per_clip)
            gen = torch.Generator(device="cuda").manual_seed(1234)
            torch.cuda.synchronize()
            stages[f"{name}_built"] = time.time() - t_spawn
            losses, step_ms, per_step, row = [], [], [], {}
            with plain_versions_raise():
                zero_counts()
                for i in range(TPR_STEPS):
                    before = counts()
                    t0 = time.perf_counter()
                    losses.append(float(step(batch, gen)))  # ends in a device -> host copy
                    step_ms.append((time.perf_counter() - t0) * 1e3)
                    per_step.append({k: v - before[k] for k, v in counts().items()})
                    if i == 0 and name == "fp32":
                        full, row["replicated_equal"] = tp_gathered_record(model, step.plan)
                        if rank == 0:
                            torch.save(full, os.path.join(tmp, "fp32.pt"))
                launched = counts()
            block = getattr(model.encoder, "conformer0", None)
            row.update(losses=losses, step_ms=step_ms, per_step=per_step, launched=launched,
                       sharded=sorted(step.plan.sharded),
                       mhsa=None if block is None else [block.mhsa.heads,
                                                        block.mhsa.head_range])
            out[name] = row
            stages[f"{name}_stepped"] = time.time() - t_spawn
            del model, step, batch
            torch.cuda.empty_cache()
        with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def phase_tp_replicated(smi, cfg, conf_cfg, conf_refs=None):
    """Tensor parallelism where N does not cut everything, each part's ranks
    sharing the one card over gloo (see the module docstring, phase 18):
    (i) the full conformer at N = 3, every module whole, fp32 and bf16;
    (ii) SE-ResNet34 at N = 2, every parameter whole; (iii) the conformer
    cut to 2 blocks at N = 8, its FFNs and conv modules sharded and each
    MHSA whole.  Each part's fp32 step 1 against the single-process step
    on the same batch and generator (``conf_refs``: phase tp's references
    of the full conformer, taken here when None), with phase tp's gates.
    The launch counts of every part's ranks are the path
    ``tp_replicated``."""
    t_phase = time.perf_counter()
    fe = make_frontend(cfg)
    cfgs = {"resnet-conformer": conf_cfg, "se-resnet34": cfg}
    path, rows, seconds = None, {}, {}
    for part, (encoder, n, blocks, dtypes, sharded) in TPR_PARTS.items():
        t_part = time.perf_counter()
        c = cfgs[encoder]
        if part == "conformer_n3" and conf_refs is not None:
            refs = conf_refs
        else:
            with conformer_blocks(blocks):
                refs = tp_references(c, fe, dtypes)
        require(os.path.isfile(build.library_path()), "tp_replicated: the kernels are not built")
        tmp = tempfile.mkdtemp(prefix=f"chip_smoke_tpr_{part}_")
        try:
            t0 = time.perf_counter()
            # forked from a server that imported this script once (the
            # first part starts it), so the ranks skip its imports; each
            # initialises CUDA itself
            torch.multiprocessing.set_forkserver_preload(["chip_smoke"])
            torch.multiprocessing.start_processes(
                tp_replicated_worker, args=(tmp, part, c, time.time()), nprocs=n,
                join=True, start_method="forkserver")
            spawn_s = time.perf_counter() - t0
            ranks = []
            for r in range(n):
                with open(os.path.join(tmp, f"rank{r}.json")) as f:
                    ranks.append(json.load(f))
            got = torch.load(os.path.join(tmp, "fp32.pt"))
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        got["loss"] = ranks[0]["fp32"]["losses"][0]
        fp32 = {**grad_distance(got, refs["ref"]),
                "single_process_batch_order_floor": refs["floor"]}
        tol = ddp_grad_tol(fp32)
        require(fp32["loss_rel"] <= TRAIN_LOSS_TOL, f"tp_replicated {part}: loss {fp32['loss']}")
        require(fp32["grad_l2_rel"] <= tol,
                f"tp_replicated {part}: grads L2 distance {fp32['grad_l2_rel']} > {tol}")
        require(fp32["stats_rel"] <= TRAIN_GRAD_TOL,
                f"tp_replicated {part}: running stats err {fp32['stats_rel']}")
        row = {"model_parallel": n, "blocks": blocks, "sharded": sharded, "fp32": fp32,
               "grad_l2_tol": tol}
        if "bf16" in dtypes:
            bf16_loss = [ranks[0]["bf16"]["losses"][0], refs["bf16"]["losses"][0]]
            row["bf16_loss"] = bf16_loss
            row["bf16_loss_rel"] = abs(bf16_loss[0] - bf16_loss[1]) / abs(bf16_loss[1])
            require(row["bf16_loss_rel"] <= BF16_TRAIN_LOSS_TOL,
                    f"tp_replicated {part}: bf16 loss {bf16_loss}")
        nb = blocks or 0
        want_step = {"fp32": {"stft": 1, **({"k2_dropout": nb, "k3": nb} if nb else {})},
                     "bf16": {"stft": 1, "k2_dropout_bf16": nb, "k3_bf16": nb}}
        mhsa = [resnet_conformer.HEADS, None] if nb else None
        for r, rec in enumerate(ranks):
            require(rec["fp32"]["replicated_equal"],
                    f"tp_replicated {part}: rank {r}'s replicated gradients differ from rank 0's")
            for name in dtypes:
                d = rec[name]
                require(d["sharded"] == sharded and d["mhsa"] == mhsa,
                        f"tp_replicated {part} rank {r}: sharded {d['sharded']}, "
                        f"MHSA heads / range {d['mhsa']}")
                require(all(np.isfinite(d["losses"])), f"tp_replicated {part} rank {r}: "
                        f"{d['losses']}")
                require(d["losses"] == ranks[0][name]["losses"],
                        f"tp_replicated {part} {name}: the ranks' losses differ")
                for i, k in enumerate(d["per_step"]):
                    require(k == {**{x: 0 for x in k}, **want_step[name]},
                            f"tp_replicated {part} {name} rank {r} step {i + 1}: launches "
                            f"{k}, want {want_step[name]}")
                path = {k: (0 if path is None else path[k]) + v for k, v in d["launched"].items()}
        row["timing"] = {name: {"step_ms_per_rank": [rec[name]["step_ms"] for rec in ranks],
                                "one_process_step_ms": refs[name]["step_ms"]}
                         for name in dtypes}
        seconds[part] = {"spawn": spawn_s, "part": time.perf_counter() - t_part,
                         "rank0_stages": ranks[0]["stages"]}
        rows[part] = row
    emit({"phase": "tp_replicated", "backend": "gloo, the part's ranks sharing one card",
          "batch": [TP_BATCH, 800, HOP, 4], **rows, "launches": path,
          "tol": {"loss_rel": TRAIN_LOSS_TOL, "bf16_loss_rel": BF16_TRAIN_LOSS_TOL,
                  "stats_rel": TRAIN_GRAD_TOL},
          "part_seconds": seconds, "seconds": time.perf_counter() - t_phase, "card": smi})
    return path


BENCH_SIZES = bench_mod.Sizes(iters=5, warmup=2, train_warmup=2, train_steps=5)
FLOPS_REL = 1e-9  # model_flops on the kernels vs on the plain versions (and the CPU)
# the conformer's B=32 bf16 step on the kernels vs on the plain attention:
# the worst gradient error over the leaves, x the largest gradient (step 1
# of train_conformer_bf16 at B=16 read 0.0148 of 0.110)
BF16_STEP_GRAD_TOL = 0.25


@contextlib.contextmanager
def plain_versions(frontend):
    """The front-end's STFT op and the conformer's attention on their plain
    versions on the card: the op's CUDA kernel replaced by the plain STFT,
    the attention called inline (:func:`plain_attention`)."""
    n_fft = frontend.fft.n_fft
    w = [t.to(frontend.device) for t in plain_stft.window_dft(frontend.fft_table[2 * n_fft:].cpu())]
    saved = hopper_stft.launch
    hopper_stft.launch = lambda x, table, hop: plain_stft.stft(x, *w, hop)
    try:
        with plain_attention():
            yield
    finally:
        hopper_stft.launch = saved


def bench_train_step(b, encoder, dtype):
    """The bench's train step of ``encoder`` in ``dtype``, its arguments
    (the bench's batch, a generator seeded 1) and its model."""
    cfg = dataclasses.replace(
        b.cfg, args=dataclasses.replace(b.cfg.args, encoder=encoder),
        train=dataclasses.replace(b.cfg.train, batch_size=b.sizes.train_batch,
                                  compute_dtype=dtype))
    model = b.model(cfg, train=True)
    return (build_train_step(cfg, model, b.frontend),
            (b.train_batch(), torch.Generator(device=b.device).manual_seed(1)), model)


def same_flops(tag, got, want):
    require(want > 0 and abs(got - want) <= FLOPS_REL * want,
            f"bench: model_flops {tag}: {got} vs {want}")
    return {"flops": got, "vs": want}


def bench_path_kernels(b):
    """The bench path's kernels at its shapes against their plain versions:
    K1 on the train batch's (32, 800, 600, 4) audio within KERNEL_TOL x
    max; k2_dropout_bf16 and k3_bf16 at the conformer step's (32, 800, 4,
    64), rate 0.2, all keys valid (the bench's clips are full), against
    float64 as in attn_train_bf16_kernel."""
    x = b.train_batch()["audio"]
    n_fft = b.frontend.fft.n_fft
    w = [t.cuda() for t in plain_stft.window_dft(b.frontend.fft_table[2 * n_fft:].cpu())]
    got, want = hopper_stft.stft_hop_blocks(x, b.frontend.fft), plain_stft.stft(x, *w, HOP)
    err = max(float((g - p).abs().max()) for g, p in zip(got, want))
    scale = max(float(p.abs().max()) for p in want)
    require(np.isfinite(err) and err <= KERNEL_TOL * scale,
            f"bench: STFT kernel at {tuple(x.shape)}: max err {err} > {KERNEL_TOL} * {scale}")
    res = {"stft": {"shape": list(x.shape), "max_abs_err": err, "max_abs_plain": scale,
                    "tol_rel": KERNEL_TOL}}
    del got, want
    B, T, H = x.shape[0], x.shape[1], 4
    rng = np.random.default_rng(18)
    q, k, v, do = (torch.tensor(rng.standard_normal((B, T, H, 64)), dtype=torch.float32,
                                device="cuda").bfloat16() for _ in range(4))
    seed = torch.tensor([int(rng.integers(-2 ** 31, 2 ** 31))], dtype=torch.int32, device="cuda")
    kv = torch.full((B,), T, dtype=torch.int32, device="cuda")
    args = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = hopper_attention.flash_attention(*args, kv, rate=RATE, seed=seed)
    grads = torch.autograd.grad(out, args, do)
    plain = [attention.mhsa_attention(q, k, v, kv, rate=RATE, seed=seed),
             *attention.mhsa_attention_bwd(q, k, v, kv, do, rate=RATE, seed=seed)]
    res["bf16_pair"] = {"shape": [B, T, H, 64], "rate": RATE,
                        "tol": {"ratio": BF16_RATIO, "half_step": BF16_HALF_STEP},
                        **bf16_vs_truth("bench", (out.detach(), *grads), plain,
                                        bf16_truth(q, k, v, kv, do, seed), [T] * B)}
    return res


def bench_conformer_steps(b):
    """The bench's conformer bf16 step (B = 32 x 20 s) from the same
    weights, batch and generator seed on the kernels and on the plain
    attention, each under ``model_flops``: the loss within
    BF16_TRAIN_LOSS_TOL rel, the worst leaf's gradient within
    BF16_STEP_GRAD_TOL x the largest, and the two counts equal."""
    runs = {}
    for tag in ("kernels", "plain"):
        step, args, model = bench_train_step(b, "resnet-conformer", "bfloat16")
        loss = []
        with plain_attention() if tag == "plain" else contextlib.nullcontext():
            flops = model_flops(lambda: loss.append(float(step(*args))))
        runs[tag] = (flops, loss[0], grads_of(model))
        del step, args, model
    (k_fl, k_loss, k_g), (p_fl, p_loss, p_g) = runs["kernels"], runs["plain"]
    require(np.isfinite(k_loss) and abs(k_loss - p_loss) <= BF16_TRAIN_LOSS_TOL * abs(p_loss),
            f"bench: conformer B=32 bf16 step loss {k_loss} vs plain {p_loss}")
    gmax = max(float(g.abs().max()) for g in p_g.values())
    worst = max(p_g, key=lambda n: float((k_g[n] - p_g[n]).abs().max()))
    gerr = float((k_g[worst] - p_g[worst]).abs().max())
    require(all(bool(torch.isfinite(g).all()) for g in k_g.values())
            and gerr <= BF16_STEP_GRAD_TOL * gmax,
            f"bench: conformer B=32 bf16 step gradient {worst}: max err {gerr} > "
            f"{BF16_STEP_GRAD_TOL} * {gmax}")
    return {"loss": [k_loss, p_loss], "loss_tol_rel": BF16_TRAIN_LOSS_TOL,
            "grad_worst_leaf": worst, "grad_max_abs_err": gerr, "grad_max_abs": gmax,
            "grad_tol": BF16_STEP_GRAD_TOL,
            "model_flops": same_flops("conformer B=32 bf16 step, plain attention", p_fl, k_fl)}


def phase_bench(smi):
    """The port's bench, its default lines through its own functions (the
    main path of this phase: the launch counts set to 0 just before the
    five lines and read just after).  Then the path's kernels at its
    shapes against their plain versions (:func:`bench_path_kernels`), the
    conformer's B=32 bf16 step on the kernels against the plain attention
    (:func:`bench_conformer_steps`), and, at B = 2 x 2 s, the headline
    forward's ``model_flops`` on the plain versions and the card's counts
    against the CPU's."""
    lines, per_line = {}, {}
    t0 = time.perf_counter()
    zero_counts()  # the main path's count starts here
    for name in bench_mod.DEFAULT_CONFIGS:
        before = counts()
        out = []
        errors = bench_mod.run([name], "cuda", BENCH_SIZES, emit=out.append)
        require(not errors and len(out) == 1, f"bench {name}: {errors}")
        lines[name] = json.loads(out[0])
        per_line[name] = {n: c - before[n] for n, c in counts().items()}
    launched = counts()
    seconds = {"main_path": time.perf_counter() - t0}
    sz = BENCH_SIZES
    for name, rec in lines.items():
        print(json.dumps(rec), flush=True)
        require(rec["metric"] == bench_mod.METRIC_OF[name], f"bench {name}: {rec['metric']}")
        require(np.isfinite(rec["value"]) and rec["value"] > 0, f"bench {name}: {rec}")
        require(np.isfinite(rec["tflops_per_s"]) and rec["tflops_per_s"] > 0, f"bench {name}: {rec}")
        require(0 < rec.get("mfu", 0) <= 1, f"bench {name}: mfu {rec.get('mfu')}")
        calls = 1 + (sz.train_warmup + sz.train_steps if name.startswith("train")
                     else sz.warmup + sz.iters)
        want = {n: 0 for n in launched}
        want["stft"] = calls
        if name == "train-conformer-bf16":
            want["k2_dropout_bf16"] = want["k3_bf16"] = 8 * calls
        require(per_line[name] == want, f"bench {name}: launches {per_line[name]}, want {want}")

    t = time.perf_counter()
    b = bench_mod.Bench("cuda", BENCH_SIZES)
    kernels = bench_path_kernels(b)
    seconds["kernels"] = time.perf_counter() - t
    t = time.perf_counter()
    steps = bench_conformer_steps(b)
    seconds["conformer_steps"] = time.perf_counter() - t
    del b
    torch.cuda.empty_cache()
    # the count is the route's no more than the device's
    t = time.perf_counter()
    small = bench_mod.Sizes(batch=2, train_batch=2, clip_s=2)
    card, cpu = bench_mod.Bench("cuda", small), bench_mod.Bench("cpu", small)
    fwd, x = build_eval_forward(card.model(card.cfg), card.frontend), card.audio(2)
    k = model_flops(fwd, x)
    with plain_versions(card.frontend):
        checks = {"headline_plain": same_flops("headline, plain", model_flops(fwd, x), k)}
    torch.set_num_threads(min(8, os.cpu_count() or 1))

    def step_flops(b, encoder, dtype):
        step, args, _ = bench_train_step(b, encoder, dtype)
        return model_flops(step, *args)

    for tag, count in (
            ("se_forward", lambda b: model_flops(build_eval_forward(b.model(b.cfg), b.frontend),
                                                 b.audio(2))),
            ("se_f32_step", lambda b: step_flops(b, "se-resnet34", "float32")),
            ("conformer_bf16_step", lambda b: step_flops(b, "resnet-conformer", "bfloat16"))):
        checks[tag + "_cpu"] = same_flops(f"{tag}, card vs CPU", count(card), count(cpu))
    seconds["small_flops"] = time.perf_counter() - t
    emit({"phase": "bench", "sizes": dataclasses.asdict(BENCH_SIZES), "seconds": seconds,
          "lines": lines, "launches": launched, "launches_per_line": per_line,
          "kernels_vs_plain": kernels, "conformer_step_vs_plain": steps,
          "model_flops_checks": checks, "card": smi})
    return launched


def main():
    smi = phase_env()
    adopt_orphans()
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
    fe = make_frontend(cfg)
    dft = window_dft(cfg.data.window, cfg.data.win_length, cfg.data.n_fft)
    stft_k = phase_kernel(smi, fe, dft)
    attn_k = phase_attn_kernel(smi)
    train_k = phase_attn_train_kernel(smi)
    bf16_k = phase_attn_train_bf16_kernel(smi)
    phase_attn_launch_order(smi)
    model = build_model(cfg, generator=torch.Generator().manual_seed(0))
    tau = pick_threshold(cfg, phase_forward(smi, fe, dft, model, "forward"))
    other_fwd = phase_forward_other_geometry(smi, cfg, model)
    g3_fwd = phase_forward_other_geometry(smi, cfg, model, "G3")
    g6_fwd = phase_forward_other_geometry(smi, cfg, model, "G6")
    conformer = build_model(conf_cfg, generator=torch.Generator().manual_seed(0))
    conf_tau = pick_threshold(conf_cfg, phase_forward(smi, fe, dft, conformer,
                                                      "forward_conformer"))
    phase_forward_conformer_long(smi, fe, dft, conformer)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        se = phase_serve(smi, cfg, fe, model, tau, tmp)
        conf = phase_serve_conformer(smi, conf_cfg, fe, conformer, conf_tau, tmp)
        eval_bf16_k = phase_attn_eval_bf16_kernel(smi)
        export = phase_export(smi, cfg, conf_cfg, fe, model, conformer, tau, conf_tau, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del model, conformer
    train, bare_step_ms = phase_train_conformer(smi, conf_cfg, fe)
    engine = phase_train_cli(smi, conf_cfg, bare_step_ms)
    se_train = phase_train_seresnet34(smi, cfg, fe)
    conf_bf16 = phase_train_conformer_bf16(smi, conf_cfg, fe)
    se_cli = phase_train_cli_se_bf16(smi, cfg)
    other_cli = phase_cli_other_geometry(smi, cfg)
    g3_cli = phase_cli_other_geometry(smi, cfg, "G3")
    mic = phase_preprocess_mic(smi, cfg)
    formats = phase_train_cli_formats(smi, cfg)
    ddp = phase_ddp(smi, cfg, conf_cfg)
    tp, conf_refs = phase_tp(smi, conf_cfg)
    tp_replicated = phase_tp_replicated(smi, cfg, conf_cfg, conf_refs)
    bench = phase_bench(smi)

    foreign = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "flax", "adyolo_tpu"))
    require(not foreign, f"the JAX package or JAX was imported: {foreign}")
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    frames_k = stft_k.pop("frames")
    k = stft_k["serving"]
    k["max_abs_err"] = max(r["max_abs_err"] for r in stft_k.values())
    attn = {"route": "cuda", "source": "adyolo_tpu_torch/csrc/attention.cu"}
    keys_k1 = keys + DEVICE_KEYS
    keys_a = keys_k1 + ("bound_units",)
    paths = {"serve": se, "serve_conformer": conf, "export": export,
             "train_conformer": train,
             "train_cli": engine, "train_seresnet34_bf16": se_train,
             "train_conformer_bf16": conf_bf16, "train_cli_se_bf16": se_cli,
             "forward_other_geometry": other_fwd, "cli_other_geometry": other_cli,
             "forward_G3": g3_fwd, "cli_G3": g3_cli, "forward_G6": g6_fwd,
             "preprocess_mic": mic,
             "train_cli_formats": {n: sum(formats[f][n] for f in DENSE_LOSSES)
                                   for n in formats["accdoa"]},
             "train_cli_formats_conformer": formats["accdoa-conformer"], "ddp": ddp,
             "tp": tp, "tp_replicated": tp_replicated, "bench": bench}
    for p in ("preprocess_mic", "train_cli_formats", "train_cli_formats_conformer"):
        require(paths[p]["stft"] > 0, f"{p}: K1 never launched")
    for p in ("cli_other_geometry", "cli_G3"):
        require(paths[p]["stft_frames"] > 0 and paths[p]["stft"] == 0,
                f"{p}: K1's frames kernel never launched, or the hop-block kernel did")
    require(paths["forward_G6"]["stft_frames_4step"] == 1,
            f"forward_G6: route four_step's one launch, got {paths['forward_G6']}")
    require(all(paths["export"][r] > 0 for r in ("stft", "k2", "k2_bf16", "k4")),
            f"export: a kernel of the path never launched: {paths['export']}")
    require(paths["train_cli_formats_conformer"]["k2_dropout"] > 0
            and paths["train_cli_formats_conformer"]["k3"] > 0,
            "the conformer's dense-format run launched no k2_dropout / k3")

    def launches(route, main="train_cli"):
        """``launches``: the route's main path (the ``cli`` train, val, test
        and resume of phase train_cli; the bf16 conformer steps for the
        bf16 training routes; the served artifacts for k2_bf16); each
        path's count beside it."""
        return {"launches": paths[main][route], "main_path": main,
                "launches_by_path": {p: n[route] for p, n in paths.items()}}

    emit({"kernels": [
        {"name": "stft_hop_blocks", "route": "cuda",
         "source": "adyolo_tpu_torch/csrc/stft.cu",
         "replaces": "adyolo_tpu/ops/pallas_stft.py:68",
         **launches("stft"), **{n: k[n] for n in keys_k1}},
        {"name": "stft_frames", "route": "cuda",
         "source": "adyolo_tpu_torch/csrc/stft.cu",
         "replaces": "adyolo_tpu/ops/pallas_stft.py:68",
         **launches("stft_frames", "cli_G3"),
         **{n: frames_k[n] for n in keys_k1},
         # the same kernel at the other timed geometries (G1 is the row's
         # own); its routes four_step and global are the next two entries
         "geometry": frames_k["geometry"], "geometries": frames_k["geometries"],
         "kernel_names": ["stft_frames_fft_kernel"]},
        {"name": "stft_frames_four_step", "route": "cuda",
         "source": "adyolo_tpu_torch/csrc/stft.cu",
         "replaces": "adyolo_tpu/ops/pallas_stft.py:68",
         # the frames kernel's route four_step (one frame a block, one
         # launch), on forward_G6's path; the numbers are G6's
         **launches("stft_frames_4step", "forward_G6"),
         **{n: frames_k["geometries"]["G6"][n] for n in keys_k1},
         "kernel_names": ["stft_frames_4step_kernel"]},
        {"name": "stft_frames_global", "route": "cuda",
         "source": "adyolo_tpu_torch/csrc/stft.cu",
         "replaces": "adyolo_tpu/ops/pallas_stft.py:68",
         # the global route (two launches a call), on no model's path: its
         # launches are phase kernel's frames cases (2402, 7919, 11274,
         # 16384); the numbers are G7's
         "launches": frames_k["launches"]["stft_frames_global"],
         "main_path": "kernel_frames",
         "launches_by_path": {"kernel_frames": frames_k["launches"]["stft_frames_global"],
                              **{p: n["stft_frames_global"] for p, n in paths.items()}},
         **{n: frames_k["geometries"]["G7"][n] for n in keys_k1},
         "kernel_names": ["stft_frames_cols_kernel", "stft_frames_rows_kernel"]},
        {"name": "stft_frames_chirp", "route": "cuda",
         "source": "adyolo_tpu_torch/csrc/stft.cu",
         "replaces": "adyolo_tpu/ops/pallas_stft.py:68",
         # the global route's whole-frame Bluestein (two launches a call),
         # where no split fits the tiles, on no model's path: its launches
         # are phase kernel's frames case at 14087; the numbers are N14087's
         "launches": frames_k["launches"]["stft_frames_chirp"],
         "main_path": "kernel_frames",
         "launches_by_path": {"kernel_frames": frames_k["launches"]["stft_frames_chirp"],
                              **{p: n["stft_frames_chirp"] for p, n in paths.items()}},
         **{n: frames_k["geometries"]["N14087"][n] for n in keys_k1},
         "kernel_names": ["stft_frames_chirp_in_kernel", "stft_frames_chirp_out_kernel"]},
        {**attn, "name": "flash_attention/k2",
         "replaces": "adyolo_tpu/ops/flash_mhsa.py:180",
         **launches("k2"), **{n: attn_k["k2"][n] for n in keys_a}},
        {**attn, "name": "flash_attention/k4",
         "replaces": "adyolo_tpu/ops/flash_mhsa.py:358",
         **launches("k4"), **{n: attn_k["k4"][n] for n in keys_a}},
        {**attn, "name": "flash_attention/k2_dropout",
         "replaces": "adyolo_tpu/ops/flash_mhsa.py:180",
         **launches("k2_dropout"), **{n: train_k["k2_dropout"][n] for n in keys_a}},
        {**attn, "name": "flash_attention_bwd/k3",
         "replaces": "adyolo_tpu/ops/flash_mhsa.py:202",
         **launches("k3"), **{n: train_k["k3"][n] for n in keys_a}},
        {**attn, "name": "flash_attention/k2_dropout_bf16",
         "replaces": "adyolo_tpu/ops/flash_mhsa.py:180",
         **launches("k2_dropout_bf16", "train_conformer_bf16"),
         **{n: bf16_k["k2_dropout_bf16"][n] for n in keys_a}},
        {**attn, "name": "flash_attention_bwd/k3_bf16",
         "replaces": "adyolo_tpu/ops/flash_mhsa.py:202",
         **launches("k3_bf16", "train_conformer_bf16"),
         **{n: bf16_k["k3_bf16"][n] for n in keys_a}},
        {**attn, "name": "flash_attention/k2_bf16",
         "replaces": "adyolo_tpu/ops/flash_mhsa.py:180",
         **launches("k2_bf16", "export"), **{n: eval_bf16_k[n] for n in keys_a}}]})
    stop_helper_processes()
    left = child_processes()
    require(not left, f"processes left running: {left}")
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    if sys.argv[1:] == [ORDER_ARG]:
        require(torch.cuda.is_available(), "no CUDA device")
        attn_launch_order_child()
        sys.exit(0)
    try:
        main()
    finally:
        stop_helper_processes()
