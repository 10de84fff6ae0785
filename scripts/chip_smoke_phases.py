#!/usr/bin/env python3
"""Run chosen phases of ``chip_smoke.py`` alone on one card.

Run from the repository root::

    python3 scripts/chip_smoke_phases.py [stftk] [attnk] [attnf32] [attn] [order] [evalk] [fwd] [geometry] [se] [conf] [cli] [export] [ddp] [tp] [tp_replicated] [bench]

Phases env and build always run; then ``stftk``: kernel (K1 against its
plain version, timed, device time a call), ``attnk``: attn_kernel (routes
k2 and k4), ``attn``: attn_train_bf16_kernel,
``se``: train_seresnet34, ``conf``: train_conformer_bf16, ``cli``:
train_cli_se_bf16 (these four when none is named), ``evalk``:
attn_eval_bf16_kernel, ``export``: export (on seeded SE-ResNet34 and
ResNet-Conformer models, thresholds from one B=16 forward each),
``order``: attn_launch_order (the train attention pairs in a fresh
process after a large plain attention), ``geometry``:
forward_other_geometry at G1, G3 and G6 and cli_other_geometry at G1
and G3 (SE-ResNet34 and the entry points at n_fft 2048, win 1200, at
44.1 kHz, n_fft 2204, hop 1102, and the forward at 96 kHz, n_fft 9600,
hop 2400, on K1's frames kernel and its global route), ``ddp``:
ddp (two ranks spawned on the card), ``tp``: tp (the head-shard kernel
checks, then two ranks of one model group spawned on the card),
``tp_replicated``: tp_replicated (the conformer at N = 3 and, cut to 2
blocks, at N = 8, SE-ResNet34 at N = 2, each part's ranks spawned on the
card; after ``tp`` it shares that phase's single-process references),
``attnf32``: attn_train_kernel (the fp32 train routes), ``fwd``:
forward, forward_conformer (each with its B = 1 x 1200 clip) and
forward_conformer_long, ``bench``:
bench (the port's bench lines and its FLOP-count checks).  Each
prints its JSON line as in the full script.  Quicker than the full script
while one phase is being worked on; the full script stays the check.
"""
import sys, os, time, dataclasses, shutil, tempfile
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs
from adyolo_tpu_torch.config import Config
from adyolo_tpu_torch.engine.evaluate import build_eval_forward, make_frontend
from adyolo_tpu_torch.models.wrapper import build_model
import numpy as np
import torch


def main():
    """The spawned ranks of phases ddp and tp import this script as their
    main module: everything runs from here, not at import."""
    t0 = time.time()
    smi = cs.phase_env()
    cs.phase_build()
    data = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data", "DCASE2022_SELD")
    cfg = Config()
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, data_pth=data, name_pth=os.path.join(data, "classes.txt")))
    conf_cfg = dataclasses.replace(cfg, args=dataclasses.replace(cfg.args, encoder="resnet-conformer"))
    fe = make_frontend(cfg)
    which = sys.argv[1:] or ["attn", "se", "conf", "cli"]
    if "stftk" in which or "fwd" in which:
        dft = cs.window_dft(cfg.data.window, cfg.data.win_length, cfg.data.n_fft)
    if "stftk" in which:
        stft_k = cs.phase_kernel(smi, fe, dft)
        print("stft_k", stft_k["serving"], stft_k["frames"]); print("t", time.time() - t0, flush=True)
    if "attnk" in which:
        print("attn_k", cs.phase_attn_kernel(smi)); print("t", time.time() - t0, flush=True)
    if "attn" in which:
        print("bf16_k", cs.phase_attn_train_bf16_kernel(smi)); print("t", time.time() - t0, flush=True)
    if "order" in which:
        cs.phase_attn_launch_order(smi); print("t", time.time() - t0, flush=True)
    if "geometry" in which:
        model = build_model(cfg, generator=torch.Generator().manual_seed(0))
        for tag in ("G1", "G3", "G6"):
            cs.phase_forward_other_geometry(smi, cfg, model, tag)
        del model
        for tag in ("G1", "G3"):
            cs.phase_cli_other_geometry(smi, cfg, tag)
        print("t", time.time() - t0, flush=True)
    if "se" in which:
        print(cs.phase_train_seresnet34(smi, cfg, fe)); print("t", time.time() - t0, flush=True)
    if "conf" in which:
        print(cs.phase_train_conformer_bf16(smi, conf_cfg, fe)); print("t", time.time() - t0, flush=True)
    if "cli" in which:
        print(cs.phase_train_cli_se_bf16(smi, cfg)); print("t", time.time() - t0, flush=True)
    if "evalk" in which:
        print(cs.phase_attn_eval_bf16_kernel(smi)); print("t", time.time() - t0, flush=True)
    if "ddp" in which:
        print(cs.phase_ddp(smi, cfg, conf_cfg)); print("t", time.time() - t0, flush=True)
    if "attnf32" in which:
        print(cs.phase_attn_train_kernel(smi)); print("t", time.time() - t0, flush=True)
    if "fwd" in which:
        for c in (cfg, conf_cfg):
            model = build_model(c, generator=torch.Generator().manual_seed(0))
            phase = "forward" if c is cfg else "forward_conformer"
            cs.phase_forward(smi, fe, dft, model, phase)
            if c is conf_cfg:
                cs.phase_forward_conformer_long(smi, fe, dft, model)
            del model
        print("t", time.time() - t0, flush=True)
    refs = None
    if "tp" in which:
        path, refs = cs.phase_tp(smi, conf_cfg)
        print(path); print("t", time.time() - t0, flush=True)
    if "tp_replicated" in which:
        print(cs.phase_tp_replicated(smi, cfg, conf_cfg, refs)); print("t", time.time() - t0, flush=True)
    if "bench" in which:
        print(cs.phase_bench(smi)); print("t", time.time() - t0, flush=True)
    if "export" in which:
        x = torch.tensor(cs.foa_audio(np.random.default_rng(1), (16, 800, cs.HOP, 4)), device="cuda")
        model = build_model(cfg, generator=torch.Generator().manual_seed(0))
        conformer = build_model(conf_cfg, generator=torch.Generator().manual_seed(0))
        tau = cs.pick_threshold(cfg, build_eval_forward(model, fe)(x))
        conf_tau = cs.pick_threshold(conf_cfg, build_eval_forward(conformer, fe)(x))
        tmp = tempfile.mkdtemp(prefix="chip_smoke_")
        try:
            print(cs.phase_export(smi, cfg, conf_cfg, fe, model, conformer, tau, conf_tau, tmp))
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        print("t", time.time() - t0, flush=True)


if __name__ == "__main__":
    try:
        main()
    finally:
        cs.stop_helper_processes()
