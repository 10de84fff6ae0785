"""Time K1's frames kernel (``stft_frames_fft_kernel`` on the shared
routes, ``stft_frames_4step_kernel`` on route four_step,
``stft_frames_cols_kernel`` + ``stft_frames_rows_kernel`` on the global
route, ``stft_frames_chirp_in_kernel`` + ``stft_frames_chirp_out_kernel``
on its whole-frame Bluestein) on one GPU: device time a call (20 back-to-back calls between
two CUDA events, median of 5 turns) at B = 16 x 20 s of 4-channel float32
audio, beside its byte bound, ``torch.stft``'s device time a call and, with
``--baseline``, an older ``stft.cu`` built and timed in the same turns.

Run from the repository root on a machine with a card::

    python3 scripts/torch_stft_frames_bench.py [--baseline OLD.cu] [--configs]
        [--geometries G1 G3 ...] [--hop-block]

Geometries (n_fft / hop / win): G1 2048 / 600 / 1200 at 24 kHz, G3 2204 /
1102 / 2204 and G5 2205 / 1102 / 2205 at 44.1 kHz, G4 4800 / 2400 / 4800
and G6 9600 / 2400 / 9600 (a 100-ms window) at 96 kHz, G7 11274 / 4000 /
11274 (2 x 3 x 1879: Bluestein) at 96 kHz, and N16384 (16384 / 4096 /
16384 at 96 kHz), P2402 (2402 / 1201 / 2402 at 48 kHz), P7919 (7919 /
1980 / 7919 at 96 kHz), N5600 (5600 / 1400 / 5600 at 96 kHz, 2^5 5^2 7:
in shared memory before the prime passes' second buffer, on the global
route since) and N14087 (14087 / 3522 / 14087 at 96 kHz, a prime: the
whole-frame Bluestein); G6 on route four_step, G7 and the rest on the
global route.
Every launch timed is first checked against the plain flat framing
(``framed_dft_flat``) at B = 2 within 2e-5 x max.  ``--baseline`` is
another ``stft.cu`` in the C interface of the frames kernel before its
four-step route (commit 2ca6931's: ``git show 2ca6931:adyolo_tpu_torch/csrc/stft.cu >
build/stft_parent.cu``): its own route rule (``adyolo_stft_frames_config``),
a 3 n_fft table, and a scratch of 2 B T n_fft float4 on its global route.
``--configs`` also times, at G1, every route, tile and ring of span slots
the shared kernel takes (the wrapper's is ``hopper_stft.frames_config``'s).
``--hop-block`` also times the hop-block kernel at (16, 800, 600, 4) beside
the baseline's.  The frames kernels' registers and spills from the build's
ptxas report, then each result, are one JSON line each.
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.getcwd())
from adyolo_tpu_torch.ops import hopper_stft  # noqa: E402
from adyolo_tpu_torch.ops import stft as plain_stft  # noqa: E402
from adyolo_tpu_torch.ops.dsp import analysis_window, dft_matrices  # noqa: E402
from adyolo_tpu_torch.utils import build  # noqa: E402

GEOMETRIES = {"G1": (2048, 600, 1200, 24000), "G3": (2204, 1102, 2204, 44100),
              "G5": (2205, 1102, 2205, 44100), "G4": (4800, 2400, 4800, 96000),
              "G6": (9600, 2400, 9600, 96000), "G7": (11274, 4000, 11274, 96000),
              "N16384": (16384, 4096, 16384, 96000), "P2402": (2402, 1201, 2402, 48000),
              "P7919": (7919, 1980, 7919, 96000), "N5600": (5600, 1400, 5600, 96000),
              "N14087": (14087, 3522, 14087, 96000)}
GLOBAL = hopper_stft.FRAME_ROUTES.index("global")
TOL = 2e-5
HBM_BYTES_S = 3.35e12
P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def baseline_library(src):
    """Build ``src`` with the repository's ``errors.cu`` into a fresh
    directory under the build tree; its ``adyolo_stft_frames_fft`` takes
    (x, clip_stride, N, B, T, hop, n, table, radices, n_pass, route, frames,
    ring, scratch, scratch_bytes, re, im, stream), its
    ``adyolo_stft_frames_config`` (n, hop, radices, n_pass, config[3]) and
    its ``adyolo_stft_fft`` the hop-block kernel's interface."""
    csrc = os.path.dirname(build.sources()[0])
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    so = os.path.join(tempfile.mkdtemp(dir=build.BUILD_DIR), "baseline.so")
    proc = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-I", csrc, "-shared", "-o",
                           so, src, os.path.join(csrc, "errors.cu")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        sys.exit("baseline build failed: " + proc.stderr[-3000:])
    lib = ctypes.CDLL(so)
    lib.adyolo_stft_frames_fft.restype = I
    lib.adyolo_stft_frames_fft.argtypes = [P, L, L, I, I, I, I, P, P, I, I, I, I, P, L, P, P, P]
    lib.adyolo_stft_frames_config.restype = L
    lib.adyolo_stft_frames_config.argtypes = [I, I, P, I, P]
    lib.adyolo_stft_fft.restype = I
    lib.adyolo_stft_fft.argtypes = hopper_stft._SIGNATURES["adyolo_stft_fft"]
    return lib


def ptxas_report(log):
    """Registers and spills of the frames kernels in an nvcc -Xptxas=-v log."""
    lines, out = log.splitlines(), {}
    for i, ln in enumerate(lines):
        if "Compiling entry function" in ln and "stft_frames" in ln:
            name = ln.split("'")[1]
            name = next((k for k in ("fft_kernelILi16ELb0E", "fft_kernelILi16ELb1E",
                                     "fft_kernelILi32ELb0E", "fft_kernelILi32ELb1E",
                                     "4step_kernel", "cols_kernel", "rows_kernel",
                                     "chirp_in_kernel", "chirp_out_kernel")
                         if k in name), name)
            out[name] = [m.split(":", 1)[-1].strip() for m in lines[i + 1:i + 4]
                         if "spill" in m or "registers" in m]
    return out


def audio(B, N, seed):
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal((B, N, 4)) * 1500).astype(np.int16)
    return torch.tensor((a / 32768.0 + 1e-8).astype(np.float32), device="cuda")


def per_launch_ms(fn, reps=20, turns=5):
    """Device time a call: ``reps`` back-to-back calls between two CUDA
    events, median of ``turns``; fewer calls a turn where one call takes
    more than 10 ms (the baseline's generic passes)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    fn()
    e.record()
    e.synchronize()
    if s.elapsed_time(e) > 10.0:
        reps, turns = 2, 3
    out = []
    for _ in range(turns):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(reps):
            fn()
        e.record()
        e.synchronize()
        out.append(s.elapsed_time(e) / reps)
    return float(np.median(out))


def this_launch(x, plan, hop, cfg, re, im):
    """One call of this tree's frames kernel at ``cfg`` (route, frames,
    ring) into ``re``/``im``, through the C entry the wrapper binds."""
    entry = hopper_stft._entry("adyolo_stft_frames_fft")
    B, N = x.shape[:2]
    n = plan.n_fft
    radices, n_pass = hopper_stft._radices_c(hopper_stft.frames_radix_plan(n))
    glob = cfg[0] == GLOBAL
    scratch = (torch.empty(B * (N // hop) * hopper_stft._scratch_points(n) * 4, device="cuda")
               if glob else None)
    chirps = hopper_stft.chirp_table(n, str(x.device)) if glob else None
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        rc = entry(
            x.data_ptr(), N, N, B, N // hop, hop, n, plan.table.data_ptr(), plan.table.numel(),
            None if chirps is None else chirps.data_ptr(),
            0 if chirps is None else chirps.numel(), radices, n_pass, cfg[0], cfg[1], cfg[2],
            None if scratch is None else scratch.data_ptr(),
            0 if scratch is None else scratch.numel() * 4, re.data_ptr(), im.data_ptr(), stream)
        if rc != 0:
            raise build.launch_error(f"frames kernel at {cfg}", rc)
    return run


def baseline_launch(lib, x, plan, hop, re, im):
    """One call of the baseline's frames kernel at its own route (its
    ``adyolo_stft_frames_config``), its radix plan being the same rule."""
    B, N = x.shape[:2]
    n, T = plan.n_fft, N // hop
    radices, n_pass = hopper_stft._radices_c(hopper_stft.frames_radix_plan(n))
    cfg = (ctypes.c_int * 3)()
    if lib.adyolo_stft_frames_config(n, hop, radices, n_pass, cfg) < 0:
        sys.exit(f"the baseline takes no route at {n}/{hop}")
    scratch = (torch.empty(2 * B * T * n * 4, device="cuda") if cfg[0] == GLOBAL else None)
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        rc = lib.adyolo_stft_frames_fft(
            x.data_ptr(), N, N, B, T, hop, n, plan.table.data_ptr(), radices, n_pass, cfg[0],
            cfg[1], cfg[2], None if scratch is None else scratch.data_ptr(),
            0 if scratch is None else scratch.numel() * 4, re.data_ptr(), im.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"baseline launch refused: {rc}")
    return run, list(cfg)


def check(run, x, mats, hop, re, im, what):
    run()
    pr, pi = plain_stft.framed_dft_flat(x, *mats, hop)
    err = max(float((re - pr).abs().max()), float((im - pi).abs().max()))
    scale = max(float(pr.abs().max()), float(pi.abs().max()))
    if not (np.isfinite(err) and err <= TOL * scale):
        sys.exit(f"{what}: max err {err} > {TOL} * {scale}")
    return err


def configs_of(n, hop):
    """Every (route, frames, ring) of the shared routes the kernel takes at
    (n, hop)."""
    radices = hopper_stft.frames_radix_plan(n)
    out = []
    for route in (0, 1):
        for ring in (1, 2):
            for frames in range(1, hopper_stft._FR_MAX_FRAMES + 1):
                if (hopper_stft._frames_smem(n, hop, frames, ring, radices)
                        <= hopper_stft._SMEM_OPTIN
                        and hopper_stft._frames_fit(radices, n, frames,
                                                    hopper_stft._FR_EPT[route])):
                    out.append((route, frames, ring))
    return out


def hop_block_rows(card, base):
    """The hop-block kernel at (16, 800, 600, 4), n_fft 1200, beside the
    baseline's, device time a call."""
    w = analysis_window("han", 1200, 1200)
    plan = hopper_stft.fft_plan(w, "cuda")
    x = audio(16, 800 * 600, seed=7).reshape(16, 800, 600, 4)
    re = torch.empty((16, 800, 601, 4), device="cuda")
    im = torch.empty_like(re)
    radices, n_pass = hopper_stft._radices_c(hopper_stft.radix_plan(1200))
    stream = torch.cuda.current_stream().cuda_stream

    def caller(fn):
        def run():
            rc = fn(x.data_ptr(), 800 * 600, 16, 800, 600, plan.table.data_ptr(), radices,
                    n_pass, re.data_ptr(), im.data_ptr(), stream)
            if rc != 0:
                raise RuntimeError(f"hop-block launch refused: {rc}")
        return run

    runs = {"stft_hop_blocks_fft_kernel": caller(hopper_stft._entry("adyolo_stft_fft"))}
    if base is not None:
        runs["baseline"] = caller(base.adyolo_stft_fft)
    ms = {k: [] for k in runs}
    for turn in range(2):
        for k in (list(runs) if turn == 0 else list(runs)[::-1]):
            ms[k].append(per_launch_ms(runs[k]))
    nbytes = 4.0 * (16 * 800 * 600 * 4 + 3 * 1200 + 2 * 16 * 800 * 601 * 4)
    for k, v in ms.items():
        print(json.dumps({"geometry": "hop_block", "n_fft": 1200, "hop": 600,
                          "shape": [16, 800, 600, 4], "kernel": k, "ms_per_launch": v,
                          "bound_ms": nbytes / HBM_BYTES_S * 1e3, "card": card}), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", help="an older stft.cu (commit 2ca6931's C interface)")
    ap.add_argument("--geometries", nargs="+", choices=list(GEOMETRIES),
                    default=list(GEOMETRIES), help="the geometries to time (all)")
    ap.add_argument("--configs", action="store_true",
                    help="time every shared route, tile and ring at G1")
    ap.add_argument("--hop-block", action="store_true",
                    help="time the hop-block kernel at (16, 800, 600, 4)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    print(json.dumps({"ptxas": ptxas_report(build.build()["ptxas"])}), flush=True)
    base = baseline_library(args.baseline) if args.baseline else None
    if args.hop_block:
        hop_block_rows(card, base)
    for tag in args.geometries:
        n, hop, win, sr = GEOMETRIES[tag]
        w = analysis_window("han", win, n)
        plan = hopper_stft.fft_plan(w, "cuda")
        mats = [torch.as_tensor(m, device="cuda") for m in dft_matrices(n, w)]
        cfg = tuple(hopper_stft.frames_config(n, hop)[:3])
        cfgs = [cfg] + ([c for c in configs_of(n, hop) if c != cfg]
                        if args.configs and tag == "G1" else [])
        N = 20 * sr
        small = audio(2, N // 8, seed=n)
        K, T = n // 2 + 1, N // hop
        re_s = torch.empty((2, small.shape[1] // hop, K, 4), device="cuda")
        im_s = torch.empty_like(re_s)
        errs = {c: check(this_launch(small, plan, hop, c, re_s, im_s), small, mats, hop, re_s,
                         im_s, f"{tag} {c}") for c in cfgs}
        base_cfg = None
        if base is not None:
            run_b, base_cfg = baseline_launch(base, small, plan, hop, re_s, im_s)
            errs["baseline"] = check(run_b, small, mats, hop, re_s, im_s, f"{tag} baseline")
        del small, re_s, im_s
        x = audio(16, N, seed=n + 1)
        re = torch.empty((16, T, K, 4), device="cuda")
        im = torch.empty_like(re)
        xs = x.permute(0, 2, 1).reshape(64, N).contiguous()
        win_t = torch.as_tensor(w, device="cuda")
        runs = {c: this_launch(x, plan, hop, c, re, im) for c in cfgs}
        if base is not None:
            runs["baseline"] = baseline_launch(base, x, plan, hop, re, im)[0]
        runs["torch.stft"] = lambda: torch.stft(xs, n_fft=n, hop_length=hop, window=win_t,
                                                center=True, pad_mode="reflect",
                                                return_complex=True)
        ms = {k: [] for k in runs}
        order = list(runs)
        for turn in range(2):  # in turns: forward order, then backward
            for k in (order if turn == 0 else order[::-1]):
                ms[k].append(per_launch_ms(runs[k]))
        nbytes = 4.0 * (16 * N * 4 + 3 * n + 2 * 16 * T * K * 4)
        bound_ms = nbytes / HBM_BYTES_S * 1e3
        for k, v in ms.items():
            print(json.dumps({
                "geometry": tag, "n_fft": n, "hop": hop, "win_length": win, "shape": [16, N, 4],
                "kernel": k if isinstance(k, str) else " + ".join(
                    hopper_stft.kernels_of(n, hop) if k == cfg else ["stft_frames_fft_kernel"]),
                "config": base_cfg if k == "baseline" else (
                    None if isinstance(k, str) else list(k)),
                "global_config": (list(hopper_stft.frames_config(n, hop)[4:])
                                  if k == cfg and cfg[0] == GLOBAL else None),
                "wrapper_config": k == cfg, "ms_per_launch": v,
                "bound_ms": bound_ms, "bound_share": bound_ms / min(v),
                "max_abs_err_b2": errs.get(k), "radices": list(plan.frames_radices),
                "card": card}), flush=True)
        del x, re, im, xs


if __name__ == "__main__":
    main()
