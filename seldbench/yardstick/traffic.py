"""The general generator of the benchmark's traffic.  A traffic mix is a
JSON file under ``seldbench/traffic/``; :func:`train_pool` and
:func:`clip_stream` read its parameters.

Copied from ``chip_smoke.py`` at commit 4ed7d29 and kept here so that a
later change to the program cannot move them:

* ``synthetic_clips`` -> :func:`dense_labels`: random events on a share of
  the label frames (70 %: one to three events each), class, azimuth and
  elevation uniform;
* ``render_clip`` -> :func:`render_clip`: FOA-encoded class tones
  (320 Hz x 2^(c/3)) at their labelled direction over noise, int16.  The
  noise is drawn on the device from a ``torch.Generator`` (one call a
  clip), the events from numpy; the same seed gives the same clip.

and from ``adyolo_tpu_torch`` at the same commit: the AD-YOLO grid
(``ops/grid.py``: cell centres, overlap-expanded bounds, the responsible
cells with the azimuth wrap) and the target encoder and padding
(``data/labels.py::encode_adyolo``, ``pad_yolo_targets``): the targets
are the benchmark's input, handed alike to the program and the reference.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

__all__ = ["Grid", "dense_labels", "encode_adyolo", "pad_targets", "train_pool",
           "render_clip", "clip_stream", "sub_seed"]


def sub_seed(seed: int, tag: int) -> int:
    """A 63-bit seed for stream ``tag`` of run seed ``seed``."""
    lo, hi = np.random.SeedSequence([int(seed) % (2 ** 64), tag]).generate_state(2, np.uint32)
    return (int(lo) + (int(hi) << 32)) % (2 ** 63)


class Grid:
    """The AD-YOLO spherical grid: ``grid_size`` degrees a cell, cells
    responsible for an event within ``g_overlap`` of their bounds."""

    def __init__(self, grid_size: Sequence[float], g_overlap: float, nb_anchors: int):
        gs = np.asarray(grid_size, np.float32)
        self.nb_grids = (math.ceil(360.0 / gs[0]), math.ceil(180.0 / gs[1]))
        self.nb_anchors = nb_anchors
        self.grid_size = gs
        self.g_overlap = g_overlap
        off = np.stack(np.meshgrid(np.arange(self.nb_grids[0]), np.arange(self.nb_grids[1]),
                                   indexing="ij"), axis=-1).astype(np.float32)
        self.offset = off * gs - np.array([180.0, 90.0], np.float32) + gs * 0.5
        half = gs * (0.5 + g_overlap)
        self.lb, self.ub = self.offset - half, self.offset + half
        self.lb[..., 1] = np.clip(self.lb[..., 1], -90.0, 90.0)
        self.ub[..., 1] = np.clip(self.ub[..., 1], -90.0, 90.0)

    def responsible(self, azi: float, ele: float) -> np.ndarray:
        ele_ok = (self.lb[..., 1] <= ele) & (ele < self.ub[..., 1])
        azi_ok = (self.lb[..., 0] <= azi) & (azi < self.ub[..., 0])
        resp = azi_ok & ele_ok
        resp |= (azi + 360.0 < self.ub[..., 0]) & ele_ok
        resp |= (self.lb[..., 0] < azi - 360.0) & ele_ok
        return resp

    @property
    def uv_scale(self) -> np.ndarray:
        return self.grid_size * (0.5 + self.g_overlap)


def dense_labels(rng: np.random.Generator, frames: int, nb_classes: int,
                 share: float, events: Sequence[int]) -> Dict[int, list]:
    """``{frame: [[class, track, azi, ele], ...]}``: on each label frame with
    probability ``share``, ``events[0]`` to ``events[1]`` random events."""
    label = {}
    for f in range(frames):
        if rng.random() < share:
            label[f] = [[int(rng.integers(nb_classes)), i,
                         float(rng.uniform(-180, 180)), float(rng.uniform(-90, 90))]
                        for i in range(int(rng.integers(events[0], events[1] + 1)))]
    return label


def encode_adyolo(label: Dict[int, list], frames: int, grid: Grid) -> np.ndarray:
    """One row ``[frame, Gi, Gj, class, azi, ele]`` an (event, responsible
    cell); azimuth +180 folds to -180."""
    rows: List[list] = []
    for frame, events in label.items():
        if frame >= frames:
            continue
        for ev in events:
            azi, ele = float(ev[2]), float(ev[3])
            if azi == 180.0:
                azi = -180.0
            gi, gj = np.where(grid.responsible(azi, ele))
            rows.extend([frame, int(i), int(j), int(ev[0]), azi, ele] for i, j in zip(gi, gj))
    return np.asarray(rows, np.float32).reshape(-1, 6)


def pad_targets(per_clip: Sequence[np.ndarray], capacity: int) -> Tuple[np.ndarray, np.ndarray]:
    """The clips' rows as ``(capacity, 7)`` ``[clip, frame, Gi, Gj, class,
    azi, ele]`` and their validity mask.  Raises where they do not fit: the
    traffic is sized so that nothing is dropped."""
    rows = [np.concatenate([np.full((len(t), 1), b, np.float32), t], axis=1)
            for b, t in enumerate(per_clip) if len(t)]
    cat = np.concatenate(rows, axis=0) if rows else np.zeros((0, 7), np.float32)
    if len(cat) > capacity:
        raise ValueError(f"{len(cat)} target rows exceed the capacity {capacity}")
    out = np.zeros((capacity, 7), np.float32)
    mask = np.zeros((capacity,), bool)
    out[:len(cat)], mask[:len(cat)] = cat, True
    return out, mask


def train_pool(mix: dict, config: dict, seed: int, device) -> List[dict]:
    """``mix["pool"]`` training batches, each ``{"audio": (B, T, hop, 4)
    int16, "targets", "target_mask"}`` as numpy arrays on the host, as a
    loader yields them.  Audio: ``N(0, 1) x audio_scale`` noise truncated
    to int16, drawn on ``device``; labels: :func:`dense_labels`."""
    d, tr = config["data"], config["train"]
    B, secs = mix["batch"], mix["clip_s"]
    hop = d["hop_length"]
    frames = int(secs / d["label_hop_len_s"])
    grid = Grid(tr["grid_size"], tr["g_overlap"], tr["nb_anchors"])
    rng = np.random.default_rng(sub_seed(seed, 1))
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 2))
    pool = []
    for _ in range(mix["pool"]):
        noise = torch.randn((B, d["sr"] * secs // hop, hop, 4), generator=gen, device=device)
        audio = (noise * mix["audio_scale"]).to(torch.int16).cpu().numpy()
        per_clip = [encode_adyolo(dense_labels(rng, frames, d["nb_classes"], mix["event_share"],
                                               mix["events_per_frame"]), frames, grid)
                    for _ in range(B)]
        targets, mask = pad_targets(per_clip, tr["max_targets_per_clip"] * B)
        pool.append({"audio": audio, "targets": targets, "target_mask": mask})
    return pool


def render_clip(rng: np.random.Generator, gen: torch.Generator, secs: int, sr: int,
                n_events: int, label_hop_s: float, nb_classes: int, device) -> tuple:
    """int16 FOA ``(secs * sr, 4)`` on the host: class tones FOA-encoded at
    their labelled direction over ``N(0, 0.02)`` noise; and the label dict
    ``{frame: [[class, 0, azi, ele]]}``."""
    n = sr * secs
    hop = int(sr * label_hop_s)
    audio = torch.randn((n, 4), generator=gen, device=device, dtype=torch.float64) * 0.02
    label: Dict[int, list] = {}
    frames = n // hop
    for _ in range(n_events):
        c = int(rng.integers(nb_classes))
        azi, ele = float(rng.integers(-180, 180)), float(rng.integers(-60, 61))
        dur = int(rng.integers(5, 15))
        start = int(rng.integers(0, frames - dur))
        t0, t1 = start * hop, (start + dur) * hop
        t = np.arange(t1 - t0) / sr
        tone = 0.35 * np.sin(2 * np.pi * 320.0 * 2 ** (c / 3.0) * t + rng.uniform(0, 6.28))
        a, e = np.radians(azi), np.radians(ele)
        gains = np.array([2 ** -0.5, np.cos(a) * np.cos(e), np.sin(a) * np.cos(e), np.sin(e)])
        audio[t0:t1] += torch.as_tensor(tone[:, None] * gains[None, :], device=device)
        for f in range(start, start + dur):
            label.setdefault(f, []).append([c, 0, azi, ele])
    pcm = (torch.clamp(audio, -0.99, 0.99) * 32767).to(torch.int16).cpu().numpy()
    return pcm, label


def clip_stream(mix: dict, config: dict, seed: int, device) -> List[dict]:
    """One cycle of the mix's clips, in order: ``{"secs", "audio" (N, 4)
    int16 on the host, "label", "events"}``; every seed draws the same
    lengths and event counts, only their content differs."""
    d = config["data"]
    rng = np.random.default_rng(sub_seed(seed, 3))
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 4))
    clips = []
    for secs in mix["clip_s"]:
        n_events = max(2, int(secs * mix["events_per_s"]))
        audio, label = render_clip(rng, gen, secs, d["sr"], n_events, d["label_hop_len_s"],
                                   d["nb_classes"], device)
        clips.append({"secs": secs, "audio": audio, "label": label,
                      "events": sum(len(v) for v in label.values())})
    return clips
