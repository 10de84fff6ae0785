"""Clip access and the eval loader: the port's copy of the eval part of
:mod:`adyolo_tpu.data.dataset` (``SELDDataset``, ``EvalLoader``,
``bucket_samples``).

* path layout: val/test -> ``<fmt>_dev/dev-val`` / ``dev-test`` with
  metadata under ``metadata_dev``; infer -> a user wav folder with empty
  labels (reference ``src/datasets.py:35-58``);
* int16 wav -> ``/32768 + 1e-8`` (``src/datasets.py:147``);
* eval clips are padded into length buckets, with their valid-frame
  counts, in the hop-block layout ``(1, T, hop, C)`` the STFT kernel takes.

The training set (epoch pool sampler, ``TrainLoader``) and the rotation
augmentation wait for the port of the train engine (``ROADMAP.md``).
"""
from __future__ import annotations

import os
from typing import Sequence

import numpy as np

from ..config import Config
from ..ops.grid import GridGeometry
from . import io
from .labels import encode_adyolo, pad_yolo_targets

__all__ = ["SELDDataset", "EvalLoader", "bucket_samples"]

_TRAIN_LOADER = ("not yet ported: the training set and rotation augmentation "
                 "(ROADMAP.md, port queue: the engine and 'cli train')")


class SELDDataset:
    """Clip-level access: wav + label dict -> (audio, encoded label)."""

    def __init__(self, cfg: Config, set_type: str, is_valid: bool = False):
        if set_type == "train" or (cfg.aug.rotation_augment and not is_valid
                                   and set_type != "infer"):
            raise NotImplementedError(_TRAIN_LOADER)
        if cfg.args.loss != "adyolo":
            raise NotImplementedError(f"not yet ported: loss {cfg.args.loss!r}")
        self.cfg = cfg
        self.set_type = set_type
        self.is_infer = set_type == "infer"
        d = cfg.data
        if self.is_infer:
            self.wav_pth = cfg.args.infer_pth
            self.csv_pth = None
        else:  # val / test
            audio_dir = f"{d.audio_format}_dev"
            self.wav_pth = os.path.join(d.data_pth, audio_dir, f"dev-{set_type}")
            self.csv_pth = os.path.join(d.data_pth, "metadata_dev", f"dev-{set_type}")
        self.filelist = io.list_clips(self.wav_pth)
        self.geom = GridGeometry(tuple(cfg.train.grid_size), cfg.train.g_overlap,
                                 cfg.train.nb_anchors)

    def __len__(self) -> int:
        return len(self.filelist)

    def get_filelist(self):
        return self.filelist

    def load_clip(self, name: str):
        """Returns (audio (N, C) float32, label_dict, nb_label_frames)."""
        audio = io.read_wav(os.path.join(self.wav_pth, name + ".wav"))
        label: io.LabelDict = {}
        if not self.is_infer:
            label = io.read_label_csv(os.path.join(self.csv_pth, name + ".csv"))
        audio = io.normalize_audio(audio)
        return audio, label, len(audio) // self.cfg.data.label_hop_len

    def encode_label(self, label: io.LabelDict, nb_label_frames: int):
        return encode_adyolo(label, nb_label_frames, self.geom)


def bucket_samples(n_samples: int, hop: int, buckets: Sequence[int]) -> int:
    """Smallest bucket (in samples) holding ``n_samples``; buckets are
    frame counts at the STFT hop.  Falls back to rounding up to the
    largest bucket's granularity for very long clips.  Frame count is
    ceil-divided: a clip whose length is not a hop multiple must still fit
    inside the bucket buffer."""
    frames = -(-n_samples // hop)
    for b in buckets:
        if frames <= b:
            return b * hop
    step = buckets[-1]
    return ((frames + step - 1) // step) * step * hop


class EvalLoader:
    """Per-clip eval iterator with length bucketing (batch_size=1 in the
    reference, train.py:130-133).  Yields dicts with the padded audio, the
    valid frame counts and the padded AD-YOLO targets."""

    # frame-count buckets: 30 s .. 16 min at 25 ms hop, x2 steps
    DEFAULT_BUCKETS = (800, 1200, 2400, 4800, 9600, 19200, 38400)

    def __init__(self, dataset: SELDDataset, cfg: Config,
                 buckets: Sequence[int] = DEFAULT_BUCKETS):
        self.dataset = dataset
        self.cfg = cfg
        self.buckets = tuple(buckets)
        # target capacity scales with clip length: max_targets_per_clip is
        # sized for one 20-s chunk, eval clips may run many minutes
        self.max_targets_per_chunk = cfg.train.max_targets_per_clip

    def __len__(self) -> int:
        return len(self.dataset)

    def __iter__(self):
        hop = self.cfg.data.hop_length
        for name in self.dataset.get_filelist():
            audio, label, nb_label_frames = self.dataset.load_clip(name)
            n_valid = len(audio)
            n_bucket = bucket_samples(n_valid, hop, self.buckets)
            padded = np.zeros((1, n_bucket, audio.shape[1]), np.float32)
            padded[0, :n_valid] = audio
            if self.cfg.data.n_fft == 2 * hop:
                # hop-block layout (1, T, hop, C): a free view (buckets are
                # hop multiples)
                padded = padded.reshape(1, -1, hop, audio.shape[1])
            chunks = -(-nb_label_frames // self.cfg.data.chunk_label_frames)
            targets, mask = pad_yolo_targets(
                [self.dataset.encode_label(label, nb_label_frames)],
                max(1, chunks) * self.max_targets_per_chunk)
            yield {"name": name, "audio": padded,
                   "valid_feat_frames": np.array([n_valid // hop], np.int32),
                   "nb_label_frames": nb_label_frames,
                   "targets": targets, "target_mask": mask}
