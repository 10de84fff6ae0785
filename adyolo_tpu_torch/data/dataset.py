"""Dataset, epoch sampling and batch assembly: the port's copy of
:mod:`adyolo_tpu.data.dataset`, for every output format.

Host side of the input pipeline (reference ``src/datasets.py:21-162``):
the host reads wavs, rotates FOA audio and encodes labels; the features
and SpecAugment run on the device, inside the train step.

* path layout: train -> ``<fmt>_dev/dev-train-chunked_<W>s_<S>s``;
  val/test -> ``<fmt>_dev/dev-val`` / ``dev-test``, metadata under
  ``metadata_dev``; infer -> a user wav folder with empty labels
  (reference ``src/datasets.py:35-58``);
* the epoch pool sampler draws ``batch_size * nb_iters`` files per epoch
  without replacement across epochs from a ``remaining`` pool that the
  checkpoint stores (``src/datasets.py:67-99``);
* int16 wav -> ``/32768 + 1e-8`` (``src/datasets.py:147``); training
  batches stay int16, in the hop-block layout ``(B, T, hop, C)``, and the
  train step normalises on the device;
* eval clips are padded into length buckets, with their valid-frame
  counts, in the hop-block layout ``(1, T, hop, C)`` the STFT kernel takes.

Every random draw (sampler, shuffle, rotation) comes from python's
``random``, in the JAX package's order, so with the same seed both
packages yield the same batches.  Under data parallelism each rank's
:class:`TrainLoader` yields its shard of every global batch.
"""
from __future__ import annotations

import copy
import os
import queue as queue_mod
import random
import sys
import threading
from typing import Dict, Iterator, List, Sequence

import numpy as np

from ..config import Config
from ..ops.grid import GridGeometry
from ..ops.rotation import RotationAug
from ..parallel.mesh import check_batch
from ..utils.profiling import span
from . import io
from .labels import (encode_accdoa, encode_adpit, encode_adyolo, encode_seddoa,
                     pad_yolo_targets)

__all__ = ["EpochPoolSampler", "SELDDataset", "TrainLoader", "EvalLoader",
           "bucket_samples"]


class EpochPoolSampler:
    """Across-epoch no-replacement sampler (datasets.py:67-99).

    Uses python's ``random`` module so the host RNG state captured in
    checkpoints covers it, like the reference.
    """

    def __init__(self, total_filelist: Sequence[str], nb_samples: int):
        self.total = list(total_filelist)
        self.nb_samples = nb_samples
        self.remaining = list(self.total)

    def sample_epoch(self) -> List[str]:
        nb = self.nb_samples
        if not self.total:
            raise ValueError("EpochPoolSampler: empty file list")
        if nb > len(self.total):
            # Small-dataset guard (e.g. quick_test on a tiny folder): wrap
            # the no-replacement pool as many times as needed.  The
            # reference crashes here (random.sample ValueError), so there
            # is no RNG-parity constraint on this branch.
            filelist: List[str] = []
            need = nb
            while need > 0:
                if not self.remaining:
                    self.remaining = copy.deepcopy(self.total)
                take = min(need, len(self.remaining))
                picked = random.sample(self.remaining, take)
                for f in picked:
                    self.remaining.remove(f)
                filelist.extend(picked)
                need -= take
            return filelist
        if len(self.remaining) >= nb:
            filelist = random.sample(self.remaining, nb)
            for f in filelist:
                self.remaining.remove(f)
        elif not self.remaining:
            self.remaining = copy.deepcopy(self.total)
            filelist = random.sample(self.remaining, nb)
            for f in filelist:
                self.remaining.remove(f)
        else:
            random.shuffle(self.remaining)
            pre_sampled = copy.deepcopy(self.remaining)
            self.remaining = copy.deepcopy(self.total)
            filelist = random.sample(self.remaining, nb - len(pre_sampled))
            for f in filelist:
                self.remaining.remove(f)
            filelist.extend(pre_sampled)
        return filelist

    # checkpoint hooks (train.py:150, 247)
    def get_remaining(self) -> List[str]:
        return self.remaining

    def set_remaining(self, remaining: List[str]) -> None:
        self.remaining = list(remaining)


class SELDDataset:
    """Clip-level access: wav + label dict -> (audio, encoded label)."""

    def __init__(self, cfg: Config, set_type: str, is_valid: bool = False):
        self.cfg = cfg
        self.loss_nm = cfg.args.loss
        self.set_type = set_type
        self.is_infer = set_type == "infer"
        d = cfg.data
        audio_dir = f"{d.audio_format}_dev"
        self.sampler = None
        if set_type == "train":
            sub = f"dev-train-chunked_{d.chunk_window_s}s_{d.chunk_stride_s}s"
            self.wav_pth = os.path.join(d.data_pth, audio_dir, sub)
            self.csv_pth = os.path.join(d.data_pth, "metadata_dev", sub)
            self.sampler = EpochPoolSampler(
                io.list_clips(self.wav_pth), cfg.train.batch_size * cfg.train.nb_iters)
            self.filelist = self.sampler.sample_epoch()
        elif self.is_infer:
            self.wav_pth = cfg.args.infer_pth
            self.csv_pth = None
            self.filelist = io.list_clips(self.wav_pth)
        else:  # val / test
            self.wav_pth = os.path.join(d.data_pth, audio_dir, f"dev-{set_type}")
            self.csv_pth = os.path.join(d.data_pth, "metadata_dev", f"dev-{set_type}")
            self.filelist = io.list_clips(self.wav_pth)

        # rotation is FOA math (sign flips and an X/Y swap of the W/Y/Z/X
        # channels); on raw MIC channels it would corrupt them
        rotation_enabled = cfg.aug.rotation_augment
        if rotation_enabled and d.audio_format != "foa":
            print("[adyolo_tpu_torch] WARNING: rotation augmentation is FOA-only; "
                  f"disabled for audio_format={d.audio_format!r}", file=sys.stderr)
            rotation_enabled = False
        self.rotation = RotationAug(rotation_enabled, is_valid or self.is_infer)
        if self.loss_nm == "adyolo":
            self.geom = GridGeometry(tuple(cfg.train.grid_size),
                                     cfg.train.g_overlap, cfg.train.nb_anchors)

    def __len__(self) -> int:
        return len(self.filelist)

    def resample_epoch(self) -> None:
        if self.sampler is not None:
            self.filelist = self.sampler.sample_epoch()

    def get_filelist(self) -> List[str]:
        return self.filelist

    def load_clip(self, name: str, normalize: bool = True, rot_comb=None):
        """Returns (audio (N, C), label_dict, nb_label_frames).

        ``normalize=False`` keeps int16 samples (the train step normalises
        on the device; rotation only flips signs and swaps channels, so the
        order does not change a bit).  ``rot_comb``: a pre-drawn rotation
        (:meth:`RotationAug.draw`), so parallel loads do not race on the
        host RNG."""
        audio = io.read_wav(os.path.join(self.wav_pth, name + ".wav"))
        label: io.LabelDict = {}
        if not self.is_infer:
            label = io.read_label_csv(os.path.join(self.csv_pth, name + ".csv"))
        audio, label = self.rotation(audio, label, comb_no=rot_comb)
        if normalize or audio.dtype != np.int16:
            audio = io.normalize_audio(audio)
        return audio, label, len(audio) // self.cfg.data.label_hop_len

    def encode_label(self, label: io.LabelDict, nb_label_frames: int):
        """The label in the loss's format (``adyolo_tpu/data/dataset.py:187-197``)."""
        K = self.cfg.data.nb_classes
        if self.loss_nm in ("seddoa", "masked-seddoa"):
            return encode_seddoa(label, nb_label_frames, K)
        if self.loss_nm == "accdoa":
            return encode_accdoa(label, nb_label_frames, K)
        if self.loss_nm == "adpit":
            return encode_adpit(label, nb_label_frames, K)
        if self.loss_nm == "adyolo":
            return encode_adyolo(label, nb_label_frames, self.geom)
        raise NotImplementedError(f"loss: {self.loss_nm!r}")


def _assemble_batch(dataset: SELDDataset, names: Sequence[str], combs: Sequence,
                    max_targets: int, pool=None):
    """Stack a fixed-length training batch (audio stays int16 when the
    source wavs are int16; the train step normalizes on device): AD-YOLO
    targets padded to ``max_targets`` with their ``target_mask``, dense
    targets stacked as float32 with no mask.

    ``combs``: the clips' rotations, pre-drawn (:meth:`RotationAug.draw`).
    ``pool``: optional ThreadPoolExecutor to load/encode clips in parallel
    (the analog of the reference's ``DataLoader(num_workers=16)``,
    train.py:125-129)."""

    def load_one(args):
        name, comb = args
        audio, label, nb_frames = dataset.load_clip(
            name, normalize=False, rot_comb=comb)
        return audio, dataset.encode_label(label, nb_frames)

    if pool is None:
        loaded = [load_one(a) for a in zip(names, combs)]
    else:
        loaded = list(pool.map(load_one, zip(names, combs)))
    audios = [a for a, _ in loaded]
    labels = [l for _, l in loaded]
    audio = np.stack(audios, axis=0)
    d = dataset.cfg.data
    if d.n_fft == 2 * d.hop_length and audio.shape[1] % d.hop_length == 0:
        # hop-block layout (B, T, hop, C), the one the STFT kernel reads:
        # a free view of the stacked batch
        audio = audio.reshape(audio.shape[0], -1, d.hop_length,
                              audio.shape[2])
    if dataset.loss_nm != "adyolo":
        return {"audio": audio, "targets": np.stack(labels, axis=0).astype(np.float32)}
    targets, mask = pad_yolo_targets(labels, max_targets)
    return {"audio": audio, "targets": targets, "target_mask": mask}


class TrainLoader:
    """Epoch iterator over shuffled fixed-length chunk batches, with an
    optional background prefetch thread (host analog of the reference's
    ``DataLoader(num_workers=16, prefetch_factor=4)``, train.py:125-129 —
    feature extraction runs on-device here, so the host only decodes wavs,
    rotates and encodes labels).  ``num_workers > 1`` additionally fans
    the per-clip load/encode work of each batch across a thread pool —
    batches are bit-identical to the sequential path (rotation RNG is
    pre-drawn in order) so resume reproducibility is unaffected.

    Data parallelism (``rank``, ``num_shards``; ``adyolo_tpu/data/
    dataset.py:252-278``): each of the ``num_shards`` ranks takes
    ``batch_size / num_shards`` clips of every global batch, the
    interleaved slice ``[rank::num_shards]`` of the identically shuffled
    epoch, so the slices are disjoint and together the single-process
    batches.  The rotations are drawn per global batch on every rank and
    sliced the same way: every rank consumes python's ``random`` as a
    single process does, and each clip gets its single-process rotation.
    ``(0, 1)`` is the single-process loader."""

    def __init__(self, dataset: SELDDataset, cfg: Config, rank: int = 0,
                 num_shards: int = 1):
        check_batch(cfg.train.batch_size, num_shards)
        self.dataset = dataset
        self.rank, self.num_shards = rank, num_shards
        self.global_batch = cfg.train.batch_size
        self.batch_size = self.global_batch // num_shards
        self.max_targets = cfg.train.max_targets_per_clip * self.batch_size
        self.prefetch = cfg.train.num_workers > 0
        self.pool_workers = min(cfg.train.num_workers, self.batch_size)
        self.queue_depth = max(2, cfg.train.prefetch_factor)

    def __len__(self) -> int:
        """Steps per epoch (global batches)."""
        return len(self.dataset) // self.global_batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        names = list(self.dataset.get_filelist())
        random.shuffle(names)  # DataLoader(shuffle=True) analog
        G = self.global_batch
        batches = [names[i : i + G] for i in range(0, len(names) - G + 1, G)]
        # every rotation of the epoch, drawn here in batch order: the host
        # RNG stream (kept in checkpoints) is the sequential one, and a
        # consumer that leaves early finds it as after a full epoch
        combs = [self.dataset.rotation.draw(len(b)) for b in batches]
        if self.num_shards > 1:  # this rank's slice of every global batch
            r, n = self.rank, self.num_shards
            batches = [b[r::n] for b in batches]
            combs = [c[r::n] for c in combs]
        if not self.prefetch:
            for b, c in zip(batches, combs):
                yield _assemble_batch(self.dataset, b, c, self.max_targets)
            return

        pool = None
        if self.pool_workers > 1:
            from concurrent.futures import ThreadPoolExecutor

            pool = ThreadPoolExecutor(max_workers=self.pool_workers,
                                      thread_name_prefix="clip-loader")

        q: queue_mod.Queue = queue_mod.Queue(maxsize=self.queue_depth)
        stop = object()
        cancelled = threading.Event()

        def put_cancellable(item) -> bool:
            """Bounded put that gives up when the consumer is gone — an
            unconditional q.put would block a worker forever on a full
            queue after an early consumer exit (quick_test break,
            preemption), leaking the thread and the pool."""
            while not cancelled.is_set():
                try:
                    q.put(item, timeout=0.5)
                    return True
                except queue_mod.Full:
                    continue
            return False

        def worker():
            try:
                for b, c in zip(batches, combs):
                    item = _assemble_batch(self.dataset, b, c, self.max_targets,
                                           pool=pool)
                    if not put_cancellable(item):
                        return
            except BaseException as e:  # propagate to the consumer
                if not cancelled.is_set():
                    # post-shutdown pool.map raising is a teardown artifact,
                    # not an error the (already departed) consumer needs
                    put_cancellable(e)
                return
            put_cancellable(stop)

        t = threading.Thread(target=worker, daemon=True,
                             name="clip-loader-prefetch")
        t.start()
        try:
            while True:
                item = q.get()
                if item is stop:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            # on an early exit, the worker finishes the batch at hand and
            # stops; it and the pool are gone when the consumer goes on
            cancelled.set()
            t.join()
            if pool is not None:
                pool.shutdown(wait=True)


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
    valid frame counts and the encoded label: AD-YOLO targets padded to a
    capacity that grows with the clip, with their mask, or dense targets
    zero-padded to the bucket's label frames."""

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
            # closed before the yield: the span never holds the consumer's work
            with span("eval.load"):
                with span("eval.normalize"):
                    audio, label, nb_label_frames = self.dataset.load_clip(name)
                n_valid = len(audio)
                n_bucket = bucket_samples(n_valid, hop, self.buckets)
                with span("eval.pad"):
                    padded = np.zeros((1, n_bucket, audio.shape[1]), np.float32)
                    padded[0, :n_valid] = audio
                if self.cfg.data.n_fft == 2 * hop:
                    # hop-block layout (1, T, hop, C): a free view (buckets are
                    # hop multiples)
                    padded = padded.reshape(1, -1, hop, audio.shape[1])
                item = {"name": name, "audio": padded,
                        "valid_feat_frames": np.array([n_valid // hop], np.int32),
                        "nb_label_frames": nb_label_frames}
                enc = self.dataset.encode_label(label, nb_label_frames)
                if self.dataset.loss_nm == "adyolo":
                    chunks = -(-nb_label_frames // self.cfg.data.chunk_label_frames)
                    item["targets"], item["target_mask"] = pad_yolo_targets(
                        [enc], max(1, chunks) * self.max_targets_per_chunk)
                else:  # the bucket's label frames (adyolo_tpu/data/dataset.py:401-407)
                    dense = np.zeros((n_bucket // self.cfg.data.label_hop_len,)
                                     + enc.shape[1:], np.float32)
                    dense[:nb_label_frames] = enc
                    item["targets"] = dense[None]
            yield item
