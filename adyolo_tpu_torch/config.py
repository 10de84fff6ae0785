"""Three-tier configuration system (the port's copy of
:mod:`adyolo_tpu.config`, which imports no JAX; kept field for field the
same, so that the port reads the experiment dirs the JAX trainer writes and
the repository's ``configs/*.yaml``).

Reproduces the semantics of the reference config stack
(``src/utils/utility.py:53-99`` ``config_reader``/``config_writer``/
``config_parser`` + ``src/configs/*.yaml``): a per-dataset data config, an
augmentation config and a training config are merged with CLI arguments
(CLI overrides train-config keys), and the merged result is frozen to the
experiment directory as ``hyp_exp.yaml`` so that eval/resume reconstitute
the exact training configuration (``src/train.py:114-115``,
``src/test.py:76-77``).

TPU-first differences:
* configs are immutable dataclasses (safe to close over in jit),
* defaults are embedded so the framework is runnable without YAML files,
* a ``mesh`` section describes the device-mesh axes used by the parallel
  layer (absent from the single-GPU reference, SURVEY.md §2.3).
"""
from __future__ import annotations

import dataclasses
import os
import re
from dataclasses import dataclass, field, replace
from typing import Any, Dict, Optional, Tuple

import yaml

# ---------------------------------------------------------------------------
# Dataclasses
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class DataConfig:
    """Dataset geometry (reference: ``src/configs/hyp_data_DCASE2022.yaml``)."""

    dataset: str = "DCASE2022"
    data_pth: str = "data/DCASE2022_SELD/"
    name_pth: str = "data/DCASE2022_SELD/classes.txt"
    nb_classes: int = 13

    audio_format: str = "foa"  # 'foa' | 'mic' (mic adds GCC-PHAT features)

    sr: int = 24000
    hop_length_s: float = 0.025
    win_length_s: float = 0.050
    hop_length: int = 600
    win_length: int = 1200
    n_fft: int = 1200
    mel_bins: int = 64
    window: str = "han"

    label_hop_len_s: float = 0.1

    chunk_window_s: int = 20
    chunk_stride_s: int = 1

    @property
    def label_hop_len(self) -> int:
        # reference: src/datasets.py:202
        return int(self.sr * self.label_hop_len_s)

    @property
    def feat_frames_per_label_frame(self) -> int:
        return self.label_hop_len // self.hop_length

    @property
    def chunk_samples(self) -> int:
        return self.sr * self.chunk_window_s

    @property
    def chunk_feat_frames(self) -> int:
        # 20 s / 25 ms = 800 STFT frames per training chunk
        return self.chunk_samples // self.hop_length

    @property
    def chunk_label_frames(self) -> int:
        return self.chunk_samples // self.label_hop_len

    @property
    def nb_feature_channels(self) -> int:
        # FOA: 4 log-mel + 3 intensity-vector channels (src/datasets.py:292)
        # MIC: 4 log-mel + 6 GCC-PHAT pair channels (DCASE baseline definition)
        return 7 if self.audio_format == "foa" else 10


@dataclass(frozen=True)
class AugConfig:
    """Augmentation switches (reference: ``src/configs/hyp_augmentation.yaml``)."""

    rotation_augment: bool = False
    spec_augment: bool = False
    spec_augment_thresh: float = 0.5
    spec_augment_time_mask_param: int = 40
    spec_augment_freq_mask_param: int = 40


@dataclass(frozen=True)
class LossGains:
    """AD-YOLO loss gains (reference: ``src/configs/hyp_train.yaml:20-25``)."""

    angular_gain: float = 5.0
    object_gain: float = 1.0
    nonobj_gain: float = 5.0
    class_gain: float = 3.0


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh description for the parallel layer (TPU-only addition).

    The reference is single-device (SURVEY.md §2.3); here a 1-D ``data``
    axis provides data parallelism over a slice, and a ``model`` axis is
    reserved for future tensor parallelism.
    """

    data_axis: str = "data"
    model_axis: str = "model"
    model_parallel: int = 1  # mesh size along the model axis


@dataclass(frozen=True)
class TrainConfig:
    """Training hyperparameters (reference: ``src/configs/hyp_train.yaml``)."""

    nb_epochs: int = 200
    nb_iters: int = 500
    batch_size: int = 16
    num_workers: int = 1  # 0 = synchronous; 1 = prefetch thread; >1 adds a
    # per-clip load/encode thread pool (bit-identical batches)
    prefetch_factor: int = 2

    optim: str = "Adam"
    lr: float = 1e-3
    weight_decay: float = 0.0

    grid_size: Tuple[float, float] = (45.0, 45.0)
    nb_anchors: int = 5
    conf_thresh: float = 0.5
    clss_thresh: float = 0.5
    unify_thresh: float = 15.0
    train_unify: Tuple[float, ...] = (45.0, 25.0, 10.0)
    g_overlap: float = 0.5
    nms: str = "conn-merge"  # 'conn-merge' | 'soft-merge' | 'default'
    loss_gains: LossGains = field(default_factory=LossGains)

    # TPU additions ---------------------------------------------------------
    # capacity of the padded AD-YOLO target tensor per batch; ragged event
    # lists (reference src/datasets.py:164-184 collate) become (max_targets,
    # 7) with a validity mask so XLA shapes stay static.
    max_targets_per_clip: int = 4096
    compute_dtype: str = "float32"  # 'float32' | 'bfloat16' for conv/matmul
    remat: bool = False  # jax.checkpoint the conformer blocks (activation
    # rematerialization: ~n_layers x less transformer activation memory in
    # backward for ~1/3 more FLOPs -- enables larger batches)
    # per-frame candidate cap for the device-side AD-YOLO decode compaction
    # (0 = ship the full grid); exactness is guarded at decode time — the
    # host re-decodes the full grid whenever the k-th candidate still
    # clears the confidence threshold.  16 >> max real polyphony and cuts
    # the device->host transfer 10x vs the full 160-anchor grid.
    decode_topk: int = 16
    # PRNG implementation for in-model dropout masks.  'rbg' routes bit
    # generation through the TPU hardware RNG as ONE fusable
    # RngBitGenerator op; threefry's op chain acts as a fusion barrier
    # around every dropout, costing ~6 ms per conformer block in the
    # backward (measured 16.4 -> 10.2 ms/block, scripts/rng_bench.py).
    # The epoch-loop key (and the checkpointable RNG state) stays
    # threefry; only the per-step dropout key is re-wrapped.
    dropout_rng: str = "rbg"  # 'rbg' | 'threefry'


@dataclass(frozen=True)
class RunConfig:
    """CLI-level arguments (reference: ``src/main.py:36-56``)."""

    action: str = "train"  # train | val | test | infer
    dataset: str = "DCASE2022"
    encoder: str = "se-resnet34"  # se-resnet34 | resnet-conformer
    loss: str = "adyolo"  # seddoa | masked-seddoa | accdoa | adpit | adyolo
    seed: int = 100
    augment: bool = False
    fix_thresh: bool = False
    logger: bool = False
    quick_test: bool = False
    eval_pth: Optional[str] = None
    resume_pth: Optional[str] = None
    infer_pth: Optional[str] = None
    exp_id: Optional[str] = None
    results_dir: str = "results"
    # directory of editable hyp_*.yaml presets (reference src/configs/);
    # defaults to ./configs when present
    config_dir: Optional[str] = None
    # experiment-tracking metadata frozen into hyp_exp.yaml so resume can
    # reconstitute the neptune run (reference train.py:86-91)
    logging_meta: Optional[Dict[str, Any]] = None


@dataclass(frozen=True)
class Config:
    """The merged ``params`` bundle threaded through every constructor
    (reference: nested dict built by ``config_reader``, utility.py:53-81)."""

    args: RunConfig = field(default_factory=RunConfig)
    data: DataConfig = field(default_factory=DataConfig)
    aug: AugConfig = field(default_factory=AugConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)


# ---------------------------------------------------------------------------
# Built-in dataset presets (reference: src/configs/hyp_data_*.yaml)
# ---------------------------------------------------------------------------

DATASET_PRESETS: Dict[str, Dict[str, Any]] = {
    "DCASE2020": {
        "data_pth": "data/DCASE2020_SELD/",
        "name_pth": "data/DCASE2020_SELD/classes.txt",
        "nb_classes": 14,
    },
    "DCASE2021": {
        "data_pth": "data/DCASE2021_SELD/",
        "name_pth": "data/DCASE2021_SELD/classes.txt",
        "nb_classes": 12,
    },
    "DCASE2022": {
        "data_pth": "data/DCASE2022_SELD/",
        "name_pth": "data/DCASE2022_SELD/classes.txt",
        "nb_classes": 13,
    },
}


# ---------------------------------------------------------------------------
# (De)serialization
# ---------------------------------------------------------------------------


def _asdict(cfg: Config) -> Dict[str, Any]:
    d = dataclasses.asdict(cfg)
    return d


def _dataclass_from(cls, d: Dict[str, Any]):
    """Build dataclass ``cls`` from dict, ignoring unknown keys and
    recursing into nested dataclass fields."""
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        if dataclasses.is_dataclass(f.type) and isinstance(v, dict):
            v = _dataclass_from(f.type, v)
        elif f.name == "loss_gains" and isinstance(v, dict):
            v = _dataclass_from(LossGains, v)
        elif isinstance(v, list):
            v = tuple(v)
        kwargs[f.name] = v
    return cls(**kwargs)


def _harvest_comments(config_dir: Optional[str], dataset: str
                      ) -> Dict[str, Dict[str, str]]:
    """Per-section ``{field: '# comment'}`` scraped from the preset files.

    The reference freezes ``hyp_exp.yaml`` through a ruamel round-trip so
    the preset files' inline comments survive into the experiment artifact
    (``config_writer``, utility.py:84-90).  ruamel isn't in this image, so
    the same effect comes from harvesting each top-level ``key: value
    # comment`` line out of the preset YAMLs and re-attaching it at dump
    time.  Top-level keys only — nested blocks (loss_gains) keep the
    plain dump.
    """
    out: Dict[str, Dict[str, str]] = {}
    if not config_dir or not os.path.isdir(config_dir):
        return out
    files = {
        "data": f"hyp_data_{dataset}.yaml",
        "aug": "hyp_augmentation.yaml",
        "train": "hyp_train.yaml",
    }
    pat = re.compile(r"^(\w+):.*?(#.*)$")
    for sec, fname in files.items():
        p = os.path.join(config_dir, fname)
        if not os.path.isfile(p):
            continue
        fields: Dict[str, str] = {}
        with open(p, "r") as f:
            for line in f:
                m = pat.match(line.rstrip())
                if m:
                    fields[m.group(1)] = m.group(2).rstrip()
        if fields:
            out[sec] = fields
    return out


def config_to_yaml(cfg: Config) -> str:
    """Serialize the frozen experiment config.

    The reference separates the top-level sections with blank lines and
    preserves preset-file comments via ruamel (``config_writer``,
    utility.py:84-90); here each section gets a header comment and the
    preset files' inline field comments are re-attached (stdlib yaml +
    :func:`_harvest_comments`).
    """
    titles = {
        "args": "CLI arguments (reference src/main.py:36-56)",
        "data": "dataset geometry (reference configs/hyp_data_*.yaml)",
        "aug": "augmentation (reference configs/hyp_augmentation.yaml)",
        "train": "training hyperparameters (reference configs/hyp_train.yaml)",
        "mesh": "device-mesh layout (TPU addition; no reference counterpart)",
    }
    comments = _harvest_comments(cfg.args.config_dir, cfg.args.dataset)
    field_pat = re.compile(r"^  (\w+):")
    parts = []
    for key, val in _asdict(cfg).items():
        body = yaml.safe_dump({key: val}, sort_keys=False)
        sec = comments.get(key)
        if sec:
            lines = []
            for ln in body.splitlines():
                m = field_pat.match(ln)
                if m and m.group(1) in sec and "#" not in ln:
                    ln = f"{ln}    {sec[m.group(1)]}"
                lines.append(ln)
            body = "\n".join(lines) + "\n"
        parts.append(f"# ---- {titles.get(key, key)}\n" + body)
    return "\n".join(parts)


def config_from_yaml(text: str) -> Config:
    d = yaml.safe_load(text)
    return Config(
        args=_dataclass_from(RunConfig, d.get("args", {})),
        data=_dataclass_from(DataConfig, d.get("data", {})),
        aug=_dataclass_from(AugConfig, d.get("aug", {})),
        train=_dataclass_from(TrainConfig, d.get("train", {})),
        mesh=_dataclass_from(MeshConfig, d.get("mesh", {})),
    )


def save_config(cfg: Config, path: str) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(config_to_yaml(cfg))


def load_config(path: str) -> Config:
    with open(path, "r") as f:
        return config_from_yaml(f.read())


def flatten_config(cfg: Config) -> Dict[str, Any]:
    """Flatten for structured logging (reference: ``config_parser``,
    utility.py:93-99)."""
    out: Dict[str, Any] = {}

    def rec(prefix: str, d: Dict[str, Any]):
        for k, v in d.items():
            key = f"{prefix}/{k}" if prefix else k
            if isinstance(v, dict):
                rec(key, v)
            else:
                out[key] = v

    rec("", _asdict(cfg))
    return out


# ---------------------------------------------------------------------------
# Building a config from the YAML presets and CLI arguments
# ---------------------------------------------------------------------------

_noticed_config_dirs: set = set()


def _notice_config_dir(config_dir: str, files) -> None:
    """One stderr line per (process, dir) so an auto-picked ./configs never
    silently hijacks hyperparameters from an unrelated working directory."""
    key = os.path.abspath(config_dir)
    if key in _noticed_config_dirs:
        return
    _noticed_config_dirs.add(key)
    import sys

    print(f"[adyolo_tpu_torch] loading config presets from {key}: "
          f"{', '.join(files)}", file=sys.stderr)


def build_config(
    args: Optional[Dict[str, Any]] = None,
    data_overrides: Optional[Dict[str, Any]] = None,
    aug_overrides: Optional[Dict[str, Any]] = None,
    train_overrides: Optional[Dict[str, Any]] = None,
    config_dir: Optional[str] = None,
) -> Config:
    """Merge the three config tiers + CLI args into one :class:`Config`.

    Mirrors ``config_reader`` (utility.py:53-81):
    * dataset preset selected by ``args['dataset']``,
    * ``--augment`` toggles both augmentations on/off (utility.py:64-69),
    * any CLI arg whose key matches a train-config field overrides it
      (utility.py:74-76).

    ``config_dir``, when given, points at a directory holding optional
    ``hyp_data_<DS>.yaml`` / ``hyp_augmentation.yaml`` / ``hyp_train.yaml``
    files that override the built-in presets before CLI overrides apply.
    """
    args = dict(args or {})
    run = _dataclass_from(RunConfig, args)

    if config_dir is None:
        config_dir = run.config_dir
    if config_dir is None and os.path.isdir("configs"):
        config_dir = "configs"  # shipped presets next to the repo root
    if config_dir is not None:
        run = dataclasses.replace(run, config_dir=config_dir)

    data_d: Dict[str, Any] = dict(DATASET_PRESETS.get(run.dataset, {}))
    data_d["dataset"] = run.dataset
    aug_d: Dict[str, Any] = {}
    train_d: Dict[str, Any] = {}

    if config_dir:
        loaded_files = []
        for name, target in (
            (f"hyp_data_{run.dataset}.yaml", data_d),
            ("hyp_augmentation.yaml", aug_d),
            ("hyp_train.yaml", train_d),
        ):
            p = os.path.join(config_dir, name)
            if os.path.isfile(p):
                with open(p, "r") as f:
                    loaded = yaml.safe_load(f) or {}
                target.update(loaded)
                loaded_files.append(name)
        if loaded_files:
            _notice_config_dir(config_dir, loaded_files)

    data_d.update(data_overrides or {})
    aug_d.update(aug_overrides or {})
    train_d.update(train_overrides or {})

    # --augment master switch (utility.py:64-69)
    aug_d["rotation_augment"] = bool(run.augment)
    aug_d["spec_augment"] = bool(run.augment)

    # CLI overrides of train-config keys (utility.py:74-76)
    train_fields = {f.name for f in dataclasses.fields(TrainConfig)}
    for k, v in args.items():
        if v is not None and k in train_fields:
            train_d[k] = v

    mesh_d = dict(args.get("mesh", {}) if isinstance(args.get("mesh"), dict)
                  else {})
    if args.get("model_parallel") is not None:
        mesh_d["model_parallel"] = int(args["model_parallel"])
    return Config(
        args=run,
        data=_dataclass_from(DataConfig, data_d),
        aug=_dataclass_from(AugConfig, aug_d),
        train=_dataclass_from(TrainConfig, train_d),
        mesh=_dataclass_from(MeshConfig, mesh_d),
    )


def with_conf_thresh(cfg: Config, thresh: float) -> Config:
    """Return a config with an updated (arbitrated) confidence threshold
    (reference: ``train.py:198-200`` updates both conf and clss thresh)."""
    new_train = replace(cfg.train, conf_thresh=float(thresh), clss_thresh=float(thresh))
    return replace(cfg, train=new_train)
