"""Structured experiment logging (the port's copy of
:mod:`adyolo_tpu.utils.logging`).

The reference optionally streams per-epoch channels to neptune.ai
(``src/train.py:264-279``, ``src/utils/utility.py:102-139``).  Here the
default sink is a local JSONL file (one ``{"channel": ..., "value": ...,
"step": ...}`` record per log call) — machine-readable, diffable, no
network — with the same channel naming so a neptune adapter can be
plugged in via the same interface.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional

__all__ = ["JsonlLogger", "NullLogger", "get_logging_meta_config", "make_logger"]

# reference main.py:20-32 fallback when no logging_meta_config.yaml exists
DEFAULT_LOGGING_META: Dict[str, Any] = {
    "exp_version": "Untitled",
    "location_tag": ["local-machine"],
    "neptune_project": None,
    "neptune_api_token": None,
}


def get_logging_meta_config(config_dir: Optional[str] = None) -> Dict[str, Any]:
    """Load ``<config_dir>/logging_meta_config.yaml`` (reference
    ``main.py:20-32``); missing file or keys fall back to defaults."""
    path = os.path.join(config_dir or "configs", "logging_meta_config.yaml")
    meta = dict(DEFAULT_LOGGING_META)
    if os.path.isfile(path):
        import yaml

        with open(path, "r") as f:
            meta.update(yaml.safe_load(f) or {})
    return meta


def make_logger(enabled: bool, meta: Optional[Dict[str, Any]],
                resume_id: Optional[str] = None):
    """Construct the neptune logger when ``--logger`` is set AND the meta
    config names a project/token (reference ``train.py:99-107`` — there a
    missing configuration raises; here the caller falls back to the local
    JSONL sink).  Returns a :class:`NeptuneLogger` or ``None``."""
    if not enabled or not meta:
        return None
    if meta.get("neptune_project") and meta.get("neptune_api_token"):
        from .neptune_adapter import NeptuneLogger

        return NeptuneLogger(meta["neptune_project"], meta["neptune_api_token"],
                             exp_version=meta.get("exp_version", "Untitled"),
                             tags=list(meta.get("location_tag") or []),
                             resume_id=resume_id)
    return None


class NullLogger:
    def log(self, channel: str, value: Any, step: Optional[int] = None) -> None:
        pass

    def log_params(self, params: Dict[str, Any]) -> None:
        pass

    def stop(self) -> None:
        pass


class JsonlLogger(NullLogger):
    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        self._f = open(path, "a", buffering=1)

    def log(self, channel: str, value: Any, step: Optional[int] = None) -> None:
        rec = {"t": time.time(), "channel": channel, "value": value}
        if step is not None:
            rec["step"] = step
        self._f.write(json.dumps(rec) + "\n")

    def log_params(self, params: Dict[str, Any]) -> None:
        self.log("parameters", {k: repr(v) for k, v in params.items()})

    def stop(self) -> None:
        self._f.close()
