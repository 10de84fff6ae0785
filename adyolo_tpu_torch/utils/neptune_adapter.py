"""Optional neptune.ai logging adapter (the port's copy of
:mod:`adyolo_tpu.utils.neptune_adapter`).

The reference streams per-epoch channels to neptune
(``src/utils/utility.py:102-139``); this adapter exposes the same
behavior behind the :class:`adyolo_tpu_torch.utils.logging.NullLogger`
interface.  neptune-client is not bundled in this image, so construction
degrades with a clear error unless the package is available.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

from .logging import NullLogger

__all__ = ["NeptuneLogger"]


class NeptuneLogger(NullLogger):
    def __init__(self, project: str, api_token: str,
                 exp_version: str = "Untitled",
                 tags: Optional[list] = None,
                 resume_id: Optional[str] = None):
        if project is None or api_token is None:
            raise AssertionError("You didn't set the neptune project/api configuration!")
        try:
            import neptune  # type: ignore
        except ImportError as e:
            raise RuntimeError(
                "neptune-client is not installed; use the default JSONL logger "
                "or install neptune to enable this adapter") from e
        if resume_id is not None:
            self._run = neptune.init_run(project=project, api_token=api_token,
                                         with_id=resume_id)
        else:
            self._run = neptune.init_run(project=project, api_token=api_token,
                                         name=exp_version, tags=tags or [])

    @property
    def sys_id(self) -> str:
        return str(self._run._sys_id)

    def log(self, channel: str, value: Any, step: Optional[int] = None) -> None:
        self._run[channel].log(value)

    def log_params(self, params: Dict[str, Any]) -> None:
        self._run["parameters"] = params

    def stop(self) -> None:
        self._run.stop()
