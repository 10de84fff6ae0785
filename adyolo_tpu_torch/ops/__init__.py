"""Operators of the port.  Importing the package registers the custom ops
``adyolo::stft`` and ``adyolo::mhsa_eval`` (:mod:`.library`), which the
wrappers :mod:`.hopper_stft` and :mod:`.hopper_attention` call."""
from . import library  # noqa: F401
