"""What the readers share: the traced profile, void where it is not whole."""
from __future__ import annotations

__all__ = ["profile_of"]


def profile_of(ctx, key=None):
    """The window's profile (or ``ctx["window"][key]["profile"]``), or None
    where there is none or it does not hold the kernels its calls launched."""
    prof = ctx["profile"] if key is None else ctx["window"].get(key)
    if isinstance(prof, dict):
        prof = prof.get("profile")
    return prof if prof is not None and prof.whole and prof.kernels else None
