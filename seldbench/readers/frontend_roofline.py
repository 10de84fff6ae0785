"""The front-end stage's bound (its least FLOPs at the fp32 peak or its
bytes at the HBM bandwidth, whichever is larger:
``yardstick.flops.frontend_flops``, ``frontend_bytes``) over the device
time of one profiled call of the train step's feature stage at the cell's
batch, percent."""
from ..yardstick.peaks import bound
from .common import profile_of


def read(ctx):
    probe = ctx["window"].get("frontend")
    prof = profile_of(ctx, "frontend")
    if probe is None or prof is None:
        return None
    ms = sum(e - s for _, s, e in prof.kernels) / 1e3 / prof.calls
    return 100.0 * bound(probe["flops"], probe["bytes"])["bound_ms"] / ms if ms > 0 else None
