"""Device ms a profiled call (a train step or a clip) in the ops of a
group of ``yardstick.profile.OPS``: ``conv`` (convolutions forward and
backward, whatever cuDNN runs for them) or ``optimizer`` (Adam's step),
from the profile that records the host's ops."""
from .common import profile_of


def read(ctx, group):
    prof = profile_of(ctx, "ops")
    if prof is None:
        return None
    return prof.op_us[group] / 1e3 / prof.calls
