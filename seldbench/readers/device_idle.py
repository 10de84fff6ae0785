"""The share of the time in which no kernel runs on the device, percent:
one minus the busy time a call (the union of the kernel intervals of the
profiled calls, over their count) over the unprofiled wall time a call of
the window (a train step; for clips, the mean over the cycle's clips of
each clip's median latency).  The tracer slows the host, so the traced
calls' own wall time would overstate the idle share."""
from .common import profile_of


def read(ctx):
    prof, call_s = profile_of(ctx), ctx["window"].get("call_s")
    if prof is None or not call_s:
        return None
    return 100.0 * (1.0 - prof.busy_s() / prof.calls / call_s)
