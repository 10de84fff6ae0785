"""The hand-written attention kernels' bound over their device time in the
profiled calls, percent.  The bound of each attention call (a conformer
block's, forward and, in training, backward) is ``attn_bound`` of its
FLOPs and bytes over the valid queries and keys (``yardstick.flops``),
summed over the profiled calls; the time is every ``mhsa_*`` kernel's."""
from ..yardstick.flops import attn_bytes, attn_flop
from ..yardstick.peaks import attn_bound
from .common import profile_of


def _call_ms(heads, q, k, backward):
    ms = attn_bound(attn_flop(heads, q, k, 4),
                    attn_bytes(heads, q, k, q_rows=2, kv_reads=2, stats=int(backward)))["bound_ms"]
    if backward:
        ms += attn_bound(attn_flop(heads, q, k, 10),
                         attn_bytes(heads, q, k, q_rows=4, kv_reads=2, kv_writes=2,
                                    stats=1))["bound_ms"]
    return ms


def read(ctx):
    prof, att = profile_of(ctx), ctx["window"].get("attention")
    if prof is None or att is None:
        return None
    ms = prof.kernel_us("mhsa_") / 1e3
    if att["steps"] == 1:  # a train step: every clip of the batch in one call
        bound = prof.calls * att["calls"] * _call_ms(att["heads"], att["q"], att["k"],
                                                     att["backward"])
    else:  # one clip a call, the profiled calls one cycle of the mix
        bound = prof.calls / att["steps"] * sum(
            att["calls"] * _call_ms(att["heads"], [q], [k], att["backward"])
            for q, k in zip(att["q"], att["k"]))
    return 100.0 * bound / ms if ms > 0 else None
