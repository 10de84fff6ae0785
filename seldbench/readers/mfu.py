"""The window's model FLOPs (the reference model's, counted at set-up at the
cell's shapes: every step, or every clip at its own length) over its
seconds, as a share of the dense bf16 peak (989.4 TFLOP/s) of each chip
the cell takes, percent."""
from ..yardstick.peaks import BF16_TC_FLOPS


def read(ctx):
    w = ctx["window"]
    peak = BF16_TC_FLOPS * ctx["driver"].chips
    return 100.0 * w["flops"] / w["seconds"] / peak if w["seconds"] > 0 else None
