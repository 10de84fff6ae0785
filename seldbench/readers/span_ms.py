"""Ms a call (a train step or a clip) in one of the program's own spans,
from the capture of :mod:`seldbench.readers.program_spans`: ``clock``
``device``, the device time of the kernels and copies launched inside it
(``less``: without those of a span nested in it), from a capture that
holds every hand-written kernel its calls launched; ``host``, the span's
host time.  None where the program has no such span."""
from .program_spans import of


def read(ctx, span, clock, less=None):
    cap = of(ctx, whole=clock == "device")
    if cap is None:
        return None
    return cap.device_ms(span, less) if clock == "device" else cap.host_ms(span)
