"""Host ms a clip in the decode (``PostProcessor.postprocess``: the device
decode's copy, top-k and host NMS), timed after a device synchronise over
the traced clips."""


def read(ctx):
    return ctx["window"].get("decode_ms")
