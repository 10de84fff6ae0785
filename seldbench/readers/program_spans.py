"""The program's own spans in a traced run, for the reader ``span_ms``.

The harness reads the per-layer metrics after the check, which frees the
program, and its window's capture keeps the harness's spans alone.  The
first of these readers in a traced run on a card therefore builds the
program again from the run's seeded weights, drives it as the window did
(a train cell: its first ``check_steps`` steps, then ``trace_steps`` more;
the serve cell: one cycle of the mix to warm its buckets, then one more)
and captures those calls with the host's ops
(:func:`seldbench.yardstick.spans.capture`); the capture is kept on the
driver for the next reader, and its idle gaps named by the program's
spans and its clock check go to the run's notes.  A program that names
no span (``adyolo.*`` ranges) leaves a capture without them, and the
readers read nothing.  This rebuild goes once the window's own capture
keeps the program's spans."""
from __future__ import annotations

from typing import Optional

from .. import program
from ..yardstick import spans

__all__ = ["capture", "of"]


def _train(drv) -> Optional[spans.SpanProfile]:
    drv.free()
    drv.program_run()
    try:
        return spans.capture(drv._one, int(drv.cell["trace_steps"]), program.kernel_counters)
    finally:
        drv.free_program()


def _serve(drv) -> Optional[spans.SpanProfile]:
    drv.free()
    drv.build_program()
    try:
        drv.serve_cycle()
        drv.items = iter(drv.loader)
        return spans.capture(lambda i: drv._serve(), len(drv.clips), program.kernel_counters)
    finally:
        del drv.fwd, drv.pp, drv.loader, drv.items
        drv.reset()
        drv.free()


DRIVE = {"train_step": _train, "serve_clips": _serve}


def capture(ctx) -> Optional[spans.SpanProfile]:
    """The run's capture of the program's spans, made once; None where
    there is none or it holds no program span."""
    drv = ctx["driver"]
    if not hasattr(drv, "program_spans"):
        drv.program_spans = None
        drive = DRIVE.get(ctx["cell"]["driver"])
        if drive is not None and drv.device.type == "cuda":
            cap = drive(drv)
            if cap is not None and cap.program:
                drv.program_spans = cap
                drv.note(f"program spans: idle gaps {cap.named_gaps(10)}")
                drv.note(f"program spans: clock check {cap.clock_check()}")
                names = sorted({s[0] for s in cap.program})
                drv.note("program spans a call (host ms, device ms): " + ", ".join(
                    f"{n} {cap.host_ms(n)!r} {cap.device_ms(n)!r}" for n in names))
                drv.note(f"device ms a call of every HtoD memcpy in the capture: "
                         f"{cap.profile.kernel_us('Memcpy HtoD') / 1e3 / cap.calls!r}")
    return drv.program_spans


def of(ctx, whole: bool = True) -> Optional[spans.SpanProfile]:
    """The capture, or None where there is none or (``whole``) it does not
    hold the kernels its calls launched."""
    cap = capture(ctx)
    return cap if cap is not None and (cap.whole or not whole) else None
