"""The program's spans as the benchmark reads them: each new reader on a
hand-built capture, and nothing where the capture is void or the program
has no spans; idle gaps named ``<harness span>/<program span>``; the
clock check; the reduction of a real (CPU) capture."""
from __future__ import annotations

import types

import pytest
import torch

from seldbench import registry
from seldbench.readers import program_spans
from seldbench.yardstick import spans
from seldbench.yardstick.profile import Profile

NEW = ["h2d_ms.train", "frontend_ms.train", "load_ms.serve", "h2d_ms.serve"]


def _profile(kernels, harness=(), whole=True, calls=2, start=0.0, end=100.0):
    seen = {"stft": 2 if whole else 1}
    return Profile(calls, 1.0, list(kernels), list(harness), {}, {"stft": 2}, seen, start, end)


def _capture(whole=True):
    """Two calls: each a features span holding an h2d span, one more h2d
    span after it; device us in the fourth place."""
    program = []
    for t0 in (0.0, 50.0):
        program += [("train.step", t0, t0 + 40, 0.0), ("train.features", t0 + 1, t0 + 10, 9000.0),
                    ("train.h2d", t0 + 1, t0 + 3, 4000.0), ("train.h2d", t0 + 12, t0 + 13, 500.0),
                    ("eval.load", t0 + 20, t0 + 30, 0.0)]
    prof = _profile([("stft_frames", 5.0, 6.0), ("stft_frames", 55.0, 56.0)], whole=whole)
    return spans.SpanProfile(prof, sorted(program, key=lambda s: (s[1], -s[2])), [])


def _ctx(cap, device="cuda"):
    drv = types.SimpleNamespace(program_spans=cap, device=torch.device(device))
    return {"driver": drv, "cell": {"driver": "train_step"}, "window": {}, "profile": None}


def _read(name, ctx):
    spec = registry.metric(name)
    return registry.reader(spec["reader"]).read(ctx, **spec.get("params", {}))


def test_each_new_reader_on_a_hand_built_capture():
    ctx = _ctx(_capture())
    assert _read("h2d_ms.train", ctx) == pytest.approx(4.5)  # (4000 + 500) x 2 us over 2 calls
    assert _read("frontend_ms.train", ctx) == pytest.approx(5.0)  # 9000 less its own 4000
    assert _read("h2d_ms.serve", ctx) is None  # a span the calls never entered
    assert _read("load_ms.serve", ctx) == pytest.approx(0.01)  # 10 us a call


def test_the_device_readers_read_nothing_from_a_void_capture():
    ctx = _ctx(_capture(whole=False))
    assert _read("h2d_ms.train", ctx) is None
    assert _read("frontend_ms.train", ctx) is None
    # host clocks do not rest on the device events the tracer lost
    assert _read("load_ms.serve", ctx) == pytest.approx(0.01)


@pytest.mark.parametrize("name", NEW)
def test_every_new_metric_reads_nothing_without_the_programs_spans(name, monkeypatch):
    # as on a parent commit whose program names no span: the capture holds none
    bare = spans.SpanProfile(_capture().profile, [], [])
    monkeypatch.setitem(program_spans.DRIVE, "train_step", lambda drv: bare)
    notes = []
    drv = types.SimpleNamespace(device=torch.device("cuda"), note=notes.append)
    ctx = {"driver": drv, "cell": {"driver": "train_step"}, "window": {}, "profile": None}
    assert _read(name, ctx) is None
    assert drv.program_spans is None and notes == []
    assert _read(name, _ctx(None)) is None  # no capture on the CPU


def test_idle_gaps_are_named_by_the_harness_and_the_program_span():
    kernels = [("k", 0.0, 10.0), ("k", 40.0, 50.0), ("k", 60.0, 70.0), ("k", 95.0, 100.0)]
    harness = [("traced", 0.0, 100.0), ("load", 10.0, 40.0), ("train_step", 50.0, 100.0)]
    program = [("eval.load", 10.0, 39.0, 0.0), ("eval.pad", 12.0, 38.0, 0.0),
               ("train.step", 50.0, 99.0, 0.0), ("train.optimizer", 72.0, 94.0, 0.0)]
    cap = spans.SpanProfile(_profile(kernels, harness), program, [])
    gaps = cap.named_gaps(10)
    assert gaps == [["load/eval.pad", 30e-6], ["train_step/train.optimizer", 25e-6],
                    ["train_step/train.step", 10e-6]]
    # the harness's own naming is what a gap no program span covers keeps
    bare = spans.SpanProfile(_profile(kernels, harness), [], [])
    assert [n for n, _ in bare.named_gaps(10)] == [n for n, _ in bare.profile.idle_gaps(10)] \
        == ["load", "train_step", "train_step"]


def test_the_clock_check_counts_what_starts_before_its_span():
    program = [("train.step", 10.0, 50.0, 0.0), ("train.h2d", 12.0, 14.0, 0.0)]
    launches = [(13.0, 20.0, "k", "cudaLaunchKernel"), (30.0, 31.0, "k", "cudaLaunchKernel"),
                (60.0, 5.0, "k", "cudaLaunchKernel"), (11.0, 9.5, "m", "cudaMemcpyAsync")]
    cap = spans.SpanProfile(_profile([]), program, launches)
    # (13, 20) lies in both spans, (60, 5) in none, (11, 9.5) started before its span
    assert cap.clock_check() == {"checked": 4, "early": 1, "least_lead_us": -0.5,
                                 "early_by": [["train.step", "m", "cudaMemcpyAsync", 1, -0.5]],
                                 "before_launch": 2, "most_before_launch_us": -55.0}


def test_reduce_keeps_the_program_spans_of_a_cpu_capture():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("adyolo.eval.load"):
            with torch.profiler.record_function("adyolo.eval.pad"):
                torch.zeros(64).add_(1)
        with torch.profiler.record_function("seldbench.decode"):
            torch.ones(4).sum()
    cap = spans.reduce(prof, 1, 0.01, {})
    assert [s[0] for s in cap.program] == ["eval.load", "eval.pad"]
    outer, inner = cap.program
    assert outer[1] <= inner[1] and inner[2] <= outer[2] and outer[3] == 0.0
    assert [s[0] for s in cap.profile.spans] == ["decode"]
    assert not cap.whole
    assert cap.host_ms("eval.load") > 0 and cap.device_ms("eval.pad") == 0.0
