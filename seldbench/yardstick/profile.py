"""The reduction of a ``torch.profiler`` capture to device times.

:func:`profile_calls` traces ``n`` calls of a function.  The logic that
holds a profile to the kernels its calls launched is copied from
``adyolo_tpu_torch/utils/profiling.py`` (``profile_calls``,
``summarize_events``, ``missing_kernels``) at commit 4ed7d29: one traced
warm-up call whose events are discarded, then the ``n`` calls; an attempt
whose kernel events of a hand-written kernel are not ``counters``' count
over the calls lost or gained events and is taken again, up to three
times, after which the profile is void (``whole`` False) and the readers
that need it read nothing.  What the program's counters say a call
launched is read by the caller (:mod:`seldbench.program`), so this module
imports nothing of the program.

A :class:`Profile` holds each device kernel's interval, the device time of
the ops of each ``OPS`` group with every kernel they and their children
launch (the convolutions, ``aten::convolution`` and
``aten::convolution_backward``, whatever algorithm cuDNN picks; Adam's
step), the
harness's own spans (``seldbench.*`` ``record_function`` labels), the busy
time (the union of the kernel intervals) and the host-clock length of the
traced calls.
"""
from __future__ import annotations

import dataclasses
import sys
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

__all__ = ["Profile", "profile_calls", "span", "OPS"]

# CPU ops whose device time (their kernels and their children's) a group sums
OPS = {"conv": ("aten::convolution", "aten::convolution_backward"),
       "optimizer": ("Optimizer.step#Adam.step",)}
SPAN_PREFIX = "seldbench."


def span(name: str):
    """A ``record_function`` span of the harness's own, named
    ``seldbench.<name>``; the idle gaps are labelled by it."""
    return torch.profiler.record_function(SPAN_PREFIX + name)


@dataclasses.dataclass
class Profile:
    calls: int
    wall_s: float  # host clock over the traced calls, synchronised at both ends
    kernels: List[Tuple[str, float, float]]  # (name, start_us, end_us)
    spans: List[Tuple[str, float, float]]  # the harness's spans
    op_us: Dict[str, float]  # device time of the ``OPS`` groups
    expected: Dict[str, int]
    seen: Dict[str, int]
    start_us: float = 0.0
    end_us: float = 0.0

    @property
    def whole(self) -> bool:
        return all(self.seen.get(k, 0) == v for k, v in self.expected.items())

    def kernel_us(self, *substrings: str) -> float:
        """Device time of the kernels whose name holds one of ``substrings``."""
        subs = tuple(s.lower() for s in substrings)
        return sum(e - s for n, s, e in self.kernels if any(x in n.lower() for x in subs))

    def busy_s(self) -> float:
        """The union of the kernel intervals, in seconds."""
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def busy_intervals(self) -> List[Tuple[float, float]]:
        merged: List[List[float]] = []
        for _, s, e in sorted(self.kernels, key=lambda k: k[1]):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(a, b) for a, b in merged]

    def top_kernels(self, k: int = 10) -> List[list]:
        """The ``k`` kernel names that took the most device time, seconds."""
        tot: Dict[str, float] = {}
        for n, s, e in self.kernels:
            tot[n] = tot.get(n, 0.0) + (e - s) / 1e6
        return [[n[:120], v] for n, v in sorted(tot.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10) -> List[list]:
        """The ``k`` longest idle gaps of the traced window, seconds each,
        named by the harness span the host spent most of the gap in (the
        innermost where spans nest), ``host`` where none covers it."""
        gaps, prev = [], self.start_us
        for a, b in self.busy_intervals() + [(self.end_us, self.end_us)]:
            if a > prev:
                gaps.append((prev, a))
            prev = max(prev, b)
        out = []
        for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:k]:
            cover = [(min(e, b) - max(s, a), -(e - s), n) for n, s, e in self.spans
                     if n != "traced" and min(e, b) > max(s, a)]
            out.append([max(cover)[2] if cover else "host", (b - a) / 1e6])
        return out


def _reduce(prof, calls, wall_s, expected) -> Profile:
    kernels, spans = [], []
    op_us = dict.fromkeys(OPS, 0.0)
    group = {name: g for g, names in OPS.items() for name in names}
    for e in prof.events():
        tr = e.time_range
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False):
                kernels.append((e.name, float(tr.start), float(tr.end)))
            elif e.name.startswith(SPAN_PREFIX):  # a span's range on the device
                spans.append((e.name[len(SPAN_PREFIX):], float(tr.start), float(tr.end)))
            continue
        if e.name.startswith(SPAN_PREFIX):
            spans.append((e.name[len(SPAN_PREFIX):], float(tr.start), float(tr.end)))
        elif e.name in group:
            op_us[group[e.name]] += float(e.device_time_total)
    seen = {k: sum(k in n for n, _, _ in kernels) for k in expected}
    whole_span = sorted(s for s in spans if s[0] == "traced")
    start = whole_span[0][1] if whole_span else min((s for _, s, _ in kernels), default=0.0)
    end = whole_span[0][2] if whole_span else max((e for _, _, e in kernels), default=0.0)
    return Profile(calls, wall_s, kernels, spans, op_us, dict(expected), seen, start, end)


def profile_calls(fn: Callable[[int], None], n: int, counters: Callable[[], Dict[str, int]],
                  attempts: int = 3, cpu: bool = False) -> Optional[Profile]:
    """A :class:`Profile` of ``fn(0) .. fn(n - 1)``; ``fn(-1)`` is the
    traced warm-up call whose events are discarded.  ``counters()`` reads
    the program's launch counters by kernel name; the calls' change of them
    is what the profile must hold.  None where the profiler recorded no
    device event in any attempt; a profile that is not whole after
    ``attempts`` comes back with ``whole`` False.  ``cpu``: record the host's
    ops too (their device time by ``OPS`` group); without it the tracer
    records the device alone, which slows the host less, so the busy and
    idle times are the program's."""
    from torch.profiler import ProfilerActivity, profile, schedule

    last = None
    for _ in range(attempts):
        torch.cuda.synchronize()
        acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
        with profile(activities=acts,
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            fn(-1)
            torch.cuda.synchronize()
            prof.step()
            before = counters()
            t0 = time.perf_counter()
            with span("traced"):
                for i in range(n):
                    fn(i)
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            after = counters()
            prof.step()
        expected = {k: after[k] - before.get(k, 0) for k in after if after[k] != before.get(k, 0)}
        res = _reduce(prof, n, wall, expected)
        if res.kernels and res.whole:
            return res
        last = res if res.kernels else last
        why = "no device event" if not res.kernels else \
            f"kernel counts {res.seen} against the calls' {res.expected}"
        print(f"seldbench: the profile holds {why}; profiling again", file=sys.stderr)
    return last
