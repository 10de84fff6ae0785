"""The program's own spans in a ``torch.profiler`` capture.

The program (the port) names the layers it runs with ``record_function``
ranges, ``adyolo.<span>``, while a capture records.  :func:`capture` traces ``n`` calls of a function
with the host's ops and the device, as
:func:`~seldbench.yardstick.profile.profile_calls` does (one traced warm-up
call whose events are discarded, the calls under the harness's
``traced`` span, a profile held to the hand-written kernels the calls
launched, up to three attempts), and keeps besides what
:func:`~seldbench.yardstick.profile.profile_calls` drops: each program
span's host range and the device time of the kernels its ops launched
(``device_time_total``, which holds the kernels launched from the span's
own thread: autograd's backward thread is not the span's), and for each
kernel and memcpy the host time of the runtime call that launched it.  A
span named by the program and never entered reads as absent, never as 0.
This module imports nothing of the program: the caller passes the reader
of its kernel counters.  It is a stopgap: once
:func:`~seldbench.yardstick.profile.profile_calls` keeps the program's
spans, :func:`capture` and the gap search of :meth:`SpanProfile.named_gaps`
go.
"""
from __future__ import annotations

import dataclasses
import sys
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from . import profile

__all__ = ["PROGRAM_PREFIX", "SpanProfile", "capture", "reduce"]

PROGRAM_PREFIX = "adyolo."


@dataclasses.dataclass
class SpanProfile:
    profile: profile.Profile  # the capture's kernels, harness spans, op groups
    program: List[Tuple[str, float, float, float]]  # (span, start_us, end_us, device_us)
    # (launch_us, device start_us, device event, runtime call) of each linked device event
    launches: List[Tuple[float, float, str, str]]

    @property
    def calls(self) -> int:
        return self.profile.calls

    @property
    def whole(self) -> bool:
        return bool(self.profile.kernels) and self.profile.whole

    def _of(self, name: str):
        return [s for s in self.program if s[0] == name]

    def host_ms(self, name: str) -> Optional[float]:
        """Host ms a call in the span ``name`` (its ranges' lengths)."""
        hit = self._of(name)
        return sum(e - s for _, s, e, _ in hit) / 1e3 / self.calls if hit else None

    def device_ms(self, name: str, less: Optional[str] = None) -> Optional[float]:
        """Device ms a call of the kernels launched inside the span ``name``;
        with ``less``, without those of the ``less`` spans nested in it."""
        hit = self._of(name)
        if not hit:
            return None
        us = sum(d for *_, d in hit)
        if less is not None:
            us -= sum(d for _, s, e, d in self._of(less)
                      if any(a <= s and e <= b for _, a, b, _ in hit))
        return us / 1e3 / self.calls

    def named_gaps(self, k: int = 10) -> List[list]:
        """The ``k`` longest idle gaps of the traced window, seconds each,
        named ``<harness span>/<program span>``: the harness span as
        :meth:`Profile.idle_gaps` names it, then the program span the host
        spent most of the gap in, a stretch inside nested spans counting
        for the innermost; a gap that no program span covers keeps the
        harness span's name alone."""
        prof = self.profile
        gaps, prev = [], prof.start_us  # the gaps of Profile.idle_gaps, in its order
        for a, b in prof.busy_intervals() + [(prof.end_us, prof.end_us)]:
            if a > prev:
                gaps.append((prev, a))
            prev = max(prev, b)
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:k]
        program = [(n, s, e) for n, s, e, _ in self.program]
        out = []
        for (name, secs), (a, b) in zip(prof.idle_gaps(k), gaps):
            inner = _innermost(program, a, b)
            out.append([f"{name}/{inner}" if inner else name, secs])
        return out

    def clock_check(self) -> dict:
        """Each kernel or memcpy launched inside a program span against the
        span's start on the profiler's timeline: how many were checked, how
        many started before the span did, the least lead (device start less
        span start, us; None where nothing was checked), and the early ones
        by (span, device event, runtime call): their count and least lead;
        besides, over every linked device event, how many start before the
        runtime call that launched them and by how much at most (us)."""
        checked, early, lead, by = 0, 0, None, {}
        before = [start - launch for launch, start, _, _ in self.launches if start < launch]
        for launch, start, dev, call in self.launches:
            for name, s, e, _ in self.program:
                if s <= launch <= e:
                    checked += 1
                    lead = start - s if lead is None else min(lead, start - s)
                    if start < s:
                        early += 1
                        n, least = by.get((name, dev[:48], call), (0, 0.0))
                        by[(name, dev[:48], call)] = (n + 1, min(least, start - s))
        return {"checked": checked, "early": early, "least_lead_us": lead,
                "early_by": [[*k, *v] for k, v in sorted(by.items(), key=lambda kv: kv[1][1])],
                "before_launch": len(before), "most_before_launch_us": min(before, default=None)}


def _innermost(spans, a: float, b: float) -> Optional[str]:
    """The span most of ``[a, b]`` was spent in, each stretch counted for
    the shortest span that holds it."""
    cuts = sorted({a, b, *(t for _, s, e in spans for t in (s, e) if a < t < b)})
    spent: Dict[str, float] = {}
    for x, y in zip(cuts, cuts[1:]):
        hold = [(e - s, n) for n, s, e in spans if s <= x and y <= e]
        if hold:
            name = min(hold)[1]
            spent[name] = spent.get(name, 0.0) + y - x
    return max(spent, key=spent.get) if spent else None


def reduce(prof, calls: int, wall_s: float, expected: Dict[str, int]) -> SpanProfile:
    """A :class:`SpanProfile` of a finished ``torch.profiler`` capture."""
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    program, runtime, device = [], {}, []
    for e in prof.events():
        tr = e.time_range
        if e.device_type == cpu:
            if e.name.startswith(PROGRAM_PREFIX):
                program.append((e.name[len(PROGRAM_PREFIX):], float(tr.start), float(tr.end),
                                float(e.device_time_total)))
            elif e.name.startswith("cu"):  # a CUDA runtime or driver call: a launch
                runtime[e.id] = (float(tr.start), e.name)
        elif e.device_type == cuda and not getattr(e, "is_user_annotation", False):
            device.append((e.id, float(tr.start), e.name))
    # a device event and the runtime call that launched it share CUPTI's correlation id
    launches = [(runtime[i][0], s, n, runtime[i][1]) for i, s, n in device if i in runtime]
    return SpanProfile(profile._reduce(prof, calls, wall_s, expected),
                       sorted(program, key=lambda s: (s[1], -s[2])), launches)


def _change(before: Dict[str, int], after: Dict[str, int]) -> Dict[str, int]:
    return {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}


def capture(fn: Callable[[int], None], n: int, kernels: Callable[[], Dict[str, int]],
            attempts: int = 3) -> Optional[SpanProfile]:
    """A :class:`SpanProfile` of ``fn(0) .. fn(n - 1)`` on a CUDA device;
    ``fn(-1)`` is the traced warm-up call whose events are discarded.
    ``kernels()`` reads the program's launch counters of its hand-written
    kernels.  None where no attempt
    recorded a device event; one that is not whole after ``attempts``
    comes back with ``whole`` False."""
    from torch.profiler import ProfilerActivity, profile as torch_profile, schedule

    last = None
    for _ in range(attempts):
        torch.cuda.synchronize()
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                           schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            fn(-1)
            torch.cuda.synchronize()
            prof.step()
            k0 = kernels()
            t0 = time.perf_counter()
            with profile.span("traced"):
                for i in range(n):
                    fn(i)
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            k1 = kernels()
            prof.step()
        res = reduce(prof, n, wall, _change(k0, k1))
        if res.whole:
            return res
        last = res if res.profile.kernels else last
        why = "no device event" if not res.profile.kernels else \
            f"kernel counts {res.profile.seen} against the calls' {res.profile.expected}"
        print(f"seldbench: the program-span capture holds {why}; capturing again",
              file=sys.stderr)
    return last
