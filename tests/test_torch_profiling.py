"""adyolo_tpu_torch/utils/profiling.py: the device time a call, read from
torch.profiler, or from CUDA events where the profiler records no device
event."""
import pytest
import torch

from adyolo_tpu_torch.utils import profiling
from adyolo_tpu_torch.utils.profiling import OTHER, PROFILE_GROUPS, group_ms, profile_calls


def _profiled(groups):
    ms = {g: 0.0 for g, _ in PROFILE_GROUPS}
    ms[OTHER] = 0.0
    ms.update(groups)
    return {"source": "profiler", "busy_ms_per_step": sum(ms.values()), "ms_per_step": ms}


def test_group_ms_sums_the_named_groups():
    p = _profiled({"attention fwd": 0.25, "attention bwd": 0.5, OTHER: 1.0})
    assert group_ms(p, "attention fwd") == 0.25
    assert group_ms(p, "attention fwd", "attention bwd") == 0.75


def test_group_ms_takes_the_event_time_without_groups():
    p = {"source": "cuda_events", "busy_ms_per_step": 0.125, "ms_per_step": None}
    assert group_ms(p, "attention fwd", "attention bwd") == 0.125


def test_profile_calls_retries_then_times_with_events(monkeypatch):
    tries, timed = [], []
    monkeypatch.setattr(profiling, "_profiled", lambda fn, n: tries.append(n))
    monkeypatch.setattr(profiling, "_event_timed", lambda fn, n: timed.append(n) or "events")
    assert profile_calls(lambda _: None, 7) == "events"
    assert tries == [7, 7, 7] and timed == [7]


def test_profile_calls_keeps_the_first_profile_with_device_time(monkeypatch):
    results = iter([None, "second"])
    monkeypatch.setattr(profiling, "_profiled", lambda fn, n: next(results))
    monkeypatch.setattr(profiling, "_event_timed", lambda fn, n: pytest.fail("events"))
    assert profile_calls(lambda _: None, 3) == "second"


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA device")
def test_profile_calls_on_cuda():
    x = torch.randn(1024, 1024, device="cuda")
    p = profile_calls(lambda _: x @ x, 5)
    assert p["source"] == "profiler" and p["busy_ms_per_step"] > 0
    assert p["ms_per_step"]["GEMM (cuBLAS)"] > 0
    e = profile_calls(lambda _: x @ x, 5, attempts=0)
    assert e["source"] == "cuda_events" and e["ms_per_step"] is None
    assert group_ms(e, "GEMM (cuBLAS)") == e["busy_ms_per_step"] > 0
