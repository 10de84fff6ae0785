"""``adyolo_tpu_torch.bench`` on the CPU, at a small size (B = 2, 2-s
clips, the conformer cut to 2 blocks, one timed call): no wall-clock
asserts, no pipes.

* Each config's metric string is the JAX bench's (``bench.py``'s
  ``METRIC_OF``), letter for letter; the default and ``--all`` lists are
  the JAX bench's judged lines with the bf16 serving line, and those plus
  its other BASELINE configs.
* Every config runs and gives one well-formed line: the JAX bench's keys
  (``vs_baseline`` on the two headline lines), a positive finite
  ``value`` and ``tflops_per_s``, ``device`` "cpu", and no ``mfu`` (the
  CPU has no peak).
* A config that raises: the lines measured before and after it are
  printed, then one ``bench-errors`` line naming it, and ``main``
  returns 1.  Without a card and without ``--device cpu`` the command
  exits with a message.
"""
import functools
import importlib.util
import json
import math
import os

import pytest
import torch

from adyolo_tpu_torch import bench
from adyolo_tpu_torch.models import resnet_conformer as port_rc
from adyolo_tpu_torch.models import wrapper as port_wrapper

from tests.test_torch_config import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = bench.Sizes(batch=2, train_batch=2, clip_s=2, iters=1, warmup=1,
                    train_warmup=1, train_steps=1, latency_calls=1)


def _jax_bench():
    """The repository's JAX ``bench.py``, loaded from its file."""
    spec = importlib.util.spec_from_file_location("jax_bench_module",
                                                  os.path.join(_REPO, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def shallow():
    mp = pytest.MonkeyPatch()
    mp.setitem(port_wrapper.ENCODERS, "resnet-conformer",
               functools.partial(port_rc.ResNetConformer, num_layers=2))
    yield
    mp.undo()


def test_metric_strings_are_the_jax_benchs():
    jb = _jax_bench()
    assert set(bench.METRIC_OF) == set(bench.ALL_CONFIGS)
    for name, metric in bench.METRIC_OF.items():
        assert metric == jb.METRIC_OF[name], name
    assert set(bench.DEFAULT_CONFIGS) == set(jb.GROUP_CONFIGS)
    assert set(bench.ALL_CONFIGS) == (set(jb.ALL_CONFIGS) - set(jb.AB_CONFIGS)) | {"headline-bf16"}


@pytest.mark.parametrize("name", bench.ALL_CONFIGS)
def test_config_prints_a_well_formed_line(name, shallow):
    lines = []
    assert bench.run([name], "cpu", SIZES, emit=lines.append) == []
    assert len(lines) == 1
    rec = json.loads(lines[0])
    keys = {"metric", "value", "unit", "tflops_per_s", "device"}
    if name.startswith("headline"):
        keys.add("vs_baseline")
        assert rec["vs_baseline"] == rec["value"] / bench.NORTH_STAR
    assert set(rec) == keys
    assert rec["metric"] == bench.METRIC_OF[name]
    assert rec["unit"] == ("ms" if name == "infer-latency" else "audio_s/s")
    for k in ("value", "tflops_per_s"):
        assert math.isfinite(rec[k]) and rec[k] > 0, (k, rec[k])
    assert rec["device"] == "cpu"


def test_failing_config_gives_bench_errors_and_exit_1(shallow, monkeypatch, capsys):
    def broken(self, name, encoder, compute_dtype):
        raise RuntimeError(f"{name} broke")

    monkeypatch.setattr(bench.Bench, "train_line", broken)
    rc = bench.main(["--config", "headline", "--config", "train-f32",
                     "--config", "scaler-pass", "--device", "cpu"], sizes=SIZES)
    assert rc == 1
    out = [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.strip()]
    assert [r["metric"] for r in out] == [bench.METRIC_OF["headline"],
                                          bench.METRIC_OF["scaler-pass"], "bench-errors"]
    errors = out[-1]
    assert errors["value"] == 1 and errors["unit"] == "failed_configs"
    assert errors["errors"] == [{"config": "train-f32",
                                 "error": "RuntimeError: train-f32 broke"}]


def test_cuda_default_without_a_card_exits(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        bench.main(["--config", "headline"], sizes=SIZES)
    assert exc.value.code != 0
    assert "--device cpu" in capsys.readouterr().err
