"""Every file the harness finds by name parses, ``BENCHMARK.json`` agrees
with the cell files, a new cell or metric is files alone, and nothing the
benchmark runs imports JAX or the JAX package."""
from __future__ import annotations

import ast
import json
import os
import re
import shutil

import pytest

from seldbench import harness, registry

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
BENCH = registry.benchmark()


def _names(kind):
    return sorted(f[:-5] for f in os.listdir(os.path.join(registry.HERE, kind))
                  if f.endswith(".json"))


@pytest.mark.parametrize("kind", ["cells", "configs", "traffic", "metrics"])
def test_every_file_parses(kind):
    names = _names(kind)
    assert names
    for n in names:
        assert NAME.match(n), n
        assert isinstance(registry.load(kind, n), dict)


def test_benchmark_keys_and_cells_agree():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["seldbench"]
    for w in BENCH["workloads"]:
        cell = registry.cell(w["name"])
        for key in ("config", "traffic", "chips", "why"):
            assert cell[key] == w[key], (w["name"], key)
        registry.config(cell["config"])
        registry.traffic(cell["traffic"])
        assert hasattr(registry.driver(cell["driver"]), "Driver")
        assert set(cell["limits"])
    for c in BENCH["configs"]:
        assert os.path.isfile(os.path.join(registry.ROOT, c["file"]))
        assert registry.config(c["name"])["name"] == c["name"]


def test_every_cell_reports_setup_an_e2e_and_a_per_layer_metric():
    for w in BENCH["workloads"]:
        e2e, per_layer = harness.cell_metrics(BENCH, w["name"])
        names = {m["name"] for m in e2e}
        assert "setup_s" in names and len(names) >= 2, w["name"]
        assert per_layer, w["name"]
        for m in per_layer:
            assert m["moves"] in names
            spec = registry.metric(m["name"])
            assert callable(registry.reader(spec["reader"]).read)


def test_a_new_cell_and_metric_are_files_alone(tmp_path, monkeypatch):
    tree = tmp_path / "seldbench"
    shutil.copytree(registry.HERE, tree, ignore=shutil.ignore_patterns("__pycache__"))
    cell = dict(registry.cell("train.se34.fp32.b16"), name="train.se34.fp32.b8", batch=8)
    (tree / "cells" / "train.se34.fp32.b8.json").write_text(json.dumps(cell))
    (tree / "metrics" / "conv_ms.extra.json").write_text(
        json.dumps({"reader": "op_ms", "params": {"group": "conv"}}))
    (tree / "traffic" / "dense_chunks_b8.json").write_text(
        json.dumps(dict(registry.traffic("dense_chunks_b16"), batch=8)))
    monkeypatch.setattr(registry, "HERE", str(tree))
    assert registry.cell("train.se34.fp32.b8")["batch"] == 8
    assert registry.traffic("dense_chunks_b8")["batch"] == 8
    spec = registry.metric("conv_ms.extra")
    assert registry.reader(spec["reader"]).read.__module__ == "seldbench.readers.op_ms"
    bench = dict(BENCH, workloads=BENCH["workloads"] + [
        {"name": "train.se34.fp32.b8", "config": cell["config"], "traffic": "dense_chunks_b8",
         "chips": 1, "why": "a throwaway"}],
        per_layer=BENCH["per_layer"] + [
        {"name": "conv_ms.extra", "unit": "ms", "better": "lower", "source": "device_trace",
         "layer": "encoders", "moves": "train_audio_s", "workloads": ["train.se34.fp32.b8"]}])
    bench["end_to_end"] = [dict(m, workloads=m["workloads"] + ["train.se34.fp32.b8"])
                           if m["name"] == "train_audio_s" else m for m in bench["end_to_end"]]
    _, per_layer = harness.cell_metrics(bench, "train.se34.fp32.b8")
    assert [m["name"] for m in per_layer] == ["conv_ms.extra"]


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _modules():
    for root, _, files in os.walk(registry.HERE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


@pytest.mark.parametrize("banned", ["jax", "jaxlib", "flax", "adyolo_tpu"])
def test_no_module_imports_jax_or_the_jax_package(banned):
    for path in _modules():
        tops = {name.split(".")[0] for name in _imports(path)}
        assert banned not in tops, (path, banned)


def test_only_the_program_adapter_imports_the_port():
    for path in _modules():
        tops = {name.split(".")[0] for name in _imports(path)}
        rel = os.path.relpath(path, registry.HERE)
        if "adyolo_tpu_torch" in tops:
            assert rel == "program.py", rel


def test_the_reference_and_the_yardstick_take_nothing_of_the_program():
    for sub in ("reference", "yardstick"):
        for f in os.listdir(os.path.join(registry.HERE, sub)):
            if not f.endswith(".py"):
                continue
            path = os.path.join(registry.HERE, sub, f)
            assert "adyolo_tpu_torch" not in {n.split(".")[0] for n in _imports(path)}, f
            tree = ast.parse(open(path).read())
            rel = [n for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.level]
            assert not any(n.module == "program" or any(a.name == "program" for a in n.names)
                           for n in rel), f


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "adyolo_tpu_torch_probe", types.ModuleType("x"))
    assert harness.forbidden_modules() == [] or "adyolo_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "adyolo_tpu.ops", types.ModuleType("x"))
    assert "adyolo_tpu" in harness.forbidden_modules()
