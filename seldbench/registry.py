"""Finds what the harness runs by name: ``cells/<cell>.json``,
``configs/<config>.json`` (with its ``scaler_file``),
``traffic/<mix>.json``, ``metrics/<metric>.json``, the driver module
``drivers/<driver>.py`` and the reader module ``readers/<reader>.py``.
Adding a cell, a configuration, a mix or a per-layer metric is adding
files; nothing here changes."""
from __future__ import annotations

import importlib
import json
import os
import re

__all__ = ["HERE", "ROOT", "load", "cell", "config", "traffic", "metric", "driver", "reader",
           "benchmark"]

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def load(kind: str, name: str) -> dict:
    """``seldbench/<kind>/<name>.json``; a name is checked before it is
    made into a path."""
    if not _NAME.match(name):
        raise ValueError(f"not a name: {name!r}")
    path = os.path.join(HERE, kind, name + ".json")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    with open(path) as f:
        return json.load(f)


def cell(name: str) -> dict:
    return load("cells", name)


def config(name: str) -> dict:
    c = load("configs", name)
    if "scaler_file" in c:
        with open(os.path.join(ROOT, c["scaler_file"])) as f:
            c = {**c, "scaler": json.load(f)}
    return c


def traffic(name: str) -> dict:
    return load("traffic", name)


def metric(name: str) -> dict:
    return load("metrics", name)


def _module(kind: str, name: str):
    if not re.match(r"^[a-z_][a-z0-9_]*$", name):
        raise ValueError(f"not a module name: {name!r}")
    return importlib.import_module(f"seldbench.{kind}.{name}")


def driver(name: str):
    return _module("drivers", name)


def reader(name: str):
    return _module("readers", name)


def benchmark(path: str = None) -> dict:
    """``BENCHMARK.json`` at the root of the checkout."""
    with open(path or os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)
