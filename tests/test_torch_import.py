"""The PyTorch port imports neither jax nor flax.

Checked in a subprocess: this test process has jax loaded already
(tests/conftest.py imports it).
"""
import json
import os
import subprocess
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, json, pkgutil, sys
import adyolo_tpu_torch
names = ["adyolo_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(adyolo_tpu_torch.__path__,
                                          "adyolo_tpu_torch.")]
for n in names:
    importlib.import_module(n)
print(json.dumps({"modules": names,
                  "jax": sorted(m for m in ("jax", "jaxlib", "flax")
                                if m in sys.modules)}))
"""

_SLICE = ("ops.stft", "ops.hopper_stft", "ops.attention",
          "ops.hopper_attention", "ops.features", "ops.decode",
          "models.layers", "models.seresnet34", "models.resnet_conformer",
          "models.heads",
          "models.wrapper", "convert", "engine.checkpoint",
          "engine.evaluate", "utils.build", "cli")


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=_REPO)
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=_REPO, env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["jax"] == [], f"the port imported {res['jax']}"
    missing = [m for m in _SLICE if f"adyolo_tpu_torch.{m}" not in res["modules"]]
    assert not missing, missing
