"""The PyTorch port imports neither jax nor flax, nor anything of the JAX
package ``adyolo_tpu``, and neither does ``chip_smoke.py``.

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
for n in names + ["chip_smoke"]:
    importlib.import_module(n)
print(json.dumps({"modules": names,
                  "jax": sorted(m for m in sys.modules
                                if m.split(".")[0] in ("jax", "jaxlib", "flax",
                                                       "adyolo_tpu"))}))
"""

_SLICE = ("config", "ops.stft", "ops.hopper_stft", "ops.attention",
          "ops.hopper_attention", "ops.features", "ops.decode", "ops.dsp",
          "ops.grid", "ops.nms_native", "ops.angular", "data.io",
          "data.labels", "data.dataset", "models.layers", "models.seresnet34",
          "models.resnet_conformer", "models.heads", "models.losses",
          "models.wrapper", "parallel.train_step", "convert",
          "engine.checkpoint", "engine.evaluate", "utils.build",
          "utils.native", "cli", "metrics.seld", "metrics.hungarian",
          "ops.rotation", "ops.specaug", "engine.train", "utils.rng",
          "utils.logging", "utils.neptune_adapter", "ops.library",
          "engine.export", "parallel.mesh")


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=_REPO)
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=_REPO, env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["jax"] == [], f"the port or chip_smoke imported {res['jax']}"
    missing = [m for m in _SLICE if f"adyolo_tpu_torch.{m}" not in res["modules"]]
    assert not missing, missing
