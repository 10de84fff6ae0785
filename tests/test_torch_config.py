"""The port's own ``Config`` and its device defaults.

* (config) ``adyolo_tpu_torch.config`` reads a ``hyp_exp.yaml`` that the
  JAX package's ``save_config`` wrote, and the repository's
  ``configs/*.yaml`` presets, to the same values as ``adyolo_tpu.config``;
  what the port writes, the JAX package reads back the same.
* (devices) ``build_model``, ``make_frontend`` and ``FeatureFrontend`` run
  on ``cuda`` unless the caller asks for the CPU.

:func:`port_config` is how the other port tests build the port's
``Config`` from the same YAML as the JAX one they hand to JAX functions,
:func:`one_torch_thread` the fixture with which the heavier ones run
PyTorch's CPU ops on one thread, and :func:`module_tmp` and
:func:`scratch_path` the temp directories of those that write checkpoints.
"""
import dataclasses
import inspect
import os
import shutil

import pytest
import torch

from adyolo_tpu import config as jax_config
from adyolo_tpu_torch import config as port_config_mod
from adyolo_tpu_torch.engine.evaluate import make_frontend
from adyolo_tpu_torch.models.wrapper import build_model
from adyolo_tpu_torch.ops.features import FeatureFrontend

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def port_config(jcfg):
    """The port's ``Config`` read from the YAML of the JAX ``jcfg``."""
    return port_config_mod.config_from_yaml(jax_config.config_to_yaml(jcfg))


@pytest.fixture(scope="module")
def one_torch_thread():
    """PyTorch's CPU ops on one thread for a test module (restored after).
    The suite runs in several worker processes on a few cores; a torch op
    that starts a thread per core in each of them waits on descheduled
    threads at every parallel region, and the models here are thousands of
    small ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def module_tmp(tmp_path_factory):
    """``tmp_path_factory.mktemp`` for a module's fixtures, each directory
    deleted when the module's tests end.  The port's tests write
    full-width checkpoints (about 2 GB in the heaviest module, 9 GB in a
    whole run), and pytest keeps the temp directories of its last three
    sessions: kept, a few runs fill the disk."""
    made = []

    def mktemp(name):
        made.append(tmp_path_factory.mktemp(name))
        return made[-1]
    yield mktemp
    for path in made:
        shutil.rmtree(path, ignore_errors=True)


@pytest.fixture
def scratch_path(tmp_path):
    """``tmp_path``, deleted when the test ends (see :func:`module_tmp`)."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def _as_dict(cfg):
    return dataclasses.asdict(cfg)


def test_port_config_reads_jax_written_yaml(tmp_path):
    jcfg = jax_config.Config()
    jcfg = dataclasses.replace(
        jcfg,
        args=dataclasses.replace(jcfg.args, encoder="resnet-conformer", exp_id="e1",
                                 logging_meta={"run": "x"}),
        train=dataclasses.replace(jcfg.train, lr=3e-4, grid_size=(30.0, 45.0),
                                  loss_gains=jax_config.LossGains(class_gain=2.0)),
        data=dataclasses.replace(jcfg.data, nb_classes=12))
    path = str(tmp_path / "hyp_exp.yaml")
    jax_config.save_config(jcfg, path)
    got = port_config_mod.load_config(path)
    assert isinstance(got, port_config_mod.Config)
    assert _as_dict(got) == _as_dict(jax_config.load_config(path))
    assert got.train.grid_size == (30.0, 45.0) and got.train.loss_gains.class_gain == 2.0
    # and the other way round
    back = str(tmp_path / "port.yaml")
    port_config_mod.save_config(got, back)
    assert _as_dict(jax_config.load_config(back)) == _as_dict(jcfg)


def test_port_config_reads_repository_presets():
    cdir = os.path.join(_REPO, "configs")
    args = {"dataset": "DCASE2022", "encoder": "resnet-conformer", "lr": 5e-4}
    want = jax_config.build_config(args, config_dir=cdir)
    got = port_config_mod.build_config(args, config_dir=cdir)
    assert _as_dict(got) == _as_dict(want)
    assert _as_dict(port_config(want)) == _as_dict(want)


def test_entry_points_default_to_cuda():
    from adyolo_tpu_torch.engine.export import export_cmd, load_exported

    for fn in (build_model, make_frontend, FeatureFrontend.__init__, load_exported,
               export_cmd):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    cfg = port_config_mod.Config()
    assert build_model(cfg, device="cpu").head.yolo_fc1.weight.device.type == "cpu"
    if not __import__("torch").cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            FeatureFrontend(cfg.data)  # no card: the default device fails
