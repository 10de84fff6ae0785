"""Each driver runs a short window on the CPU (the port's plain versions,
at a test's size) and prints the contract's last line; with the timed
path broken underneath, ``correct`` comes out false.  The harness's look
for a chip is skipped (``device="cpu"``)."""
from __future__ import annotations

import json

import pytest
import torch

from seldbench import harness, program
from seldbench.drivers.train_step import half_batch

KEYS = ("correct", "attempted", "failed", "metrics", "device")


def run(capsys, name, trace=0):
    rc = harness.main(["--workload", name, "--seed", str(2 ** 31 + 11), "--seconds", "1",
                       "--trace", str(trace)], device="cpu")
    out = capsys.readouterr()
    assert rc == 0, out.err[-2000:]
    res = json.loads(out.out.strip().splitlines()[-1])
    assert list(res)[:5] == list(KEYS) and list(res)[-1] == "checks"
    for n, c in res["checks"].items():
        assert f"check {n} = " in out.err
    return res


@pytest.mark.parametrize("name", ["train.se34.fp32.b16", "train.conformer.fp32.b16",
                                  "serve.conformer.starss22"])
def test_a_short_window_prints_the_result_line(capsys, small_cell, name):
    small_cell(name)
    res = run(capsys, name)
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert "setup_s" in res["metrics"] and len(res["metrics"]) >= 2


def test_a_traced_run_on_the_cpu_reads_no_device_metric(capsys, small_cell):
    small_cell("train.se34.fp32.b16")
    res = run(capsys, "train.se34.fp32.b16", trace=1)
    assert "mfu.train" in res["metrics"]  # from the window's FLOPs and seconds
    assert not any(k.startswith(("conv_ms", "device_idle", "optimizer_ms"))
                   for k in res["metrics"])


def _wrap_step(monkeypatch, wrap):
    orig = program.train_step

    def patched(cfg, model, fe):
        step, features = orig(cfg, model, fe)
        new = wrap(step)
        new.optimizer = step.optimizer
        return new, features

    monkeypatch.setattr(program, "train_step", patched)


TRAIN = ["train.se34.fp32.b16", "train.conformer.fp32.b16"]


@pytest.mark.parametrize("name", TRAIN)
def test_a_step_that_leaves_the_state_unchanged_is_not_correct(capsys, small_cell, monkeypatch,
                                                               name):
    small_cell(name)

    def wrap(step):
        def frozen(batch, gen=None):
            saved = [p.detach().clone() for p in step.optimizer.param_groups[0]["params"]]
            loss = step(batch, gen)
            with torch.no_grad():
                for p, s in zip(step.optimizer.param_groups[0]["params"], saved):
                    p.copy_(s)
            return loss
        return frozen

    _wrap_step(monkeypatch, wrap)
    res = run(capsys, name)
    assert res["correct"] is False and res["checks"]["change_gap"]["value"] >= 0.99


@pytest.mark.parametrize("name", TRAIN)
def test_half_the_batch_left_out_is_not_correct(capsys, small_cell, monkeypatch, name):
    small_cell(name)
    _wrap_step(monkeypatch, lambda step: lambda batch, gen=None: step(half_batch(batch), gen))
    assert run(capsys, name)["correct"] is False


def _added(dets):
    dets[0] = dets.get(0, []) + [[0, 1.0, 0.0, 0.0]]


def _dropped(dets):
    if dets:
        t = min(dets)
        dets[t] = dets[t][1:]


def _moved(dets):
    if dets:
        c, x, y, z = dets[min(dets)][0]
        dets[min(dets)][0] = [c, y, x, z]


@pytest.mark.parametrize("fault", [_added, _dropped, _moved])
def test_an_answer_altered_where_it_is_produced_is_not_correct(capsys, small_cell, monkeypatch,
                                                               fault):
    """A detection added, dropped or moved in the port's decode."""
    small_cell("serve.conformer.starss22")
    orig = program.postprocessor

    def postprocessor(cfg, tau):
        pp = orig(cfg, tau)
        decode = pp.postprocess

        def postprocess(output, valid_label_frames=None):
            dets = decode(output, valid_label_frames)
            fault(dets)
            return dets

        pp.postprocess = postprocess
        return pp

    monkeypatch.setattr(program, "postprocessor", postprocessor)
    res = run(capsys, "serve.conformer.starss22")
    assert res["correct"] is False and res["checks"]["det_mismatch"]["value"] >= 1


def test_logits_altered_where_they_are_produced_are_not_correct(capsys, small_cell, monkeypatch):
    small_cell("serve.conformer.starss22")
    orig = program.eval_forward

    def eval_forward(model, fe):
        fwd = orig(model, fe)
        return lambda audio, valid: fwd(audio, valid) * 1.01

    monkeypatch.setattr(program, "eval_forward", eval_forward)
    res = run(capsys, "serve.conformer.starss22")
    assert res["correct"] is False and res["checks"]["logit_gap"]["value"] > 1e-3


def test_no_result_without_the_chips_a_cell_asks_for(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = harness.main(["--workload", "train.se34.fp32.b16", "--seed", "1", "--seconds", "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
