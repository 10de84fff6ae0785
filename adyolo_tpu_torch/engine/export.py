"""Ahead-of-time serving export (counterpart of
:mod:`adyolo_tpu.engine.export`).

``export_model`` traces the fused audio -> head-output program (the
feature front-end with the scaler stats, the encoder and the head, weights
inside) with ``torch.export`` and saves it.  A serving process needs torch
and :mod:`adyolo_tpu_torch.ops.library` (the custom ops the graph calls),
not the model code or the config system::

    call, meta = load_exported("results/<exp>/export")   # on cuda
    out = call(audio)          # (B, N, 4) float32 -> head output

The artifact directory holds:

* ``model.pt2``: the ``torch.export`` program (weights, buffers and the
  front-end's constants inside, saved on the CPU);
* ``meta.json``: input and output shapes, the input layout, sample rate,
  loss format, the arbitrated confidence threshold, the serve dtype (the
  JAX package's keys; ``platforms`` is ``["cuda", "cpu"]``);
* ``hyp_exp.yaml``: the frozen experiment config, from which a decoder
  (:class:`~adyolo_tpu_torch.ops.decode.PostProcessor`) is rebuilt.

One artifact serves on both devices: the STFT and the attention are the
custom ops ``adyolo::stft`` and ``adyolo::mhsa_eval``, which run the
hand-written Hopper kernels on CUDA tensors and the plain versions on CPU
tensors (the JAX package disables its Pallas kernels at export for its
CPU platform instead).  Shapes are static: one artifact per (batch,
clip-length) pair.

``serve_dtype='bfloat16'`` traces the encoder computing in bfloat16 (the
eval compute dtype of :class:`~adyolo_tpu_torch.models.wrapper.SELDModel`;
attention on route ``k2_bf16``); the front-end, the encoders' tails and
the head stay float32, and so does the output.
"""
from __future__ import annotations

import functools
import json
import os
import shutil
import warnings
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn as nn
from torch.export.passes import move_to_device_pass
from torch.fx.node import map_arg

from ..config import Config
from ..models.wrapper import DTYPES, SELDModel
from ..ops import library  # noqa: F401  registers the ops an artifact calls
from ..ops.features import FeatureFrontend

__all__ = ["ServingProgram", "export_model", "load_exported", "export_cmd"]

_PLATFORMS = ["cuda", "cpu"]
_N_CH = 4  # FOA and the 4-mic array both carry 4 waveform channels


class ServingProgram(nn.Module):
    """``forward(audio) -> model(frontend(audio))``: the eval forward of
    :func:`~adyolo_tpu_torch.engine.evaluate.build_eval_forward` for
    whole clips (no ``valid_frames``), as one module."""

    def __init__(self, frontend: FeatureFrontend, model: SELDModel):
        super().__init__()
        self.frontend = frontend
        self.model = model

    def forward(self, audio: torch.Tensor) -> torch.Tensor:
        return self.model(self.frontend(audio))


def _trace(program: ServingProgram, example: torch.Tensor, serve_dtype: str):
    """``torch.export`` of ``program`` in eval mode with ``serve_dtype`` as
    the model's eval compute dtype; the parameters do not require grad
    during the trace (so every attention takes its eval op).  The model's
    dtype and the parameters' flags are restored."""
    model = program.model
    params = list(program.parameters())
    flags = [p.requires_grad for p in params]
    prev = model.serve_dtype
    program.eval()
    try:
        model.serve_dtype = DTYPES[serve_dtype]
        for p in params:
            p.requires_grad_(False)
        with warnings.catch_warnings():
            # nn.GRU refreshes its _flat_weights list when it sees the
            # trace's parameters; the graph takes them as parameters
            warnings.filterwarnings("ignore", message="The tensor attributes .*_flat_weights")
            return torch.export.export(program, (example,))
    finally:
        model.serve_dtype = prev
        for p, f in zip(params, flags):
            p.requires_grad_(f)


def _drop_identity_casts(ep) -> None:
    """Remove what the trace records of the model's dtype casts that change
    nothing: ``aten.to.dtype`` to the dtype its input has (the layers cast
    weights to their input's dtype, a no-op in float32) and the
    ``_assert_tensor_metadata`` checks beside the casts.  Each is a Python
    call a request (~800 in the conformer): at B=1, where the host bounds
    the latency, they would cost more than the model's own launches."""
    g = ep.graph_module.graph
    out = next(n for n in g.nodes if n.op == "output")
    for n in list(g.nodes):
        if n.op != "call_function":
            continue
        if n.target is torch.ops.aten._assert_tensor_metadata.default:
            g.erase_node(n)
        elif (n.target is torch.ops.aten.to.dtype and not n.kwargs and len(n.args) == 2
              and n.args[0].meta["val"].dtype == n.args[1] and out not in n.users):
            n.replace_all_uses_with(n.args[0])
            g.erase_node(n)
    ep.graph_module.recompile()


def export_model(cfg: Config, model: SELDModel, frontend: FeatureFrontend,
                 out_dir: str, batch_size: int = 1, seconds: Optional[float] = None,
                 conf_thresh: float = 0.5, frozen_cfg_path: Optional[str] = None,
                 serve_dtype: Optional[str] = None) -> str:
    """Trace and save the serving program of ``frontend`` + ``model`` (put
    in eval mode) for ``batch_size`` clips of ``seconds`` (default: the
    config's ``chunk_window_s``); returns ``out_dir``.  The trace runs on
    the front-end's device and launches no kernel.  ``serve_dtype``:
    'float32' or 'bfloat16', the encoder's compute dtype; None takes
    ``ADYOLO_SERVE_DTYPE``, else 'float32' (``adyolo_tpu/engine/
    export.py:58-59``)."""
    serve_dtype = serve_dtype or os.environ.get("ADYOLO_SERVE_DTYPE", "float32")
    if serve_dtype not in DTYPES:
        raise ValueError(f"serve_dtype {serve_dtype!r}: one of {sorted(DTYPES)}")
    secs = float(seconds if seconds is not None else cfg.data.chunk_window_s)
    n = int(round(secs * cfg.data.sr))
    # hop-block input (B, T, hop, C) when the geometry allows it: the
    # loaders' layout, a free host-side view of the flat clip
    hop = cfg.data.hop_length
    chunked = cfg.data.n_fft == 2 * hop and n % hop == 0
    shape = (batch_size, n // hop, hop, _N_CH) if chunked else (batch_size, n, _N_CH)
    example = torch.zeros(shape, dtype=torch.float32, device=frontend.device)
    ep = _trace(ServingProgram(frontend, model), example, serve_dtype)
    _drop_identity_casts(ep)
    ep.example_inputs = None  # the zeros it was traced on: not saved
    out_val = next(n for n in ep.graph.nodes if n.op == "output").args[0][0].meta["val"]

    os.makedirs(out_dir, exist_ok=True)
    # saved on the CPU, so a host without a card can load it
    torch.export.save(move_to_device_pass(ep, "cpu"), os.path.join(out_dir, "model.pt2"))
    meta = {
        "input_shape": [batch_size, n, _N_CH],
        "input_layout": "hop_blocks" if chunked else "flat",
        "hop_length": hop,
        "output_shape": list(out_val.shape),
        "output_dtype": str(out_val.dtype).removeprefix("torch."),
        "sr": cfg.data.sr,
        "seconds": secs,
        "audio_format": cfg.data.audio_format,
        "loss_format": cfg.args.loss,
        "nb_classes": cfg.data.nb_classes,
        "confidence_thresh": float(conf_thresh),
        "platforms": list(_PLATFORMS),
        "serve_dtype": serve_dtype,
    }
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump(meta, f, indent=1)
    if frozen_cfg_path and os.path.isfile(frozen_cfg_path):
        shutil.copy(frozen_cfg_path, os.path.join(out_dir, "hyp_exp.yaml"))
    return out_dir


def _flatten_gru_weights(module: torch.fx.GraphModule) -> None:
    """Put each ``aten.gru`` call's weights in one cuDNN buffer, as
    ``nn.GRU.flatten_parameters`` does for the live model: otherwise cuDNN
    packs them into a fresh buffer at every call (and warns at every call)."""
    from torch.backends.cudnn import rnn

    for n in module.graph.nodes:
        if n.op != "call_function" or n.target is not torch.ops.aten.gru.input:
            continue
        _, _, weights, has_biases, num_layers, _, _, bidirectional, batch_first = n.args
        params = [module.get_parameter(w.target) for w in weights]
        with torch.no_grad():
            torch._cudnn_rnn_flatten_weight(
                params, 4 if has_biases else 2, params[0].shape[1],
                rnn.get_cudnn_mode("GRU"), params[1].shape[1], 0, num_layers,
                batch_first, bidirectional)


def _fold_constants(module: torch.fx.GraphModule) -> None:
    """Evaluate once, at load, every ATen call whose inputs are all the
    program's own tensors (weights, buffers) or none (factories): the
    BatchNorm scale and shift from the running stats, and in a bf16 program
    the weights' casts to bfloat16.  The live model computes them at every
    call; the served program reads them.  The same ops on the same device
    give the same values."""
    g = module.graph
    const = {}
    for n in list(g.nodes):
        if n.op == "get_attr":
            const[n] = functools.reduce(getattr, n.target.split("."), module)
            continue
        if (n.op != "call_function" or not isinstance(n.target, torch._ops.OpOverload)
                or n.target.namespace != "aten"):
            continue
        inputs = []
        map_arg((n.args, n.kwargs), inputs.append)
        if not all(a in const for a in inputs):
            continue
        args, kwargs = map_arg((n.args, n.kwargs), const.__getitem__)
        with torch.no_grad():
            val = n.target(*args, **kwargs)
        if not isinstance(val, torch.Tensor):
            continue
        name = f"_folded_{len(const)}"  # const only grows: a new name
        module.register_buffer(name, val, persistent=False)
        with g.inserting_before(n):
            folded = g.get_attr(name)
        const[folded] = val
        n.replace_all_uses_with(folded)
        g.erase_node(n)
    g.eliminate_dead_code()
    module.recompile()


def load_exported(artifact_dir: str, device="cuda") -> Tuple[Callable, Dict[str, Any]]:
    """Load a serving artifact onto ``device``: returns ``(call, meta)``,
    ``call(audio)`` the head output (a tensor on ``device``) of float32
    audio ``(B, N, 4)`` (or already in ``meta['input_layout']``), run
    under ``torch.inference_mode``.  Flat audio is viewed in the traced
    hop-block layout, as the JAX package's loader does.  The program's
    weight-only arithmetic is folded once here (:func:`_fold_constants`)
    and, on CUDA, each GRU's weights packed for cuDNN.  A float32 artifact
    runs with TF32 off for cuDNN convolutions and CUDA matmuls,
    process-wide, as
    :func:`~adyolo_tpu_torch.engine.evaluate.build_eval_forward` does."""
    with open(os.path.join(artifact_dir, "meta.json")) as f:
        meta = json.load(f)
    ep = torch.export.load(os.path.join(artifact_dir, "model.pt2"))
    module = move_to_device_pass(ep, device).module()
    device = torch.device(device)
    _fold_constants(module)
    if device.type == "cuda" and torch.backends.cudnn.is_available():
        _flatten_gru_weights(module)
    if meta["serve_dtype"] == "float32":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    hop_blocks = meta["input_layout"] == "hop_blocks"

    @torch.inference_mode()
    def call(audio):
        audio = torch.as_tensor(audio, dtype=torch.float32, device=device)
        if hop_blocks and audio.ndim == 3:  # a view
            audio = audio.reshape(audio.shape[0], -1, meta["hop_length"], audio.shape[2])
        return module(audio)

    return call, meta


def export_cmd(cfg_args: Dict, results_dir: str = "results", device="cuda") -> str:
    """CLI handler: ``export --eval_pth <exp_id> [--serve_dtype bfloat16]``
    exports the experiment's best checkpoint (written by either package's
    trainer) to ``<results_dir>/<exp_id>/export``, traced on ``device``."""
    from ..config import load_config
    from .evaluate import load_best_model, make_frontend

    exp_id = cfg_args.get("eval_pth")
    if exp_id is None:
        raise SystemExit("error: --eval_pth <exp_id> is required for export")
    output_pth = os.path.join(results_dir, exp_id)
    frozen = os.path.join(output_pth, "hyp_exp.yaml")
    if not os.path.isfile(frozen):
        raise SystemExit(f"error: no experiment at {output_pth} (no hyp_exp.yaml)")
    cfg = load_config(frozen)
    frontend = make_frontend(cfg, device)
    model, host = load_best_model(cfg, output_pth, device)
    out_dir = export_model(cfg, model, frontend, os.path.join(output_pth, "export"),
                           conf_thresh=host.get("confidence_thresh", 0.5),
                           frozen_cfg_path=frozen,
                           serve_dtype=cfg_args.get("serve_dtype"))
    print(f"exported serving artifact -> {out_dir}")
    return out_dir
