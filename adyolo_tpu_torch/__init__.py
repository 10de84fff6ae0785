"""PyTorch + CUDA port of the AD-YOLO SELD framework.

The JAX package :mod:`adyolo_tpu` stays the reference; this package mirrors
its module names (``config.py``, ``ops/stft.py``, ``ops/features.py``,
``models/layers.py``, ``parallel/train_step.py`` ...) so each counterpart is
easy to find.  Public functions keep the JAX package's layouts: audio
``(B, T, hop, C)`` or ``(B, N, C)``, STFT output ``(B, T, K, C)``, features
``(B, T, F, C)``, model output ``(B, T/4, 2560)``.

The package is self-contained: it imports neither ``jax``/``flax`` nor
anything of :mod:`adyolo_tpu`.  The host helpers it shares with the JAX
package (``config``, ``ops.dsp``, ``ops.grid``, ``ops.nms_native``,
``ops.rotation``, ``data.{io,labels,dataset}``, ``metrics``,
``utils.logging``) are its own copies, so it still reads the
experiment dirs the JAX trainer writes and the repository's
``configs/*.yaml``.  Its entry points run on the CUDA device unless the
caller asks for the CPU.

Hand-written Hopper kernels live in ``csrc/`` and are built on first use
into ``build/adyolo_tpu_torch/`` (see :mod:`adyolo_tpu_torch.utils.build`).
"""
