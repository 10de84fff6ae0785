"""PyTorch + CUDA port of the AD-YOLO SELD serving path.

The JAX package :mod:`adyolo_tpu` stays the reference; this package mirrors
its module names (``ops/stft.py``, ``ops/features.py``, ``models/layers.py``
...) so each counterpart is easy to find.  Public functions keep the JAX
package's layouts: audio ``(B, T, hop, C)`` or ``(B, N, C)``, STFT output
``(B, T, K, C)``, features ``(B, T, F, C)``, model output ``(B, T/4, 2560)``.

Host-only helpers that never touch JAX are imported from :mod:`adyolo_tpu`
in place (``config``, ``ops.dsp``, ``ops.grid``, ``ops.nms_native``,
``data.{io,dataset,labels}``, ``metrics``).  Nothing here imports ``jax``
or ``flax``.

Hand-written Hopper kernels live in ``csrc/`` and are built on first use
into ``build/adyolo_tpu_torch/`` (see :mod:`adyolo_tpu_torch.utils.build`).
"""
