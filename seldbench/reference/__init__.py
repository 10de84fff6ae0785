"""The plain PyTorch reference that decides ``correct``: the DCASE2022 FOA
front-end, SE-ResNet34 + BiGRU, ResNet-Conformer, the AD-YOLO head, loss
and decode, and Adam, written from the published description (sadPororo/
AD-YOLO, arXiv:2303.15703) and the configuration files under
``seldbench/configs``.  It imports nothing of ``adyolo_tpu_torch``, of
``adyolo_tpu`` or of ``jax``; float32 products run with TF32 off unless a
caller turns it on (the control, :mod:`seldbench.checks`)."""
