"""The benchmark of ``adyolo_tpu_torch`` (the PyTorch and CUDA port) on an
NVIDIA H100.

One command runs one cell once, from the root of a checkout::

    python3 -m seldbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything the harness runs is found by name in files of its own:
``cells/<cell>.json`` (configuration, traffic, driver, limits),
``configs/<config>.json`` (the model's sizes), ``traffic/<mix>.json``
(what the general generator of :mod:`seldbench.yardstick.traffic` draws),
``drivers/<driver>.py`` and, for each per-layer metric,
``metrics/<metric>.json`` naming a reader in ``readers/``.  The yardstick
(traffic, peaks, FLOP and byte counts, the profile's reduction) and the
plain reference that decides ``correct`` (``reference/``) live here, so
that a change to the program cannot move them.  :mod:`seldbench.program`
is the one module that imports the port.
"""
