"""The benchmark of ``repro_torch``, the PyTorch and CUDA port of the
decentralized kernel PCA system.

One run is one process: ``python3 kpcabench/run.py --workload <cell>
--seed <n> --seconds <s> --trace <0|1>``. Every cell, configuration,
traffic mix and per-layer metric is a file of its own under this folder,
found by the name ``BENCHMARK.json`` gives it: ``cells/<cell>.json``,
``configs/<config>.json``, ``traffic/<mix>.json``, ``metrics/<metric>.py``.
The yardstick lives here too: the data generator (``data.py``), the plain
reference and its control (``reference.py``), the comparisons that decide
``correct`` (``checks.py``), the peaks (``peaks.json``), each kernel's
operation and byte count (``work/``) and the kernel names of each op
(``kernels/``).

Nothing here imports ``jax``, ``jaxlib``, ``flax`` or the JAX package
``repro``; only the runners import the port, and the reference imports
nothing of it.
"""
