"""The benchmark of the PyTorch and CUDA port (``repro_torch``) on one NVIDIA H100.

``python perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once and prints one JSON line.  Everything a
cell needs is found by name: its configuration in ``configs/<config>.json``, its
traffic in ``traffic/<traffic>.json``, the driver of the traffic's ``kind`` in
``drivers/<kind>.py`` and each per-layer metric's reader in
``metrics/<metric>.py``.  Nothing here imports JAX or the JAX package.
"""
