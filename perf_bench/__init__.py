"""The benchmark of the PyTorch/CUDA port (``raft_tpu_torch``).

Run one cell of ``BENCHMARK.json`` with::

    python3 perf_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything a cell needs is found by name: its configuration in
``configs/<config>.json`` (which names the entry in ``entries/``), its
traffic mix in ``traffic/<traffic>.json``, and each per-layer metric's
reader in ``metrics/<metric>.py``.  ``reference/`` is the plain PyTorch
reference that decides ``correct``; it imports nothing of the port.
"""
