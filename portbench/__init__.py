"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on a CUDA card
and prints one JSON line.  Everything a cell needs is found by name:
its configuration in ``configs/``, its traffic in ``traffic/``, the
driver that traffic names in ``drivers/``, its correctness limits in
``limits/`` and each per-layer metric's reader in ``metrics/``.  The
yardstick (operation and byte counts, peaks, the plain reference) lives
in ``counts/`` and ``reference/``.  See ``README.md``.
"""
