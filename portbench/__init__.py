"""The benchmark of ``cmlpl_tpu_torch`` on NVIDIA GPUs.

One command runs one cell of ``BENCHMARK.json`` once and prints one JSON
line::

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Everything is found by name: a cell's configuration in
``configs/<config>.json``, its traffic in ``traffic/<traffic>.json``
(whose ``driver`` names the general generator in ``drivers/``), its
correctness limits in ``workloads/<cell>.json`` and each per-layer metric's
reader in ``metrics/<metric>.py``.  The yardstick lives here too: the
traffic generators (``scenes.py``), the operation and byte counts
(``counts.py``), the table of peaks (``peaks.json``), the comparison that
decides ``correct`` (``compare.py``) and the plain references
(``reference/``), which import nothing of the program.
"""
