"""The benchmark of ``repro_torch``, the PyTorch and CUDA port of NEO.

``python bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` on one NVIDIA GPU and prints one JSON
result line.  Everything a cell needs is found by name: its configuration in
``configs/<config>.json``, its traffic mix in ``traffic/<mix>.json``, each
metric's reader in ``metrics/<metric>.py`` and the plain reference of the
configuration's family in ``reference/<family>.py``.  The yardstick (traffic
generation, window arithmetic, peaks, work formulas, the reference and the
comparison that decides ``correct``) lives here and imports nothing of the
program; the program under test is ``repro_torch``.
"""
