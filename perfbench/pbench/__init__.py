"""The port's benchmark: one cell of ``BENCHMARK.json`` run once.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file of its own under ``perfbench/``, found by the
name ``BENCHMARK.json`` gives it (``spec.py``). The harness (``harness.py``)
drives the program, ``repro_torch``; the reference (``reference/``), the
operation counts (``counts/``), the peaks (``peaks.py``) and the
comparison (``check.py``) are the benchmark's own and import nothing of
the program.
"""
