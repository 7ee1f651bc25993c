"""The port's benchmark: ``python3 perfbench/run.py --workload <cell> ...``.

Everything that belongs to one configuration, traffic mix, kind of cell or
per-layer metric is a file of its own, found by the name that
``BENCHMARK.json`` gives it (``harness.spec``).
"""
