"""The harness of the port's serving benchmark (``netkv_bench/run.py``).

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file of its own under ``configs/``, ``traffic/``,
``workloads/`` and ``metrics/``; these modules read them by name.  Only
``nkb.program`` imports the program (``repro_torch``); the reference under
``reference/`` imports nothing of it.
"""
