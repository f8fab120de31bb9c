"""The benchmark of ``repro_torch``: one command runs one cell once.

    python3 gcnbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Cells, metrics and bounds are listed in ``BENCHMARK.json`` at the root of
the checkout. Each configuration (``configs/<name>.json``), traffic mix
(``traffic/<name>.json``), per-layer metric (``metrics/<name>.py``) and
cell's comparison limits (``limits/<cell>.json``) lives in a file of its
own that the harness finds by name. Nothing here imports ``jax`` or the
JAX package; ``reference/`` imports nothing of ``repro_torch`` either.
"""
