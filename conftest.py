"""Give each pytest-xdist worker its share of the CPU.

Each worker runs torch's intra-op pool and the JAX reference in one
process; at their defaults every worker sizes its pool to all the cores,
so with several workers most threads wait for one another. pytest loads
this file in each worker before any test module imports torch, so the
value set here sizes the worker's pool, and the pools of the processes its
tests spawn, which inherit the environment. Only a worker acts: the
controller's value would reach the workers too. A value already set wins.
"""
import os

_workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
if _workers:
    os.environ.setdefault(
        "OMP_NUM_THREADS",
        str(max(1, len(os.sched_getaffinity(0)) // int(_workers))))
