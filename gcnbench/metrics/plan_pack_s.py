"""Seconds of the plan build spent in the slab packing
(``core/partition.py::pack_slabs``, span ``plan.pack``), both plans: the
program's span, host clock, in the pass of ``gcnbench/program_trace.py``."""
from gcnbench.program_trace import plan_stage_s


def read(rec):
    return plan_stage_s(rec, "plan.pack")
