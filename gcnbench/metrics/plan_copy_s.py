"""Seconds of the plan build spent in the copy of the slabs, ``inv_perm``
and the COO arrays to the device, ending in a synchronise (span
``plan.copy``), both plans: the program's span, host clock, in the pass of
``gcnbench/program_trace.py``."""
from gcnbench.program_trace import plan_stage_s


def read(rec):
    return plan_stage_s(rec, "plan.copy")
