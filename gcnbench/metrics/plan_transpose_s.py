"""Seconds of the plan build spent in the transpose of A' for the backward
plan (``core/graph.py::csr_transpose``, span ``plan.transpose``): the
program's span, host clock, in the pass of ``gcnbench/program_trace.py``."""
from gcnbench.program_trace import plan_stage_s


def read(rec):
    return plan_stage_s(rec, "plan.transpose")
