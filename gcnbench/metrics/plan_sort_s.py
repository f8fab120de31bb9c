"""Seconds of the plan build spent in the graph's check and degree sort
(``core/graph.py::degree_sort_csr``, span ``plan.sort``), both plans: the
program's span, host clock, in the pass of ``gcnbench/program_trace.py``."""
from gcnbench.program_trace import plan_stage_s


def read(rec):
    return plan_stage_s(rec, "plan.sort")
