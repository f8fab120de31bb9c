"""Seconds of the plan build spent in the content hash of each plan's graph
(``core/plan_cache.py::graph_content_hash``, span ``plan.hash``), both
plans: the program's span, host clock, in the pass of
``gcnbench/program_trace.py``."""
from gcnbench.program_trace import plan_stage_s


def read(rec):
    return plan_stage_s(rec, "plan.hash")
