"""Seconds of the plan build spent in Algorithms 1-2, the pattern table and
the block partition (``core/partition.py``, span ``plan.partition``), both
plans: the program's span, host clock, in the pass of
``gcnbench/program_trace.py``."""
from gcnbench.program_trace import plan_stage_s


def read(rec):
    return plan_stage_s(rec, "plan.partition")
