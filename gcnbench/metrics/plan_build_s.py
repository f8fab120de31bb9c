"""Seconds the program takes to build its plans of the graph (degree sort,
Algorithms 1-2, slab packing, the copy to the device): host clock around
``GraphOp.build`` (both directions) or ``register_graph``, ending in a
synchronise."""


def read(rec):
    return rec.get("plan_build_s")
