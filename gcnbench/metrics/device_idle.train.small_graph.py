"""``device_idle.train`` in the cells of small graphs, where it moves
``train_step_ms.small_graph``: the same reading."""
from gcnbench import spec

read = spec.metric_reader("device_idle.train")
