"""``unpermute_ms.train`` in the cells of small graphs, where it moves
``train_step_ms.small_graph``: the same reading."""
from gcnbench import spec

read = spec.metric_reader("unpermute_ms.train")
