"""Fleet execution on ``torch.distributed``.

Only :class:`~repro_torch.distributed.replication.EwmaRate` is here so far:
the partition autotuner's request-rate tracker. Placement, replication's
``ReplicaManager``, the placement directory, sharded SpMM and the
multi-host plane follow in later slices.
"""
from .replication import EwmaRate  # noqa: F401

__all__ = ["EwmaRate"]
