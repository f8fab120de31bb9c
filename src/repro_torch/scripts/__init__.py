"""The port's user scripts (``python -m repro_torch.scripts.<name>``), the
counterparts of the reference's ``scripts/*.py``: ``tune_partition``
(offline partition tuning of one graph), ``hillclimb`` (the roofline of
the LM's named flag bundles), ``coll_breakdown`` (collective bytes by
kind, dtype and source) and ``make_experiments_tables`` (the dry run's
tables). ``scripts/check_invariants.py``'s counterpart is
``python -m repro_torch.statics``."""
