"""Roofline terms against a card's peaks and the op-by-op counts of one call
(:mod:`repro_torch.analysis.roofline`, :mod:`repro_torch.analysis.counters`)."""
from .counters import Counts, CountingMode, count_call  # noqa: F401
from .roofline import (HARDWARE, collective_bytes, hw_for,  # noqa: F401
                       roofline_terms)
