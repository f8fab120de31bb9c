"""AST-based project invariant analyzer + runtime lock-order witness for
the port (standard library only; imports no other ``repro_torch`` module,
so the witness can be installed before the rest of the package loads).

Static side (``analyze_paths``): lock-discipline, kernel-launch and
future-settlement rules over the tree; ``python -m repro_torch.statics``
is the CLI.  Runtime side (``witness``): an opt-in instrumented-lock
acquisition-order graph over ``repro_torch.*`` locks that reports a cycle
as a potential deadlock.
"""

from .analyzer import ALL_RULES, RULE_FAMILIES, analyze_paths, collect_py_files
from .findings import Finding, apply_suppressions, parse_suppressions
from .lock_rules import DEFAULT_GUARDED_ATTRS
from .witness import InstrumentedLock, LockWitness, install, uninstall

LAUNCH_RULES = RULE_FAMILIES["launch"]

__all__ = [
    "ALL_RULES",
    "RULE_FAMILIES",
    "LAUNCH_RULES",
    "analyze_paths",
    "collect_py_files",
    "Finding",
    "apply_suppressions",
    "parse_suppressions",
    "DEFAULT_GUARDED_ATTRS",
    "InstrumentedLock",
    "LockWitness",
    "install",
    "uninstall",
]
