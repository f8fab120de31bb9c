"""Opt-in runtime lock-order witness (lockdep-lite), the port's copy.

The static rules are lexical; they cannot see the ORDER in which two
locks are taken across threads.  This witness can: when installed it
wraps every ``threading.Lock`` / ``RLock`` / ``Condition`` created by
``repro_torch.*`` modules, records a global acquisition-order graph (edge
``A -> B`` whenever a thread acquires B while holding A), and flags a
cycle in that graph as a potential deadlock — even on runs that never
actually deadlock.  Install it before the first ``repro_torch`` import so
that module-level locks (``kernels/build.py``, ``kernels/spmm_accel.py``)
are wrapped too.

It differs from the reference package's witness in three ways:

* **Node identity.** A node is a number from a process-wide counter, never
  ``id(lock)``.  CPython hands a collected object's id to the next object
  of its size, and edges outlive their locks: with ids, a later pair of
  locks can inherit a collected pair's edges in swapped roles and report
  a cycle no code made.  A collected lock's edges are dropped (its node is
  queued by ``weakref.finalize`` and purged at the next acquisition); its
  node is never handed to another lock, and labels are never overwritten.
* **Real factories.** Locks are made from ``_thread.allocate_lock`` and
  ``_thread.RLock``, never from whatever ``threading.Lock`` is at import
  time, and ``install()`` refuses while threading's factories are patched
  by anyone else (the reference's witness, say): two witnesses would wrap
  each other's locks, and ``uninstall`` would restore the wrong factory.
* **Default prefix** ``"repro_torch."``.

Known approximation: nodes are lock *instances* labelled by creation
site.  Per-instance tracking avoids false cycles between two unrelated
instances of the same class, at the cost of missing A1/B1-vs-B2/A2
inversions across instance pairs.  A lock created through a helper
(``dataclasses.field(default_factory=threading.Lock)``, ``threading.Event``)
is attributed to the helper's module and not wrapped; ``locks_by_module``
shows which modules were.
"""

from __future__ import annotations

import _thread
import itertools
import sys
import threading
import weakref
from collections import Counter

_REAL_LOCK = _thread.allocate_lock
_REAL_RLOCK = _thread.RLock
_NODES = itertools.count(1)     # process-wide: one node per lock, ever


class LockWitness:
    """Acquisition-order graph + per-thread held-lock stacks.

    Every acquisition takes the meta-lock once; ``acquisitions``,
    ``edges_recorded`` and ``locks_by_module`` count what was seen.
    """

    def __init__(self):
        self._meta_lock = _REAL_LOCK()
        self._edges: dict[int, set[int]] = {}
        self._preds: dict[int, set[int]] = {}
        self._labels: dict[int, str] = {}
        self._dead: list[int] = []      # collected locks' nodes, to purge
        self._tls = threading.local()
        self.cycles: list[tuple[str, ...]] = []
        self.locks_by_module: Counter[str] = Counter()
        self.acquisitions = 0
        self.edges_recorded = 0

    # -- bookkeeping -------------------------------------------------------

    def _stack(self) -> list[int]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = []
            self._tls.stack = st
        return st

    def register(self, lock: object, label: str) -> int:
        """A fresh node for ``lock``, labelled ``module:line``."""
        node = next(_NODES)
        with self._meta_lock:
            self._labels[node] = label
            self.locks_by_module[label.split(":", 1)[0]] += 1
        # list.append needs no lock, so a collection that runs while this
        # thread holds the meta-lock cannot deadlock on it
        weakref.finalize(lock, self._dead.append, node)
        return node

    def label(self, node: int) -> str:
        return self._labels.get(node, f"#{node}")

    def _purge_locked(self) -> None:
        while self._dead:
            node = self._dead.pop()
            for succ in self._edges.pop(node, ()):
                self._preds.get(succ, set()).discard(node)
            for pred in self._preds.pop(node, ()):
                self._edges.get(pred, set()).discard(node)

    # -- events ------------------------------------------------------------

    def before_acquire(self, node: int) -> None:
        st = self._stack()
        with self._meta_lock:
            self.acquisitions += 1
            if self._dead:
                self._purge_locked()
            if node in st:
                return  # reentrant re-acquire: no new ordering information
            for h in dict.fromkeys(st):
                succ = self._edges.setdefault(h, set())
                if node in succ:
                    continue
                path = self._find_path(node, h)
                if path is not None:
                    self.cycles.append(tuple(self.label(n) for n in [h, *path]))
                succ.add(node)
                self._preds.setdefault(node, set()).add(h)
                self.edges_recorded += 1

    def after_acquire(self, node: int) -> None:
        self._stack().append(node)

    def on_release(self, node: int) -> None:
        st = self._stack()
        for i in range(len(st) - 1, -1, -1):
            if st[i] == node:
                del st[i]
                return

    def _find_path(self, src: int, dst: int) -> list[int] | None:
        """DFS path src -> dst over the recorded edges (meta lock held)."""
        seen = {src}
        stack: list[tuple[int, list[int]]] = [(src, [src])]
        while stack:
            n, path = stack.pop()
            if n == dst:
                return path
            for m in self._edges.get(n, ()):
                if m not in seen:
                    seen.add(m)
                    stack.append((m, path + [m]))
        return None

    # -- reporting ---------------------------------------------------------

    def summary(self) -> dict:
        """What the witness saw, as plain data (JSON-ready)."""
        with self._meta_lock:
            return {"locks_by_module": dict(sorted(self.locks_by_module.items())),
                    "acquisitions": self.acquisitions,
                    "edges": self.edges_recorded,
                    "cycles": [list(c) for c in self.cycles]}

    def assert_no_cycles(self) -> None:
        if self.cycles:
            lines = "\n".join("  " + " -> ".join(c) for c in self.cycles)
            raise AssertionError(
                f"lock-order witness found {len(self.cycles)} acquisition-order "
                f"cycle(s) — potential deadlock:\n{lines}"
            )


class InstrumentedLock:
    """Wraps a real Lock/RLock, reporting events to a LockWitness.

    Also implements the private Condition protocol (``_release_save`` /
    ``_acquire_restore`` / ``_is_owned``) so ``threading.Condition`` built
    on an instrumented RLock keeps full reentrancy semantics, and
    ``cond.wait()`` correctly pops/pushes the held stack around the
    blocking window.
    """

    def __init__(self, inner, witness: LockWitness, label: str):
        self._inner = inner
        self._witness = witness
        self._node = witness.register(self, label)

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        self._witness.before_acquire(self._node)
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            self._witness.after_acquire(self._node)
        return ok

    def release(self) -> None:
        self._inner.release()
        self._witness.on_release(self._node)

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> bool:
        self.release()
        return False

    def locked(self) -> bool:
        fn = getattr(self._inner, "locked", None)
        return bool(fn()) if fn is not None else False

    # Condition protocol -----------------------------------------------------

    def _release_save(self):
        fn = getattr(self._inner, "_release_save", None)
        state = fn() if fn is not None else self._inner.release()
        self._witness.on_release(self._node)
        return state

    def _acquire_restore(self, state) -> None:
        self._witness.before_acquire(self._node)
        fn = getattr(self._inner, "_acquire_restore", None)
        if fn is not None:
            fn(state)
        else:
            self._inner.acquire()
        self._witness.after_acquire(self._node)

    def _is_owned(self) -> bool:
        fn = getattr(self._inner, "_is_owned", None)
        if fn is not None:
            return fn()
        return self._node in self._witness._stack()


_active: LockWitness | None = None
_saved: tuple | None = None     # threading's factories, restored by uninstall


def current() -> LockWitness | None:
    return _active


def factories_genuine() -> bool:
    """True while ``threading.Lock``, ``RLock`` and ``Condition`` are the
    interpreter's own (no witness of either package installed)."""
    return (threading.Lock in (_thread.allocate_lock, _thread.LockType)
            and getattr(threading.RLock, "__module__", None) == "threading"
            and getattr(threading.Condition, "__module__", None) == "threading")


def install(module_prefix: str = "repro_torch.") -> LockWitness:
    """Patch the threading lock factories for ``module_prefix`` callers.

    Locks created by other modules (threading internals, torch, pytest)
    pass through untouched; the caller module is read off the stack
    frame at construction time.  Raises RuntimeError when threading's
    factories are not the interpreter's own.
    """
    global _active, _saved
    if _active is not None:
        return _active
    if not factories_genuine():
        raise RuntimeError(
            "threading's lock factories are already patched (is the reference "
            "package's witness installed?); uninstall it first")
    witness = LockWitness()
    saved = (threading.Lock, threading.RLock, threading.Condition)
    real_condition = threading.Condition

    def _caller():
        f = sys._getframe(2)
        mod = f.f_globals.get("__name__", "")
        return mod, f.f_lineno

    def make_lock():
        mod, line = _caller()
        if not mod.startswith(module_prefix):
            return _REAL_LOCK()
        return InstrumentedLock(_REAL_LOCK(), witness, f"{mod}:{line}")

    def make_rlock():
        mod, line = _caller()
        if not mod.startswith(module_prefix):
            return _REAL_RLOCK()
        return InstrumentedLock(_REAL_RLOCK(), witness, f"{mod}:{line}")

    def make_condition(lock=None):
        mod, line = _caller()
        if lock is None and mod.startswith(module_prefix):
            lock = InstrumentedLock(_REAL_RLOCK(), witness, f"{mod}:{line} (cond)")
        if lock is None:
            return real_condition()
        return real_condition(lock)

    threading.Lock = make_lock
    threading.RLock = make_rlock
    threading.Condition = make_condition
    _saved = saved
    _active = witness
    return witness


def uninstall() -> None:
    """Restore the factories ``install`` replaced (a no-op when it did not
    run)."""
    global _active, _saved
    if _saved is not None:
        threading.Lock, threading.RLock, threading.Condition = _saved
    _saved = None
    _active = None
