"""The port's lock-order witness (``repro_torch.statics.witness``).

* The reference's toy cases (``tests/test_statics.py``) against the port's
  witness: a toy cycle, a consistent order, RLock re-entry,
  ``Condition.wait`` releasing its lock, and ``install`` wrapping only the
  locks that ``repro_torch.*`` callers create.
* Node identity: 1,000 rounds of a fresh pair of locks taken in
  alternating order and dropped report no cycle (an ``id()``-named node
  can inherit a collected lock's edges; the port names nodes by a
  counter).
* ``install()`` refuses while another patch of threading's factories is
  active (the reference's witness), and ``uninstall()`` restores the
  interpreter's own factories.
* Phase 17 of ``chip_smoke.py`` at a small size on the CPU: the
  witnessed child and the two ``run_fleet`` workers report no cycle, and
  the child wrapped locks in every lock-creating module of the served
  path.
"""
import _thread
import os
import sys
import threading

import pytest

from repro.statics import witness as ref_witness
from repro_torch.statics import witness as witness_mod
from repro_torch.statics.witness import InstrumentedLock, LockWitness

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_threads(*fns):
    threads = [threading.Thread(target=fn) for fn in fns]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()


@pytest.fixture
def genuine_factories():
    """The test runs with threading's own factories and leaves them so,
    whatever it installs."""
    before = (threading.Lock, threading.RLock, threading.Condition)
    assert witness_mod.factories_genuine()
    try:
        yield before
    finally:
        witness_mod.uninstall()
        ref_witness.uninstall()
        threading.Lock, threading.RLock, threading.Condition = before
    assert witness_mod.factories_genuine()


# ------------------------------------------------------------ toy cases
def test_witness_detects_toy_cycle():
    w = LockWitness()
    a = InstrumentedLock(_thread.allocate_lock(), w, "A")
    b = InstrumentedLock(_thread.allocate_lock(), w, "B")

    def ab():
        with a:
            with b:
                pass

    def ba():
        with b:
            with a:
                pass

    # sequentially on two threads: A->B then B->A, a cycle in the order
    # graph although no run deadlocks
    _run_threads(ab)
    _run_threads(ba)
    assert w.cycles == [("B", "A", "B")]
    with pytest.raises(AssertionError, match="acquisition-order cycle"):
        w.assert_no_cycles()


def test_witness_consistent_order_is_clean():
    w = LockWitness()
    a = InstrumentedLock(_thread.allocate_lock(), w, "A")
    b = InstrumentedLock(_thread.allocate_lock(), w, "B")

    def ab():
        with a:
            with b:
                pass

    _run_threads(ab, ab)
    _run_threads(ab)
    assert not w.cycles
    assert w.edges_recorded == 1 and w.acquisitions == 6
    w.assert_no_cycles()


def test_witness_rlock_reentry_not_a_cycle():
    w = LockWitness()
    r = InstrumentedLock(_thread.RLock(), w, "R")
    with r:
        with r:  # reentrant: must not self-edge
            pass
    assert not w.cycles and w.edges_recorded == 0


def test_witness_condition_wait_releases_lock():
    """cond.wait() built on an instrumented lock pops the held stack during
    the blocking window and pushes it back on waking, so the waiter's
    stack is balanced and no inversion is fabricated."""
    w = LockWitness()
    lk = InstrumentedLock(_thread.RLock(), w, "cond-lock")
    cond = threading.Condition(lk)
    ready = threading.Event()
    woke = []

    def waiter():
        with cond:
            ready.set()
            cond.wait(timeout=5)
            woke.append(w._stack() == [lk._node])
        woke.append(w._stack() == [])

    def notifier():
        assert ready.wait(5)
        with cond:
            cond.notify_all()

    _run_threads(waiter, notifier)
    assert woke == [True, True]
    assert not w.cycles


def _make_locks_as(module_name):
    """Locks created by code whose module is ``module_name``."""
    ns = {"__name__": module_name, "threading": threading}
    exec("lk = threading.Lock()\nrl = threading.RLock()\n"
         "cv = threading.Condition()\n", ns)
    return ns["lk"], ns["rl"], ns["cv"]


def test_install_wraps_only_repro_torch_callers(genuine_factories):
    w = witness_mod.install()
    try:
        assert witness_mod.current() is w
        assert witness_mod.install() is w          # idempotent
        lk, rl, cv = _make_locks_as("repro_torch.serve.probe")
        assert isinstance(lk, InstrumentedLock)
        assert isinstance(rl, InstrumentedLock)
        assert isinstance(cv._lock, InstrumentedLock)
        for name in ("repro.serve.probe", "tests.probe", "repro_torchx"):
            plain = _make_locks_as(name)
            assert not isinstance(plain[0], InstrumentedLock)
            assert not isinstance(plain[1], InstrumentedLock)
            assert not isinstance(plain[2]._lock, InstrumentedLock)
        assert w.locks_by_module == {"repro_torch.serve.probe": 3}
        with cv:
            cv.notify_all()
        assert w.acquisitions == 1
    finally:
        witness_mod.uninstall()
    assert witness_mod.current() is None
    assert not isinstance(_make_locks_as("repro_torch.serve.probe")[0],
                          InstrumentedLock)


# ------------------------------------------------------------ node identity
def test_fresh_pairs_in_alternating_order_report_no_cycle():
    """Each round's pair is new, so no order was ever inverted. Naming a
    node by ``id()`` lets a new pair reuse a collected pair's ids in
    swapped roles and inherit its edges; a counter cannot."""
    w = LockWitness()
    for i in range(1000):
        a = InstrumentedLock(_thread.allocate_lock(), w, "A")
        b = InstrumentedLock(_thread.allocate_lock(), w, "B")
        first, second = (a, b) if i % 2 == 0 else (b, a)
        with first:
            with second:
                pass
        del a, b, first, second
    assert w.cycles == []
    assert w.edges_recorded == 1000 and w.acquisitions == 2000
    with w._meta_lock:
        w._purge_locked()
        assert sum(len(s) for s in w._edges.values()) == 0


def test_collected_lock_never_lends_its_node():
    w = LockWitness()
    nodes = set()
    for _ in range(200):
        lk = InstrumentedLock(_thread.allocate_lock(), w, "L")
        assert lk._node not in nodes
        nodes.add(lk._node)
        del lk
    assert len(nodes) == 200


# ------------------------------------------------------------ factories
def test_install_refuses_over_the_reference_witness(genuine_factories):
    ref_witness.install(module_prefix="repro.")
    try:
        assert not witness_mod.factories_genuine()
        with pytest.raises(RuntimeError, match="already patched"):
            witness_mod.install()
        assert witness_mod.current() is None
    finally:
        ref_witness.uninstall()
    assert witness_mod.factories_genuine()


def test_install_refuses_over_any_patch(genuine_factories):
    threading.Lock = lambda: _thread.allocate_lock()
    try:
        with pytest.raises(RuntimeError, match="already patched"):
            witness_mod.install()
    finally:
        threading.Lock = genuine_factories[0]


def test_uninstall_restores_the_interpreters_factories(genuine_factories):
    witness_mod.install()
    assert threading.Lock is not genuine_factories[0]
    witness_mod.uninstall()
    assert (threading.Lock, threading.RLock, threading.Condition) == \
        genuine_factories
    assert threading.Lock in (_thread.allocate_lock, _thread.LockType)
    assert type(threading.Lock()) is _thread.LockType
    assert type(threading.RLock()) is _thread.RLock
    witness_mod.uninstall()                      # a second call is a no-op
    assert witness_mod.factories_genuine()


# ------------------------------------------------------------ phase 17
_SHRINK = """
import repro_torch.data.graphs as _graphs
_graphs.BENCHMARK_GRAPHS["Reddit"] = (3000, 30000, 1.0)
_graphs.BENCHMARK_GRAPHS["Arxiv"] = (2000, 12000, 1.0)
import chip_smoke as _cs
_cs.WITNESS_F = 64
_cs.WITNESS_REQUESTS = 12
_cs.WITNESS_ZIPF_NODES = (600, 800, 1000)
_cs.WITNESS_ZIPF_REQUESTS = 24
_cs.MH_TIMEOUT_S = 120.0
"""
# off the card the wrappers run their plain versions and count nothing:
# count those calls, as a launch would be counted
_COUNT = """
from repro_torch.kernels import spmm_accel as _accel, spmm_hbm as _hbm
def _counted(wrapper, plain):
    def run(*a, **k):
        wrapper.launches += 1
        wrapper.launches_by_instance["bulk"] += 1
        return plain(*a, **k)
    return run
for _mod, _w, _p in ((_accel, "spmm_block_slabs", "spmm_block_slabs_plain"),
                     (_accel, "spmm_block_slabs_windowed",
                      "spmm_block_slabs_windowed_plain"),
                     (_hbm, "spmm_block_slabs_hbm",
                      "spmm_block_slabs_hbm_plain")):
    setattr(_mod, _p, _counted(getattr(_mod, _w), getattr(_mod, _p)))
"""

_PHASE = """
import json, sys, time
sys.path[:0] = [{src!r}, {root!r}]
{shrink}
import torch
import chip_smoke
t0 = time.perf_counter()
launches, recs = chip_smoke.phase_witness(
    torch, "CPU", device="cpu", prelude={prelude!r})
print(json.dumps({{"launches": launches, "recs": recs,
                  "seconds": time.perf_counter() - t0}}))
"""


def test_phase17_workload_on_cpu_has_no_cycle():
    import json
    import subprocess
    src = _PHASE.format(src=os.path.join(REPO, "src"), root=REPO,
                        shrink=_SHRINK, prelude=_SHRINK + _COUNT)
    out = subprocess.run([sys.executable, "-c", src], capture_output=True,
                         text=True, cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    child, workers = rec["recs"]["child"], rec["recs"]["workers"]
    assert len(workers) == 2
    for r in [child] + workers:
        assert r["witness"]["cycles"] == []
        assert r["witness"]["acquisitions"] > 0
    mods = child["witness"]["locks_by_module"]
    for m in ("serve.scheduler", "serve.graph_engine", "serve.fleet",
              "core.plan_cache", "tuning.tuner", "distributed.replication",
              "sampling.service"):
        assert mods.get(f"repro_torch.{m}", 0) >= 1, (m, mods)
    for r in workers:
        wmods = r["witness"]["locks_by_module"]
        for m in ("distributed.multihost", "distributed.directory"):
            assert wmods.get(f"repro_torch.{m}", 0) >= 1, (m, wmods)
    assert child["serve"]["shadows"] >= 1
    assert min(child["serve"]["mutated_reads"]) >= 1
    assert child["fleet"]["promotions"] >= 1
    assert sum(r["forwarded"] for r in workers) >= 1
    assert rec["launches"]["K1"] == child["launches"]["K1"] + sum(
        r["launches"]["K1"] for r in workers) > 0
