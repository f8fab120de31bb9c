"""The port's partition autotuner on the CPU: every test of the reference's
``tests/test_tuning.py`` against ``repro_torch.tuning`` and the port's
engine, plus parity with the reference package.

* ``default_candidates`` and ``staircase_warp_nzs`` equal the reference's
  field for field for the tpu default, paper (12, 32), (64, 1) and (8, 4);
* both packages' ``PlanTuner``, driven by the same fake clock and the same
  sequence of ``observe``/``next_shadow``/``record_shadow``/
  ``candidate_failed`` calls, return the same labels and equal ``stats()``;
* ``EwmaRate`` reads the same rates;
* a promoted plan answers like the reference engine's promoted plan:
  exactly on an integer-valued graph.

Float answers of a promoted plan are held to ``1e-4`` (the reference
test's tolerance) against the port's own operator; integer-valued graphs
and features make every sum exact, so the packages must agree bit for bit.
"""
import dataclasses
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import plan_cache as ref_pc
from repro.core.graph import csr_from_edges as ref_csr_from_edges
from repro.core.graph import gcn_normalize as ref_normalize
from repro.distributed.replication import EwmaRate as RefEwma
from repro.serve.graph_engine import GraphServeEngine as RefEngine
from repro.tuning import PlanTuner as RefTuner
from repro.tuning import TuningCandidate as RefCandidate
from repro.tuning import default_candidates as ref_default_candidates
from repro.tuning import staircase_warp_nzs as ref_staircase
from repro_torch.core.graph import CSRGraph
from repro_torch.core.partition import validate_warp_nzs_override
from repro_torch.core.plan_cache import (PartitionConfig, PlanCache,
                                        build_partition_plan)
from repro_torch.core.spmm import make_accel_spmm
from repro_torch.distributed.replication import EwmaRate
from repro_torch.serve.graph_engine import GraphServeEngine
from repro_torch.tuning import (PlanTuner, TuningCandidate,
                                default_candidates, staircase_warp_nzs,
                                tune_offline)

from conftest import make_powerlaw_csr

BASE = PartitionConfig()
CPU = "cpu"


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _fixed_candidates(n=2):
    cfgs = [dataclasses.replace(BASE, max_warp_nzs=BASE.max_warp_nzs // 2),
            dataclasses.replace(BASE, max_rows_per_block=BASE.deg_bound),
            dataclasses.replace(
                BASE, warp_nzs_table=staircase_warp_nzs(
                    BASE.max_block_warps, BASE.max_warp_nzs))]
    return [TuningCandidate(config=c, label=f"c{i}")
            for i, c in enumerate(cfgs[:n])]


def _hot_tuner(clock, **kw):
    kw.setdefault("hot_rate", 10.0)
    kw.setdefault("shadow_fraction", 1.0)
    kw.setdefault("win_streak", 2)
    kw.setdefault("min_improvement", 0.02)
    kw.setdefault("max_trials", 4)
    kw.setdefault("candidates", _fixed_candidates())
    return PlanTuner(now_fn=clock, halflife_s=1.0, **kw)


def _heat(tuner, gid="g", n=100):
    tuner.observe(gid, n)   # burst >> hot_rate * halflife / ln2


def _port(g):
    return CSRGraph(g.rowptr, g.colidx, g.values, g.n_cols)


# ---------------------------------------------------------------------------
# pure policy: deterministic under the fake clock
# ---------------------------------------------------------------------------
def test_cold_graph_never_shadowed():
    clock = FakeClock()
    tuner = _hot_tuner(clock)
    tuner.observe("g", 1)
    for _ in range(10):
        assert tuner.next_shadow("g", BASE) is None
    assert tuner.stats()["tracked"] == 0


def test_hot_graph_enters_tuning_and_cools_off_clockwise():
    clock = FakeClock()
    tuner = _hot_tuner(clock)
    _heat(tuner)
    assert tuner.next_shadow("g", BASE) is not None
    # an UNSEEN graph whose rate decayed to ~0 stays untracked
    clock.t += 1000.0
    tuner.observe("g2", 1)
    assert tuner.next_shadow("g2", BASE) is None


def test_shadow_stride_is_deterministic():
    clock = FakeClock()
    tuner = _hot_tuner(clock, shadow_fraction=0.25)
    _heat(tuner)
    picks = [tuner.next_shadow("g", BASE) is not None for _ in range(12)]
    assert picks == [False, False, False, True] * 3


def test_win_streak_promotes_and_stops_shadowing():
    clock = FakeClock()
    tuner = _hot_tuner(clock)
    _heat(tuner)
    cand = tuner.next_shadow("g", BASE)
    assert tuner.record_shadow("g", cand, 1.0, 0.5) is None
    winner = tuner.record_shadow("g", cand, 1.0, 0.5)
    assert winner is cand
    tuner.confirm_promoted("g")
    assert tuner.describe("g")["status"] == "promoted"
    assert tuner.next_shadow("g", BASE) is None
    s = tuner.stats()
    assert s["promotions"] == 1 and s["wins"] == 2


def test_loss_resets_the_streak():
    clock = FakeClock()
    tuner = _hot_tuner(clock, max_trials=10)
    _heat(tuner)
    cand = tuner.next_shadow("g", BASE)
    assert tuner.record_shadow("g", cand, 1.0, 0.5) is None     # win
    assert tuner.record_shadow("g", cand, 1.0, 0.999) is None   # loss (< 2%)
    assert tuner.describe("g")["streak"] == 0
    # needs a fresh full streak after the loss
    assert tuner.record_shadow("g", cand, 1.0, 0.5) is None
    assert tuner.record_shadow("g", cand, 1.0, 0.5) is cand


def test_max_trials_advances_then_exhausts():
    clock = FakeClock()
    tuner = _hot_tuner(clock, max_trials=2, win_streak=2)
    _heat(tuner)
    c0 = tuner.next_shadow("g", BASE)
    tuner.record_shadow("g", c0, 1.0, 2.0)
    tuner.record_shadow("g", c0, 1.0, 2.0)      # c0 dropped
    c1 = tuner.next_shadow("g", BASE)
    assert c1 is not c0 and c1.label == "c1"
    tuner.record_shadow("g", c1, 1.0, 2.0)
    tuner.record_shadow("g", c1, 1.0, 2.0)      # list exhausted
    assert tuner.next_shadow("g", BASE) is None
    assert tuner.describe("g")["status"] == "exhausted"
    assert tuner.stats()["exhausted"] == 1


def test_candidate_failure_drops_candidate():
    clock = FakeClock()
    tuner = _hot_tuner(clock)
    _heat(tuner)
    c0 = tuner.next_shadow("g", BASE)
    tuner.candidate_failed("g", c0)
    assert tuner.next_shadow("g", BASE).label == "c1"
    assert tuner.stats()["candidate_failures"] == 1


def test_stale_shadow_result_is_ignored():
    clock = FakeClock()
    tuner = _hot_tuner(clock)
    _heat(tuner)
    c0 = tuner.next_shadow("g", BASE)
    tuner.candidate_failed("g", c0)             # moved on to c1
    assert tuner.record_shadow("g", c0, 1.0, 0.1) is None
    assert tuner.stats()["comparisons"] == 0


def test_reset_reenters_tuning_from_scratch():
    clock = FakeClock()
    tuner = _hot_tuner(clock)
    _heat(tuner)
    c0 = tuner.next_shadow("g", BASE)
    tuner.record_shadow("g", c0, 1.0, 0.5)
    tuner.reset("g")
    assert tuner.describe("g") is None
    _heat(tuner)
    again = tuner.next_shadow("g", BASE)
    assert again.label == "c0" and tuner.describe("g")["trials"] == 0


def test_constructor_validation():
    with pytest.raises(ValueError):
        PlanTuner(shadow_fraction=0.0)
    with pytest.raises(ValueError):
        PlanTuner(win_streak=3, max_trials=2)


# ---------------------------------------------------------------------------
# candidate generator
# ---------------------------------------------------------------------------
def test_default_candidates_admissible_and_nondefault():
    cands = default_candidates(BASE)
    assert len(cands) >= 4
    assert len({c.label for c in cands}) == len(cands)
    for c in cands:
        assert c.config != BASE or c.backend is not None
        if c.config.warp_nzs_table is not None:
            validate_warp_nzs_override(c.config.max_block_warps,
                                       c.config.max_warp_nzs,
                                       c.config.warp_nzs_table)
    # best-guess-first: the halved-slab capacity variant leads the list
    assert cands[0].label == "half-slab"


def test_staircase_table_is_minimal_admissible():
    mbw, mwn = BASE.max_block_warps, BASE.max_warp_nzs
    tab = staircase_warp_nzs(mbw, mwn)
    assert len(tab) == mbw * mwn
    for d, w in enumerate(tab, start=1):
        assert 1 <= w <= mwn and mbw * w >= d
        assert w == 1 or mbw * (w - 1) < d      # cannot shrink further


BASES = [("tpu", 64, 4), ("paper", 12, 32), ("tpu", 64, 1), ("tpu", 8, 4)]


@pytest.mark.parametrize("mode,mbw,mwn", BASES)
def test_default_candidates_identical_to_reference(mode, mbw, mwn):
    port = default_candidates(PartitionConfig(mode, mbw, mwn))
    ref = ref_default_candidates(ref_pc.PartitionConfig(mode, mbw, mwn))
    assert [c.label for c in port] == [c.label for c in ref]
    for p, r in zip(port, ref):
        assert dataclasses.asdict(p.config) == dataclasses.asdict(r.config)
        assert (p.backend, p.grid_order) == (r.backend, r.grid_order)
        assert p.tuned_hints() == r.tuned_hints()


@pytest.mark.parametrize("mode,mbw,mwn", BASES)
@pytest.mark.parametrize("base", [1, 2, 3, 64])
def test_staircase_identical_to_reference(mode, mbw, mwn, base):
    assert staircase_warp_nzs(mbw, mwn, base) == ref_staircase(mbw, mwn, base)


CANDIDATE_CONFIGS = [(mode, mbw, mwn, i)
                     for mode, mbw, mwn in BASES[:2]
                     for i in range(len(default_candidates(
                         PartitionConfig(mode, mbw, mwn))))]


@pytest.mark.parametrize("mode,mbw,mwn,i", CANDIDATE_CONFIGS)
def test_candidate_plans_identical_to_reference_and_rows_one_run(mode, mbw,
                                                                 mwn, i):
    """Every slab shape the tuner can promote: the port's plan equals the
    reference's slab for slab, and in every block the live slots' rowloc
    never decreases (K1-K3 add each local row's run with one RED), also
    where partly filled warps leave dead slots between live ones."""
    cand = default_candidates(PartitionConfig(mode, mbw, mwn))[i]
    ref_cand = ref_default_candidates(ref_pc.PartitionConfig(mode, mbw, mwn))[i]
    C = cand.config.deg_bound
    rng = np.random.default_rng(C + i)
    deg = np.concatenate([[0] * 3, rng.integers(1, 40, 150), [C], [C + 1],
                          [3 * C + 7]])
    src = np.repeat(np.arange(len(deg)), deg)
    rg = ref_csr_from_edges(src, rng.integers(0, len(deg), len(src)),
                            len(deg))
    rp = ref_pc.build_partition_plan(rg, ref_cand.config)
    pp = build_partition_plan(_port(rg), cand.config, device=CPU)
    assert pp.partition.is_split.any()
    assert (pp.slabs["C"], pp.slabs["R"]) == (rp.slabs["C"], rp.slabs["R"])
    for k in ("colidx", "values", "rowloc", "out_row"):
        np.testing.assert_array_equal(pp.slabs[k].numpy(),
                                      np.asarray(rp.slabs[k]))
    values, rowloc = pp.slabs["values"].numpy(), pp.slabs["rowloc"].numpy()
    for b in range(values.shape[0]):
        assert np.all(np.diff(rowloc[b][values[b] != 0]) >= 0), b


# ---------------------------------------------------------------------------
# the policy against the reference's, call for call
# ---------------------------------------------------------------------------
def _script(seed, n=160):
    """A random sequence of tuner calls over three graphs: observe bursts,
    clock steps, shadow questions, scored comparisons, failures and
    resets."""
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(n):
        r = rng.random()
        gid = f"g{rng.integers(0, 3)}"
        if r < 0.25:
            ops.append(("observe", gid, int(rng.integers(1, 40))))
        elif r < 0.35:
            ops.append(("tick", float(rng.uniform(0.0, 2.0))))
        elif r < 0.85:
            ops.append(("shadow", gid, float(rng.uniform(0.5, 1.5)),
                        float(rng.uniform(0.3, 1.5)), rng.random() < 0.08))
        elif r < 0.95:
            ops.append(("describe", gid))
        else:
            ops.append(("reset", gid))
    return ops


def _play(tuner_cls, cand_cls, cfg_cls, clock, ops, **kw):
    base = cfg_cls()
    cands = [cand_cls(config=dataclasses.replace(base, max_warp_nzs=2),
                      label="half"),
             cand_cls(config=dataclasses.replace(base, max_rows_per_block=256),
                      label="dense"),
             cand_cls(config=base, backend="blocked", label="twin")]
    tuner = tuner_cls(now_fn=clock, halflife_s=1.0, candidates=cands, **kw)
    trace = []
    for op in ops:
        if op[0] == "observe":
            tuner.observe(op[1], op[2])
        elif op[0] == "tick":
            clock.t += op[1]
        elif op[0] == "shadow":
            _, gid, inc, cand_s, fail = op
            cand = tuner.next_shadow(gid, base)
            trace.append(None if cand is None else cand.label)
            if cand is None:
                continue
            if fail:
                tuner.candidate_failed(gid, cand)
                continue
            won = tuner.record_shadow(gid, cand, inc, cand_s)
            trace.append(None if won is None else won.label)
            if won is not None:
                tuner.confirm_promoted(gid)
        elif op[0] == "describe":
            trace.append(tuner.describe(op[1]))
        else:
            tuner.reset(op[1])
    return trace, tuner.stats()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("kw", [
    dict(hot_rate=10.0, shadow_fraction=1.0, win_streak=2, max_trials=4),
    dict(hot_rate=25.0, shadow_fraction=0.25, win_streak=3, max_trials=5,
         min_improvement=0.1)])
def test_tuner_decisions_identical_to_reference(seed, kw):
    ops = _script(seed)
    port = _play(PlanTuner, TuningCandidate, PartitionConfig, FakeClock(),
                 ops, **kw)
    ref = _play(RefTuner, RefCandidate, ref_pc.PartitionConfig, FakeClock(),
                ops, **kw)
    assert port == ref
    assert port[1]["comparisons"] > 0


@pytest.mark.parametrize("halflife", [0.5, 5.0])
def test_ewma_rate_identical_to_reference(halflife):
    clock_p, clock_r = FakeClock(), FakeClock()
    port = EwmaRate(halflife_s=halflife, now_fn=clock_p)
    ref = RefEwma(halflife_s=halflife, now_fn=clock_r)
    rng = np.random.default_rng(7)
    for _ in range(200):
        dt = float(rng.exponential(0.3))
        clock_p.t += dt
        clock_r.t += dt
        key, n = f"k{rng.integers(0, 4)}", int(rng.integers(1, 9))
        port.observe(key, n)
        ref.observe(key, n)
        for k in ("k0", "k1", "k2", "k3", "never"):
            assert port.rate(k) == ref.rate(k)
    clock_p.t += 30 * halflife
    clock_r.t += 30 * halflife
    for k in ("k0", "k1", "k2", "k3"):
        assert port.rate(k) == ref.rate(k)
    with pytest.raises(ValueError):
        EwmaRate(halflife_s=0.0)


# ---------------------------------------------------------------------------
# engine integration: shadow rollout end to end
# ---------------------------------------------------------------------------
def _ref_graph(n=220, seed=7):
    return ref_normalize(make_powerlaw_csr(n=n, seed=seed))


def _graph():
    return _port(_ref_graph())


def _promote(engine, gid, x, deadline_s=30.0):
    t0 = time.monotonic()
    while engine.stats()["tuned_promotions"] < 1:
        engine.serve_one(gid, x)
        time.sleep(0.005)
        assert time.monotonic() - t0 < deadline_s, \
            f"no promotion: {engine.tuner.describe(gid)}"


@pytest.mark.parametrize("backend", ["accel", "blocked"])
def test_engine_promotes_and_serves_correctly(backend):
    g = _graph()
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(g.n_cols, 8)).astype(np.float32))
    # min_improvement << 0 makes every comparison a win, so the FIRST
    # candidate promotes after win_streak shadows regardless of timings
    tuner = PlanTuner(hot_rate=0.0, shadow_fraction=1.0, win_streak=2,
                      min_improvement=-100.0, max_trials=4,
                      candidates=_fixed_candidates(1))
    engine = GraphServeEngine(device=CPU, backend=backend, tuner=tuner)
    try:
        engine.register_graph("hot", g)
        v0 = engine.plan_for("hot").version
        _promote(engine, "hot", x)
        plan = engine.plan_for("hot")
        assert plan.tuned is not None and plan.tuned["label"] == "c0"
        assert plan.config == _fixed_candidates(1)[0].config
        assert plan.version > v0, "promotion must ride the version chain"
        # the tuned plan answers like the operator on the default plan
        out = engine.serve_one("hot", x)
        direct = make_accel_spmm(g, device=CPU)(x)
        np.testing.assert_allclose(out.numpy(), direct.numpy(),
                                   atol=1e-4, rtol=1e-4)
        s = engine.stats()
        assert s["tuned_graphs"] == 1 and s["shadow_failures"] == 0
        assert s["tuner_promotions"] == 1
        # K1 (plain version here) ran 5 times per shadow: 1 warm-up + ABBA
        assert s["shadow_dispatches"] >= 2
    finally:
        engine.close()


def test_promoted_plan_answers_like_the_reference_engine_on_integers():
    """Integer-valued graph and features: the port's engine (K1's plain
    version) and the reference's (``blocked``) after the same forced
    promotion serve identical answers through the same tuned config."""
    rg = make_powerlaw_csr(n=240, seed=11)
    vals = np.random.default_rng(3).integers(1, 4, rg.nnz).astype(np.float32)
    rg = type(rg)(rg.rowptr, rg.colidx, vals, rg.n_cols)
    x = np.random.default_rng(4).integers(-4, 5, (rg.n_cols, 6)) \
        .astype(np.float32)
    kw = dict(hot_rate=0.0, shadow_fraction=1.0, win_streak=2,
              min_improvement=-100.0, max_trials=4)
    port = GraphServeEngine(device=CPU, backend="accel", tuner=PlanTuner(
        candidates=[default_candidates(BASE)[0]], **kw))
    ref = RefEngine(backend="blocked", tuner=RefTuner(
        candidates=[ref_default_candidates(ref_pc.PartitionConfig())[0]],
        **kw))
    try:
        port.register_graph("g", _port(rg))
        ref.register_graph("g", rg)
        before = port.serve_one("g", torch.from_numpy(x))
        _promote(port, "g", torch.from_numpy(x))
        _promote(ref, "g", jnp.asarray(x))
        after = port.serve_one("g", torch.from_numpy(x))
        want = np.asarray(ref.serve_one("g", jnp.asarray(x)))
        assert port.plan_for("g").tuned == ref.plan_for("g").tuned
        assert dataclasses.asdict(port.plan_for("g").config) == \
            dataclasses.asdict(ref.plan_for("g").config)
        assert np.array_equal(before.numpy(), want)
        assert np.array_equal(after.numpy(), want)
    finally:
        port.close()
        ref.close()


def test_reregister_same_content_keeps_tuned_binding():
    g = _graph()
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(g.n_cols, 8)).astype(np.float32))
    tuner = PlanTuner(hot_rate=0.0, shadow_fraction=1.0, win_streak=1,
                      min_improvement=-100.0, max_trials=2,
                      candidates=_fixed_candidates(1))
    engine = GraphServeEngine(device=CPU, tuner=tuner)
    try:
        engine.register_graph("hot", g)
        _promote(engine, "hot", x)
        tuned_key = engine.plan_for("hot").key
        engine.register_graph("hot", g)     # same content: must be a no-op
        assert engine.plan_for("hot").key == tuned_key
        assert engine.plan_for("hot").tuned is not None
        # unregistering drops the tuned hints with the binding
        assert engine.unregister_graph("hot")
        assert engine.stats()["tuned_graphs"] == 0
    finally:
        engine.close()


def test_shadow_never_blocks_reads_while_busy():
    """The opportunistic-skip invariant: at most one shadow in flight,
    extra shadow-due dispatches are counted as skipped, never queued."""
    g = _graph()
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(g.n_cols, 8)).astype(np.float32))
    tuner = PlanTuner(hot_rate=0.0, shadow_fraction=1.0, win_streak=10 ** 6,
                      min_improvement=10.0, max_trials=10 ** 6,
                      candidates=_fixed_candidates(2))
    engine = GraphServeEngine(device=CPU, tuner=tuner)
    try:
        engine.register_graph("hot", g)
        for _ in range(30):
            engine.serve_one("hot", x)      # no pacing: worker stays busy
        s = engine.stats()
        assert s["shadow_dispatches"] + s["shadow_skipped"] >= 29
        assert s["tuned_promotions"] == 0
    finally:
        engine.close()
    # close() waited for the measurement in flight
    assert not engine._shadow_inflight


def test_broken_candidate_in_a_shadow_is_counted_not_raised():
    g = _graph()
    x = torch.ones((g.n_cols, 4))
    bad = TuningCandidate(config=BASE, backend="no-such-backend",
                          label="broken")
    tuner = PlanTuner(hot_rate=0.0, shadow_fraction=1.0, win_streak=1,
                      max_trials=1, candidates=[bad])
    engine = GraphServeEngine(device=CPU, tuner=tuner)
    try:
        engine.register_graph("hot", g)
        deadline = time.monotonic() + 30
        while engine.stats()["shadow_failures"] < 1:
            engine.serve_one("hot", x)
            time.sleep(0.005)
            assert time.monotonic() < deadline
        s = engine.stats()
        assert s["tuner_candidate_failures"] == 1
        assert s["tuner_exhausted_graphs"] == 1 and s["tuned_promotions"] == 0
    finally:
        engine.close()


# ---------------------------------------------------------------------------
# tuned configs survive disk spill/reload
# ---------------------------------------------------------------------------
def test_tuned_plan_roundtrips_through_spill(tmp_path):
    cache = PlanCache(capacity=1, save_dir=str(tmp_path), device=CPU)
    cfg = dataclasses.replace(
        BASE, warp_nzs_table=staircase_warp_nzs(BASE.max_block_warps,
                                                BASE.max_warp_nzs))
    g = _graph()
    plan = cache.get_or_build(g, cfg)
    plan.tuned = {"backend": None, "grid_order": "block_major",
                  "label": "wnz-min"}
    cache.get_or_build(_port(_ref_graph(n=150, seed=8)), BASE)
    assert cache.stats()["spills"] == 1     # evicted + spilled the tuned plan

    back = cache.get_or_build(g, cfg)       # disk reload, not a rebuild
    assert cache.stats()["disk_hits"] == 1
    assert back.tuned == plan.tuned
    assert back.key == plan.key
    assert back.key[1].warp_nzs_table == cfg.warp_nzs_table
    for k in ("colidx", "values", "rowloc", "out_row"):
        assert torch.equal(back.slabs[k], plan.slabs[k])
    # and the reloaded tuned plan holds the reference's slabs for the config
    rp = ref_pc.build_partition_plan(
        _ref_graph(), ref_pc.PartitionConfig(
            warp_nzs_table=ref_staircase(BASE.max_block_warps,
                                         BASE.max_warp_nzs)))
    for k in ("colidx", "values", "rowloc", "out_row"):
        np.testing.assert_array_equal(back.slabs[k].numpy(),
                                      np.asarray(rp.slabs[k]))


def test_untuned_plan_reloads_with_tuned_none(tmp_path):
    cache = PlanCache(capacity=1, save_dir=str(tmp_path), device=CPU)
    g = _graph()
    cache.get_or_build(g, BASE)
    cache.get_or_build(_port(_ref_graph(n=150, seed=8)), BASE)
    back = cache.get_or_build(g, BASE)
    assert cache.stats()["disk_hits"] == 1 and back.tuned is None


# ---------------------------------------------------------------------------
# offline search
# ---------------------------------------------------------------------------
def test_tune_offline_ranks_candidates():
    g = _graph()
    rep = tune_offline(g, feat_dim=8, repeats=1,
                       candidates=_fixed_candidates(2), device=CPU)
    assert {r["label"] for r in rep["candidates"]} == {"c0", "c1"}
    assert all("time_s" in r for r in rep["candidates"])
    assert rep["best"]["label"] in {"c0", "c1"}
    assert rep["base"]["time_s"] > 0


def test_tune_offline_broken_candidate_is_a_result_not_a_crash():
    g = _graph()
    bad = TuningCandidate(config=BASE, backend="no-such-backend",
                          label="broken")
    rep = tune_offline(g, feat_dim=8, repeats=1, candidates=[bad],
                       device=CPU)
    (row,) = rep["candidates"]
    assert row["label"] == "broken" and "error" in row
    assert rep["best"] is None and rep["best_speedup"] == 0.0


def test_tune_offline_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this checks the CPU-only behaviour")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tune_offline(_graph(), feat_dim=8, repeats=1)
