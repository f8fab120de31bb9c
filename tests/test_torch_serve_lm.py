"""The port's continuous-batching LM engine (``repro_torch.serve.engine``):
the cases of the reference's ``tests/test_serve.py`` on the port's engine,
then one case against the reference engine itself.

The cross-engine case gives both engines the same parameters (the
reference's ``init_lm`` cast to fp32, through ``params_from_jax``) and the
same requests through ``generate()``. Greedy tokens flip on near-ties, so
each request's tokens are compared up to the first step at which the
reference's own top-two logit margin is below ten times the fp32 logits
bound of ``tests/test_torch_lm.py`` (``1e-5 * max|logits|``); the margins
come from replaying the reference's decode step over the same batch.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced
from repro.models import lm as R
from repro.serve.engine import Request as RefRequest
from repro.serve.engine import ServeEngine as RefEngine
from repro_torch.configs import get_reduced as port_reduced
from repro_torch.models import lm
from repro_torch.serve import Request, ServeEngine


@pytest.fixture(scope="module")
def engine():
    cfg = port_reduced("phi3-mini-3.8b")
    params = lm.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    eng = ServeEngine(cfg, params, batch=4, max_seq=64, eos_id=-1,
                      device="cpu")
    yield eng
    eng.close()


def test_batched_generation(engine):
    reqs = [Request(prompt=[1, 2, 3], max_new=5),
            Request(prompt=[9, 8], max_new=3),
            Request(prompt=[4], max_new=6)]
    out = engine.generate(reqs)
    assert [len(r.out) for r in out] == [5, 3, 6]
    for r in out:
        assert all(0 <= t < engine.cfg.vocab for t in r.out)
        assert r.latency_s is not None and r.latency_s > 0


def test_generation_deterministic(engine):
    a = engine.generate([Request(prompt=[5, 6, 7], max_new=6)])[0].out
    b = engine.generate([Request(prompt=[5, 6, 7], max_new=6)])[0].out
    assert a == b


def test_submit_future_matches_generate(engine):
    """Async admission of a lone request decodes exactly like generate()."""
    want = engine.generate([Request(prompt=[2, 9, 4], max_new=5)])[0].out
    got = engine.submit([2, 9, 4], max_new=5).result(timeout=120)
    assert got == want


def test_submit_validates_synchronously(engine):
    with pytest.raises(ValueError, match="non-empty"):
        engine.submit([], max_new=3)
    with pytest.raises(ValueError, match="max_new"):
        engine.submit([1], max_new=0)
    with pytest.raises(ValueError, match="KV budget"):
        engine.submit(list(range(engine.max_seq)), max_new=1)
    with pytest.raises(ValueError, match="invalid request"):
        engine.generate([Request(prompt=[1], max_new=0)])
    with pytest.raises(ValueError, match="decode slots"):
        engine.generate([Request(prompt=[1], max_new=1)] * 5)


def test_slot_reuse_admission(engine):
    """More requests than decode slots: early finishers free slots that are
    refilled mid-round from the queue, and every answer has the right
    length (``submit_many`` enqueues atomically, so the first flush holds
    ``batch`` requests and the rest MUST be admitted mid-round)."""
    reused_before = engine.slots_reused
    items = engine.scheduler.submit_many(
        [([1 + i, 7, 42], 2 + i) for i in range(engine.batch + 2)])
    outs = [it.future.result(timeout=300) for it in items]
    assert [len(o) for o in outs] == [2 + i for i in range(engine.batch + 2)]
    assert engine.slots_reused > reused_before, \
        "expected mid-round admission into freed slots"
    st = engine.stats()
    assert st["sched_mid_flush_admissions"] >= engine.slots_reused
    assert st["slot_utilization"] > 0
    assert set(st) >= {"rounds", "steps", "tokens_generated", "prompt_tokens",
                       "slots_reused", "cache_exhausted", "total_round_s",
                       "tokens_per_s", "slot_utilization"}


def test_cache_exhausted_answers_with_what_it_has():
    """A sequence still generating when the KV budget fills is answered
    with its tokens so far and counted in ``cache_exhausted``."""
    cfg = port_reduced("phi3-mini-3.8b")
    params = lm.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    eng = ServeEngine(cfg, params, batch=2, max_seq=8, eos_id=-1,
                      device="cpu")
    try:
        out = eng.generate([Request(prompt=[1, 2, 3], max_new=20)])[0].out
    finally:
        eng.close()
    assert len(out) == 8 - 3 + 1 and eng.cache_exhausted == 1


def test_engine_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this checks the CPU-only behaviour")
    cfg = port_reduced("phi3-mini-3.8b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(cfg, {}, batch=2, max_seq=8)


def _replay_margins(cfg, params, reqs, outs):
    """The reference's decode step over the batch the engine ran: for each
    request, the top-two margin of the logits behind each emitted token."""
    seqs = [list(r.prompt) + list(o) for r, o in zip(reqs, outs)]
    n = len(reqs)
    st = R.track_slot_starts(R.init_decode_state(cfg, 4, 64), 4)
    step = jax.jit(functools.partial(R.decode_step, cfg))
    margins = [[] for _ in reqs]
    scale = 0.0
    for t in range(max(len(s) for s in seqs) - 1):
        toks = np.zeros((4, 1), np.int32)
        for i, s in enumerate(seqs):
            toks[i, 0] = s[min(t, len(s) - 2)]
        logits, st = step(params, jnp.asarray(toks), st)
        lg = np.asarray(logits)
        scale = max(scale, float(np.abs(lg[:n]).max()))
        for i, (r, s) in enumerate(zip(reqs, seqs)):
            if len(r.prompt) - 1 <= t < len(s) - 1:
                top = np.sort(lg[i])[-2:]
                margins[i].append(float(top[1] - top[0]))
    return margins, scale


def test_tokens_match_the_reference_engine():
    cfg = get_reduced("phi3-mini-3.8b")
    rp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      R.init_lm(cfg, jax.random.PRNGKey(0)))
    prompts = [([1, 2, 3], 8), ([9, 8], 6), ([4], 10)]
    ref = RefEngine(cfg, rp, batch=4, max_seq=64, eos_id=-1)
    pcfg = port_reduced("phi3-mini-3.8b")
    port = ServeEngine(pcfg, lm.params_from_jax(pcfg, rp, device="cpu"),
                       batch=4, max_seq=64, eos_id=-1, device="cpu")
    try:
        want = [r.out for r in ref.generate(
            [RefRequest(prompt=p, max_new=n) for p, n in prompts])]
        got = [r.out for r in port.generate(
            [Request(prompt=p, max_new=n) for p, n in prompts])]
    finally:
        ref.close()
        port.close()
    reqs = [Request(prompt=p, max_new=n) for p, n in prompts]
    margins, scale = _replay_margins(cfg, rp, reqs, want)
    floor = 10 * 1e-5 * scale
    compared = 0
    for g, w, m in zip(got, want, margins):
        k = next((j for j, v in enumerate(m) if v < floor), len(m))
        assert g[:k] == w[:k]
        compared += k
    print(f"compared {compared} of {sum(n for _, n in prompts)} tokens")
    assert compared >= sum(n for _, n in prompts) // 2, (compared, margins)


_PHASE18 = """
import json, sys, time
sys.path[:0] = [{src!r}, {root!r}]
import torch
import chip_smoke
import repro_torch.configs as configs
configs.get_config = configs.get_reduced     # full widths only on the card
chip_smoke.LM_LOAD = ((2, 4), (4, 8))         # the load's scale: the card's
chip_smoke.LM_LOAD_PROMPT, chip_smoke.LM_LOAD_NEW = 12, 4


class HostEvent:                              # CUDA events on the host clock
    def __init__(self, enable_timing=False):
        self.t = None

    def record(self, stream=None):
        self.t = time.perf_counter()

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


torch.cuda.Event = HostEvent
torch.cuda.synchronize = lambda *a: None
torch.cuda.reset_peak_memory_stats = lambda *a: None
torch.cuda.max_memory_allocated = lambda *a: 0
torch.cuda.memory_allocated = lambda *a: 0
torch.cuda.empty_cache = lambda: None
import repro_torch.analysis.roofline as roofline
# phase 20 (b): the card's row, named here; the CPU has no allocator peak,
# so the tracker's own count on the CPU stands in for the card's
roofline.hw_for = lambda device="cuda": roofline.hw_row(
    "NVIDIA H100 80GB HBM3")
chip_smoke.card_step_peak = lambda torch, base, counts: counts.peak_live_bytes
rec = chip_smoke.phase_lm(torch, "CPU", device="cpu")
print(json.dumps({{"reused": rec["engine"]["slots_reused"],
                  "load": {{k: [r["requests"], r["tokens"]]
                           for k, r in rec["load"].items()}},
                  "bf16_cpu": rec["bf16_cpu"]["prefill+decode"]["max_abs"],
                  "consistency": rec["consistency"],
                  "slot_reuse": rec["slot_reuse"],
                  "cut": {{a: [r["prefill_vs_decode"], r["card_vs_cpu"]]
                          for a, r in rec["cut"].items()}},
                  "dryrun": [[h[k] for k in ("flops", "card_flops",
                                             "argument_bytes", "live_bytes",
                                             "peak", "card_peak")]
                             for h in rec["dryrun"]]}}))
"""


def test_phase18_on_cpu_at_reduced_configs():
    """``chip_smoke.py`` phase 18 end to end on the CPU, every arch at its
    reduced config (a fresh process: the CUDA clock is the host's there)."""
    import json
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    src = os.path.join(root, "src")
    out = subprocess.run(
        [sys.executable, "-c", _PHASE18.format(src=src, root=root)],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=src))
    assert out.returncode == 0, out.stderr[-3000:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["reused"] > 0
    assert rec["load"] == {"b2": [4, 16], "b4": [8, 32]}
    assert rec["bf16_cpu"] == 0.0               # the "card" is the CPU here
    assert max(rec["consistency"].values()) <= 0.1
    assert len(rec["cut"]) == 9
    assert all(max(v) <= 1e-3 for v in rec["cut"].values())
    # phase 20 (b) at the two decode batches: meta against the CPU, exact
    assert len(rec["dryrun"]) == 2
    for flops, cflops, args, live, peak, cpeak in rec["dryrun"]:
        assert flops == cflops > 0 and args == live > 0
        assert peak == cpeak > args
