"""The port's training loop (``repro_torch.train.loop``) and checkpoints of
its ``TrainState``: the reference's loop tests (``tests/test_system.py``),
port-side, and a ``TrainState`` checkpoint crossing packages both ways.

The port's train step updates its state in place, so every run below
starts from a fresh state (``fresh()``), as the reference's test does.
On the CPU a crash and a resume give an uninterrupted run's history and
final state bit for bit: batches depend on (seed, step) alone, the
checkpoint restores every leaf exactly, and the step is deterministic.
"""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as RefManager
from repro.configs import get_reduced
from repro.models import lm as R
from repro.optim.adamw import adamw_init as ref_adamw_init
from repro.train.step import TrainState as RefTrainState
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_reduced as port_reduced
from repro_torch.data.tokens import token_batch_fn
from repro_torch.optim.adamw import AdamWState, tree_leaves
from repro_torch.train import TrainState, make_train_step, train_loop
from repro_torch.train.step import init_train_state


def _quiet(*_):
    return None


def _setup(arch="qwen1.5-32b", batch=2, seq=16, seed=1):
    cfg = port_reduced(arch)
    bf_np = token_batch_fn(batch=batch, seq=seq, vocab=cfg.vocab, seed=seed)

    def bf(s):
        return {k: torch.from_numpy(v) for k, v in bf_np(s).items()}

    def fresh():
        return init_train_state(cfg, torch.Generator().manual_seed(3),
                                device="cpu")

    step = make_train_step(cfg, loss_chunk=16, q_chunk=16, kv_chunk=16)
    return cfg, bf, fresh, step


def test_fault_tolerant_resume_bit_identical(tmp_path):
    """Crash mid-run, restart from checkpoint: history and final state
    equal an uninterrupted run exactly."""
    _, bf, fresh, step = _setup()
    ref = train_loop(state=fresh(), train_step=step, batch_fn=bf, n_steps=8,
                     ckpt=None, log_every=100, log_fn=_quiet)

    ck = CheckpointManager(str(tmp_path), keep=2)
    with pytest.raises(RuntimeError, match="simulated failure at step 5"):
        train_loop(state=fresh(), train_step=step, batch_fn=bf, n_steps=8,
                   ckpt=ck, ckpt_every=3, crash_at=5, log_every=100,
                   log_fn=_quiet)
    assert ck.latest_step() == 3
    logs = []
    out = train_loop(state=fresh(), train_step=step, batch_fn=bf, n_steps=8,
                     ckpt=ck, ckpt_every=3, log_every=100, log_fn=logs.append)
    assert "[loop] resumed from checkpoint step 3" in logs
    assert out["history"] == ref["history"][3:]
    assert ck.latest_step() == 8
    got, want = tree_leaves(out["state"]), tree_leaves(ref["state"])
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert int(out["state"].opt.step) == 8


def test_history_holds_every_metric_as_a_float():
    _, bf, fresh, step = _setup("phi3-mini-3.8b")
    out = train_loop(state=fresh(), train_step=step, batch_fn=bf, n_steps=2,
                     log_every=1, log_fn=_quiet)
    for h in out["history"]:
        assert set(h) == {"ce", "aux", "loss", "lr", "grad_norm"}
        assert all(type(v) is float and np.isfinite(v) for v in h.values())
    # lr is the schedule's fp32 value, read exactly
    assert out["history"][0]["lr"] == float(np.float32(3e-4 * 1 / 100))


def test_lm_train_loss_decreases():
    cfg = port_reduced("phi3-mini-3.8b")
    state = init_train_state(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    step = make_train_step(cfg, peak_lr=5e-3, warmup=5, total=100,
                           loss_chunk=16, q_chunk=16, kv_chunk=16)
    bf = token_batch_fn(batch=4, seq=32, vocab=cfg.vocab, seed=0)
    losses = []
    for s in range(25):
        state, m = step(state, bf(s))
        losses.append(float(m["ce"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.2, losses


def test_straggler_accounting():
    calls = {"n": 0}

    def slow_step(state, batch):
        calls["n"] += 1
        if calls["n"] == 8:
            time.sleep(0.25)
        return state, {"loss": torch.tensor(1.0)}

    out = train_loop(state={}, train_step=slow_step,
                     batch_fn=lambda s: {}, n_steps=10, log_every=100,
                     straggler_factor=3.0, log_fn=_quiet)
    assert out["stragglers"] >= 1
    assert [h["loss"] for h in out["history"]] == [1.0] * 10


def _ref_state(name):
    cfg = get_reduced(name)
    params = R.init_lm(cfg, jax.random.PRNGKey(0))
    return RefTrainState(params, ref_adamw_init(params))


@pytest.mark.parametrize("name", ["phi3-mini-3.8b", "zamba2-7b",
                                  "deepseek-moe-16b"])
def test_train_state_checkpoint_crosses_packages(tmp_path, name):
    """A port ``TrainState`` after two steps restores into the reference's
    ``TrainState`` tree with equal leaves (bf16 params, fp32 moments and
    masters, the int32 step), and the reference's into the port's."""
    cfg = port_reduced(name)
    state = init_train_state(cfg, torch.Generator().manual_seed(1),
                             device="cpu")
    step = make_train_step(cfg, loss_chunk=16, q_chunk=16, kv_chunk=16,
                           ssd_chunk=8)
    bf = token_batch_fn(batch=2, seq=16, vocab=cfg.vocab, seed=2)
    for s in range(2):
        state, _ = step(state, bf(s))
    CheckpointManager(str(tmp_path / "port")).save(2, state)
    ref_like = _ref_state(name)
    got = RefManager(str(tmp_path / "port")).restore(2, ref_like)
    assert isinstance(got, RefTrainState)
    a_l, b_l = tree_leaves(state), jax.tree_util.tree_leaves(got)
    assert len(a_l) == len(b_l)
    for a, b in zip(a_l, b_l):
        assert str(a.dtype).split(".")[-1] == str(b.dtype)
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(b.astype(jnp.float32)))
    assert int(got.opt.step) == 2

    # the reverse: the reference's state (as initialised) into the port's
    RefManager(str(tmp_path / "ref")).save(0, ref_like)
    back = CheckpointManager(str(tmp_path / "ref")).restore(0, state)
    assert isinstance(back, TrainState) and isinstance(back.opt, AdamWState)
    for a, b in zip(tree_leaves(back), jax.tree_util.tree_leaves(ref_like)):
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(b.astype(jnp.float32)))
    assert back.opt.step.dtype == torch.int32 and int(back.opt.step) == 0
    # and the port restores its own tree bit for bit
    again = CheckpointManager(str(tmp_path / "port")).restore(2, state)
    for a, b in zip(tree_leaves(again), a_l):
        assert a.dtype == b.dtype and torch.equal(a, b)
