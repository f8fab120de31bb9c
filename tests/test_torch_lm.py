"""The port's LM stack (``repro_torch.models.lm``) against the reference
(``repro.models.lm``) for all ten architectures at their reduced configs:
the same weights (the reference's ``init_lm`` through ``params_from_jax``)
and the same inputs (numpy, from a seed).

Each arch runs twice, in fp32 here and in bf16 in
``tests/test_torch_lm_bf16.py`` (the same tests on a fixture of its own):
* fp32 (the reference tree cast to fp32): logits, loss, caches within
  ``1e-5 * max|ref|`` (the same math in another summation order; the
  largest difference seen is ~1e-6 of the logits' scale);
* bf16 as initialised: within the reference's own serving bounds
  (``tests/test_serve.py:73-74``): ``atol=rtol=0.08`` for every arch with
  attention, ``2e-3`` for mamba2. Both sides round each projection and the
  residual stream to bf16, where XLA's and torch's CPU kernels may land on
  neighbouring bf16 values. The reference runs under ``jax.jit``, except
  the MoE archs in bf16, which run op by op (``jax.disable_jit``): jit
  fuses bf16 elementwise chains and skips roundings that the port (and
  the reference op by op) makes, and a router near-tie then sends a token
  to another expert (seen on one dbrx token row, 1.58 off). Op by op the
  two agree to the bit there.

Per arch and precision: ``lm_forward`` logits (B=2, T=16, chunks of 4, so
several query/key/SSD chunks), the ``lm_loss`` value (a quarter of the
labels masked), ``prefill_forward``'s last-token logits and every cache,
then 4 ``decode_step``s after ``pad_prefill_caches`` and one more after
``reset_decode_slot`` of slot 1 on both sides. Separately: decode-state
shapes, a recycled slot against a fresh state, and the full
configurations' parameter counts, exact.
"""
import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS, get_config, get_reduced
from repro.models import lm as R
from repro_torch.configs import get_config as port_config
from repro_torch.configs import get_reduced as port_reduced
from repro_torch.models import lm as P
from repro_torch.models.layers import to_torch

B, T, EXTRA = 2, 16, 4
CH = dict(q_chunk=4, kv_chunk=4, ssd_chunk=4)


def _fp32(tree):
    return jax.tree.map(
        lambda x: x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x,
        tree)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _leaves(tree, path=""):
    if tree is None:
        return {}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    else:
        return {path: tree}
    out = {}
    for k, v in items:
        out.update(_leaves(v, f"{path}.{k}" if path else str(k)))
    return out


def _bound(name, prec):
    if prec == "fp32":
        return None
    return 2e-3 if get_reduced(name).family == "ssm" else 0.08


def _close(got, want, name, prec, what):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    tol = _bound(name, prec)
    if tol is None:
        err = float(np.abs(got - want).max())
        assert err <= 1e-5 * float(np.abs(want).max()), f"{what}: {err}"
    else:
        np.testing.assert_allclose(got, want, atol=tol, rtol=tol,
                                   err_msg=what)


def results(name, prec):
    """Every reference and port result of one arch at one precision."""
    eager = prec == "bf16" and get_reduced(name).family == "moe"
    with jax.disable_jit() if eager else contextlib.nullcontext():
        return _results(name, prec, (lambda f: f) if eager else jax.jit)


@pytest.fixture(scope="module", params=ARCH_IDS)
def run(request):
    return results(request.param, "fp32")


def _results(name, prec, jit):
    cfg, pcfg = get_reduced(name), port_reduced(name)
    rp = R.init_lm(cfg, jax.random.PRNGKey(0))
    if prec == "fp32":
        rp = _fp32(rp)
    pp = P.params_from_jax(pcfg, rp, device="cpu")
    rng = np.random.default_rng(1)
    if cfg.frontend == "token":
        xj = jnp.asarray(rng.integers(0, cfg.vocab, (B, T + EXTRA)), jnp.int32)
    else:
        xj = jnp.asarray(rng.normal(size=(B, T, cfg.d_model))).astype(
            jnp.float32 if prec == "fp32" else jnp.bfloat16)
    xt = to_torch(np.asarray(xj))
    labels = rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)
    labels[:, ::4] = -1
    out = {"name": name, "prec": prec, "cfg": cfg}

    out["forward"] = (
        P.lm_forward(pcfg, pp, xt[:, :T], **CH),
        jit(functools.partial(R.lm_forward, cfg, **CH))(rp, xj[:, :T]))
    loss = P.lm_loss(pcfg, pp, xt[:, :T], torch.from_numpy(labels),
                     loss_chunk=8, **CH)
    rloss = jit(functools.partial(R.lm_loss, cfg, loss_chunk=8, remat=False,
                                  **CH))(rp, xj[:, :T], jnp.asarray(labels))
    out["loss"] = (loss, rloss)

    lg, st = P.prefill_forward(pcfg, pp, xt[:, :T], **CH)
    rlg, rst = jit(functools.partial(R.prefill_forward, cfg, **CH))(
        rp, xj[:, :T])
    # the port writes its state in place: keep copies of what is compared
    out["prefill"] = (lg, rlg, st and st.clone(), rst)
    if st is None:
        return out
    st = P.pad_prefill_caches(pcfg, st, T + EXTRA + 1)
    rst = R.pad_prefill_caches(cfg, rst, T + EXTRA + 1)
    # the reference's own state, converted, decodes like the port's
    out["from_jax"] = P.decode_step(pcfg, pp, xt[:, T:T + 1],
                                    P.decode_state_from_jax(rst, "cpu"))[0]
    step = jit(functools.partial(R.decode_step, cfg))
    decode = []
    for t in range(EXTRA):
        lg, st = P.decode_step(pcfg, pp, xt[:, T + t:T + t + 1], st)
        rlg, rst = step(rp, xj[:, T + t:T + t + 1], rst)
        decode.append((lg, rlg))
    out["decode"] = (decode, st.clone(), rst)
    # slot 1 recycled at position T + EXTRA on both sides, then one step
    st = P.reset_decode_slot(pcfg, P.track_slot_starts(st, B), 1)
    rst = R.reset_decode_slot(cfg, R.track_slot_starts(rst, B), 1)
    tok = np.array([[3], [5]], np.int32)
    lg, st = P.decode_step(pcfg, pp, torch.from_numpy(tok), st)
    rlg, rst = step(rp, jnp.asarray(tok), rst)
    out["reset"] = (lg, rlg, st, rst)
    return out


def test_lm_forward(run):
    got, want = run["forward"]
    assert got.shape == (B, T, run["cfg"].vocab) and got.dtype == torch.float32
    _close(got, want, run["name"], run["prec"], "logits")


def test_lm_loss(run):
    (loss, m), (rloss, rm) = run["loss"]
    for k, g, w in (("loss", loss, rloss), ("ce", m["ce"], rm["ce"]),
                    ("aux", m["aux"], rm["aux"])):
        _close(g, w, run["name"], run["prec"], k)


def test_prefill(run):
    lg, rlg, st, rst = run["prefill"]
    name, prec = run["name"], run["prec"]
    _close(lg, rlg, name, prec, "prefill logits")
    if run["cfg"].family == "encoder":
        assert st is None and rst is None and lg.shape == (B, T,
                                                           run["cfg"].vocab)
        return
    assert st.pos == int(rst.pos) == T
    got, want = _leaves(st.caches), _leaves(rst.caches)
    assert got.keys() == want.keys()
    for k in want:
        _close(got[k], want[k], name, prec, k)


def _encoder_has_no_decode(run):
    """The encoder family: no decode state, so no decode step."""
    cfg = port_reduced(run["name"])
    with pytest.raises(ValueError, match="no decode step"):
        P.init_decode_state(cfg, B, T, device="cpu")
    with pytest.raises(ValueError, match="no decode step"):
        R.init_decode_state(run["cfg"], B, T)


def test_decode_steps(run):
    if "decode" not in run:
        return _encoder_has_no_decode(run)
    decode, st, rst = run["decode"]
    for i, (lg, rlg) in enumerate(decode):
        _close(lg, rlg, run["name"], run["prec"], f"decode step {i}")
    assert st.pos == int(rst.pos) == T + EXTRA
    got, want = _leaves(st.caches), _leaves(rst.caches)
    for k in want:
        _close(got[k], want[k], run["name"], run["prec"], k)


def test_decode_state_from_jax(run):
    if "decode" not in run:
        return _encoder_has_no_decode(run)
    _close(run["from_jax"], run["decode"][0][0][1], run["name"], run["prec"],
           "decode from the reference's converted state")


def test_reset_decode_slot_against_reference(run):
    if "reset" not in run:
        return _encoder_has_no_decode(run)
    lg, rlg, st, rst = run["reset"]
    _close(lg, rlg, run["name"], run["prec"], "logits after the reset")
    np.testing.assert_array_equal(st.start.numpy(), np.asarray(rst.start))
    got, want = _leaves(st.caches), _leaves(rst.caches)
    for k in want:
        _close(got[k], want[k], run["name"], run["prec"], k)


@pytest.mark.parametrize("name", ARCH_IDS)
def test_init_decode_state_shapes(name):
    cfg, pcfg = get_reduced(name), port_reduced(name)
    if cfg.family == "encoder":
        with pytest.raises(ValueError):
            P.init_decode_state(pcfg, 2, 16, device="cpu")
        return
    st = P.init_decode_state(pcfg, 3, 24, device="cpu")
    rst = R.init_decode_state(cfg, 3, 24)
    got = {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
           for k, v in _leaves(st.caches).items()}
    want = {k: (tuple(v.shape), str(v.dtype))
            for k, v in _leaves(rst.caches).items()}
    assert got == want
    assert st.pos == int(rst.pos) == 0 and st.start is None


@pytest.mark.parametrize("name", [n for n in ARCH_IDS
                                  if n != "hubert-xlarge"])
def test_reset_decode_slot_matches_fresh_state(name):
    """The reference's slot-reuse soundness test on the port: after
    ``reset_decode_slot`` a recycled slot's logits match a fresh-cache
    decode of the same prompt (bf16 weights from the port's own init;
    bound 0.08, mamba2 2e-3, as ``tests/test_serve.py``)."""
    cfg = port_reduced(name)
    params = P.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    tol = 2e-3 if cfg.family == "ssm" else 0.08
    occupant, prompt = [5, 9, 2, 7], [3, 8, 6]

    def feed(st, toks):
        out = []
        for t in toks:
            logits, st = P.decode_step(
                cfg, params, torch.tensor([[1], [t]], dtype=torch.int32), st)
            out.append(logits[1])
        return out, st

    fresh = P.track_slot_starts(P.init_decode_state(cfg, 2, 32, device="cpu"),
                                2)
    ref, _ = feed(fresh, prompt)
    st = P.track_slot_starts(P.init_decode_state(cfg, 2, 32, device="cpu"), 2)
    _, st = feed(st, occupant)
    st = P.reset_decode_slot(cfg, st, 1)
    assert st.start.tolist() == [0, len(occupant)]
    got, _ = feed(st, prompt)
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.numpy(), r.numpy(), atol=tol, rtol=tol)


def test_reset_decode_slot_requires_start_tracking():
    cfg = port_reduced("phi3-mini-3.8b")
    state = P.init_decode_state(cfg, 2, 16, device="cpu")
    with pytest.raises(ValueError, match="track_slot_starts"):
        P.reset_decode_slot(cfg, state, 0)


def test_clone_keeps_an_earlier_state():
    cfg = port_reduced("zamba2-7b")
    params = P.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    st = P.track_slot_starts(P.init_decode_state(cfg, 2, 8, device="cpu"), 2)
    _, st = P.decode_step(cfg, params, torch.tensor([[1], [2]]), st)
    kept = st.clone()
    _, st2 = P.decode_step(cfg, params, torch.tensor([[3], [4]]), st)
    P.reset_decode_slot(cfg, st2, 0)
    assert kept.pos == 1 and st2.pos == 2
    assert not torch.equal(kept.caches["kv"].k, st2.caches["kv"].k)
    assert int(kept.start[0]) == 0 and int(st2.start[0]) == 2


@pytest.mark.parametrize("name", ARCH_IDS)
def test_full_config_param_counts(name):
    """The full configuration's count without allocating, equal to the
    reference's ``eval_shape`` count (``tests/test_lm_smoke.py:50-57``)."""
    sds = jax.eval_shape(functools.partial(R.init_lm, get_config(name)),
                         jax.random.PRNGKey(0))
    want = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(sds))
    assert P.config_param_count(port_config(name)) == want


def test_params_from_jax_refuses_another_config():
    rp = R.init_lm(get_reduced("phi3-mini-3.8b"), jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="shape"):
        P.params_from_jax(port_reduced("chameleon-34b"), rp, device="cpu")
    with pytest.raises(ValueError, match="keys"):
        P.params_from_jax(port_reduced("qwen1.5-32b"), rp, device="cpu")
