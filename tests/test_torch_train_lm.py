"""The port's LM backward (``repro_torch.models.lm.lm_loss`` under autograd)
against the reference's ``jax.value_and_grad`` of ``lm_loss(remat=True)``,
for all ten architectures at their reduced configs, B=2, T=32, chunks
16/16/8 as in ``tests/test_lm_smoke.py``.

The same weights (the reference's ``init_lm`` cast to fp32, through
``params_from_jax``) and the same inputs (numpy, from a seed; a quarter of
the labels masked). Bounds, the same math in another summation order:
* the loss within ``1e-5 * |loss|``;
* every gradient leaf within ``2e-5 * max|g| + 1e-7`` of the reference's
  (the largest difference seen is ~0.22 of that bound, zamba-2);
* ``remat=True`` against ``remat=False`` on the port's side: loss and
  every gradient bit for bit (recompute is the same deterministic CPU
  arithmetic, and the backward graph is the same).
Then the reference's own smoke (``tests/test_lm_smoke.py``) port-side in
bf16: one ``make_train_step`` from ``init_train_state``: the loss finite
and > 0, every fp32 master leaf moved (zamba-2's LoRA ``b_*``, which start
at zero, and the MoE routers through ``aux`` included).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS, get_reduced
from repro.models import lm as R
from repro_torch.configs import get_reduced as port_reduced
from repro_torch.models import lm as P
from repro_torch.optim.adamw import tree_leaves, tree_map
from repro_torch.train.step import init_train_state, make_train_step

B, T = 2, 32
CH = dict(q_chunk=16, kv_chunk=16, ssd_chunk=8)


def fp32(tree):
    return jax.tree.map(
        lambda x: x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x,
        tree)


def batch(cfg, seed=1):
    """numpy (inputs, labels): tokens or fp32 frames; every 4th label -1."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "token":
        x = rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)
    else:
        x = rng.normal(size=(B, T, cfg.d_model)).astype(np.float32)
    y = rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)
    y[:, ::4] = -1
    return x, y


def port_grads(pcfg, params, x, y, remat=True, **kw):
    """(loss, every leaf's gradient in tree order) by autograd."""
    live = tree_map(lambda t: t.detach().requires_grad_(), params)
    leaves = tree_leaves(live)
    loss, _ = P.lm_loss(pcfg, live, torch.as_tensor(x), torch.as_tensor(y),
                        remat=remat, loss_chunk=16, **CH, **kw)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    return loss.detach(), list(grads)


@pytest.fixture(scope="module", params=ARCH_IDS)
def run(request):
    name = request.param
    cfg, pcfg = get_reduced(name), port_reduced(name)
    rp = fp32(R.init_lm(cfg, jax.random.PRNGKey(0)))
    x, y = batch(cfg)

    def loss_fn(p):
        return R.lm_loss(cfg, p, jnp.asarray(x), jnp.asarray(y), remat=True,
                         loss_chunk=16, **CH)

    (rloss, _), rgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        rp)
    pp = P.params_from_jax(pcfg, rp, device="cpu")
    return {"name": name, "rloss": float(rloss),
            "rgrads": [np.asarray(g) for g in jax.tree_util.tree_leaves(
                rgrads)],
            "remat": port_grads(pcfg, pp, x, y, remat=True),
            "plain": port_grads(pcfg, pp, x, y, remat=False)}


def test_loss_and_grads_against_reference(run):
    loss, grads = run["remat"]
    assert abs(float(loss) - run["rloss"]) <= 1e-5 * abs(run["rloss"])
    assert len(grads) == len(run["rgrads"])
    for i, (g, want) in enumerate(zip(grads, run["rgrads"])):
        assert g.shape == want.shape, i
        err = float(np.abs(g.numpy() - want).max())
        bound = 2e-5 * float(np.abs(want).max()) + 1e-7
        assert err <= bound, f"{run['name']} leaf {i}: {err} > {bound}"


def test_remat_is_bit_equal_to_plain_backward(run):
    (l1, g1), (l2, g2) = run["remat"], run["plain"]
    assert torch.equal(l1, l2)
    for i, (a, b) in enumerate(zip(g1, g2)):
        assert torch.equal(a, b), f"{run['name']} leaf {i}"


def test_remat_recomputes_in_the_backward():
    """Under remat the forward saves only each unit's inputs: the layers'
    activations come back in the backward (fewer tensors saved)."""
    pcfg = port_reduced("phi3-mini-3.8b")
    params = P.init_lm(pcfg, torch.Generator().manual_seed(0), device="cpu")
    x, y = batch(pcfg)
    saved = {}
    for remat in (True, False):
        live = tree_map(lambda t: t.detach().requires_grad_(), params)
        n = [0]
        with torch.autograd.graph.saved_tensors_hooks(
                lambda t: n.__setitem__(0, n[0] + 1) or t, lambda t: t):
            P.lm_loss(pcfg, live, torch.as_tensor(x), torch.as_tensor(y),
                      remat=remat, loss_chunk=16, **CH)
        saved[remat] = n[0]
    assert saved[True] < saved[False] / 2, saved


def test_stacked_leaf_gradient_is_one_stack():
    """A stacked leaf's gradient is one stack of its layers' slices (the
    leaf's only consumer is ``UnbindBackward``), never a zero-filled whole
    leaf per layer (a ``SelectBackward`` a layer)."""
    pcfg = port_reduced("phi3-mini-3.8b")
    params = P.init_lm(pcfg, torch.Generator().manual_seed(0), device="cpu")
    live = tree_map(lambda t: t.detach().requires_grad_(), params)
    stacked = {id(t) for t in tree_leaves(live["layers"])}
    x, y = batch(pcfg)
    loss, _ = P.lm_loss(pcfg, live, torch.as_tensor(x), torch.as_tensor(y),
                        loss_chunk=16, **CH)
    consumers = {}
    todo, seen = [loss.grad_fn], set()
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        for nxt, _ in fn.next_functions:
            if type(nxt).__name__ == "AccumulateGrad" and \
                    id(nxt.variable) in stacked:
                consumers.setdefault(id(nxt.variable), []).append(
                    type(fn).__name__)
            todo.append(nxt)
    assert len(consumers) == len(stacked)
    assert all(c == ["UnbindBackward0"] for c in consumers.values()), \
        consumers


@pytest.mark.parametrize("name", ARCH_IDS)
def test_bf16_train_step_smoke(name):
    """The reference's smoke (``tests/test_lm_smoke.py``), port-side."""
    cfg = port_reduced(name)
    state = init_train_state(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    assert all(t.dtype == torch.float32 for t in tree_leaves(state.opt.master))
    x, y = batch(cfg, seed=2)
    if cfg.frontend != "token":
        x = torch.from_numpy(x).bfloat16()
    m0 = [t.clone() for t in tree_leaves(state.opt.master)]
    step = make_train_step(cfg, loss_chunk=16, q_chunk=16, kv_chunk=16,
                           ssd_chunk=8)
    state2, metrics = step(state, {"inputs": x, "labels": y})
    loss = float(metrics["loss"])
    assert np.isfinite(loss) and loss > 0
    assert int(state2.opt.step) == 1 and state2.opt.step.dtype == torch.int32
    m1 = tree_leaves(state2.opt.master)
    moved = sum(not torch.equal(a, b) for a, b in zip(m0, m1))
    assert moved == len(m0), f"{name}: only {moved}/{len(m0)} master leaves moved"
    # the params are the masters, rounded to each param's dtype
    for p, w in zip(tree_leaves(state2.params), m1):
        assert torch.equal(p, w.to(p.dtype))
    assert any(p.dtype == torch.bfloat16 for p in tree_leaves(state2.params))
