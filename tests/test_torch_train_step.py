"""One fp32 ``make_train_step`` of the port against the reference's
(``repro.train.step``), for all ten architectures at their reduced
configs (B=2, T=32, chunks 16/16/8), without microbatches here and with
``microbatch=1`` in ``tests/test_torch_train_step_mb.py`` (two
microbatches: each one's gradients cast to bf16 and summed in bf16).

Both start from the reference's ``init_lm`` cast to fp32 and
``adamw_init``; the reference runs under ``jax.jit``. Bounds:
* loss and ``grad_norm`` within ``1e-5`` relative; ``lr`` equal;
* ``master`` within ``1e-6 + 1e-5 * |w|`` wherever the gradient the step
  used is not tiny (``|g| >= 1e-3 * max|g|`` of the leaf; with
  microbatches the bf16 sums, which route each microbatch on its own);
  at a first Adam step ``mh / (sqrt(vh) + eps)`` is ``g / (|g| + eps)``,
  so an entry moves by ``lr * (+-1 + wd * w)`` and the two agree up to
  rounding where the sign of ``g`` is the same;
* ``master`` within ``2.2 * lr`` everywhere: where ``|g|`` is tiny its
  sign may differ between two summation orders, and the two updates then
  differ by ``2 * lr`` at most (plus ``wd * lr * |w|``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS, get_reduced
from repro.models import lm as R
from repro.optim.adamw import adamw_init as ref_adamw_init
from repro.train.step import TrainState as RefTrainState
from repro.train.step import make_train_step as ref_make_train_step
from repro_torch.configs import get_reduced as port_reduced
from repro_torch.models import lm as P
from repro_torch.optim.adamw import adamw_init, tree_leaves
from repro_torch.train.step import TrainState, make_train_step

from test_torch_train_lm import CH, batch, fp32, port_grads

KW = dict(peak_lr=1e-3, warmup=1, total=10, loss_chunk=16, **CH)


def effective_grads(pcfg, params, x, y, microbatch):
    """The gradients the step feeds AdamW: the batch's, or the bf16 sum of
    each microbatch's divided by their count, as fp32 numpy."""
    if microbatch is None:
        return [g.numpy() for g in port_grads(pcfg, params, x, y)[1]]
    n = x.shape[0] // microbatch
    acc = None
    for i in range(n):
        sl = slice(i * microbatch, (i + 1) * microbatch)
        g = [t.to(torch.bfloat16) for t in port_grads(pcfg, params, x[sl],
                                                      y[sl])[1]]
        acc = g if acc is None else [a + b for a, b in zip(acc, g)]
    return [(a.float() / n).numpy() for a in acc]


@pytest.mark.parametrize("name", ARCH_IDS)
def test_train_step_against_reference(name):
    check_train_step(name, None)


def check_train_step(name, microbatch):
    """One step of both packages from the same state and batch (see the
    module docstring); ``tests/test_torch_train_step_mb.py`` runs it with
    microbatches."""
    cfg, pcfg = get_reduced(name), port_reduced(name)
    rp = fp32(R.init_lm(cfg, jax.random.PRNGKey(0)))
    x, y = batch(cfg)
    rstate, rm = jax.jit(ref_make_train_step(cfg, microbatch=microbatch,
                                             **KW))(
        RefTrainState(rp, ref_adamw_init(rp)),
        {"inputs": jnp.asarray(x), "labels": jnp.asarray(y)})
    params = P.params_from_jax(pcfg, rp, device="cpu")
    grads = effective_grads(pcfg, params, x, y, microbatch)
    state, m = make_train_step(pcfg, microbatch=microbatch, **KW)(
        TrainState(params, adamw_init(params)), {"inputs": x, "labels": y})
    for k in ("loss", "ce", "aux", "grad_norm"):
        want = float(rm[k])
        assert abs(float(m[k]) - want) <= 1e-5 * abs(want), (k, float(m[k]),
                                                              want)
    lr = float(rm["lr"])
    assert float(m["lr"]) == lr and int(state.opt.step) == 1
    ref_master = jax.tree_util.tree_leaves(rstate.opt.master)
    got_master = tree_leaves(state.opt.master)
    assert len(got_master) == len(ref_master) == len(grads)
    for i, (w, want, g) in enumerate(zip(got_master, ref_master, grads)):
        w, want, g = w.numpy(), np.asarray(want), np.abs(g)
        d = np.abs(w - want)
        assert d.max() <= 2.2 * lr, (name, i, float(d.max()))
        sure = g >= 1e-3 * g.max()
        bad = sure & (d > 1e-6 + 1e-5 * np.abs(want))
        assert not bad.any(), (name, i, float(d[sure].max()))
    # the params are the masters (fp32 here: equal)
    for p, w in zip(tree_leaves(state.params), got_master):
        assert torch.equal(p, w)
