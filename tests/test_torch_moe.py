"""The port's MoE layer against the reference (``repro.models.moe``): the
same parameters (the reference's ``init_moe`` through ``params_from_jax``)
and the same inputs (numpy, from a seed).

Tolerances, stated once:
* dispatch metadata (router ids, sort order, destination rows, expert run
  starts and counts, block expert ids) and integer-valued products: equal;
* fp32 outputs: within 64 fp32 ulps of the largest output magnitude
  (``2**-18 * max|ref|``). Both sides sum the same products of two chained
  GEMMs (at most 96 terms each here) and a k-term combine in other orders;
  the largest difference seen was 7 ulps;
* bf16 outputs: within ``2**-6 * max|ref|``. A GEMM sum that lands next to
  a bf16 rounding boundary may round to the other neighbour when its fp32
  summation order differs (2**-8 relative), and h, g, the gate product and
  the output are each rounded to bf16;
* the aux loss: within 2 fp32 ulps of the reference's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.models.moe as ref_moe
from repro.configs import get_reduced
from repro.models.layers import apply_mlp as ref_apply_mlp
from repro.models.layers import init_mlp as ref_init_mlp
import repro_torch.models.moe as port_moe
from repro_torch.configs import get_reduced as port_get_reduced
from repro_torch.kernels.grouped_matmul import grouped_matmul
from repro_torch.models.layers import apply_mlp, init_mlp, to_torch

GRID = [(8, 2, 0), (8, 2, 1), (4, 1, 0), (16, 4, 2)]   # tests/test_moe.py


def _np(a):
    a = a.detach() if isinstance(a, torch.Tensor) else a
    if isinstance(a, torch.Tensor):
        return a.float().numpy() if a.dtype == torch.bfloat16 else a.numpy()
    return np.asarray(a, np.float32)


def _close(got, want, dtype=np.float32):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    tol = (2.0 ** -18 if dtype == np.float32 else 2.0 ** -6) * scale
    assert float(np.abs(got - want).max()) <= tol


def _aux_close(got, want):
    want = np.float32(want)
    assert abs(float(got) - float(want)) <= 2 * float(np.spacing(want))


def _x(shape, seed, dtype=np.float32):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return x.astype(ml_dtypes.bfloat16) if dtype == jnp.bfloat16 else x


def _ref_params(seed, D, FF, E, shared, dtype=jnp.float32, skew=0.0):
    p = ref_moe.init_moe(jax.random.PRNGKey(seed), D, FF, E, n_shared=shared,
                         dtype=dtype)
    if skew:
        p["router"] = p["router"] + jnp.zeros((E,)).at[0].set(skew)
    return p


def _ref_dispatch(ids, n_experts, m_tile):
    """The reference's moe_block metadata (moe.py:174-198), step by step."""
    n_tok, top_k = ids.shape
    flat_e = ids.reshape(-1)
    order = jnp.argsort(flat_e, stable=True)
    se = flat_e[order]
    S = n_tok * top_k
    M = S + n_experts * m_tile
    M = ((M + m_tile - 1) // m_tile) * m_tile
    counts = jnp.bincount(flat_e, length=n_experts)
    padded = ((counts + m_tile - 1) // m_tile) * m_tile
    starts = jnp.concatenate([jnp.zeros(1, padded.dtype),
                              jnp.cumsum(padded)])[:-1]
    rank_in_e = jnp.arange(S) - jnp.searchsorted(se, se, side="left")
    dst = starts[se] + rank_in_e
    blk_start = jnp.arange(M // m_tile) * m_tile
    block_expert = jnp.clip(jnp.searchsorted(starts + padded, blk_start,
                                             side="right"), 0, n_experts - 1)
    return {"order": order, "counts": counts, "starts": starts, "dst": dst,
            "block_expert": block_expert, "M": M}


@pytest.mark.parametrize("E,k,shared", GRID)
@pytest.mark.parametrize("use_pallas", [True, False])
def test_moe_block_matches_reference(E, k, shared, use_pallas):
    B, T, D, FF = 2, 24, 16, 32
    p = _ref_params(E + k, D, FF, E, shared)
    x = _x((B, T, D), E)
    want, aux = ref_moe.moe_block(p, jnp.asarray(x), top_k=k, n_experts=E,
                                  m_tile=8, use_pallas=True)
    before = grouped_matmul.launches
    got, got_aux = port_moe.moe_block(
        port_moe.params_from_jax(p, "cpu"), torch.from_numpy(x), top_k=k,
        n_experts=E, m_tile=8, use_pallas=use_pallas)
    assert grouped_matmul.launches == before
    _close(got, want)
    _aux_close(got_aux, aux)


@pytest.mark.parametrize("E,k,shared", GRID)
def test_moe_capacity_matches_reference(E, k, shared):
    B, T, D, FF = 2, 24, 16, 32
    p = _ref_params(E + k, D, FF, E, shared)
    x = _x((B, T, D), E + 1)
    tp = port_moe.params_from_jax(p, "cpu")
    for cf in (8.0, 0.5):          # ample capacity, then tokens dropped
        want, aux = ref_moe.moe_capacity(p, jnp.asarray(x), top_k=k,
                                         n_experts=E, capacity_factor=cf)
        got, got_aux = port_moe.moe_capacity(tp, torch.from_numpy(x),
                                             top_k=k, n_experts=E,
                                             capacity_factor=cf)
        _close(got, want)
        _aux_close(got_aux, aux)


@pytest.mark.parametrize("groups", [1, 4])
def test_moe_capacity_dispatch_groups_match_reference(groups):
    """DISPATCH_GROUPS > 1 (groups of >= 64 tokens, per-group capacity)
    against the reference's vmap path, with ample and with tight
    capacity."""
    B, T, D, FF, E, k = 2, 256, 16, 32, 4, 2
    p = _ref_params(9, D, FF, E, 0)
    x = _x((B, T, D), 10)
    tp = port_moe.params_from_jax(p, "cpu")
    ref_moe.DISPATCH_GROUPS = port_moe.DISPATCH_GROUPS = groups
    try:
        for cf in (8.0, 0.5):
            want, aux = ref_moe.moe_capacity(p, jnp.asarray(x), top_k=k,
                                             n_experts=E, capacity_factor=cf)
            got, got_aux = port_moe.moe_capacity(tp, torch.from_numpy(x),
                                                 top_k=k, n_experts=E,
                                                 capacity_factor=cf)
            _close(got, want)
            _aux_close(got_aux, aux)
    finally:
        ref_moe.DISPATCH_GROUPS = port_moe.DISPATCH_GROUPS = 1


def test_dispatch_groups_equivalent_and_guarded():
    """The port's grouped path equals its single-group path when capacity
    is ample, and decode-sized token counts keep the single group."""
    tp = port_moe.params_from_jax(_ref_params(11, 16, 32, 4, 0), "cpu")
    for (B, T), exact in (((2, 256), False), ((2, 16), True)):
        x = torch.from_numpy(_x((B, T, 16), 12))
        y1, a1 = port_moe.moe_capacity(tp, x, top_k=2, n_experts=4,
                                       capacity_factor=8.0)
        port_moe.DISPATCH_GROUPS = 4
        try:
            y2, a2 = port_moe.moe_capacity(tp, x, top_k=2, n_experts=4,
                                           capacity_factor=8.0)
        finally:
            port_moe.DISPATCH_GROUPS = 1
        if exact:
            assert torch.equal(y1, y2)
        else:
            assert float((y1 - y2).abs().max()) <= 1e-5
        assert float(a1) == float(a2)


@pytest.mark.parametrize("skew", [0.0, 10.0])
@pytest.mark.parametrize("E,k,m_tile", [(4, 1, 8), (16, 4, 8), (8, 2, 128)])
def test_dispatch_metadata_identical(E, k, m_tile, skew):
    """Router ids, then every piece of the block dispatch computed from
    them, equal the reference's; with skew (router biased to expert 0, as
    tests/test_moe.py does) expert 0 carries the largest load."""
    B, T, D, FF = 1, 64, 8, 16
    p = _ref_params(3, D, FF, E, 0, skew=skew)
    x = _x((B, T, D), 4)
    _, ref_ids, _ = ref_moe._route(p, jnp.asarray(x.reshape(-1, D)), k, True)
    tp = port_moe.params_from_jax(p, "cpu")
    _, ids, _ = port_moe._route(tp, torch.from_numpy(x.reshape(-1, D)), k,
                                True)
    assert np.array_equal(ids.numpy(), np.asarray(ref_ids))
    want = _ref_dispatch(ref_ids, E, m_tile)
    meta = port_moe.block_dispatch(ids, E, m_tile)
    assert meta["M"] == want["M"]
    for key in ("order", "counts", "starts", "dst", "block_expert"):
        assert np.array_equal(meta[key].numpy(), np.asarray(want[key])), key
    assert meta["block_expert"].dtype == torch.int32
    if skew:
        assert int(meta["counts"][0]) == int(meta["counts"].max())


def test_skewed_router_block_dispatch_matches_reference():
    """tests/test_moe.py's extreme skew: every token to expert 0, dropless."""
    B, T, D, FF, E, k = 1, 64, 8, 16, 4, 1
    p = _ref_params(3, D, FF, E, 0, skew=10.0)
    x = _x((B, T, D), 4)
    want, aux = ref_moe.moe_block(p, jnp.asarray(x), top_k=k, n_experts=E,
                                  m_tile=8, use_pallas=True)
    tp = port_moe.params_from_jax(p, "cpu")
    for use_pallas in (True, False):
        got, got_aux = port_moe.moe_block(tp, torch.from_numpy(x), top_k=k,
                                          n_experts=E, m_tile=8,
                                          use_pallas=use_pallas)
        _close(got, want)
        _aux_close(got_aux, aux)


def test_router_ties_go_to_the_lower_expert_as_in_the_reference():
    """A saturated router (one logit far above the rest: the softmax's
    tail is exactly 0 in fp32) leaves the other experts tied; the port's
    top-k takes them by ascending expert id, as ``jax.lax.top_k`` does."""
    E, k, D = 8, 3, 4
    x = np.zeros((5, D), np.float32)
    x[:, 0] = [1.0, 2.0, 1.25, 3.0, 1.5]      # exp(-200 x) is 0 in fp32
    router = np.zeros((D, E), np.float32)
    router[0, 5] = 200.0                     # expert 5 takes every token
    rw, rids, _ = ref_moe._route({"router": jnp.asarray(router)},
                                 jnp.asarray(x), k, True)
    w, ids, _ = port_moe._route({"router": torch.from_numpy(router)},
                                torch.from_numpy(x), k, True)
    assert np.asarray(rids).tolist() == [[5, 0, 1]] * 5
    assert ids.tolist() == np.asarray(rids).tolist()
    np.testing.assert_array_equal(w.numpy(), np.asarray(rw))


def test_integer_valued_moe_block_is_exact():
    """Integer weights and inputs with one expert per token (k=1,
    unnormalized gates, so every gate is a probability): h, g and the
    expert product are exact in fp32, and the products x @ wi, x @ wg of
    both sides equal; the dispatch's GEMMs must then match the reference's
    bit for bit."""
    B, T, D, FF, E = 1, 32, 8, 16, 4
    rng = np.random.default_rng(7)
    p = _ref_params(1, D, FF, E, 0)
    for key in ("wi", "wg", "wo"):
        p[key] = jnp.asarray(rng.integers(-2, 3, np.shape(p[key])),
                             jnp.float32)
    x = rng.integers(-2, 3, (B, T, D)).astype(np.float32)
    tp = port_moe.params_from_jax(p, "cpu")
    _, ids, _ = port_moe._route(tp, torch.from_numpy(x.reshape(-1, D)), 1,
                                False)
    meta = port_moe.block_dispatch(ids, E, 8)
    xs = torch.zeros((meta["M"], D))
    xs[meta["dst"]] = torch.from_numpy(x.reshape(-1, D))[meta["order"]]
    from repro.kernels.ops import grouped_matmul_pallas as ref_gmm
    for key in ("wi", "wg"):
        got = grouped_matmul(xs, tp[key], meta["block_expert"], m_tile=8)
        want = np.asarray(ref_gmm(jnp.asarray(xs.numpy()), p[key],
                                  jnp.asarray(meta["block_expert"].numpy()),
                                  m_tile=8))
        assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", ["dbrx-132b", "deepseek-moe-16b"])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_reduced_configs_end_to_end(name, dtype):
    """The reduced smoke configs (deepseek's has a shared expert) through
    params_from_jax in fp32 and bf16 weights, activations in the same
    dtype, the reference's default tiles (m_tile=128)."""
    cfg = get_reduced(name)
    assert dataclasses.asdict(port_get_reduced(name)) == \
        dataclasses.asdict(cfg)
    p = ref_moe.init_moe(jax.random.PRNGKey(0), cfg.d_model, cfg.d_ff,
                         cfg.n_experts, n_shared=cfg.n_shared_experts,
                         dtype=dtype)
    xj = jnp.asarray(_x((2, 16, cfg.d_model), 1)).astype(dtype)
    tp = port_moe.params_from_jax(p, "cpu")
    xt = to_torch(xj)
    want_dtype = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    assert tp["wi"].dtype == want_dtype and xt.dtype == want_dtype
    kw = dict(top_k=cfg.top_k, n_experts=cfg.n_experts)
    want, aux = ref_moe.moe_block(p, xj, **kw)
    for use_pallas in (True, False):
        got, got_aux = port_moe.moe_block(tp, xt, use_pallas=use_pallas, **kw)
        assert got.dtype == want_dtype
        _close(got, want, dtype)
        _aux_close(got_aux, aux)
    want, aux = ref_moe.moe_capacity(
        p, xj, capacity_factor=cfg.moe_capacity_factor, **kw)
    got, got_aux = port_moe.moe_capacity(
        tp, xt, capacity_factor=cfg.moe_capacity_factor, **kw)
    _close(got, want, dtype)
    _aux_close(got_aux, aux)


@pytest.mark.parametrize("dtype", [None, torch.float32])
@pytest.mark.parametrize("shared", [0, 2])
def test_init_moe_shapes_and_dtypes_match_reference(dtype, shared):
    kw = {} if dtype is None else {"dtype": jnp.float32}
    ref = ref_moe.init_moe(jax.random.PRNGKey(0), 16, 24, 4, n_shared=shared,
                           **kw)
    kw = {} if dtype is None else {"dtype": dtype}
    got = port_moe.init_moe(torch.Generator().manual_seed(0), 16, 24, 4,
                            n_shared=shared, device="cpu", **kw)
    again = port_moe.init_moe(torch.Generator().manual_seed(0), 16, 24, 4,
                              n_shared=shared, device="cpu", **kw)

    def leaves(tree, prefix=""):
        for k, v in sorted(tree.items()):
            if isinstance(v, dict):
                yield from leaves(v, prefix + k + ".")
            else:
                yield prefix + k, v

    ref_leaves = dict(leaves(ref))
    got_leaves = dict(leaves(got))
    assert sorted(ref_leaves) == sorted(got_leaves)
    for key, v in ref_leaves.items():
        t = got_leaves[key]
        assert tuple(t.shape) == tuple(v.shape), key
        assert str(t.dtype).split(".")[-1] == str(v.dtype), key
        assert torch.equal(t, dict(leaves(again))[key])       # seeded
    assert abs(got["wi"].float().std().item() - 16 ** -0.5) < 0.05


def test_params_from_jax_keeps_bf16_bits():
    p = ref_moe.init_moe(jax.random.PRNGKey(2), 8, 16, 2, n_shared=1)
    tp = port_moe.params_from_jax(p, "cpu")
    for key in ("wi", "wg", "wo"):
        assert tp[key].dtype == torch.bfloat16
        assert np.array_equal(tp[key].view(torch.int16).numpy(),
                              np.asarray(p[key]).view(np.int16))
    assert tp["router"].dtype == torch.float32
    assert tp["shared"]["wi"].dtype == torch.bfloat16


@pytest.mark.parametrize("act", ["silu", "gelu", "relu", "gelu_tanh"])
@pytest.mark.parametrize("gated", [True, False])
def test_apply_mlp_matches_reference(act, gated):
    p = ref_init_mlp(jax.random.PRNGKey(1), 16, 40, gated=gated,
                     dtype=jnp.float32)
    x = _x((6, 16), 2)
    want = ref_apply_mlp(p, jnp.asarray(x), act=act, gated=gated)
    tp = port_moe.params_from_jax(p, "cpu")
    _close(apply_mlp(tp, torch.from_numpy(x), act=act, gated=gated), want)
    # bf16 activations with fp32 weights promote as jnp.dot does
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = ref_apply_mlp(p, xb, act=act, gated=gated)
    got = apply_mlp(tp, to_torch(xb), act=act, gated=gated)
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    _close(got, want)


def test_init_mlp_shapes():
    for gated in (True, False):
        got = init_mlp(torch.Generator().manual_seed(0), 8, 12, gated=gated)
        want = ref_init_mlp(jax.random.PRNGKey(0), 8, 12, gated=gated)
        assert sorted(got) == sorted(want)
        for k in want:
            assert tuple(got[k].shape) == tuple(want[k].shape)
            assert got[k].dtype == torch.bfloat16


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_moe.init_moe(torch.Generator(), 8, 16, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_moe.params_from_jax({"router": np.zeros((8, 2), np.float32)})
