"""The port's AdamW (``repro_torch.optim.adamw``) against the reference's
(``repro.optim.adamw``, run op by op as ``tests/test_optim.py`` runs it)
and against numpy; the reference's four tests, port-side.

The port updates in place: a test that compares a state before and after
an update keeps a clone of the earlier one.

Parity bounds, elementwise, within 2 fp32 ulp of the reference's value:
* gradients drawn on a grid of multiples of 2**-3 (|g| <= 4), so every
  square and every partial sum of the global norm is exact in fp32 in any
  order: the clip scale is then the same number on both sides, and every
  later operation is the same IEEE operation in the same order;
* without clipping (``max_grad_norm=None``), gradients from a normal
  draw.
The norm on normal draws and the cosine schedule carry bounds of their
own (see their tests).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as R
from repro_torch.models.layers import to_torch
from repro_torch.optim import adamw as P
from repro_torch.optim.adamw import (adamw_init, adamw_update,
                                     clip_by_global_norm, cosine_schedule)


# -- the reference's tests (tests/test_optim.py), port-side -------------------
def test_adamw_matches_reference():
    p = {"w": torch.from_numpy(np.random.default_rng(0).normal(size=(5,))
                               .astype(np.float32))}
    g = {"w": torch.from_numpy(np.random.default_rng(1).normal(size=(5,))
                               .astype(np.float32))}
    p0 = p["w"].numpy().copy()
    st = adamw_init(p)
    lr, b1, b2, eps, wd = 1e-2, 0.9, 0.95, 1e-8, 0.1
    new_p, st2, _ = adamw_update(g, st, p, lr=lr, b1=b1, b2=b2, eps=eps,
                                 weight_decay=wd, max_grad_norm=None)
    # numpy reference
    m = (1 - b1) * g["w"].numpy()
    v = (1 - b2) * g["w"].numpy() ** 2
    mh, vh = m / (1 - b1), v / (1 - b2)
    ref = p0 - lr * (mh / (np.sqrt(vh) + eps) + wd * p0)
    np.testing.assert_allclose(new_p["w"].numpy(), ref, atol=1e-6)
    assert int(st2.step) == 1


def test_bf16_params_fp32_master():
    p = {"w": torch.full((3,), 0.1, dtype=torch.bfloat16)}
    st = adamw_init(p)
    assert st.master["w"].dtype == torch.float32
    before = st.master["w"].clone()
    g = {"w": torch.full((3,), 1.0, dtype=torch.bfloat16)}
    new_p, st2, _ = adamw_update(g, st, p, lr=1e-3)
    assert new_p["w"].dtype == torch.bfloat16
    # master moved even if bf16 quantization hides tiny deltas
    assert not torch.allclose(st2.master["w"], before)


def test_clipping():
    g = {"a": torch.full((4,), 3.0)}
    clipped, norm = clip_by_global_norm(g, 1.0)
    assert float(norm) == pytest.approx(6.0)
    np.testing.assert_allclose(clipped["a"].numpy(), 0.5, rtol=1e-5)


def test_cosine_schedule_shape():
    s = [float(cosine_schedule(torch.tensor(t), peak_lr=1.0, warmup=10,
                               total=100)) for t in range(100)]
    assert s[0] == 0.0 and s[10] == pytest.approx(1.0, abs=1e-2)
    assert s[99] < 0.2 and min(s[10:]) >= 0.1 * 1.0 - 1e-6  # floor


# -- against the reference's functions ----------------------------------------
SHAPES = {"layers": {"wi": (3, 17, 40), "ln": (3, 17)}, "head": (17, 11),
          "b": (5,)}


def _draw(rng, grid):
    def one(shape):
        if grid:
            return (rng.integers(-32, 33, shape) / 8).astype(np.float32)
        return rng.normal(size=shape).astype(np.float32)
    return jax.tree.map(one, SHAPES, is_leaf=lambda x: isinstance(x, tuple))


def _pair(tree, dtype):
    """(reference jnp tree, port torch tree) of the same values in
    ``dtype`` (fp32 or bf16)."""
    jt = jax.tree.map(lambda a: jnp.asarray(a).astype(
        jnp.bfloat16 if dtype == "bf16" else jnp.float32), tree)
    return jt, jax.tree.map(lambda a: to_torch(np.asarray(a)), jt)


def _within_ulp(got, want, n=2):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    bound = n * np.spacing(np.abs(want).astype(np.float32))
    bad = np.abs(got - want) > bound
    assert not bad.any(), (got[bad][:5], want[bad][:5])


def test_adamw_init_against_reference():
    rng = np.random.default_rng(0)
    for dtype in ("fp32", "bf16"):
        jp, tp = _pair(_draw(rng, False), dtype)
        rs, ps = R.adamw_init(jp), adamw_init(tp)
        assert ps.step.dtype == torch.int32 and ps.step.dim() == 0
        assert int(ps.step) == int(rs.step) == 0
        for field in ("m", "v", "master"):
            a = jax.tree_util.tree_leaves(getattr(rs, field))
            b = P.tree_leaves(getattr(ps, field))
            assert len(a) == len(b)
            for x, y in zip(a, b):
                assert y.dtype == torch.float32
                assert np.array_equal(np.asarray(x), y.numpy())
        # every tensor of the state is its own (the update writes in place)
        ptrs = [t.data_ptr() for t in P.tree_leaves(ps) + P.tree_leaves(tp)]
        assert len(set(ptrs)) == len(ptrs)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("clip", [True, False], ids=["clip", "noclip"])
def test_adamw_update_against_reference(dtype, clip, monkeypatch):
    """Three updates (bias corrections of steps 1-3, the cosine schedule's
    lr as a tensor), param dtype fp32 or bf16 with an fp32 master."""
    monkeypatch.setattr(P, "UPDATE_CHUNK", 64)   # chunks cut the leaves
    rng = np.random.default_rng(1)
    jp, tp = _pair(_draw(rng, False), dtype)
    rs, ps = R.adamw_init(jp), adamw_init(tp)
    kw = dict(max_grad_norm=1.0 if clip else None)
    for _ in range(3):
        jg, tg = _pair(_draw(rng, clip), "fp32")
        rlr = R.cosine_schedule(rs.step + 1, peak_lr=1e-2, warmup=2,
                                total=10)
        plr = cosine_schedule(ps.step + 1, peak_lr=1e-2, warmup=2, total=10)
        assert float(plr) == float(rlr)
        jp, rs, rm = R.adamw_update(jg, rs, jp, lr=rlr, **kw)
        tp, ps, pm = adamw_update(tg, ps, tp, lr=plr, **kw)
        assert float(pm["grad_norm"]) == float(rm["grad_norm"])
        assert int(ps.step) == int(rs.step)
        for field in ("m", "v", "master"):
            for x, y in zip(jax.tree_util.tree_leaves(getattr(rs, field)),
                            P.tree_leaves(getattr(ps, field))):
                _within_ulp(y, x)
        for x, y in zip(jax.tree_util.tree_leaves(jp), P.tree_leaves(tp)):
            assert y.dtype == (torch.bfloat16 if dtype == "bf16"
                               else torch.float32)
            _within_ulp(y, x)


def test_clip_by_global_norm_against_reference():
    """On the grid the norm and every clipped entry are equal. On normal
    draws the two sum n squares in different orders: the recursive
    summation bound, (n - 1) * 2**-24 of the sum for each order, gives the
    norm within n * 2**-24 relative."""
    rng = np.random.default_rng(2)
    for grid in (True, False):
        for dtype in ("fp32", "bf16"):
            jg, tg = _pair(_draw(rng, grid), dtype)
            rc, rn = R.clip_by_global_norm(jg, 1.0)
            pc, pn = clip_by_global_norm(tg, 1.0)
            n = sum(t.numel() for t in P.tree_leaves(tg))
            assert abs(float(pn) - float(rn)) <= n * 2.0 ** -24 * float(rn)
            if grid:    # the same scale: every entry the same product
                assert float(pn) == float(rn)
                for x, y in zip(jax.tree_util.tree_leaves(rc),
                                P.tree_leaves(pc)):
                    assert y.dtype == torch.float32
                    assert np.array_equal(np.asarray(x), y.numpy())


@pytest.mark.parametrize("peak,warmup,total", [(1.0, 10, 100),
                                               (3e-4, 2, 6),
                                               (5e-3, 0, 40)])
def test_cosine_schedule_against_reference(peak, warmup, total):
    """Within 2 ulp of the reference's value, plus one ulp of the cosine
    scaled by ``peak * (1 - floor) / 2``: neither package's fp32 ``cos``
    is correctly rounded and they differ by an ulp at some arguments
    (5 of 91 points of [0, pi]), which ``1 + cos`` near the end of the
    schedule carries into several ulp of the rate."""
    for t in range(100):
        want = float(R.cosine_schedule(jnp.asarray(t, jnp.int32),
                                       peak_lr=peak, warmup=warmup,
                                       total=total))
        got = cosine_schedule(torch.tensor(t, dtype=torch.int32),
                              peak_lr=peak, warmup=warmup, total=total)
        assert got.dtype == torch.float32
        bound = 2 * np.spacing(np.float32(want)) + \
            peak * 0.9 * 0.5 * 2.0 ** -23
        assert abs(float(got) - want) <= bound, (t, float(got), want)


def test_compress_grads_against_reference():
    jg, tg = _pair(_draw(np.random.default_rng(3), False), "fp32")
    want = jax.tree_util.tree_leaves(R.compress_grads(jg))
    got = P.tree_leaves(P.compress_grads(tg))
    for x, y in zip(want, got):
        assert y.dtype == torch.bfloat16
        assert np.array_equal(np.asarray(x).view(np.uint16),
                              y.view(torch.int16).numpy().view(np.uint16))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chunked_walk_equals_whole_leaf_update(dtype, monkeypatch):
    """The walk of a stacked leaf a chunk at a time (chunks cutting layer
    slices, a last chunk short) writes the same bits as one whole-leaf
    chunk, clipping included: the gradients lie on a grid of multiples of
    2**-3, so the global norm is the same number in any summation
    order."""
    gen = torch.Generator().manual_seed(4)

    def tree(grid):
        def draw(shape):
            if grid:
                return torch.randint(-32, 33, shape, generator=gen) / 8
            return torch.randn(shape, generator=gen)
        return {"layers": {"wi": draw((4, 9, 13)), "ln": draw((4, 9))},
                "head": draw((9, 7))}

    p = P.tree_map(lambda t: t.to(dtype), tree(False))
    grads = [P.tree_map(lambda t: t.to(dtype), tree(True)) for _ in range(3)]
    runs = []
    for chunk in (1 << 30, 50, 117):
        monkeypatch.setattr(P, "UPDATE_CHUNK", chunk)
        pp = P.tree_map(torch.clone, p)
        st = adamw_init(pp)
        for g in grads:
            pp, st, m = adamw_update(g, st, pp, lr=1e-2)
        runs.append((pp, st, m["grad_norm"]))
    (p0, s0, n0) = runs[0]
    assert float(n0) > 1.0                      # the clip is active
    for pp, st, n in runs[1:]:
        assert torch.equal(n, n0)
        for a, b in zip(P.tree_leaves((p0, s0)), P.tree_leaves((pp, st))):
            assert torch.equal(a, b)


def test_update_is_in_place():
    p = {"w": torch.randn(6, 4)}
    st = adamw_init(p)
    ptrs = [t.data_ptr() for t in (p["w"], st.m["w"], st.v["w"],
                                   st.master["w"])]
    p2, st2, _ = adamw_update({"w": torch.randn(6, 4)}, st, p, lr=1e-2)
    assert p2["w"] is p["w"] and st2.m["w"] is st.m["w"]
    assert [t.data_ptr() for t in (p2["w"], st2.m["w"], st2.v["w"],
                                   st2.master["w"])] == ptrs
    assert int(st.step) == 0 and int(st2.step) == 1
    with pytest.raises(ValueError, match="differ in leaves"):
        adamw_update({"w": torch.zeros(6, 4), "x": torch.zeros(1)}, st2, p2,
                     lr=1e-2)
