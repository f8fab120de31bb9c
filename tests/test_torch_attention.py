"""The port's attention paths against the reference
(``repro.models.attention``): the same weights (the reference's
``init_attention``) and the same inputs (numpy, from a seed), in the
configurations of ``tests/test_attention.py``.

Tolerances, stated once:
* fp32: the reference's own bound against its naive oracle,
  ``atol=2e-5, rtol=1e-4`` (``tests/test_attention.py:53``);
* bf16 (weights and activations bf16, attention math in fp32 on both
  sides): the outputs are rounded to bf16 at the end and after each
  projection, so an element may land on the other neighbour of a rounding
  boundary: ``atol = 2**-8 * max|ref|`` on top of the fp32 bound;
* ``BF16_EINSUMS``: the flag rounds the same operands to bf16 on both
  sides, so the bf16 bound.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.attention as RA
from repro.models.layers import rope_table as ref_rope_table
import repro_torch.models.attention as PA
from repro_torch.models.layers import to_torch

B, T, D, H, KH, DH = 2, 64, 32, 4, 2, 8


def _cast(tree, dtype):
    return jax.tree.map(lambda a: a.astype(dtype), tree)


@pytest.fixture(scope="module", params=["fp32", "bf16"])
def setup(request):
    dt = jnp.float32 if request.param == "fp32" else jnp.bfloat16
    p = RA.init_attention(jax.random.PRNGKey(0), D, H, KH, DH, qkv_bias=True,
                          dtype=jnp.float32)
    # non-zero biases, so the bias path is exercised
    p = dict(p, bq=p["wq"][0] * 0.5, bk=p["wk"][1] * 0.5, bv=p["wv"][2])
    p = _cast(p, dt)
    x = np.random.default_rng(1).normal(size=(B, T, D)).astype(np.float32)
    x = jnp.asarray(x).astype(dt)
    cos, sin = ref_rope_table(jnp.arange(T), DH, 1e4)
    q, k, v = RA._project_qkv(p, x, H, KH, DH, cos, sin)
    pt = {k_: to_torch(a) for k_, a in p.items()}
    return request.param, p, x, (q, k, v), pt


def _t(a):
    return to_torch(np.asarray(a))


def _close(got, want, prec):
    got = got.float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    assert got.shape == want.shape
    atol = 2e-5 + (2.0 ** -8 * float(np.abs(want).max())
                   if prec == "bf16" else 0.0)
    np.testing.assert_allclose(got, want, atol=atol, rtol=1e-4)


def test_project_qkv(setup):
    prec, p, x, (q, k, v), pt = setup
    cos, sin = ref_rope_table(jnp.arange(T), DH, 1e4)
    got = PA._project_qkv(pt, _t(x), H, KH, DH, _t(cos), _t(sin))
    for g, w in zip(got, (q, k, v)):
        _close(g, w, prec)


@pytest.mark.parametrize("causal,window,softcap,qc,kc", [
    (True, None, None, 16, 16), (True, None, None, 64, 8),
    (True, 16, None, 16, 16), (False, None, None, 8, 32),
    (True, None, 30.0, 16, 16), (True, 24, 50.0, 8, 8),
])
def test_chunked_attention(setup, causal, window, softcap, qc, kc):
    prec, _, _, (q, k, v), _ = setup
    want = RA.chunked_attention(q, k, v, causal=causal, window=window,
                                softcap=softcap, q_chunk=qc, kv_chunk=kc)
    got = PA.chunked_attention(_t(q), _t(k), _t(v), causal=causal,
                               window=window, softcap=softcap, q_chunk=qc,
                               kv_chunk=kc)
    assert got.dtype == _t(q).dtype
    _close(got, want, prec)


def test_chunked_attention_uneven_chunks_raise(setup):
    _, _, _, (q, k, v), _ = setup
    with pytest.raises(ValueError, match="multiple"):
        PA.chunked_attention(_t(q), _t(k), _t(v), q_chunk=24, kv_chunk=16)


@pytest.mark.parametrize("window,qc,softcap", [(16, 16, None), (8, 32, None),
                                               (24, 8, 50.0)])
def test_banded_attention(setup, window, qc, softcap):
    prec, _, _, (q, k, v), _ = setup
    want = RA.banded_attention(q, k, v, window=window, q_chunk=qc,
                               softcap=softcap)
    got = PA.banded_attention(_t(q), _t(k), _t(v), window=window, q_chunk=qc,
                              softcap=softcap)
    _close(got, want, prec)


@pytest.mark.parametrize("window,banded", [(None, False), (16, False),
                                           (16, True)])
def test_attention_forward_return_kv(setup, window, banded):
    prec, p, x, _, pt = setup
    kw = dict(n_heads=H, n_kv_heads=KH, d_head=DH, q_chunk=16, kv_chunk=16,
              window=window, use_banded=banded, softcap=30.0)
    want, wkv = RA.attention_forward(p, x, return_kv=True, **kw)
    got, gkv = PA.attention_forward(pt, _t(x), return_kv=True, **kw)
    _close(got, want, prec)
    _close(gkv.k, wkv.k, prec)
    _close(gkv.v, wkv.v, prec)
    assert gkv.k.dtype == _t(x).dtype


@pytest.mark.parametrize("with_start", [False, True])
def test_attention_decode(setup, with_start):
    """Every position of the sequence through the decode step; with
    ``start`` slot 1 begins at position 5 (earlier entries masked)."""
    prec, p, x, _, pt = setup
    kw = dict(n_heads=H, n_kv_heads=KH, d_head=DH, rope_theta=1e4,
              softcap=50.0, window=24)
    start = np.array([0, 5], np.int32) if with_start else None
    rc = RA.KVCache.create(B, T, KH, DH, x.dtype)
    pc = PA.KVCache.create(B, T, KH, DH, _t(x).dtype)
    for t in range(T):
        ro, rc = RA.attention_decode(
            p, x[:, t:t + 1], rc, t, **kw,
            start=None if start is None else jnp.asarray(start))
        po, pc2 = PA.attention_decode(
            pt, _t(x[:, t:t + 1]), pc, t, **kw,
            start=None if start is None else torch.from_numpy(start))
        assert pc2 is pc                     # written in place
        _close(po, ro, prec)
    _close(pc.k, rc.k, prec)
    _close(pc.v, rc.v, prec)


@pytest.mark.parametrize("with_start", [False, True])
def test_attention_decode_shared_tables(setup, with_start):
    """The step's tables built once (``decode_tables``, as ``lm.decode_step``
    shares them across layers) give bit for bit what each call builds."""
    _, _, x, _, pt = setup
    kw = dict(n_heads=H, n_kv_heads=KH, d_head=DH, rope_theta=1e4,
              softcap=50.0, window=24)
    start = torch.tensor([0, 5], dtype=torch.int32) if with_start else None
    own = PA.KVCache.create(B, T, KH, DH, _t(x).dtype)
    shared = PA.KVCache.create(B, T, KH, DH, _t(x).dtype)
    for t in range(T):
        xt = _t(x[:, t:t + 1])
        want, _ = PA.attention_decode(pt, xt, own, t, **kw, start=start)
        tables = PA.decode_tables(T, t, d_head=DH, rope_theta=1e4,
                                  window=24, start=start)
        got, _ = PA.attention_decode(pt, xt, shared, t, **kw, start=start,
                                     tables=tables)
        assert torch.equal(got, want)
    assert torch.equal(shared.k, own.k) and torch.equal(shared.v, own.v)


def test_attention_decode_outside_the_cache_raises(setup):
    _, _, x, _, pt = setup
    pc = PA.KVCache.create(B, 4, KH, DH, _t(x).dtype)
    with pytest.raises(IndexError, match="outside"):
        PA.attention_decode(pt, _t(x[:, :1]), pc, 4, n_heads=H,
                            n_kv_heads=KH, d_head=DH)


def test_bf16_einsums_flag(setup, monkeypatch):
    """The flag on both sides: chunked attention and one decode step."""
    _, p, x, (q, k, v), pt = setup
    monkeypatch.setattr(RA, "BF16_EINSUMS", True)
    monkeypatch.setattr(PA, "BF16_EINSUMS", True)
    want = RA.chunked_attention(q, k, v, q_chunk=16, kv_chunk=16,
                                softcap=30.0)
    got = PA.chunked_attention(_t(q), _t(k), _t(v), q_chunk=16, kv_chunk=16,
                               softcap=30.0)
    _close(got, want, "bf16")
    kw = dict(n_heads=H, n_kv_heads=KH, d_head=DH, rope_theta=1e4)
    rc = RA.KVCache.create(B, T, KH, DH)        # bf16 cache
    pc = PA.KVCache.create(B, T, KH, DH)
    for t in range(3):
        ro, rc = RA.attention_decode(p, x[:, t:t + 1], rc, t, **kw)
        po, pc = PA.attention_decode(pt, _t(x[:, t:t + 1]), pc, t, **kw)
    _close(po, ro, "bf16")


def test_init_attention_shapes():
    g = torch.Generator().manual_seed(0)
    p = PA.init_attention(g, 48, 6, 2, 8, qkv_bias=True, device="cpu")
    r = RA.init_attention(jax.random.PRNGKey(0), 48, 6, 2, 8, qkv_bias=True)
    assert {k: tuple(v.shape) for k, v in p.items()} == \
        {k: tuple(v.shape) for k, v in r.items()}
    assert all(v.dtype == torch.bfloat16 for v in p.values())


def test_mask():
    qpos, kpos = np.arange(8, 16), np.arange(16)
    for causal, window in ((True, None), (True, 4), (False, 3)):
        got = PA._mask(torch.from_numpy(qpos), torch.from_numpy(kpos),
                       causal, window)
        want = RA._mask(jnp.asarray(qpos), jnp.asarray(kpos), causal, window)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
