"""The port's Mamba-2 SSD block against the reference
(``repro.models.ssm``) and against the naive recurrence oracle of
``tests/test_ssm.py``, on the same seeded inputs and the same weights (the
reference's ``init_mamba2``).

Tolerances, stated once:
* the scan in fp32 against the reference: ``1e-5 * max|ref|`` (the same
  einsums, contracted in another order);
* the scan against the oracle: the reference's own ``atol=rtol=1e-4``
  (``tests/test_ssm.py:40``), and ``1e-5`` for state threading;
* the block in bf16 (weights and activations bf16, the scan in fp32):
  the reference's mamba bound ``atol=rtol=2e-3`` (``tests/test_serve.py:74``)
  plus one bf16 ulp of the magnitude, ``2**-8 * max|ref|``: each
  projection's output is rounded to bf16 and may land on the other
  neighbour of a rounding boundary.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.ssm as RS
import repro_torch.models.ssm as PS
from repro_torch.models.layers import to_torch


def naive_ssd(x, dt, A, B, C, h=None):
    """The recurrence, step by step, in fp64: y [b,T,H,P], h [b,H,N,P]."""
    x, dt, A, B, C = (np.asarray(a, np.float64) for a in (x, dt, A, B, C))
    b, T, H, P = x.shape
    N = B.shape[-1]
    h = np.zeros((b, H, N, P)) if h is None else np.asarray(h, np.float64)
    ys = []
    for t in range(T):
        dec = np.exp(dt[:, t] * A[None])
        h = dec[:, :, None, None] * h + np.einsum(
            "bn,bh,bhp->bhnp", B[:, t], dt[:, t], x[:, t])
        ys.append(np.einsum("bn,bhnp->bhp", C[:, t], h))
    return np.stack(ys, 1), h


def _inputs(T, seed, b=2, H=3, P=4, N=5):
    r = np.random.default_rng(seed)
    x = r.normal(size=(b, T, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(r.normal(size=(b, T, H)))).astype(np.float32)
    A = -np.exp(r.normal(size=(H,))).astype(np.float32)
    B = r.normal(size=(b, T, N)).astype(np.float32)
    C = r.normal(size=(b, T, N)).astype(np.float32)
    return x, dt, A, B, C


def _t(a):
    return to_torch(np.asarray(a))


def _close(got, want, rel=1e-5):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= rel * float(np.abs(want).max())


@pytest.mark.parametrize("T,chunk", [(8, 4), (16, 8), (32, 16), (64, 4),
                                     (64, 16), (16, 128)])
def test_ssd_against_reference_and_oracle(T, chunk):
    args = _inputs(T, T + chunk)
    y, h = PS.ssd_chunked(*(_t(a) for a in args), chunk=chunk)
    ry, rh = RS.ssd_chunked(*(jnp.asarray(a) for a in args), chunk=chunk)
    assert h.shape == (2, 3, 5, 4)          # [b, H, N, P], as the code
    _close(y, ry)
    _close(h, rh)
    oy, oh = naive_ssd(*args)
    np.testing.assert_allclose(y.numpy(), oy, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(h.numpy(), oh, atol=1e-4, rtol=1e-4)


def test_ssd_uneven_chunk_raises():
    with pytest.raises(ValueError, match="multiple"):
        PS.ssd_chunked(*(_t(a) for a in _inputs(12, 0)), chunk=8)


def test_initial_state_threading():
    x, dt, A, B, C = (_t(a) for a in _inputs(16, 1, b=1, H=2, P=4, N=3))
    y_full, h_full = PS.ssd_chunked(x, dt, A, B, C, chunk=8)
    y1, h1 = PS.ssd_chunked(x[:, :8], dt[:, :8], A, B[:, :8], C[:, :8],
                            chunk=8)
    y2, h2 = PS.ssd_chunked(x[:, 8:], dt[:, 8:], A, B[:, 8:], C[:, 8:],
                            h0=h1, chunk=8)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(),
                               y_full.numpy(), atol=1e-5)
    np.testing.assert_allclose(h2.numpy(), h_full.numpy(), atol=1e-5)
    # and against the reference given the same h0
    ry2, rh2 = RS.ssd_chunked(*(jnp.asarray(a.numpy()) for a in
                                (x[:, 8:], dt[:, 8:], A, B[:, 8:], C[:, 8:])),
                              h0=jnp.asarray(h1.numpy()), chunk=8)
    _close(y2, ry2)
    _close(h2, rh2)


D, DI, HD, ST = 16, 32, 8, 5


@pytest.fixture(scope="module", params=["fp32", "bf16"])
def block(request):
    dt = jnp.float32 if request.param == "fp32" else jnp.bfloat16
    p = RS.init_mamba2(jax.random.PRNGKey(7), D, DI, HD, ST, dtype=dt)
    # non-zero conv bias and norm weight, so their paths are exercised
    p = dict(p, conv_b=(0.1 * p["conv_w"][0]).astype(dt),
             norm_w=(0.5 * p["w_in"][0, :DI]).astype(dt))
    x = np.random.default_rng(8).normal(size=(2, 16, D)).astype(np.float32)
    return request.param, p, jnp.asarray(x).astype(dt), \
        {k: to_torch(v) for k, v in p.items()}


def _bclose(got, want, prec):
    if prec == "fp32":
        return _close(got, want)
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(
        got, want, rtol=2e-3, atol=2e-3 + 2.0 ** -8 * float(np.abs(want).max()))


def test_causal_conv(block):
    prec, p, x, pt = block
    xi = jnp.dot(x, p["w_in"])[..., DI:2 * DI + 2 * ST]
    _bclose(PS._causal_conv(_t(xi), pt["conv_w"], pt["conv_b"]),
            RS._causal_conv(xi, p["conv_w"], p["conv_b"]), prec)


def test_forward_with_state_and_decode(block):
    """The block over 16 tokens with its state, then 4 decode steps from
    that state, each against the reference's; then the whole sequence
    through decode from a zero cache equals the forward pass (the
    reference's own consistency check, on the port)."""
    prec, p, x, pt = block
    kw = dict(head_dim=HD, state=ST)
    ry, rc = RS.mamba2_forward(p, x[:, :12], chunk=4, return_state=True, **kw)
    py, pc = PS.mamba2_forward(pt, _t(x[:, :12]), chunk=4, return_state=True,
                               **kw)
    _bclose(py, ry, prec)
    _bclose(pc.ssm, rc.ssm, prec)
    _bclose(pc.conv, rc.conv, prec)
    for t in range(12, 16):
        ry, rc = RS.mamba2_decode(p, x[:, t:t + 1], rc, **kw)
        py, pc2 = PS.mamba2_decode(pt, _t(x[:, t:t + 1]), pc, **kw)
        assert pc2 is pc                     # written in place
        _bclose(py, ry, prec)
    _bclose(pc.ssm, rc.ssm, prec)
    _bclose(pc.conv, rc.conv, prec)

    if prec == "fp32":
        full, cf = PS.mamba2_forward(pt, _t(x), chunk=8, return_state=True,
                                     **kw)
        cache = PS.MambaCache.create(2, 4, DI + 2 * ST, DI // HD, ST, HD)
        ys = [PS.mamba2_decode(pt, _t(x[:, t:t + 1]), cache, **kw)[0]
              for t in range(16)]
        np.testing.assert_allclose(torch.cat(ys, 1).numpy(), full.numpy(),
                                   atol=1e-5)
        np.testing.assert_allclose(cache.ssm.numpy(), cf.ssm.numpy(),
                                   atol=1e-5)
        np.testing.assert_allclose(cache.conv.numpy(), cf.conv.numpy(),
                                   atol=1e-6)


@pytest.mark.parametrize("T", [1, 2])
def test_short_prompt(block, T):
    """A prompt shorter than the conv history (K-1 = 3): the port raises at
    prefill; the reference returns a conv cache of fewer than K-1 rows,
    which its decode step's concat cannot take (a reference behaviour)."""
    prec, p, x, pt = block
    with pytest.raises(ValueError, match="shorter than the conv"):
        PS.mamba2_forward(pt, _t(x[:, :T]), head_dim=HD, state=ST,
                          return_state=True)
    _, rc = RS.mamba2_forward(p, x[:, :T], head_dim=HD, state=ST,
                              return_state=True)
    assert rc.conv.shape[1] < 3
    # without the state the port runs the short prompt like the reference
    _bclose(PS.mamba2_forward(pt, _t(x[:, :T]), head_dim=HD, state=ST),
            RS.mamba2_forward(p, x[:, :T], head_dim=HD, state=ST), prec)


def test_init_mamba2_shapes():
    g = torch.Generator().manual_seed(0)
    p = PS.init_mamba2(g, D, DI, HD, ST, device="cpu")
    r = RS.init_mamba2(jax.random.PRNGKey(0), D, DI, HD, ST)
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in p.items()} == \
        {k: (tuple(v.shape), str(v.dtype)) for k, v in r.items()}
    sp = torch.nn.functional.softplus(p["dt_bias"])
    assert bool(((sp > 1e-3 - 1e-6) & (sp < 0.1 + 1e-6)).all())
