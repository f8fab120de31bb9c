"""The port's norms, rotary embedding, soft-cap and initialisers against
the reference (``repro.models.layers``) on the same seeded numpy inputs.

Tolerances, stated once:
* fp32 inputs: within ``1e-5 * max|ref|`` (both sides compute in fp32 and
  differ only in the order of a few reductions);
* bf16 inputs: both sides compute in fp32 and round the result to bf16,
  so an element may land on the other neighbour of a rounding boundary:
  within one bf16 ulp of the magnitude, ``2**-8 * max|ref|``.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.models.layers as R
import repro_torch.models.layers as P

DTYPES = {"fp32": np.float32, "bf16": ml_dtypes.bfloat16}


def _x(shape, seed, dtype, scale=1.0):
    x = np.random.default_rng(seed).normal(size=shape) * scale
    return x.astype(np.float32).astype(DTYPES[dtype])


def _t(a):
    return P.to_torch(a)


def _close(got, want, dtype):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    tol = (1e-5 if dtype == "fp32" else 2.0 ** -8) * float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= tol


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_rms_norm(dtype):
    x, w = _x((2, 5, 48), 0, dtype, 3.0), _x((48,), 1, dtype, 0.1)
    got = P.rms_norm(_t(x), _t(w))
    assert got.dtype == _t(x).dtype
    _close(got, R.rms_norm(jnp.asarray(x), jnp.asarray(w)), dtype)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_layer_norm(dtype):
    x = _x((3, 4, 40), 2, dtype, 2.0) + np.asarray(1.5, DTYPES[dtype])
    w, b = _x((40,), 3, dtype), _x((40,), 4, dtype)
    got = P.layer_norm(_t(x), _t(w), _t(b))
    assert got.dtype == _t(x).dtype
    _close(got, R.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)),
           dtype)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("cap", [30.0, 50.0])
def test_soft_cap(dtype, cap):
    x = _x((4, 64), 5, dtype, 40.0)
    _close(P.soft_cap(_t(x), cap), R.soft_cap(jnp.asarray(x), cap), dtype)


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope_table(theta):
    pos = np.arange(37, dtype=np.int32) + 5
    cos, sin = P.rope_table(torch.from_numpy(pos), 96, theta)
    rc, rs = R.rope_table(jnp.asarray(pos), 96, theta)
    # angles up to 41 rad: fp32 rounds the angle to ~4e-6, in either order
    assert cos.shape == (37, 48)
    assert float(np.abs(cos.numpy() - np.asarray(rc)).max()) <= 1e-5
    assert float(np.abs(sin.numpy() - np.asarray(rs)).max()) <= 1e-5


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_apply_rope(dtype):
    x = _x((2, 9, 4, 16), 6, dtype)
    pos = np.arange(9)
    rc, rs = R.rope_table(jnp.asarray(pos), 16, 1e4)
    got = P.apply_rope(_t(x), _t(np.asarray(rc)), _t(np.asarray(rs)))
    assert got.dtype == _t(x).dtype
    _close(got, R.apply_rope(jnp.asarray(x), rc, rs), dtype)


def test_embed_init_scale_and_dtype():
    g = torch.Generator().manual_seed(0)
    e = P.embed_init(g, 512, 64, device="cpu")
    assert e.shape == (512, 64) and e.dtype == torch.bfloat16
    assert abs(float(e.float().std()) - 0.02) < 1e-3
    assert abs(float(e.float().mean())) < 1e-3


def test_meta_device_draws_nothing():
    """On meta the initialisers take no generator and allocate nothing."""
    e = P.embed_init(None, 256000, 4608, device="meta")
    w = P.dense_init(None, 4608, 36864, device="meta")
    assert e.is_meta and w.is_meta and w.shape == (4608, 36864)
    assert w.dtype == torch.bfloat16
