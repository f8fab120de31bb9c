"""The grouped GEMM (K4's plain version, ``grouped_matmul_pallas`` and the
``grouped_matmul_blocked`` twin, all on the CPU) against the reference's
Pallas kernel in interpret mode and its oracle, on the shape and group
sweep of ``tests/test_grouped_matmul.py``.

Tolerance: every fp32 result here is a sum of K products, each within
``(K + 1) * 2**-24 * (|x| @ |w|)`` of the exact product whatever the
summation order (recursive-summation bound; bf16 x bf16 products are exact
in fp32), so two of them differ by at most twice that, elementwise.
Integer-valued inputs keep every sum exact: those must match bit for bit.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.grouped_matmul import grouped_matmul as ref_gmm
from repro.kernels.ops import grouped_matmul_blocked as ref_blocked
from repro.kernels.ref import grouped_matmul_ref as ref_oracle
from repro_torch.kernels import ops as port_ops
from repro_torch.kernels.grouped_matmul import (_instance, grouped_matmul,
                                                grouped_matmul_in_range,
                                                grouped_matmul_plain)
from repro_torch.kernels.ref import grouped_matmul_ref

U = 2.0 ** -24


def _inputs(E, K, N, mt, sizes, seed=0, integer=False, bf16=False):
    rng = np.random.default_rng(seed)
    gsz = np.asarray(sizes, np.int32)
    M = int(gsz.sum())
    if integer:
        x = rng.integers(-2, 3, (M, K)).astype(np.float32)
        w = rng.integers(-2, 3, (E, K, N)).astype(np.float32)
    else:
        x = (rng.normal(size=(M, K)) * 0.2).astype(np.float32)
        w = (rng.normal(size=(E, K, N)) * 0.2).astype(np.float32)
    if bf16:
        x = x.astype(ml_dtypes.bfloat16)
        w = w.astype(ml_dtypes.bfloat16)
    be = np.repeat(np.arange(E), gsz // mt).astype(np.int32)
    return x, w, be, gsz


def _torch(a):
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _bound(x, w, be, mt):
    xa = np.abs(np.asarray(x, np.float64))
    wa = np.abs(np.asarray(w, np.float64))
    mag = np.concatenate([xa[b * mt:(b + 1) * mt] @ wa[e]
                          for b, e in enumerate(be)]) if len(be) else \
        np.zeros((0, w.shape[2]))
    return 2 * (x.shape[1] + 1) * U * mag


def _check(E, K, N, mt, sizes, seed=0, integer=False, bf16=False):
    x, w, be, gsz = _inputs(E, K, N, mt, sizes, seed, integer, bf16)
    want = np.asarray(ref_gmm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(be),
                              m_tile=mt, interpret=True))
    oracle = np.asarray(ref_oracle(jnp.asarray(x), jnp.asarray(w),
                                   jnp.asarray(gsz)))
    tx, tw, tbe = _torch(x), _torch(w), _torch(be)
    before = grouped_matmul.launches
    outs = {
        "grouped_matmul": grouped_matmul(tx, tw, tbe, m_tile=mt),
        "grouped_matmul_pallas": port_ops.grouped_matmul_pallas(
            tx, tw, tbe, m_tile=mt),
        "grouped_matmul_blocked": port_ops.grouped_matmul_blocked(
            tx, tw, tbe, m_tile=mt),
        "grouped_matmul_ref": grouped_matmul_ref(tx, tw, _torch(gsz)),
    }
    assert grouped_matmul.launches == before   # the CPU runs no kernel
    bound = _bound(x, w, be, mt)
    for name, got in outs.items():
        got = got.numpy()
        assert got.dtype == np.float32 and got.shape == want.shape, name
        for ref in (want, oracle):
            if integer:
                assert np.array_equal(got, ref), name
            else:
                err = np.abs(got.astype(np.float64) - ref)
                assert (err <= bound).all(), (name, float(err.max()))


@pytest.mark.parametrize("K,N,mt", [(64, 64, 32), (256, 128, 128),
                                    (128, 96, 16), (512, 256, 64)])
@pytest.mark.parametrize("integer", [False, True])
def test_shapes(K, N, mt, integer):
    _check(4, K, N, mt, [mt * 2, 0, mt, mt * 3], integer=integer)


@pytest.mark.parametrize("integer", [False, True])
@pytest.mark.parametrize("bf16", [False, True])
def test_empty_and_single_groups(integer, bf16):
    _check(5, 64, 64, 16, [0, 16, 0, 0, 48], integer=integer, bf16=bf16)
    _check(1, 64, 48, 16, [32], seed=1, integer=integer, bf16=bf16)


@pytest.mark.parametrize("seed", range(10))
def test_random_groups(seed):
    """The reference's hypothesis sweep as seeded cases: 1-6 experts, 0-4
    blocks each, at least one block."""
    rng = np.random.default_rng(100 + seed)
    e = int(rng.integers(1, 7))
    nblocks = [int(v) for v in rng.integers(0, 5, e)]
    if sum(nblocks) == 0:
        nblocks[0] = 1
    _check(e, 32, 32, 16, [b * 16 for b in nblocks], seed=seed)


def test_trailing_blocks_take_the_clipped_expert():
    """moe_block's trailing blocks (past the last expert, zero rows) carry
    expert E-1: the groups' sum falls short of M and the oracles give the
    leftover rows to the last expert."""
    x, w, be, _ = _inputs(3, 64, 32, 8, [8, 16, 8], seed=5)
    x = np.concatenate([x, np.zeros((8, 64), np.float32)])
    be = np.append(be, np.int32(2))
    want = np.asarray(ref_gmm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(be),
                              m_tile=8, interpret=True))
    got = grouped_matmul(_torch(x), _torch(w), _torch(be), m_tile=8).numpy()
    assert np.abs(got - want).max() <= _bound(x, w, be, 8).max()
    assert not got[-8:].any()
    short = grouped_matmul_ref(_torch(x), _torch(w), torch.tensor([8, 16, 8]))
    assert torch.equal(short[-8:], torch.zeros(8, 32))


def test_blocked_twin_matches_kernel():
    rng = np.random.default_rng(4)
    E, K, N, mt = 3, 64, 48, 8
    gsz = np.array([16, 8, 24], np.int32)
    M = int(gsz.sum())
    x = rng.normal(size=(M, K)).astype(np.float32)
    w = rng.normal(size=(E, K, N)).astype(np.float32)
    be = np.repeat(np.arange(E), gsz // mt).astype(np.int32)
    want = np.asarray(ref_blocked(jnp.asarray(x), jnp.asarray(w),
                                  jnp.asarray(be), m_tile=mt))
    a = grouped_matmul(_torch(x), _torch(w), _torch(be), m_tile=mt)
    b = port_ops.grouped_matmul_blocked(_torch(x), _torch(w), _torch(be),
                                        m_tile=mt)
    bound = _bound(x, w, be, mt)
    assert (np.abs(a.numpy() - want) <= bound).all()
    assert (np.abs(b.numpy() - want) <= bound).all()
    assert torch.equal(a, grouped_matmul_plain(_torch(x), _torch(w),
                                               _torch(be), mt))


@pytest.mark.parametrize("M,K,N,mt,tiles", [
    (32, 640, 64, 16, {}),                  # K % min(512, K) != 0
    (32, 64, 200, 16, {}),                  # N % min(128, N) != 0
    (40, 64, 64, 16, {}),                   # M % m_tile != 0
    (32, 96, 64, 16, {"k_tile": 64}),
    (32, 64, 96, 16, {"n_tile": 64}),
])
def test_port_refuses_the_shapes_the_reference_refuses(M, K, N, mt, tiles):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(M, K)).astype(np.float32)
    w = rng.normal(size=(2, K, N)).astype(np.float32)
    be = np.zeros(M // mt, np.int32)
    with pytest.raises(AssertionError):
        ref_gmm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(be), m_tile=mt,
                interpret=True, **tiles)
    with pytest.raises(ValueError):
        grouped_matmul(_torch(x), _torch(w), _torch(be), m_tile=mt, **tiles)
    with pytest.raises(ValueError):
        port_ops.grouped_matmul_pallas(_torch(x), _torch(w), _torch(be),
                                       m_tile=mt, **tiles)


def test_wrapper_checks_types_devices_and_metadata():
    x = torch.zeros(32, 64)
    w = torch.zeros(2, 64, 32)
    be = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(TypeError):
        grouped_matmul(x.double(), w, be, m_tile=16)
    with pytest.raises(TypeError):
        grouped_matmul(x, w, be.long(), m_tile=16)
    with pytest.raises(ValueError):          # one expert id per row block
        grouped_matmul(x, w, be[:1], m_tile=16)
    with pytest.raises(ValueError):
        grouped_matmul(x, w[:, :32], be, m_tile=16)
    with pytest.raises(ValueError):
        grouped_matmul(x.t(), w, be, m_tile=16)
    with pytest.raises(ValueError):          # neither cuda nor cpu
        grouped_matmul(x.to("meta"), w.to("meta"), be.to("meta"), m_tile=16)
    empty = grouped_matmul(torch.zeros(0, 64), w, be[:0], m_tile=16)
    assert empty.shape == (0, 32) and empty.dtype == torch.float32


@pytest.mark.parametrize("bad", [-1, 2])
def test_expert_ids_out_of_range_raise(bad):
    """An expert id outside [0, E) raises ValueError on the CPU as on the
    card, where K4 would otherwise read past w."""
    x = torch.zeros(32, 64)
    w = torch.zeros(2, 64, 32)
    be = torch.tensor([0, bad], dtype=torch.int32)
    with pytest.raises(ValueError, match="outside"):
        grouped_matmul(x, w, be, m_tile=16)
    with pytest.raises(ValueError, match="outside"):
        port_ops.grouped_matmul_pallas(x, w, be, m_tile=16)


def _operands(xd, wd, K, N, mt, x_offset=0, w_offset=0):
    """x [2 mt, K] and w [2, K, N] of the given dtypes; an offset of 1
    makes the tensor a contiguous view that starts 2 or 4 bytes past a
    16-byte boundary of its flat buffer."""
    M = 2 * mt
    xbuf = torch.zeros(x_offset + M * K, dtype=xd)
    wbuf = torch.zeros(w_offset + 2 * K * N, dtype=wd)
    x = xbuf[x_offset:].view(M, K)
    w = wbuf[w_offset:].view(2, K, N)
    assert x.data_ptr() % 16 == x_offset * x.element_size()
    assert w.data_ptr() % 16 == w_offset * w.element_size()
    return x, w


BF, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("xd,wd,K,N,mt,x_off,w_off,want", [
    (BF, BF, 512, 256, 128, 0, 0, "wgmma"),      # the MoE path's shapes
    (BF, BF, 520, 264, 64, 0, 0, "wgmma"),       # ragged last K, N tiles
    (BF, BF, 64, 96, 192, 0, 0, "wgmma"),
    (BF, BF, 8, 8, 256, 0, 0, "wgmma"),
    (F32, F32, 512, 256, 128, 0, 0, "simt"),     # tensor cores would round
    (BF, F32, 512, 256, 128, 0, 0, "simt"),
    (F32, BF, 512, 256, 128, 0, 0, "simt"),
    (BF, BF, 516, 256, 128, 0, 0, "simt"),       # K % 8 == 4
    (BF, BF, 99, 256, 128, 0, 0, "simt"),
    (BF, BF, 512, 258, 128, 0, 0, "simt"),       # N % 8 == 2
    (BF, BF, 512, 301, 128, 0, 0, "simt"),
    (BF, BF, 512, 256, 16, 0, 0, "simt"),        # m_tile % 64 != 0
    (BF, BF, 512, 256, 96, 0, 0, "simt"),
    (BF, BF, 512, 256, 160, 0, 0, "simt"),
    (BF, BF, 512, 256, 128, 1, 0, "simt"),       # x 2 bytes off 16
    (BF, BF, 512, 256, 128, 0, 1, "simt"),       # w 2 bytes off 16
])
def test_instance_choice(xd, wd, K, N, mt, x_off, w_off, want):
    """K4's instance is a pure function of dtypes, shapes, m_tile and
    alignment: the wgmma instance takes bf16 x bf16 with K, N multiples of
    8, m_tile a multiple of 64 and 16-byte aligned bases."""
    x, w = _operands(xd, wd, K, N, mt, x_off, w_off)
    assert _instance(x, w, mt) == want


@pytest.mark.parametrize("xd,wd,mt", [(BF, BF, 64), (BF, BF, 16),
                                      (F32, F32, 64)])
def test_cpu_tensors_take_the_plain_version(xd, wd, mt):
    """On CPU tensors neither instance launches, whichever ``_instance``
    names: the result is the plain version's and no count moves."""
    rng = np.random.default_rng(3)
    E, K, N = 2, 64, 32
    x = torch.from_numpy(rng.integers(-2, 3, (3 * mt, K)).astype(
        np.float32)).to(xd)
    w = torch.from_numpy(rng.integers(-2, 3, (E, K, N)).astype(
        np.float32)).to(wd)
    be = torch.tensor([0, 1, 1], dtype=torch.int32)
    before = (grouped_matmul.launches,
              dict(grouped_matmul.launches_by_instance))
    for fn in (grouped_matmul, grouped_matmul_in_range):
        assert torch.equal(fn(x, w, be, m_tile=mt),
                           grouped_matmul_plain(x, w, be, mt))
    assert (grouped_matmul.launches,
            grouped_matmul.launches_by_instance) == before
