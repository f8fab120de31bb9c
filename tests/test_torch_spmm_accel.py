"""K1's plain version, the PyTorch twin and the oracles against the
reference package's Pallas kernel (interpret mode), jnp twin and oracles.

Tolerances: on integer-valued graphs and features every sum is exact in
fp32, so results must be bit-identical. On normalized graphs the fp32 sums
run in different orders; each is a two-level sum (at most min(deg, C)
products inside a block, then ceil(deg / C) block partials), so two results
may differ by twice the recursive-summation bound
``(min(deg, C) + ceil(deg / C) + 1) * 2**-24 * (|A| @ |x|)`` (``_bound``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.graph import degree_sort_csr, gcn_normalize
from repro.core.partition import (block_level_partition,
                                  get_partition_patterns, pack_slabs)
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro.kernels.spmm_accel import scatter_block_rows as ref_scatter
from repro.kernels.spmm_accel import spmm_block_slabs as ref_kernel
from repro_torch.kernels import ops as port_ops
from repro_torch.kernels import ref as port_ref
from repro_torch.kernels import spmm_accel as port_k

from conftest import make_powerlaw_csr

U = 2.0 ** -24


def _int_graph(g, seed):
    """Same pattern as ``g`` with small integer edge values."""
    vals = np.random.default_rng(seed).integers(1, 4, g.nnz).astype(np.float32)
    return type(g)(g.rowptr, g.colidx, vals, g.n_cols)


def _slabs(g, mode, mbw, mwn):
    gs = degree_sort_csr(g)
    bp = block_level_partition(gs, get_partition_patterns(mbw, mwn, mode=mode))
    return gs, pack_slabs(gs, bp)


def _t(s):
    return [torch.from_numpy(np.ascontiguousarray(s[k]))
            for k in ("colidx", "values", "rowloc", "out_row")]


def _j(s):
    return [jnp.asarray(s[k]) for k in ("colidx", "values", "rowloc", "out_row")]


def _bound(gs, C, x):
    """Per-element bound for two fp32 two-level sums of the same row:
    2 * (min(deg, C) + ceil(deg / C) + 1) * u * (|A| @ |x|)."""
    deg = np.diff(gs.rowptr)
    k = np.minimum(deg, C) + -(-deg // C) + 1
    mag = ref_ref.csr_spmm_ref(gs.rowptr, gs.colidx, np.abs(gs.values),
                               jnp.abs(jnp.asarray(x)))
    return 2 * U * k[:, None] * np.asarray(mag, dtype=np.float64)


MODES = [("tpu", 32, 8), ("paper", 12, 8), ("tpu", 64, 4)]


@pytest.mark.parametrize("mode,mbw,mwn", MODES)
@pytest.mark.parametrize("F", [1, 17, 64])
def test_plain_matches_pallas_exactly_on_integer_graphs(mode, mbw, mwn, F):
    g = _int_graph(make_powerlaw_csr(n=180, seed=F), seed=F)
    gs, s = _slabs(g, mode, mbw, mwn)
    x = np.random.default_rng(F).integers(-3, 4, (g.n_cols, F)).astype(
        np.float32)
    want = np.asarray(ref_kernel(*_j(s), jnp.asarray(x), gs.n_rows,
                                 interpret=True))
    got = port_k.spmm_block_slabs(*_t(s), torch.from_numpy(x), gs.n_rows)
    np.testing.assert_array_equal(got.numpy(), want)
    # the jnp twin and the CSR oracle agree bit for bit too
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(ref_ops.spmm_blocked(*_j(s), jnp.asarray(x),
                                                     gs.n_rows)))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(ref_ref.csr_spmm_ref(
            gs.rowptr, gs.colidx, gs.values, jnp.asarray(x))))


@pytest.mark.parametrize("mode,mbw,mwn", MODES)
def test_plain_matches_pallas_within_ulp_on_normalized_graphs(mode, mbw, mwn):
    g = gcn_normalize(make_powerlaw_csr(n=200, seed=11))
    gs, s = _slabs(g, mode, mbw, mwn)
    x = np.random.default_rng(1).normal(size=(g.n_cols, 40)).astype(np.float32)
    want = np.asarray(ref_kernel(*_j(s), jnp.asarray(x), gs.n_rows,
                                 interpret=True), dtype=np.float64)
    got = port_k.spmm_block_slabs(*_t(s), torch.from_numpy(x),
                                  gs.n_rows).numpy().astype(np.float64)
    assert np.all(np.abs(got - want) <= _bound(gs, mbw * mwn, x))


@pytest.mark.parametrize("F", [3, 32])
def test_twin_oracles_and_epilogue_match_reference(F):
    g = _int_graph(gcn_normalize(make_powerlaw_csr(n=120, seed=2)), seed=2)
    gs, s = _slabs(g, "tpu", 16, 8)
    x = np.random.default_rng(F).integers(-3, 4, (g.n_cols, F)).astype(
        np.float32)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    want = np.asarray(ref_ref.slab_spmm_ref(*_j(s), xj, gs.n_rows))
    np.testing.assert_array_equal(
        port_ops.spmm_blocked(*_t(s), xt, gs.n_rows).numpy(), want)
    np.testing.assert_array_equal(
        port_ref.slab_spmm_ref(*_t(s), xt, gs.n_rows).numpy(), want)
    np.testing.assert_array_equal(
        port_ref.csr_spmm_ref(gs.rowptr, gs.colidx, gs.values, xt,
                              nnz_chunk=37).numpy(),
        np.asarray(ref_ref.csr_spmm_ref(gs.rowptr, gs.colidx, gs.values, xj)))
    # the scatter epilogue on packed block rows
    B, R = s["out_row"].shape
    blocks = np.random.default_rng(0).integers(-2, 3, (B, R, F + 5)).astype(
        np.float32)
    np.testing.assert_array_equal(
        port_k.scatter_block_rows(torch.from_numpy(blocks),
                                  torch.from_numpy(s["out_row"]),
                                  gs.n_rows, F).numpy(),
        np.asarray(ref_scatter(jnp.asarray(blocks), jnp.asarray(s["out_row"]),
                               gs.n_rows, F)))


def test_slab_dict_wrapper_and_fp64_oracle():
    g = gcn_normalize(make_powerlaw_csr(n=90, seed=3))
    gs, s = _slabs(g, "tpu", 64, 4)
    x = torch.randn(g.n_cols, 8, generator=torch.Generator().manual_seed(0))
    slabs = dict(zip(("colidx", "values", "rowloc", "out_row"), _t(s)))
    got = port_ops.spmm_accel(slabs, x, gs.n_rows)
    want = port_ref.csr_spmm_ref(gs.rowptr, gs.colidx,
                                 gs.values.astype(np.float64), x.double())
    assert want.dtype == torch.float64
    mag = port_ref.csr_spmm_ref(gs.rowptr, gs.colidx,
                                np.abs(gs.values).astype(np.float64),
                                x.double().abs())
    deg = torch.from_numpy(np.diff(gs.rowptr))[:, None]
    assert torch.all((got.double() - want).abs() <= (deg + 2) * U * mag)


def test_wrapper_validates_and_uses_plain_version_on_cpu():
    g = make_powerlaw_csr(n=60, seed=4)
    gs, s = _slabs(g, "tpu", 16, 8)
    ci, va, rl, orow = _t(s)
    x = torch.ones(g.n_cols, 4)
    before = port_k.spmm_block_slabs.launches
    out = port_k.spmm_block_slabs(ci, va, rl, orow, x, gs.n_rows)
    assert out.shape == (gs.n_rows, 4) and out.dtype == torch.float32
    assert port_k.spmm_block_slabs.launches == before, \
        "CPU tensors take the plain version, which is not a kernel launch"
    with pytest.raises(TypeError, match="x must be torch.float32"):
        port_k.spmm_block_slabs(ci, va, rl, orow, x.double(), gs.n_rows)
    with pytest.raises(TypeError, match="colidx must be torch.int32"):
        port_k.spmm_block_slabs(ci.long(), va, rl, orow, x, gs.n_rows)
    with pytest.raises(ValueError, match="contiguous"):
        port_k.spmm_block_slabs(ci, va, rl, orow, torch.ones(4, g.n_cols).T,
                                gs.n_rows)
    with pytest.raises(ValueError, match="shapes differ"):
        port_k.spmm_block_slabs(ci, va[:, :-1].contiguous(), rl, orow, x,
                                gs.n_rows)
    with pytest.raises(ValueError, match="grid_order"):
        port_k.spmm_block_slabs(ci, va, rl, orow, x, gs.n_rows,
                                grid_order="diagonal")
    with pytest.raises(ValueError, match="f_tile"):
        port_k.spmm_block_slabs(ci, va, rl, orow, x, gs.n_rows, f_tile=100)
    # grid_order is accepted for parity and changes nothing
    torch.testing.assert_close(
        port_k.spmm_block_slabs(ci, va, rl, orow, x, gs.n_rows,
                                grid_order="ft_major"), out, rtol=0, atol=0)


# F -> the f_tile K1 takes when the caller gives none: F in whole warps,
# at most K1_F_TILE
K1_RULE = {1: 32, 32: 32, 33: 64, 40: 64, 41: 64, 47: 64, 64: 64, 65: 96,
           100: 128, 129: 160, 255: 256, 256: 256, 257: 256, 602: 256,
           2048: 256}


@pytest.mark.parametrize("F,f_tile", sorted(K1_RULE.items()))
def test_k1_f_tile_rule(F, f_tile):
    assert port_k.K1_F_TILE == 256
    assert port_k.k1_f_tile(F) == f_tile


def test_explicit_f_tile_is_kept():
    """A caller's f_tile is validated as given, never replaced by the
    rule: 100 is refused at F = 100, where the rule would take 128; 32 and
    1024 are accepted at F = 100, and the result is the same."""
    g = _int_graph(make_powerlaw_csr(n=60, seed=6), seed=6)
    gs, s = _slabs(g, "tpu", 16, 8)
    x = torch.from_numpy(np.random.default_rng(6).integers(
        -3, 4, (g.n_cols, 100)).astype(np.float32))
    with pytest.raises(ValueError, match="f_tile"):
        port_k.spmm_block_slabs(*_t(s), x, gs.n_rows, f_tile=100)
    want = port_k.spmm_block_slabs(*_t(s), x, gs.n_rows)
    for f_tile in (32, 1024):
        np.testing.assert_array_equal(
            port_k.spmm_block_slabs(*_t(s), x, gs.n_rows,
                                    f_tile=f_tile).numpy(), want.numpy())


@pytest.mark.parametrize("f_tile",
                         sorted({32, 64, 128, port_k.K1_F_TILE}) + [None])
@pytest.mark.parametrize("F,offset", [(8, 0), (8, 1), (3, 0)])
def test_cpu_tensors_count_no_launch_in_either_counter(f_tile, F, offset):
    """On CPU tensors K1's wrapper takes the plain version at every f_tile
    it can pick (None: the rule's), whichever gather instance the layout
    would take on the card (offset 1: x 4 bytes off a 16-byte boundary),
    and counts nothing: neither ``launches`` nor ``launches_by_instance``
    nor ``launches_by_f_tile``."""
    g = _int_graph(make_powerlaw_csr(n=70, seed=5), seed=5)
    gs, s = _slabs(g, "tpu", 16, 8)
    base = torch.from_numpy(np.random.default_rng(F).integers(
        -3, 4, g.n_cols * F + 4).astype(np.float32))
    shift = (-base.data_ptr() // 4) % 4 + offset      # floats to the boundary
    x = base[shift:shift + g.n_cols * F].view(g.n_cols, F)
    tile = port_k.k1_f_tile(F) if f_tile is None else f_tile
    assert port_k.gather_instance(x, tile) == (
        "bulk" if F % 4 == 0 and offset == 0 else "cp_async")
    before = port_k.spmm_block_slabs.launches
    by_instance = dict(port_k.spmm_block_slabs.launches_by_instance)
    by_tile = dict(port_k.spmm_block_slabs.launches_by_f_tile)
    got = port_k.spmm_block_slabs(*_t(s), x, gs.n_rows, f_tile=f_tile)
    assert port_k.spmm_block_slabs.launches == before
    assert port_k.spmm_block_slabs.launches_by_instance == by_instance
    assert port_k.spmm_block_slabs.launches_by_f_tile == by_tile
    np.testing.assert_array_equal(
        got.numpy(), port_k.spmm_block_slabs_plain(*_t(s), x,
                                                   gs.n_rows).numpy())
