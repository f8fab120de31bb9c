"""The port's sharded SpMM (``distributed/shard_spmm.py``) against the
reference's, over 1-8 CPU slots.

* ``round_robin_block_order`` and the padded, slot-major reordered block
  arrays are bit for bit the reference's;
* ``spmm_feature_sharded`` and ``spmm_block_sharded`` agree with the
  reference's functions on the same slabs: exactly on integer-valued graphs
  and features, and otherwise within twice the fp32 summation bound
  ``k * 2**-24 * (|A'| @ |x|)`` with ``k = min(deg, C) + ceil(deg / C) + 1``
  plus the slot count (a split row's partials now also sum across slots).

The reference functions run over ``graph_mesh(d)``; where this process has
fewer than ``d`` JAX devices, the reference's d-device result is composed
from its own parts as ``shard_map`` computes it: ``spmm_blocked`` on each
device's column shard (feature) or on each device's slice of the
reference's ``prepare_block_shards`` arrays, summed in device order
(block). Every slot's share on the port's side runs through the kernel
wrapper of its regime (here its plain version: the tensors lie on the CPU).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.graph import csr_from_edges, gcn_normalize
from repro.core.plan_cache import PartitionConfig as RefConfig
from repro.core.plan_cache import build_partition_plan as ref_build
from repro.data.graphs import make_power_law_graph
from repro.distributed import shard_spmm as ref_shard
from repro.kernels.ops import spmm_blocked as ref_blocked
from repro.launch.mesh import graph_mesh as ref_mesh
from repro_torch.core.graph import CSRGraph
from repro_torch.core.plan_cache import PartitionConfig, build_partition_plan
from repro_torch.distributed import shard_spmm
from repro_torch.kernels.ops import spmm_blocked
from repro_torch.launch.mesh import graph_mesh

U = 2.0 ** -24
_KEYS = ("colidx", "values", "rowloc", "out_row")


def _port(g):
    return CSRGraph(g.rowptr, g.colidx, g.values, g.n_cols)


def _graph(n, e, seed, integer):
    g = make_power_law_graph(n, e, seed=seed)
    if integer:
        vals = np.random.default_rng(seed).integers(1, 4, g.nnz)
        return csr_from_edges(np.repeat(np.arange(g.n_rows),
                                        np.diff(g.rowptr)),
                              g.colidx, g.n_cols, values=vals)
    return gcn_normalize(g)


@functools.lru_cache(maxsize=None)
def _case(n, e, seed, integer):
    """``(graph, reference plan, port plan)``, built once per module."""
    g = _graph(n, e, seed, integer)
    return (g, ref_build(g, RefConfig()),
            build_partition_plan(_port(g), PartitionConfig(), device="cpu"))


def _x(n, F, seed, integer):
    rng = np.random.default_rng(seed)
    if integer:
        return rng.integers(-4, 5, (n, F)).astype(np.float32)
    return rng.normal(size=(n, F)).astype(np.float32)


def _ref_feature(rp, x, d):
    if d <= len(jax.devices()):
        return np.asarray(ref_shard.spmm_feature_sharded(
            rp.slabs, jnp.asarray(x), rp.n_rows, ref_mesh(d)))
    F = x.shape[1]
    fs = -(-F // d)
    xp = np.pad(x, ((0, 0), (0, fs * d - F)))
    parts = [np.asarray(ref_blocked(*(rp.slabs[k] for k in _KEYS),
                                    jnp.asarray(xp[:, k * fs:(k + 1) * fs]),
                                    rp.n_rows)) for k in range(d)]
    return np.concatenate(parts, axis=1)[:, :F]


def _ref_block(rp, x, d):
    if d <= len(jax.devices()):
        out, live = ref_shard.spmm_block_sharded(
            rp.slabs, jnp.asarray(x), rp.n_rows, ref_mesh(d))
        return np.asarray(out), live
    arrs, live = ref_shard.prepare_block_shards(rp.slabs, rp.n_rows, d)
    per = arrs["colidx"].shape[0] // d
    out = None
    for k in range(d):
        part = np.asarray(ref_blocked(
            *(arrs[n][k * per:(k + 1) * per] for n in _KEYS),
            jnp.asarray(x), rp.n_rows))
        out = part if out is None else out + part
    return out, live


def _bound(g, pp, x, extra):
    """Twice the summation bound, rows in the plan's (sorted) order."""
    deg = np.diff(g.rowptr).astype(np.int64)
    perm = np.argsort(pp.inv_perm.numpy())          # sorted pos -> row
    deg = deg[perm]
    C = int(pp.slabs["C"])
    k = np.minimum(deg, C) + -(-deg // C) + 1 + extra
    mag = spmm_blocked(pp.slabs["colidx"], pp.slabs["values"].abs(),
                       pp.slabs["rowloc"], pp.slabs["out_row"],
                       torch.from_numpy(np.abs(x)), pp.n_rows)
    return 2 * U * k[:, None] * mag.double().numpy()


def _hold(got, want, bound, integer):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    if integer:
        np.testing.assert_array_equal(got, want)
    else:
        err = np.abs(got.astype(np.float64) - want)
        assert (err <= bound).all(), float((err - bound).max())


# ------------------------------------------------------------ host side
@pytest.mark.parametrize("n_dev", [1, 2, 3, 5, 8, 16])
def test_round_robin_block_order_matches_reference(n_dev):
    for num_blocks in (0, 1, 7, 8, 9, 64, 169, 500):
        order, live = shard_spmm.round_robin_block_order(num_blocks, n_dev)
        r_order, r_live = ref_shard.round_robin_block_order(num_blocks,
                                                            n_dev)
        np.testing.assert_array_equal(order, r_order)
        np.testing.assert_array_equal(live, r_live)
        assert order.dtype == r_order.dtype and live.dtype == r_live.dtype
        assert live.sum() == num_blocks and live.max() - live.min() <= 1
    for bad in ((-1, 2), (4, 0)):
        with pytest.raises(ValueError):
            shard_spmm.round_robin_block_order(*bad)


@pytest.mark.parametrize("n_dev", [1, 3, 8])
def test_padded_reordered_block_arrays_match_reference(n_dev):
    _, rp, pp = _case(900, 6000, 2, False)
    arrs, live = ref_shard.prepare_block_shards(rp.slabs, rp.n_rows, n_dev)
    shards, p_live = shard_spmm.prepare_block_shards(
        pp.slabs, pp.n_rows, graph_mesh(n_dev, "cpu"))
    np.testing.assert_array_equal(p_live, live)
    assert len(shards) == n_dev
    for j, name in enumerate(_KEYS):
        got = torch.cat([s[j] for s in shards]).numpy()
        want = np.asarray(arrs[name])
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    b_pad = 8 * (pp.num_blocks // 8 + 2)
    padded = shard_spmm._pad_blocks(pp.slabs, b_pad, pp.n_rows)
    r_padded = ref_shard._pad_blocks(rp.slabs, b_pad, rp.n_rows)
    for name in _KEYS:
        np.testing.assert_array_equal(padded[name].numpy(), r_padded[name])


def test_feature_shards_alias_slabs_on_their_own_device():
    _, _, pp = _case(300, 1500, 1, False)
    shards = shard_spmm.prepare_feature_shards(pp.slabs, ["cpu"] * 3)
    assert all(s[0] is pp.slabs["colidx"] for s in shards)


# ----------------------------------------------------------------- float
@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("n_dev", [1, 2, 3, 4, 8])
def test_feature_sharded_matches_reference(n_dev, integer):
    g, rp, pp = _case(400, 2600, 0, integer)
    for F in (n_dev * 8, n_dev * 8 + 3, 5):
        x = _x(g.n_cols, F, F, integer)
        want = _ref_feature(rp, x, n_dev)
        got = shard_spmm.spmm_feature_sharded(
            pp.slabs, torch.from_numpy(x), pp.n_rows,
            graph_mesh(n_dev, "cpu"))
        assert tuple(got.shape) == (pp.n_rows, F)
        _hold(got, want, _bound(g, pp, x, 0), integer)


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("n_dev", [1, 2, 3, 5, 8])
def test_block_sharded_matches_reference(n_dev, integer):
    g, rp, pp = _case(900, 6000, 2, integer)
    x = _x(g.n_cols, 24, 1, integer)
    want, r_live = _ref_block(rp, x, n_dev)
    got, live = shard_spmm.spmm_block_sharded(
        pp.slabs, torch.from_numpy(x), pp.n_rows, graph_mesh(n_dev, "cpu"))
    np.testing.assert_array_equal(live, r_live)
    assert live.sum() == pp.num_blocks and live.max() - live.min() <= 1
    _hold(got, want, _bound(g, pp, x, n_dev), integer)


@pytest.mark.parametrize("regime", ["resident", "windowed", "hbm", "blocked"])
def test_every_regime_gives_the_same_answer(regime):
    """Each slot's share goes through its regime's kernel wrapper; on
    integer data every regime's plain version is exact."""
    g, rp, pp = _case(5000, 30000, 4, True)     # > 4096 rows: 2 windows
    x = _x(g.n_cols, 12, 3, integer=True)
    slots = graph_mesh(4, "cpu")
    want_f = _ref_feature(rp, x, 4)
    want_b, _ = _ref_block(rp, x, 4)
    got_f = shard_spmm.spmm_feature_sharded(
        pp.slabs, torch.from_numpy(x), pp.n_rows, slots, regime=regime)
    got_b, _ = shard_spmm.spmm_block_sharded(
        pp.slabs, torch.from_numpy(x), pp.n_rows, slots, regime=regime)
    np.testing.assert_array_equal(got_f.numpy(), want_f)
    np.testing.assert_array_equal(got_b.numpy(), want_b)


def test_prepared_shards_are_reused_and_bad_regime_raises():
    g, _, pp = _case(900, 6000, 2, True)
    slots = graph_mesh(3, "cpu")
    x = torch.from_numpy(_x(g.n_cols, 8, 0, integer=True))
    prep = shard_spmm.prepare_block_shards(pp.slabs, pp.n_rows, slots)
    a, _ = shard_spmm.spmm_block_sharded(pp.slabs, x, pp.n_rows, slots,
                                         prepared=prep)
    b, _ = shard_spmm.spmm_block_sharded(pp.slabs, x, pp.n_rows, slots)
    assert torch.equal(a, b)
    fprep = shard_spmm.prepare_feature_shards(pp.slabs, slots)
    c = shard_spmm.spmm_feature_sharded(pp.slabs, x, pp.n_rows, slots,
                                        prepared=fprep)
    assert torch.equal(c, a)
    with pytest.raises(ValueError, match="regime"):
        shard_spmm.spmm_block_sharded(pp.slabs, x, pp.n_rows, slots,
                                      regime="pallas")


# ------------------------------------------------------------------ mesh
def test_graph_mesh_slots():
    assert graph_mesh(8, "cpu") == [torch.device("cpu")] * 8
    assert graph_mesh(None, "cpu") == [torch.device("cpu")]
    with pytest.raises(ValueError, match="needs >= 1 device"):
        graph_mesh(0, "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            graph_mesh()
    with pytest.raises(ValueError, match=r"exceeds the \d+ visible"):
        ref_mesh(len(jax.devices()) + 1)          # the reference's message
