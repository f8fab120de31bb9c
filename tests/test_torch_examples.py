"""The port's example programs run end to end on the CPU
(``python -m repro_torch.examples.<name> --device cpu``) and make the
checks their reference counterparts make: ``quickstart`` every backend
against the fp64 oracle, ``serve_gcn`` the engine against the direct
operator before and after a mutation, with the tuner attached,
``serve_sampled`` full fanout bit for bit against the full graph (on the
CPU), a frontier hit rate from recurring batches, a delta that repairs or
drops the cached frontier, and a partitioned store's frontier identical
to the monolithic one, ``serve_lm`` the LM engine's ``generate()`` and
its slot-reuse admission, ``moe_block_dispatch`` the expert loads and
``moe_block`` of both routings against the reference's from the
reference's parameters (loads equal as integers, outputs within
``1e-5 * max|ref|``) and its own claims (dropless; capacity 1.25 drops
under skew). Each example also defaults to ``cuda``."""
import numpy as np
import pytest
import torch

from repro_torch.examples import (moe_block_dispatch, quickstart, serve_gcn,
                                  serve_lm, serve_sampled)


def test_quickstart_every_backend_against_the_oracle():
    errs = quickstart.main(["--device", "cpu"])
    assert set(errs) == {"accel", "blocked", "segment", "warp"}
    assert max(errs.values()) < 1e-4


def test_serve_gcn_end_to_end_with_the_tuner():
    out = serve_gcn.main(["--device", "cpu", "--graphs", "3", "--nodes",
                          "300", "--edges", "1500", "--rounds", "2"])
    assert out["err"] < 1e-3 and out["mutate_err"] < 1e-3
    assert out["shadow_dispatches"] >= 1


def test_serve_sampled_end_to_end():
    out = serve_sampled.main(["--device", "cpu", "--nodes", "1200",
                              "--edges", "7000", "--batch-size", "32"])
    assert out["frontier_hit_rate"] >= 0.5
    assert out["frontier_mutations"] + out["frontiers_invalidated"] >= 1


def test_serve_sampled_bound_holds_on_the_cpu():
    """``gcn_bound``, the example's tolerance on the card, has the shape of
    the output and is positive wherever the output has magnitude."""
    import numpy as np
    from repro_torch.core.graph import gcn_normalize
    from repro_torch.data.graphs import make_power_law_graph
    from repro_torch.models.gcn import init_gcn
    g = gcn_normalize(make_power_law_graph(200, 900, seed=3))
    params = init_gcn(torch.Generator().manual_seed(2), [4, 6, 3],
                      device="cpu")
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(200, 4)).astype(np.float32))
    b = serve_sampled.gcn_bound(g, x, params, 256)
    assert b.shape == (200, 3) and bool((b > 0).all())


def test_serve_lm_end_to_end():
    out = serve_lm.main(["--device", "cpu", "--batch", "3", "--max-new",
                         "8"])
    assert [len(r.out) for r in out["sync"]] == [8, 6]
    assert [len(o) for o in out["async"]] == out["async_lengths"]
    assert all(0 <= t < 256 for o in out["async"] for t in o)
    assert out["stats"]["slots_reused"] > 0


def _moe_claims(out):
    """The example's claims: block dispatch dropless against the dropless
    oracle; a capacity-1.25 dispatch drops tokens under skew."""
    assert [r["loads"] for r in out.values()] and all(
        sum(r["loads"]) == 2 * 128 * 2 for r in out.values())
    for r in out.values():
        assert r["block_err"] <= 1e-5, r["block_err"]
    assert out["skewed routing"]["capacity_err"] > 0


def test_moe_block_dispatch_end_to_end():
    _moe_claims(moe_block_dispatch.main(["--device", "cpu"]))


def test_moe_block_dispatch_against_the_reference():
    """The reference example's parameters and tokens (``init_moe`` and
    ``jax.random.normal`` from its keys) through the port's ``run``: the
    loads of each routing equal the reference's, and ``moe_block``'s
    output matches the reference's (its Pallas kernel in interpret mode)
    within ``1e-5 * max|ref|``."""
    import jax
    import jax.numpy as jnp
    from repro.models.moe import init_moe, moe_block
    from repro_torch.models.moe import params_from_jax
    B, T, D, FF, E, k = (moe_block_dispatch.B, moe_block_dispatch.T,
                         moe_block_dispatch.D, moe_block_dispatch.FF,
                         moe_block_dispatch.E, moe_block_dispatch.K)
    rp = init_moe(jax.random.PRNGKey(0), D, FF, E, dtype=jnp.float32)
    rx = jax.random.normal(jax.random.PRNGKey(1), (B, T, D))
    # XLA's CPU arithmetic flushes subnormals to zero: under the skewed
    # router the softmax's tail is subnormal, and its ties at 0 decide
    # the second expert of those tokens
    assert torch.set_flush_denormal(True)
    try:
        out = moe_block_dispatch.run(params_from_jax(rp, device="cpu"),
                                     torch.from_numpy(np.asarray(rx)))
    finally:
        torch.set_flush_denormal(False)
    _moe_claims(out)
    for name, bias in moe_block_dispatch.ROUTINGS:
        p2 = dict(rp)
        p2["router"] = rp["router"] + jnp.zeros((E,)).at[0].set(bias)
        logits = rx.reshape(-1, D) @ p2["router"]
        ids = jax.lax.top_k(jax.nn.softmax(logits, -1), k)[1].reshape(-1)
        assert out[name]["loads"] == np.bincount(
            np.asarray(ids), minlength=E).tolist(), name
        want, _ = moe_block(p2, rx, top_k=k, n_experts=E,
                            m_tile=moe_block_dispatch.M_TILE,
                            use_pallas=True)
        want = np.asarray(want)
        err = float(np.abs(out[name]["y_block"].numpy() - want).max())
        assert err <= 1e-5 * float(np.abs(want).max()), (name, err)


@pytest.mark.parametrize("mod", [quickstart, serve_gcn, serve_lm,
                                 serve_sampled, moe_block_dispatch])
def test_examples_default_to_cuda(mod):
    if torch.cuda.is_available():
        pytest.skip("this checks the CPU-only behaviour")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([])
