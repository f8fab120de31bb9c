"""The port's example programs run end to end on the CPU
(``python -m repro_torch.examples.<name> --device cpu``) and make the
checks their reference counterparts make: ``quickstart`` every backend
against the fp64 oracle, ``serve_gcn`` the engine against the direct
operator before and after a mutation, with the tuner attached,
``serve_sampled`` full fanout bit for bit against the full graph (on the
CPU), a frontier hit rate from recurring batches, a delta that repairs or
drops the cached frontier, and a partitioned store's frontier identical
to the monolithic one, ``serve_lm`` the LM engine's ``generate()`` and
its slot-reuse admission. Each example also defaults to ``cuda``."""
import pytest
import torch

from repro_torch.examples import (quickstart, serve_gcn, serve_lm,
                                  serve_sampled)


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


@pytest.mark.parametrize("mod", [quickstart, serve_gcn, serve_lm,
                                 serve_sampled])
def test_examples_default_to_cuda(mod):
    if torch.cuda.is_available():
        pytest.skip("this checks the CPU-only behaviour")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([])
