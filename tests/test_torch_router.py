"""The port's routing policy (``repro_torch.kernels.router``) against the
reference's (``repro.kernels.router``): over a grid that covers every
boundary of ``tests/test_spmm_router.py`` (resident / windowed / hbm
thresholds, row padding, itemsize, custom budgets, block capacities that
overflow the total budget, forced regimes), both modules return the same
decisions field for field, or raise the same error with the same message.
Pure Python on both sides: exact equality."""
import dataclasses
import itertools

import pytest

from repro.kernels import router as ref
from repro_torch.kernels import router as port

WINDOW = 4096
N_ROWS = [1, 7, 8, 64, 4090, 4092, WINDOW, WINDOW + 1, 4104, 2 * WINDOW,
          2 * WINDOW + 8, 3 * WINDOW, 4 * WINDOW, 4 * WINDOW + 1, 20_000,
          402_308, 500_000]
FEATURES = [1, 16, 64, 100, 130, 2048]
CAPACITIES = [(256, 64), (96, 48), (32, 16), (2048, 768), (4096, 1024)]
SMALL_BUDGET = 64 * 1024


def _outcome(fn, *args, **kwargs):
    """A call's result as comparable data: the decision's fields, or the
    exception's type name and message."""
    try:
        out = fn(*args, **kwargs)
    except ValueError as e:
        return ("raises", type(e).__name__, str(e))
    if dataclasses.is_dataclass(out):
        return ("returns", type(out).__name__, dataclasses.asdict(out))
    return ("returns", type(out).__name__, out)


def test_policy_constants_identical():
    for name in ("VMEM_BYTES_PER_CORE", "X_TILE_BUDGET_BYTES",
                 "TOTAL_VMEM_BUDGET_BYTES", "MAX_WINDOWS"):
        assert getattr(port, name) == getattr(ref, name), name
    assert issubclass(port.VmemBudgetError, ValueError)
    assert port.resident_window_rows() == ref.resident_window_rows() == WINDOW


@pytest.mark.parametrize("force", [None, "resident", "windowed", "hbm"])
@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("budget", [ref.X_TILE_BUDGET_BYTES, SMALL_BUDGET])
def test_route_spmm_identical(force, itemsize, budget):
    n_raised = n_routed = 0
    for n, f, (C, R) in itertools.product(N_ROWS, FEATURES, CAPACITIES):
        kw = dict(itemsize=itemsize, budget_bytes=budget, force=force)
        want = _outcome(ref.route_spmm, n, f, C, R, **kw)
        got = _outcome(port.route_spmm, n, f, C, R, **kw)
        assert got == want, (n, f, C, R, kw)
        n_raised += want[0] == "raises"
        n_routed += want[0] == "returns"
    assert n_routed > 0
    if force in (None, "resident"):
        assert n_raised > 0      # the grid reaches the error paths


@pytest.mark.parametrize("f_tile,max_windows", [(128, 4), (64, 2), (256, 1)])
def test_route_spmm_tile_and_window_cap_identical(f_tile, max_windows):
    for n, f, (C, R) in itertools.product(N_ROWS, FEATURES, CAPACITIES[:3]):
        kw = dict(f_tile=f_tile, max_windows=max_windows)
        assert _outcome(port.route_spmm, n, f, C, R, **kw) == \
            _outcome(ref.route_spmm, n, f, C, R, **kw), (n, f, C, R)
    with pytest.raises(ValueError, match="unknown forced backend"):
        port.route_spmm(8, 8, 256, 64, force="segment")


def test_helpers_identical():
    for n in N_ROWS:
        assert port.pad_rows(n) == ref.pad_rows(n)
    for f, t in itertools.product(FEATURES, [32, 64, 128, 256]):
        assert port.pad_features(f, t) == ref.pad_features(f, t)
    for t, i, b in itertools.product([32, 128, 256, 1024], [1, 2, 4],
                                     [1024, SMALL_BUDGET,
                                      ref.X_TILE_BUDGET_BYTES]):
        assert port.resident_window_rows(t, i, b) == \
            ref.resident_window_rows(t, i, b)
    for be, n, (C, R), w in itertools.product(
            ["resident", "windowed", "hbm", "nope"], [8, 4096, 20_000],
            CAPACITIES, [None, 64]):
        assert _outcome(port.estimate_vmem_bytes, be, n, C, R,
                        window_rows=w) == \
            _outcome(ref.estimate_vmem_bytes, be, n, C, R, window_rows=w)


@pytest.mark.parametrize("n", [100, 4096, 5_000, 20_000])
def test_assert_resident_fits_identical(n):
    for f, (C, R), i in itertools.product(FEATURES, CAPACITIES[:3], [2, 4]):
        assert _outcome(port.assert_resident_fits, n, f, C, R, itemsize=i) \
            == _outcome(ref.assert_resident_fits, n, f, C, R, itemsize=i)
    if n > WINDOW:
        with pytest.raises(port.VmemBudgetError, match=f"N_pad={n}"):
            port.assert_resident_fits(n, 64, 256, 64)


def test_route_fleet_identical():
    for n, f, blocks, devs, hosts in itertools.product(
            [100, 5_000, 20_000, 402_308], [16, 128, 1024, 2048],
            [1, 8, 64, 4096], [1, 2, 4, 8], [1, 2]):
        args = (n, f, 256, 64, blocks, devs)
        assert _outcome(port.route_fleet, *args, n_hosts=hosts) == \
            _outcome(ref.route_fleet, *args, n_hosts=hosts), (args, hosts)
    assert _outcome(port.route_fleet, 8, 8, 256, 64, 1, 1, n_hosts=0) == \
        _outcome(ref.route_fleet, 8, 8, 256, 64, 1, 1, n_hosts=0)
    d = port.route_fleet(20_000, 2048, 256, 64, 64, 4)
    assert d.describe() == ref.route_fleet(20_000, 2048, 256, 64, 64,
                                           4).describe()
