"""The yardstick's FLOP and byte counts against counts made by hand on a
tiny graph, and the metric readers on a record made by hand."""
import pytest

from gcnbench import flops, peaks, spec

N, NNZ = 5, 7          # a 5-node graph with 7 entries


def test_gcn_flops_by_hand():
    # dims 3 -> 4 -> 2: hW 2*5*3*4 = 120, A'(hW) 2*7*4 = 56; 2*5*4*2 = 80,
    # 2*7*2 = 28
    assert flops.model_flops("gcn", [3, 4, 2], N, NNZ, False) == 284
    # training: the first layer's product twice (no input gradient), its
    # aggregation twice (hW needs one); the second's product thrice
    assert flops.model_flops("gcn", [3, 4, 2], N, NNZ, True) == (
        120 * 2 + 56 * 2 + 80 * 3 + 28 * 2)


def test_sage_flops_by_hand():
    # A h 2*7*3 = 42, two products 2*120; A h 2*7*4 = 56, two products 2*80
    assert flops.model_flops("sage", [3, 4, 2], N, NNZ, False) == 498
    # the raw features' aggregation once, its products twice each
    assert flops.model_flops("sage", [3, 4, 2], N, NNZ, True) == (
        42 + 240 * 2 + 56 * 2 + 160 * 3)


def test_unknown_variant_raises():
    with pytest.raises(ValueError):
        flops.model_flops("gin", [3, 4], N, NNZ, False)


def test_aggregation_bytes_by_hand():
    # rowptr 6, colidx 7 and values 7 int32/fp32, X 5x4, Y 5x4: 60 words
    assert flops.aggregation_bytes(5, 5, 7, 4) == 4 * (6 + 14 + 20 + 20)


def _read(name, rec):
    return spec.metric_reader(name)(rec)


def test_readers_on_a_record_by_hand():
    cfg = {"model": {"variant": "gcn", "dims": [3, 4, 2]}}
    rec = {"config": cfg, "n": N, "nnz": NNZ, "plan_build_s": 1.5,
           "step_s": 2.0,
           "aggr_calls": [(5, 5, 7, 4), (5, 5, 7, 2)],
           "trace": {"window_s": 2.0, "busy_s": 0.5,
                     "range_device_s": {"gcnbench.aggr": 1e-9}}}
    assert _read("plan_build_s", rec) == 1.5
    assert _read("mfu.train", rec) == pytest.approx(
        100 * 648 / 2.0 / peaks.FP32_FLOP_PER_S)
    need = flops.aggregation_bytes(5, 5, 7, 4) + flops.aggregation_bytes(
        5, 5, 7, 2)
    assert _read("spmm_roofline.train", rec) == pytest.approx(
        100 * need / peaks.HBM_BYTES_PER_S / 1e-9)
    assert _read("device_idle.train", rec) == pytest.approx(75.0)


def test_readers_find_nothing_and_return_none():
    rec = {"config": {"model": {"variant": "gcn", "dims": [3, 2]}},
           "n": N, "nnz": NNZ}
    for name in ("spmm_roofline.train", "mfu.train", "device_idle.train",
                 "plan_build_s"):
        assert _read(name, rec) is None, name
    # a trace whose ranges launched nothing reads nothing, never 0
    rec.update(aggr_calls=[(5, 5, 7, 4)], trace={"range_device_s": {}})
    assert _read("spmm_roofline.train", rec) is None
