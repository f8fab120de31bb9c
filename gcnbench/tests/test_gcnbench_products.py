"""The ogbn-products cell, ``sage-products.train``: the metrics it reports,
its run at the tiny size on the CPU with each planted fault, and the reader
of the forward of its layers that aggregate first (``aggr_first_ms.train``)
on records made by hand."""
import pytest

from gcnbench import control, spec

CELL = "sage-products.train"
FAULTS = ["unchanged", "half_batch", "altered", "altered_late"]


def test_the_cell_reports_its_metrics():
    cell = spec.load_cell(CELL)
    assert cell.config["model"]["dims"] == [100, 256, 256, 47]
    assert cell.config["graph"]["nodes"] == 2449029
    assert cell.config["graph"]["edges"] == 123718280
    assert cell.config["reduced"] == []
    assert {m.name for m in cell.end_to_end} == {
        "setup_s", "train_step_ms", "train_peak_gib"}
    assert {m.name for m in cell.per_layer} == {
        "plan_build_s", "plan_transpose_s", "plan_hash_s", "plan_sort_s",
        "plan_partition_s", "plan_pack_s", "plan_copy_s",
        "spmm_roofline.train", "mfu.train", "device_idle.train",
        "unpermute_ms.train", "aggr_first_ms.train"}
    assert set(cell.limits) == {"loss_gap", "grad_gap", "update_gap"}


def test_aggr_first_is_read_only_in_this_cell():
    for other in ("sage-reddit.train", "gcn-arxiv.train"):
        assert "aggr_first_ms.train" not in {
            m.name for m in spec.load_cell(other).per_layer}


@pytest.mark.parametrize("fault", FAULTS)
def test_a_broken_run_is_not_correct(tiny, fault):
    run, _, _ = tiny
    assert run(CELL)["correct"]
    with control.planted(fault):
        r = run(CELL, seconds=0.8)
    assert r["correct"] is False, r["checks"]


def test_the_tiny_cell_keeps_the_full_sizes_orders(tiny):
    _, root, bench = tiny
    dims = spec.load_cell(CELL, root, bench).config["model"]["dims"]
    from repro_torch.models.gcn import transform_first
    orders = [transform_first("sage", a, b, i > 0, True)
              for i, (a, b) in enumerate(zip(dims[:-1], dims[1:]))]
    full = [100, 256, 256, 47]
    assert orders == [transform_first("sage", a, b, i > 0, True)
                      for i, (a, b) in enumerate(zip(full[:-1], full[1:]))]
    assert orders == [False, False, True]


def _reader():
    return spec.metric_reader("aggr_first_ms.train")


def test_aggr_first_reads_none_without_the_span():
    read = _reader()
    # a record the pass has not filled, off a card
    assert read({"config": {}, "n": 5, "nnz": 7}) is None
    # a pass on a program whose layers carry no such span (the parent's)
    rec = {"plan_spans": {"wall_s": {}},
           "program": {"steps": 4, "span_device_s": {
               "spmm.unpermute": 0.002, "aggr.fwd": 0.5}}}
    assert read(rec) is None
    # a pass that ran no step
    rec = {"plan_spans": {"wall_s": {}},
           "program": {"steps": 0,
                       "span_device_s": {"layer.aggr_first": 0.3}}}
    assert read(rec) is None


def test_aggr_first_reads_the_device_ms_a_step():
    rec = {"plan_spans": {"wall_s": {}},
           "program": {"steps": 4, "span_device_s": {
               "layer.aggr_first": 0.44, "layer.transform_first": 0.1,
               "spmm.unpermute": 0.002}}}
    assert _reader()(rec) == pytest.approx(110.0)
