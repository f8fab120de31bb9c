"""A configuration, a traffic mix, a cell's limits and a per-layer metric
are added as new files and new entries of ``BENCHMARK.json``: no file that
is there changes, and the harness finds and runs them."""
import hashlib
import json

from gcnbench import spec


def digests(root):
    return {p.relative_to(root).as_posix(): hashlib.sha256(
        p.read_bytes()).hexdigest()
        for p in sorted(root.rglob("*")) if p.is_file()
        and p.name != "BENCHMARK.json" and "data" not in p.parts}


def test_new_files_add_a_cell_and_a_metric(tiny):
    run, root, bench = tiny
    before = digests(root)
    cfg = json.loads((root / "configs" / "gcn-arxiv.json").read_text())
    cfg.update(name="gcn-wide")
    cfg["model"]["dims"] = [12, 32, 4]
    (root / "configs" / "gcn-wide.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "train-slow.json").write_text(json.dumps(
        {"driver": "train", "lr": 0.05, "checked_steps": 3}))
    (bench / "limits" / "gcn-wide.train-slow.json").write_text(json.dumps(
        {"loss_gap": 1e-3, "grad_gap": 1e-2, "update_gap": 1e-2}))
    (bench / "metrics" / "steps_per_s.train.py").write_text(
        "def read(rec):\n"
        "    return 1.0 / rec['step_s'] if rec.get('step_s') else None\n")
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "gcn-wide", "source": "https://example.org",
                         "file": "configs/gcn-wide.json", "reduced": [],
                         "why": "a wider hidden layer"})
    b["workloads"].append({"name": "gcn-wide.train-slow", "config": "gcn-wide",
                           "traffic": "train-slow", "chips": 1,
                           "why": "the added cell"})
    b["per_layer"].append({"name": "steps_per_s.train", "unit": "1/s",
                           "better": "higher", "source": "host_clock",
                           "layer": "models/gcn.py model",
                           "moves": "train_step_ms"})
    for m in b["end_to_end"]:
        if "workloads" in m and "sage-reddit.train" in m["workloads"]:
            m["workloads"].append("gcn-wide.train-slow")
    (root / "BENCHMARK.json").write_text(json.dumps(b))

    cell = spec.load_cell("gcn-wide.train-slow", root, bench)
    assert cell.config["model"]["dims"] == [12, 32, 4]
    assert cell.traffic["lr"] == 0.05
    names = {m.name for m in cell.per_layer}
    # a metric without ``workloads`` goes to every cell reporting what it
    # moves, the existing training cells included
    assert "steps_per_s.train" in names
    assert "steps_per_s.train" in {
        m.name for m in spec.load_cell("sage-reddit.train", root,
                                       bench).per_layer}
    assert "steps_per_s.train" not in {
        m.name for m in spec.load_cell("gcn-arxiv.train", root,
                                       bench).per_layer}
    r = run("gcn-wide.train-slow", trace=True)
    assert r["correct"] and r["metrics"]["steps_per_s.train"]["value"] > 0
    r = run("gcn-wide.train-slow")
    assert set(r["metrics"]) == {"setup_s", "train_step_ms", "train_peak_gib"}
    assert digests(root) == {**before, **{k: v for k, v in digests(
        root).items() if k not in before}}
    assert all(digests(root)[k] == v for k, v in before.items())


def test_a_qualified_metric_reads_its_quantity(tiny):
    """``train_step_ms.small_graph`` is the driver's ``train_step_ms``, in
    the cells that list it, and the per-layer metrics that move it are
    read there."""
    run, _, _ = tiny
    r = run("gcn-arxiv.train")
    assert set(r["metrics"]) == {"setup_s", "train_step_ms.small_graph",
                                 "train_peak_gib"}
    assert r["metrics"]["train_step_ms.small_graph"]["value"] > 0
    r = run("gcn-arxiv.train", trace=True)
    assert {"mfu.train.small_graph", "plan_build_s"} <= set(r["metrics"])
    assert "mfu.train" not in r["metrics"]
