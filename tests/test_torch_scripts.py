"""The port's user scripts (``python -m repro_torch.scripts.<name>``)
against the reference's ``scripts/*.py``.

* ``hillclimb``: ``VARIANTS`` has the reference's keys and bundles (read
  from the reference's source with ``ast``: importing the reference's
  script sets ``XLA_FLAGS`` for the whole process); ``apply_flags`` sets
  the port's flags and puts them back, and ``headshard_off`` reaches the
  name attention calls; the extrapolated probes equal a direct full-depth
  count of rank 0's partitioned program (integers: exactly), with and
  without microbatching; the terms are the card row's.
* ``coll_breakdown``: the (kind, dtype, source) rows of each kind sum to
  ``Counts.coll_bytes``; ``models.layers:_row_parallel`` is the source of
  the largest share of the all-reduces over "model" and runs nothing else.
* ``tune_partition``: the report's keys, candidate labels and graph on a
  synthetic graph are the reference CLI's (times are not compared).
* ``make_experiments_tables``: the reference's section headings and table
  columns (trace seconds for compile seconds, the card's memory for the
  TPU's), and a hardware note from the card's row.
"""
import ast
import importlib.util
import json
import os

import pytest

from repro_torch.configs import get_reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_device_mesh
from repro_torch.scripts import (coll_breakdown, hillclimb,
                                 make_experiments_tables, tune_partition)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H100 = "NVIDIA H100 80GB HBM3"
SIZES = {"data": 2, "model": 2}
SHAPE = ShapeConfig("c", "train", 32, 8)


def _ref_script(name):
    spec = importlib.util.spec_from_file_location(
        f"_ref_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_variants_are_the_reference_bundles():
    with open(os.path.join(ROOT, "scripts", "hillclimb.py")) as f:
        tree = ast.parse(f.read())
    ref = next(ast.literal_eval(n.value) for n in tree.body
               if isinstance(n, ast.Assign)
               and any(getattr(t, "id", None) == "VARIANTS"
                       for t in n.targets))
    assert list(hillclimb.VARIANTS) == list(ref)
    assert hillclimb.VARIANTS == ref


@pytest.mark.parametrize("variant", sorted(hillclimb.VARIANTS))
def test_apply_flags_sets_and_restores(variant):
    import repro_torch.sharding as S
    from repro_torch.models import attention as A
    from repro_torch.models import moe as MO
    from repro_torch.sharding import rules as R
    flags = hillclimb.VARIANTS[variant]
    before = (A.BF16_EINSUMS, R.ZERO1_MOE, MO.DISPATCH_GROUPS,
              A.shard_heads, R.shard_heads, S.shard_heads)
    assert before == (False, False, 1, R.shard_heads, R.shard_heads,
                      R.shard_heads)
    restore = hillclimb.apply_flags(flags)
    try:
        assert A.BF16_EINSUMS == bool(flags.get("bf16_attn"))
        assert R.ZERO1_MOE == bool(flags.get("zero1_moe"))
        assert MO.DISPATCH_GROUPS == flags.get("dispatch_groups", 1)
        off = bool(flags.get("headshard_off"))
        # the name attention's projection calls, bound at its import
        called = A._project_qkv.__globals__["shard_heads"]
        assert (called is hillclimb._no_head_sharding) == off
        assert (R.shard_heads is hillclimb._no_head_sharding) == off
    finally:
        restore()
    assert (A.BF16_EINSUMS, R.ZERO1_MOE, MO.DISPATCH_GROUPS, A.shard_heads,
            R.shard_heads, S.shard_heads) == before


@pytest.mark.parametrize("variant", ["baseline", "microbatch4"])
def test_probe_extrapolation_equals_the_direct_count(variant):
    """Reduced phi3 cut to 4 layers, rank 0 of a fake group of 4: the
    extrapolated probes (1 and 2 layers) equal the 4-layer trace."""
    cfg = get_reduced("phi3-mini-3.8b").replace(n_layers=4)
    chunks = D.probe_chunks(SHAPE, hillclimb.VARIANTS[variant].get(
        "microbatch_div"))
    assert chunks.get("microbatch") == (2 if variant == "microbatch4"
                                        else None)
    got = hillclimb.probe_partitioned(cfg, SHAPE, SIZES, chunks)
    want = D.cost_vector(D.trace_partitioned(cfg, SHAPE, SIZES,
                                             chunks=chunks)[0])
    assert set(got) == set(want) and want["coll"] > 0
    for k, v in want.items():
        assert got[k] == v, k


def test_measure_record_on_the_card_row():
    cfg = get_reduced("phi3-mini-3.8b").replace(n_layers=4)
    base = hillclimb.measure(cfg, SHAPE, "baseline", sizes=SIZES, hw=H100)
    mb = hillclimb.measure(cfg, SHAPE, "microbatch4", sizes=SIZES, hw=H100)
    from repro_torch.analysis.roofline import HARDWARE
    row = HARDWARE[H100]
    for rec in (base, mb):
        c, t = rec["cost"], rec["terms"]
        assert rec["hw"] == H100 and rec["mesh"] == SIZES
        assert t == {"compute_s": c["flops"] / row["peak_flops"],
                     "memory_s": c["bytes"] / row["hbm_bw"],
                     "collective_s": c["coll"] / row["link_bw"]}
        assert rec["bottleneck"] == max(t, key=t.get)
        n = D.active_param_count(cfg)
        assert rec["useful"] == pytest.approx(
            6 * n * SHAPE.global_batch * SHAPE.seq_len / (c["flops"] * 4))
    # microbatching does the same FLOPs and gathers every weight per
    # microbatch (here 4 of them)
    assert mb["cost"]["flops"] == base["cost"]["flops"]
    assert mb["cost"]["coll_all-gather"] == 4 * base["cost"][
        "coll_all-gather"]


def test_coll_breakdown_rows_sum_to_the_count():
    cfg = get_reduced("phi3-mini-3.8b")
    rows, counts = coll_breakdown.breakdown(cfg, SHAPE, sizes=SIZES)
    per_kind = {}
    for (kind, dtype, src), b in rows:
        per_kind[kind] = per_kind.get(kind, 0) + b
        assert src != "?" and dtype in ("f32", "bf16"), (kind, dtype, src)
    assert per_kind == counts.coll_bytes
    assert rows == sorted(rows, key=lambda kv: (-kv[1], kv[0]))


def test_row_parallel_is_the_source_of_the_model_all_reduces():
    """The same trace with the mesh's group names at hand: every
    collective ``_row_parallel`` runs is an fp32 all-reduce over "model",
    and those carry the largest share of "model"'s all-reduce bytes."""
    cfg = get_reduced("phi3-mini-3.8b")
    chunks = D.probe_chunks(SHAPE)
    with D.fake_group(4):
        mesh = make_device_mesh(SIZES, device="meta")
        names = {mesh.get_group(i).group_name: n
                 for i, n in enumerate(mesh.mesh_dim_names)}
        fn, args = D.build_cell(cfg, SHAPE, chunks=chunks, mesh=mesh)
        c = D.run_counted(fn, args, "train", mesh)
    by_src = {}
    for (kind, g, *_, n), (dtype, src) in zip(c.collectives,
                                              c.collective_origins):
        if src == "models.layers:_row_parallel":
            assert (kind, names.get(g), dtype) == ("all-reduce", "model",
                                                   "f32")
        if kind == "all-reduce" and names.get(g) == "model":
            by_src[src] = by_src.get(src, 0) + n
    assert max(by_src, key=by_src.get) == "models.layers:_row_parallel"


def test_tune_partition_report_is_the_reference_cli_report(capsys):
    argv = ["--synthetic", "2000,10000,0", "--repeats", "1"]
    got = tune_partition.main(argv + ["--device", "cpu"])
    err = capsys.readouterr().err
    assert f"best: {got['best']['label']}" in err
    ref_mod = _ref_script("tune_partition")
    assert ref_mod.main(argv) == 0
    out = capsys.readouterr()
    want = json.loads(out.out.strip())
    assert "best: " in out.err
    got = json.loads(json.dumps(got, default=str))    # as printed
    assert set(got) == set(want) == {"base", "candidates", "best",
                                     "best_speedup", "graph"}
    assert got["graph"] == want["graph"]
    assert got["base"]["config"] == want["base"]["config"]
    assert [c["label"] for c in got["candidates"]] == \
        [c["label"] for c in want["candidates"]]
    for g, w in zip(got["candidates"], want["candidates"]):
        assert set(g) == set(w) and g["config"] == w["config"]


def _records(compile_key):
    mesh = {"argument_bytes_per_dev": 2.5e9, "temp_bytes_per_dev": 1.5e10,
            "rolled_cost": {"coll": 3.2e10}, compile_key: 12.5}
    return [{"arch": "a", "shape": "train_4k", "pod16x16": mesh,
             "multipod2x16x16": dict(mesh, temp_bytes_per_dev=1e11),
             "roofline": {"compute_s": 1.0, "memory_s": 2.0,
                          "collective_s": 0.5, "bottleneck": "memory",
                          "model_flops": 1e18, "useful_ratio": 0.5}},
            {"arch": "b", "shape": "long_500k", "skipped": "why"},
            {"arch": "c", "shape": "decode_32k", "error": "boom"}]


def test_make_experiments_tables_has_the_reference_headers(tmp_path,
                                                           capsys):
    port_p, ref_p = tmp_path / "port.json", tmp_path / "ref.json"
    port_p.write_text(json.dumps(_records("trace_s")))
    ref_p.write_text(json.dumps(_records("compile_s")))
    make_experiments_tables.main([str(port_p), "--hw", H100])
    got = capsys.readouterr().out.splitlines()
    _ref_script("make_experiments_tables").main(str(ref_p))
    want = capsys.readouterr().out.splitlines()
    assert len(got) == len(want)
    renamed = {"compile s": "trace s", "fits 16GB?": "fits 80GB?"}
    for g, w in zip(got, want):
        if w.startswith(("###", "| arch |", "|---")):
            for a, b in renamed.items():
                w = w.replace(a, b)
            assert g == w
    note = got[2]
    assert H100 in note and "TPU" not in note and "80 GB" in note
    assert "| a | train_4k | multipod2x16x16 | 12.5 |" in "\n".join(got)
    assert any("no (102GB)" in line for line in got)


def test_hillclimb_and_coll_breakdown_command_lines(tmp_path, monkeypatch,
                                                    capsys):
    """Both ``main``s on reduced phi3 at ``train_4k``'s shape (rank 0 of
    ``pod16x16``): hillclimb appends its record to ``--out``; the
    breakdown prints at most 25 rows."""
    for mod in (hillclimb, coll_breakdown):
        monkeypatch.setattr(mod, "get_config", get_reduced)
    out = tmp_path / "hc.json"
    argv = ["--arch", "phi3-mini-3.8b", "--shape", "train_4k"]
    for v in ("baseline", "microbatch4"):
        hillclimb.main(argv + ["--variant", v, "--hw", H100, "--out",
                               str(out)])
    recs = json.loads(out.read_text())
    assert [r["variant"] for r in recs] == ["baseline", "microbatch4"]
    assert recs[1]["chunks"]["microbatch"] == 64
    assert json.loads(capsys.readouterr().out.split("\n}\n")[0] + "}")[
        "variant"] == "baseline"
    rows = coll_breakdown.main(argv)
    printed = capsys.readouterr().out.splitlines()
    assert printed[0].startswith("# phi3-mini-3.8b x train_4k x baseline")
    assert len(printed) == 1 + min(25, len(rows))
