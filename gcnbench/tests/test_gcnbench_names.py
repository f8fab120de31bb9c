"""``BENCHMARK.json`` keeps to the contract's shapes: names, units, keys,
lengths, and a file for every name the harness looks up."""
import json
import re
from pathlib import Path

import pytest

from gcnbench import spec

REPO = Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
LINE = re.compile(r"^[^\n\t]{1,200}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["gcnbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(BENCH["command"]) <= 32
    for word in BENCH["command"]:
        assert LINE.match(word) and not word.startswith("/")
        assert ".." not in word
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_and_units():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        spec.check_name(c["name"])
        assert LINE.match(c["source"]) and LINE.match(c["why"])
        assert c["file"].startswith("gcnbench/") and (REPO / c["file"]).exists()
        assert len(c["reduced"]) <= 16
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        for k in ("name", "config", "traffic"):
            spec.check_name(w[k])
        assert w["chips"] in (1, 4) and LINE.match(w["why"])
        names.append(w["name"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        spec.check_name(m["name"])
        spec.check_unit(m["unit"])
        assert m["better"] in ("lower", "higher")
        names.append(m["name"])
    assert len(names) == len(set(names))


def test_metric_entries():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in e2e.values():
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25 and m["bound"] >= 0.01
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and LINE.match(m["layer"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        for w in m["workloads"]:
            moved = e2e[m["moves"]]
            assert "workloads" not in moved or w in moved["workloads"]
        if m["unit"] == "%" and ("roofline" in m["name"] or "mfu" in m["name"]):
            assert m["better"] == "higher"


@pytest.mark.parametrize("w", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_finds_its_files_and_reports_enough(w):
    cell = spec.load_cell(w, REPO)
    names = {m.name for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert callable(spec.metric_reader(m.name))
    assert cell.traffic["driver"] in ("train",)
    assert cell.limits and all(v > 0 for v in cell.limits.values())


def test_files_under_the_benchmark_are_named_from_name_characters():
    for p in (REPO / "gcnbench").rglob("*"):
        rel = p.relative_to(REPO).as_posix()
        if "__pycache__" in rel or "/.data" in rel:
            continue
        for part in rel.split("/"):
            assert re.match(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]*$", part), rel


@pytest.mark.parametrize("bad", ["", "a b", "a,b", "a/b", ".x", "-x",
                                 "x" * 65, "µs"])
def test_check_name_refuses(bad):
    with pytest.raises(ValueError):
        spec.check_name(bad)


@pytest.mark.parametrize("bad", ["", "tokens per s", "x" * 17, "µs"])
def test_check_unit_refuses(bad):
    with pytest.raises(ValueError):
        spec.check_unit(bad)
