"""Every configuration, cell and metric file parses, and agrees with
BENCHMARK.json."""

import json
import re
from pathlib import Path

import pytest

from portbench import harness, readers

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def e2e_of(cell: str):
    return [m["name"] for m in BENCH["end_to_end"]
            if cell in m.get("workloads", CELLS)]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_file_matches_benchmark(cell):
    w = harness.workload(cell)
    entry = next(x for x in BENCH["workloads"] if x["name"] == cell)
    for k in ("config", "traffic", "chips", "why"):
        assert w[k] == entry[k], k
    cfg = harness.config(w["config"])
    assert cfg["name"] == w["config"]
    assert (ROOT / "portbench" / "drivers" / f"{w['entry']}.py").exists()
    assert w["limits"] and all(v > 0 for v in w["limits"].values())
    assert "setup_s" in e2e_of(cell) and len(e2e_of(cell)) >= 2


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_matches_benchmark(cfg):
    path = ROOT / cfg["file"]
    data = json.loads(path.read_text())
    assert data["name"] == cfg["name"]
    assert data["reduced"] == cfg["reduced"]
    assert data["source"] == cfg["source"]
    assert all(k in data for k in cfg["reduced"])


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_dir_matches_benchmark(metric):
    spec = next(m for m in BENCH["per_layer"] if m["name"] == metric)
    d = ROOT / "portbench" / "metrics" / metric
    mine = json.loads((d / "metric.json").read_text())
    reader = mine.pop("reader", None)
    assert mine == spec
    assert (hasattr(readers, reader) if reader is not None
            else (d / "reader.py").exists())
    for cell in spec["workloads"]:
        assert spec["moves"] in e2e_of(cell), (cell, spec["moves"])
        assert d in harness.per_layer_for(cell)


def test_every_metric_dir_is_in_benchmark():
    names = {m["name"] for m in BENCH["per_layer"]}
    assert {d.name for d in harness.metric_dirs()} == names


def test_names_and_layers():
    ms = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in ms] + CELLS + [c["name"] for c in
                                               BENCH["configs"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert all(m["better"] in ("lower", "higher") for m in ms)
    assert all(re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"]) for m in ms)
    setup = next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in BENCH["end_to_end"])


def test_kernel_pattern_files_are_regexes():
    for d in harness.metric_dirs():
        for f in d.glob("kernels*.txt"):
            for p in harness.lines(f):
                re.compile(p)
