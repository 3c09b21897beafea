"""BENCHMARK.json against the contract it is read by: names, units,
keys, and a file under benchmark/ for everything a cell names."""
import json
import re

import pytest

from benchmark import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = spec.load()


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51


def test_names_and_units():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group, e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
    assert len(names) == len(set(names))


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_cell_files(cell):
    cfg = spec.config(BENCH, cell)
    assert callable(spec.loop(spec.traffic(cell)).run)
    assert set(cfg["limits"]) >= {"node_counts", "leaf_values"}
    e2e = spec.metrics(BENCH, cell, trace=False)
    assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
    assert spec.metrics(BENCH, cell, trace=True)


@pytest.mark.parametrize(
    "metric", BENCH["end_to_end"] + BENCH["per_layer"],
    ids=lambda m: m["name"])
def test_metric_has_reader(metric):
    assert callable(spec.reader(metric["name"]).read)


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_per_layer_moves_an_end_to_end_metric_of_its_cells(metric):
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    target = e2e[metric["moves"]]
    for w in metric["workloads"]:
        assert w in target.get("workloads", [w])
    if metric["name"].endswith("_roofline"):
        step = metric["name"][:-len("_roofline")]
        assert spec.kernel_names(step) and metric["unit"] == "%"


def test_config_entries_match_their_files():
    for c in BENCH["configs"]:
        with open(spec.ROOT / c["file"]) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
