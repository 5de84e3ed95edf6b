"""BENCHMARK.json against the rules it is checked by before any run, and
against the files the harness finds by name."""
import json
import pathlib
import re

import pytest

from benchmark.harness import Bench

REPO = pathlib.Path(__file__).resolve().parents[2]
SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]
CELLS = {w["name"]: w for w in SPEC["workloads"]}


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_and_names():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51
    assert SPEC["paths"] == ["benchmark"]
    assert all(_line(w) for w in SPEC["command"])
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in SPEC[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    assert len({m["name"] for m in METRICS}) == len(METRICS)


def test_configs_and_cells():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"])
        conf = json.loads((REPO / c["file"]).read_text())
        assert conf["source"] == c["source"]
        assert sorted(c["reduced"]) == sorted(conf["reduced"])
        for k in c["reduced"]:
            assert NAME.match(k) and not k.endswith(("_dim", "_rank"))
            assert conf["published"][k] != conf[k]
        assert any(w["config"] == c["name"] for w in CELLS.values())
    for w in CELLS.values():
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and _line(w["why"])
        assert (REPO / "benchmark" / "traffic" / f"{w['traffic']}.json").exists()
        assert (REPO / "benchmark" / "cells" / f"{w['name']}.json").exists()
    pairs = [(w["config"], w["traffic"]) for w in CELLS.values()]
    assert len(pairs) == len(set(pairs))


def test_metrics():
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    setup = [m for m in SPEC["end_to_end"] if m["name"] == "setup_s"]
    assert setup and "workloads" not in setup[0]
    for m in METRICS:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert all(c in CELLS for c in m.get("workloads", []))
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    for cell in CELLS:
        mine = [m for m in SPEC["end_to_end"]
                if cell in m.get("workloads", [cell])]
        assert len(mine) >= 2
        assert any(cell in m.get("workloads", []) for m in SPEC["per_layer"])


@pytest.mark.parametrize("m", SPEC["per_layer"], ids=lambda m: m["name"])
def test_each_per_layer_metric_has_its_reader(m):
    assert set(m) == {"name", "unit", "better", "source", "layer", "moves",
                      "workloads"}
    assert _line(m["layer"])
    moves = [e for e in SPEC["end_to_end"] if e["name"] == m["moves"]][0]
    assert all(c in moves.get("workloads", [c]) for c in m["workloads"])
    mod = Bench(REPO).reader(m["name"])
    assert callable(mod.read)
    assert not {"LAYER", "UNIT", "SOURCE", "MOVES"} & set(vars(mod))
    if "roofline" in m["name"] or "mfu" in m["name"]:
        assert m["unit"] == "%"
