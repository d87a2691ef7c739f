"""BENCHMARK.json, the registry and the files each name needs."""

import json
import os
import re

import pytest

from portbench import registry

BENCH = registry.load_benchmark()
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
LINE = re.compile(r"^[^\n\t]{1,200}$")


def test_top_level_keys_and_limits():
    assert set(BENCH) == KEYS
    assert 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["paths"] == ["portbench"]
    assert len(BENCH["command"]) <= 32
    assert all(LINE.match(w) for w in BENCH["command"])
    cells = len(BENCH["workloads"])
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(
        1, cells // 4)
    assert os.path.getsize(os.path.join(registry.ROOT,
                                        "BENCHMARK.json")) <= 64 * 1024


def test_entries_have_exactly_their_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}


def test_names_units_and_lines():
    names = [x["name"] for part in ("configs", "workloads", "end_to_end",
                                    "per_layer") for x in BENCH[part]]
    assert len(names) == len(set(names))
    for n in names + [w["config"] for w in BENCH["workloads"]] + [
            w["traffic"] for w in BENCH["workloads"]]:
        assert registry.NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert registry.UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for x in BENCH["configs"] + BENCH["workloads"]:
        assert LINE.match(x["why"])
    for m in BENCH["per_layer"]:
        assert LINE.match(m["layer"])


def test_every_cell_reports_what_it_must():
    for w in BENCH["workloads"]:
        cell = registry.cell(w["name"])
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in e2e
        assert cell.limits
        registry.driver(cell.traffic["driver"])


def test_every_config_is_used_and_its_file_under_paths():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("portbench/")
        with open(os.path.join(registry.ROOT, c["file"])) as f:
            assert json.load(f)["name"] == c["name"]


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["end_to_end"]
                                    + BENCH["per_layer"]])
def test_every_metric_has_a_reader(metric):
    assert callable(registry.reader(metric))


def test_unknown_names_are_refused():
    with pytest.raises(KeyError):
        registry.cell("no-such-cell")
    with pytest.raises(KeyError):
        registry.reader("no_such_metric")
    with pytest.raises(ValueError):
        registry.cell("../BENCHMARK")
    with pytest.raises(ValueError):
        registry.driver("../run")
