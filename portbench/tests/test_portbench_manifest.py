"""BENCHMARK.json against the benchmark's contract, and every file a cell
names found by its name."""

from __future__ import annotations

import json
import os
import re

import pytest

from portbench import harness

REPO = harness.ROOT
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}

with open(os.path.join(REPO, "BENCHMARK.json")) as _f:
    BENCH = json.load(_f)


def one_line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(REPO, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16
    assert all(PATH.match(p) and ".." not in p for p in BENCH["paths"])
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(one_line(w) and not w.startswith("/") for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    # the check's whole budget, with the full 24 cells
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_entries():
    entries = {"configs": {"name", "source", "file", "reduced", "why"},
               "workloads": {"name", "config", "traffic", "chips", "why"}}
    for section, keys in entries.items():
        for e in BENCH[section]:
            assert set(e) == keys, e
            assert NAME.match(e["name"]) and one_line(e["why"])
    for c in BENCH["configs"]:
        assert one_line(c["source"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith("portbench/")
    for w in BENCH["workloads"]:
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
        assert w["chips"] in (1, 4)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert one_line(m["layer"])
    names = [e["name"] for s in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in BENCH[s]]
    assert len(names) == len(set(names))
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) \
        == len(BENCH["workloads"])
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(
        1, len(BENCH["workloads"]) // 4)


def test_metrics_reach_every_cell():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in e2e["setup_s"]
    cells = {w["name"] for w in BENCH["workloads"]}
    configs = {c["name"] for c in BENCH["configs"]}
    assert configs == {w["config"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        assert set(m.get("workloads", cells)) <= set(
            moved.get("workloads", cells))
    for cell in cells:
        own = [m for m in BENCH["end_to_end"] if harness.applies(m, cell)]
        assert len(own) >= 2
        assert any(harness.applies(m, cell) for m in BENCH["per_layer"])


def test_layers_are_named_in_perf_md():
    with open(os.path.join(REPO, "PERF.md")) as f:
        perf = f.read()
    for m in BENCH["per_layer"]:
        assert f"`{m['layer']}`" in perf, m["layer"]


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_found_by_name(cell):
    c = harness.Cell(cell)
    assert c.config["model"]["encoder"]["layers"]
    driver = c.driver()
    assert callable(driver.run)
    for m in c.per_layer:
        assert callable(c.reader(m["name"]).read)
    assert c.limits, f"portbench/limits/{cell}.json"
    for name, entry in c.limits.items():
        assert entry["lower"] < entry["limit"] < entry["upper"], name


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_is_the_flagship(entry):
    """Nothing cut: the model section is configs/uncertainty.yml's, the
    frozen graphs are graphs/nodes_5_seed_42's."""
    from uncertainty_model_tpu_torch.config import FLAGSHIP_MODEL, load_config

    cfg = harness.load_json(os.path.join(REPO, entry["file"]))
    assert cfg["model"] == FLAGSHIP_MODEL
    assert cfg["model"] == load_config(os.path.join(
        REPO, "configs", "uncertainty.yml"))["model"]
    assert entry["reduced"] == cfg["reduced"] == []
    for s in range(1, 6):
        graph = harness.load_json(os.path.join(
            REPO, "graphs", "nodes_5_seed_42", f"stage_{s}.json"))
        assert cfg["graph_adjacency"][f"stage_{s}"] == graph["adjacency"]
    if "loss" in cfg:
        from uncertainty_model_tpu_torch.config import FLAGSHIP_LOSS

        assert cfg["loss"] == FLAGSHIP_LOSS
