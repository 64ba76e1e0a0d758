"""``BENCHMARK.json`` against the rules it is checked by, and every
file it names. :func:`check` runs every rule on another checkout."""

from __future__ import annotations

import json
import os
import re

import pytest

from portbench.tests._tiny import REPO, manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
KEYS = {
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves",
                  "workloads"},
}


@pytest.fixture(scope="module")
def man():
    return manifest()


@pytest.fixture(scope="module")
def root():
    return REPO


def test_top_level_keys_and_command(man):
    assert set(man) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert man["paths"] == ["portbench"]
    assert man["command"] == ["python3", "portbench/run.py"]
    assert 1 <= man["run_seconds"] <= 51
    assert isinstance(man["run_seconds"], int)
    assert len(json.dumps(man)) < 64 * 1024


@pytest.mark.parametrize("group,kind", [
    ("configs", "config"), ("workloads", "workload"),
    ("end_to_end", "end_to_end"), ("per_layer", "per_layer")])
def test_entries_names_and_units(man, group, kind):
    names = [e["name"] for e in man[group]]
    assert len(names) == len(set(names))
    for e in man[group]:
        assert set(e) <= KEYS[kind], e["name"]
        assert NAME.match(e["name"]), e["name"]
        for key in ("why", "layer", "source"):
            if key in e and kind != "end_to_end" and kind != "per_layer":
                assert TEXT.match(e[key]), (e["name"], key)
        if "unit" in e:
            assert UNIT.match(e["unit"]), (e["name"], e["unit"])
            assert e["better"] in ("lower", "higher")
            assert e["source"] in SOURCES
        if kind == "per_layer":
            assert TEXT.match(e["layer"])


def test_metric_names_unique_across_groups(man):
    names = [m["name"] for m in man["end_to_end"] + man["per_layer"]]
    assert len(names) == len(set(names))


def test_bounds(man):
    for m in man["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25, m["name"]
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25
               for m in man["end_to_end"])


def _reports(man, metric, cell):
    return cell in metric.get("workloads", [cell])


def test_every_config_has_a_cell_and_each_cell_a_config(man):
    configs = {c["name"] for c in man["configs"]}
    used = {w["config"] for w in man["workloads"]}
    assert configs == used
    pairs = [(w["config"], w["traffic"]) for w in man["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_cells_report_setup_another_metric_and_a_layer(man):
    for w in man["workloads"]:
        cell = w["name"]
        assert w["chips"] == 1
        e2e = [m["name"] for m in man["end_to_end"] if _reports(man, m, cell)]
        assert "setup_s" in e2e and len(e2e) >= 2, cell
        assert any(_reports(man, m, cell) for m in man["per_layer"]), cell


def test_moves_is_reported_by_each_cell_of_the_metric(man):
    e2e = {m["name"]: m for m in man["end_to_end"]}
    cells = {w["name"] for w in man["workloads"]}
    for m in man["per_layer"]:
        assert m["moves"] in e2e, m["name"]
        for cell in m.get("workloads", cells):
            assert cell in cells, (m["name"], cell)
            assert _reports(man, e2e[m["moves"]], cell), (m["name"], cell)


def test_shares_are_percent(man):
    for m in man["per_layer"]:
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%", m["name"]


def test_named_files_exist(man, root):
    base = os.path.join(root, "portbench")
    for c in man["configs"]:
        assert c["file"].startswith("portbench/")
        with open(os.path.join(root, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"]
        assert cfg["reduced"] == c["reduced"]
        assert os.path.isfile(os.path.join(base, "drivers",
                                           cfg["driver"] + ".py"))
    for w in man["workloads"]:
        assert os.path.isfile(os.path.join(base, "traffic",
                                           w["traffic"] + ".json"))
        assert os.path.isfile(os.path.join(base, "limits",
                                           w["name"] + ".json"))
    for m in man["end_to_end"] + man["per_layer"]:
        # a name <base>.<variant> may be read by the reader of <base>
        assert any(os.path.isfile(os.path.join(base, "metrics", f + ".py"))
                   for f in (m["name"], m["name"].split(".")[0])), m["name"]


def test_four_chip_cells_within_a_quarter(man):
    four = sum(1 for w in man["workloads"] if w["chips"] == 4)
    assert four <= max(1, len(man["workloads"]) // 4)


def test_each_config_states_its_control_and_test_sizes(man, root):
    from portbench import harness

    for c in man["configs"]:
        with open(os.path.join(root, c["file"])) as f:
            cfg = json.load(f)
        stated = harness.controls(cfg)
        assert stated, c["name"]
        assert set(stated) <= set(harness.driver(root, cfg).CONTROLS), \
            c["name"]
        assert set(cfg["test"]) == {"cpu", "card"}, c["name"]
        for where in ("cpu", "card"):  # test sizes change keys it has
            assert set(cfg["test"][where]) <= set(cfg), (c["name"], where)


def check(man: dict, root: str) -> None:
    """Every rule of this file on the manifest ``man`` of the checkout at
    ``root``."""
    test_top_level_keys_and_command(man)
    for group, kind in [("configs", "config"), ("workloads", "workload"),
                        ("end_to_end", "end_to_end"),
                        ("per_layer", "per_layer")]:
        test_entries_names_and_units(man, group, kind)
    for rule in (test_metric_names_unique_across_groups, test_bounds,
                 test_every_config_has_a_cell_and_each_cell_a_config,
                 test_cells_report_setup_another_metric_and_a_layer,
                 test_moves_is_reported_by_each_cell_of_the_metric,
                 test_shares_are_percent,
                 test_four_chip_cells_within_a_quarter):
        rule(man)
    test_named_files_exist(man, root)
    test_each_config_states_its_control_and_test_sizes(man, root)
