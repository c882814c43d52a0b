"""BENCHMARK.json against the contract, and every entry found from its files."""

import json
import re

import pytest

from benchmark.harness.env import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCHMARK = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys():
    assert set(BENCHMARK) == {"command", "paths", "run_seconds", "configs", "workloads",
                              "end_to_end", "per_layer"}
    assert BENCHMARK["paths"] == ["benchmark"]
    assert BENCHMARK["command"][:2] == ["python3", "benchmark/run.py"]
    assert 1 <= BENCHMARK["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def _one_line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


@pytest.mark.parametrize("entry", BENCHMARK["configs"], ids=lambda e: e["name"])
def test_config_has_its_files(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"]) and _one_line(entry["source"]) and _one_line(entry["why"])
    assert entry["file"] == f"benchmark/configs/{entry['name']}.json"
    cfg = json.loads((ROOT / entry["file"]).read_text())
    assert cfg["reduced"] == entry["reduced"] == [] and cfg["source"] == entry["source"]
    assert (BENCH / "configs" / f"{entry['name']}.py").exists()
    assert (BENCH / "reference" / f"{entry['name']}.py").exists()
    assert any(w["config"] == entry["name"] for w in BENCHMARK["workloads"])


@pytest.mark.parametrize("cell", BENCHMARK["workloads"], ids=lambda e: e["name"])
def test_cell_has_its_files(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"]) and _one_line(cell["why"])
    assert cell["chips"] == 1
    traffic = json.loads((BENCH / "traffic" / f"{cell['traffic']}.json").read_text())
    assert (BENCH / "harness" / f"{traffic['kind']}_driver.py").exists()
    own = json.loads((BENCH / "workloads" / f"{cell['name']}.json").read_text())
    assert own["limits"] and all(v >= 0 for v in own["limits"].values())
    reported = [m for m in BENCHMARK["end_to_end"]
                if cell["name"] in m.get("workloads", [cell["name"]])]
    assert {"setup_s"} < {m["name"] for m in reported}
    assert any(cell["name"] in m.get("workloads", [cell["name"]]) for m in BENCHMARK["per_layer"])


def test_cells_are_distinct():
    pairs = [(c["config"], c["traffic"]) for c in BENCHMARK["workloads"]]
    assert len(set(pairs)) == len(pairs)
    names = [e["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for e in BENCHMARK[key]]
    assert len(set(names)) == len(names)


@pytest.mark.parametrize("metric", BENCHMARK["end_to_end"], ids=lambda e: e["name"])
def test_end_to_end_metric(metric):
    assert set(metric) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert metric["source"] in ("host_clock", "device_trace")
    assert 0.01 <= metric["bound"] <= 0.25


@pytest.mark.parametrize("metric", BENCHMARK["per_layer"], ids=lambda e: e["name"])
def test_per_layer_metric_has_its_reader(metric):
    assert set(metric) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"]) and _one_line(metric["layer"])
    assert metric["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    moved = next(m for m in BENCHMARK["end_to_end"] if m["name"] == metric["moves"])
    for cell in metric["workloads"]:
        assert cell in moved.get("workloads", [cell])
    if metric["name"].endswith("_roofline") or "mfu" in metric["name"]:
        assert metric["unit"] == "%"
    text = (BENCH / "metrics" / f"{metric['name']}.py").read_text()
    assert "def read(ctx)" in text


def test_layers_named_alike():
    layers = {m["layer"] for m in BENCHMARK["per_layer"]}
    perf = (ROOT / "PERF.md").read_text()
    for layer in layers:
        assert layer in perf
