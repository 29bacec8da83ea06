"""``BENCHMARK.json`` against the rules of its format, and every name in it
resolved to the files that the harness finds by name."""

import json
import re
import shutil

import pytest

from benchmark import core, harness
from benchmark.tests import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
WIDTHS = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|"
                    r"projection|head|expansion|features")

M = core.load_json(core.ROOT / "BENCHMARK.json")


def _line(text, limit=200):
    return (isinstance(text, str) and 1 <= len(text) <= limit
            and "\n" not in text and "\t" not in text)


def test_top_level():
    assert set(M) == KEYS["top"]
    assert (core.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(M["paths"]) <= 16
    for p in M["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    assert 1 <= len(M["command"]) <= 32
    assert all(_line(w) for w in M["command"])
    for word in M["command"][1:]:
        if "/" in word:
            assert any(word.startswith(p + "/") for p in M["paths"])
    assert isinstance(M["run_seconds"], int) and 1 <= M["run_seconds"] <= 51


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_entries(kind):
    entries = M[kind]
    assert entries
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    for e in entries:
        extra = {"workloads"} if kind in ("end_to_end", "per_layer") else set()
        assert KEYS[kind] <= set(e) <= KEYS[kind] | extra, e["name"]
        assert NAME.match(e["name"])
        if "unit" in e:
            assert UNIT.match(e["unit"]) and len(e["unit"]) <= 16
            assert e["better"] in ("lower", "higher")
            assert e["source"] in SOURCES
        for key in ("why", "layer", "source"):
            if key in e and kind != "end_to_end":
                assert _line(e[key]), (e["name"], key)


def test_configs():
    assert 1 <= len(M["configs"]) <= 24
    files = [c["file"] for c in M["configs"]]
    assert len(files) == len(set(files))
    used = {w["config"] for w in M["workloads"]}
    for c in M["configs"]:
        assert c["name"] in used
        assert any(c["file"].startswith(p + "/") for p in M["paths"])
        assert (core.ROOT / c["file"]).is_file()
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key) and not WIDTHS.search(key)


def test_workloads():
    assert 1 <= len(M["workloads"]) <= 24
    pairs = [(w["config"], w["traffic"]) for w in M["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in M["workloads"])
    assert four <= max(1, len(M["workloads"]) // 4)
    for w in M["workloads"]:
        assert w["chips"] in (1, 4)
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])


def test_metrics():
    e2e = {m["name"]: m for m in M["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in M["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in M["workloads"]}
    layers = {m["layer"] for m in M["per_layer"]}
    for m in M["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert cell in cells
            # The cell reports the metric that this one moves.
            assert cell in e2e[m["moves"]].get("workloads", cells)
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert layers
    for cell in cells:
        reported = [m for m in M["end_to_end"]
                    if cell in m.get("workloads", cells)]
        assert len(reported) >= 2  # setup_s and another
        assert any(cell in m.get("workloads", cells)
                   for m in M["per_layer"])


@pytest.mark.parametrize("name", [w["name"] for w in M["workloads"]])
def test_each_cell_resolves_by_name(name):
    cell = core.Cell(name)
    driver = core.load_module(cell.driver_path)
    assert hasattr(driver, "Driver")
    assert cell.reference_path.is_file()
    assert set(cell.own["limits"])
    for m in cell.metrics("per_layer"):
        assert callable(cell.reader(m["name"]).read)
    assert cell.metrics("end_to_end")


def test_files_are_named_from_names():
    for path in core.BENCH.rglob("*"):
        if "__pycache__" in path.parts:
            continue
        rel = path.relative_to(core.ROOT).as_posix()
        assert PATH.match(rel), rel


def test_a_cell_config_and_metric_added_as_files_alone(tmp_path):
    """A new cell, configuration and per-layer metric are new data and new
    files: entries of BENCHMARK.json, a configuration file, a traffic file,
    the cell's own file and a reader; no file of the harness changes."""
    root = tiny.make(tmp_path)
    bench = root / "benchmark"
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    manifest["configs"].append(
        {"name": "tabular_qtable_small",
         "source": "https://github.com/Rocco9999/2048_Q-Learning",
         "file": "benchmark/configs/tabular_qtable_small.json",
         "reduced": ["capacity_log2"], "why": "a smaller table, as data"})
    manifest["workloads"].append(
        {"name": "tabular_train_small", "config": "tabular_qtable_small",
         "traffic": "train_tabular_small", "chips": 1,
         "why": "a second tabular mix, added as data"})
    manifest["per_layer"].append(
        {"name": "tabular.traced_steps", "unit": "steps", "better": "higher",
         "source": "program_counter", "layer": "tabular trainer",
         "moves": "env_steps_per_s", "workloads": ["tabular_train_small"]})
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if "tabular_train" in m.get("workloads", []):
            m["workloads"].append("tabular_train_small")
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    config = json.loads((bench / "configs"
                         / "tabular_qtable_ref.json").read_text())
    config.update(name="tabular_qtable_small", capacity_log2=10)
    (bench / "configs" / "tabular_qtable_small.json").write_text(
        json.dumps(config))
    traffic = json.loads((bench / "traffic"
                          / "train_tabular_defaults.json").read_text())
    traffic.update(lanes=8, steps_per_chunk=4)
    (bench / "traffic" / "train_tabular_small.json").write_text(
        json.dumps(traffic))
    shutil.copy(bench / "workloads" / "tabular_train.json",
                bench / "workloads" / "tabular_train_small.json")
    (bench / "metrics" / "tabular.traced_steps.py").write_text(
        "def read(s):\n    return s.counts.get('steps')\n")
    cell = core.Cell("tabular_train_small", root)
    line = harness.run_cell(cell, 7, 0.2, False, "cpu")
    assert line["correct"]
    assert set(line["metrics"]) == {"env_steps_per_s", "setup_s"}
    assert list(line)[-1] == "checks"
    traced = harness.run_cell(cell, 8, 0.2, True, "cpu")
    assert traced["correct"]
    assert traced["metrics"]["tabular.traced_steps"]["value"] == 4
