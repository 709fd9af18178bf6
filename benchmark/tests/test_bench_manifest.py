"""BENCHMARK.json against the contract's form: names, units, keys and
lengths, and every file the harness finds by name."""

import importlib
import json
import os
import re

import pytest

from benchmark import harness, scene

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./\-]{1,200}$")
MAN = harness.manifest()


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(MAN["command"]) <= 32
    assert all(_line(w) and not w.startswith("/") and ".." not in w
               for w in MAN["command"])
    assert 1 <= len(MAN["paths"]) <= 16
    assert all(PATH.match(p) for p in MAN["paths"])
    assert isinstance(MAN["run_seconds"], int) and 1 <= MAN["run_seconds"] <= 51
    cells = len(MAN["workloads"])
    assert (2 + 14 * 24) * (MAN["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    assert 1 <= cells <= 24
    assert len(json.dumps(MAN).encode()) <= 64 * 1024


@pytest.mark.parametrize("entry", MAN["configs"], ids=lambda c: c["name"])
def test_configs(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"])
    assert _line(entry["source"]) and _line(entry["why"])
    assert entry["file"].startswith(MAN["paths"][0] + "/")
    assert os.path.exists(os.path.join(harness.ROOT, entry["file"]))
    assert len(entry["reduced"]) <= 16
    cfg = scene.load("configs", entry["name"])
    assert cfg["reduced"] == entry["reduced"]
    assert any(w["config"] == entry["name"] for w in MAN["workloads"])


@pytest.mark.parametrize("cell", MAN["workloads"], ids=lambda w: w["name"])
def test_workloads(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"])
    assert cell["chips"] in (1, 4)
    assert _line(cell["why"])
    assert cell["config"] in {c["name"] for c in MAN["configs"]}
    scene.load("traffic", cell["traffic"])
    lim = harness.limits(cell["name"])
    assert "agents_off" in lim
    e2e = harness.metrics_of(MAN, cell["name"], "end_to_end")
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    assert harness.metrics_of(MAN, cell["name"], "per_layer")


def test_unique_names():
    for key in ("configs", "workloads"):
        names = [x["name"] for x in MAN[key]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    assert len(metrics) == len(set(metrics))
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("m", MAN["end_to_end"], ids=lambda m: m["name"])
def test_end_to_end(m):
    assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                      "source"}
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert m["source"] in ("host_clock", "device_trace")
    assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("m", MAN["per_layer"], ids=lambda m: m["name"])
def test_per_layer(m):
    assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                      "layer", "moves"}
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["source"] in ("device_trace", "program_span",
                           "program_counter", "host_clock")
    assert _line(m["layer"])
    cells = m.get("workloads", [w["name"] for w in MAN["workloads"]])
    for c in cells:
        moved = harness.metrics_of(MAN, c, "end_to_end")
        assert m["moves"] in {e["name"] for e in moved}
    mod = importlib.import_module(f"benchmark.metrics.{m['name']}")
    assert callable(mod.read)
    if m["name"].endswith("_roofline"):
        assert m["unit"] == "%"
