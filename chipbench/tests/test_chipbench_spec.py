"""``BENCHMARK.json`` keeps to its format: its keys, the
characters of names and units, the lengths of the texts, and every file a
name leads to."""

import json
import os
import re

import pytest

from chipbench import spec
from chipbench.tests import smoke

BENCH = spec.Spec(smoke.ROOT)
DATA = BENCH.data
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n\r]{1,200}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def test_top_level_keys_and_command():
    assert set(DATA) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert 1 <= len(DATA["paths"]) <= 16 and 1 <= len(DATA["command"]) <= 32
    for p in DATA["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
    for word in DATA["command"]:
        assert TEXT.match(word) and not word.startswith("/")
        if "/" in word:
            assert any(word.startswith(p + "/") for p in DATA["paths"]), word
    assert isinstance(DATA["run_seconds"], int) and 1 <= DATA["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(smoke.ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_units_and_texts():
    names = []
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in DATA[section]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((section, entry["name"]))
    assert len(names) == len(set(names))
    for c in DATA["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert TEXT.match(c["source"]) and TEXT.match(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in DATA["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["traffic"]) and w["chips"] in (1, 4) and TEXT.match(w["why"])
    for m in DATA["end_to_end"] + DATA["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in DATA["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in DATA["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert TEXT.match(m["layer"])
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_reports_what_it_must():
    e2e = {m["name"] for m in DATA["end_to_end"]}
    assert "setup_s" in e2e
    pairs = {(w["config"], w["traffic"]) for w in DATA["workloads"]}
    assert len(pairs) == len(DATA["workloads"])
    for w in DATA["workloads"]:
        own = {m["name"] for m in BENCH.end_to_end(w["name"])}
        assert "setup_s" in own and len(own) >= 2
        layer = BENCH.per_layer(w["name"])
        assert layer and all(m["moves"] in own for m in layer)


@pytest.mark.parametrize("cell", [w["name"] for w in DATA["workloads"]])
def test_every_file_a_cell_names_is_there(cell):
    w = BENCH.workload(cell)
    cfg = BENCH.config(w["config"])
    assert cfg["arch"] and cfg["source"] and "reduced" in cfg and "deployment" in cfg
    entry = [c for c in DATA["configs"] if c["name"] == w["config"]][0]
    assert entry["source"] == cfg["source"] and entry["reduced"] == cfg["reduced"]
    assert any(entry["file"].startswith(p + "/") for p in DATA["paths"])
    assert set(cfg["published"]) == set(cfg["reduced"])
    traffic = BENCH.traffic(w["traffic"])
    assert os.path.exists(BENCH.path("entries", f"{traffic['entry']}.py"))
    for m in BENCH.per_layer(cell):
        assert callable(BENCH.load("metrics", m["name"]).read)
    with open(BENCH.path("limits", f"{cell}.json")) as f:
        limits = json.load(f)
    for number in limits.values():
        assert number["lower"] < number["limit"] < number["upper"]
