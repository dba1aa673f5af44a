"""BENCHMARK.json keeps to the benchmark's contract, and every name in it
has its file."""

from __future__ import annotations

import json
import re

import pytest

from benchmark import run
from benchmark.tests.tiny import ROOT

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")
PATH = re.compile(r"[A-Za-z0-9_.\-/]{1,200}")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
WIDTHS = re.compile(r"(hidden|intermediate|latent|state|projection|head).*|.*_dim|.*_rank")


@pytest.fixture(scope="module")
def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def line(s) -> bool:
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command(bench):
    assert set(bench) == TOP_KEYS
    assert 1 <= len(bench["command"]) <= 32 and all(line(w) for w in bench["command"])
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.fullmatch(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch") and (ROOT / p).is_dir()
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_entry_keys(bench):
    names = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.fullmatch(c["name"]) and line(c["source"]) and line(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.fullmatch(k) and not WIDTHS.fullmatch(k) for k in c["reduced"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.fullmatch(w["name"]) and NAME.fullmatch(w["traffic"])
        assert w["chips"] in (1, 4) and line(w["why"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.fullmatch(m["name"]) and UNIT.fullmatch(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter",
                               "host_clock")
        assert line(m["layer"])
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in bench[group]:
            assert e["name"] not in names
            names.add(e["name"])


def test_every_cell_reports_setup_another_end_to_end_and_a_layer(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for w in bench["workloads"]:
        reported = [m for m in e2e.values()
                    if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in [m["name"] for m in reported] and len(reported) >= 2
        layers = [m for m in bench["per_layer"]
                  if w["name"] in m.get("workloads", [w["name"]])]
        assert layers
        for m in layers:  # a layer metric's cells report what it moves
            assert m["moves"] in [r["name"] for r in reported]


def test_every_name_has_its_file(bench):
    files = set()
    for c in bench["configs"]:
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file()
        assert c["file"] not in files
        files.add(c["file"])
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
        assert any(w["config"] == c["name"] for w in bench["workloads"])
    for w in bench["workloads"]:
        wl = json.loads((ROOT / "benchmark" / "workloads" / f"{w['name']}.json").read_text())
        assert wl["config"] == w["config"] and wl["traffic"] == w["traffic"]
        assert (ROOT / "benchmark" / "traffic" / f"{w['traffic']}.py").is_file()
    for m in bench["per_layer"]:  # its own reader, or its base name's
        assert run.reader_path(m["name"]).is_file()


def test_four_chip_cells_are_few(bench):
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert four <= max(1, len(bench["workloads"]) // 4)
