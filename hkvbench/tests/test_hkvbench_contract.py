"""BENCHMARK.json against the benchmark's contract: its keys, names, units
and limits, and every file the harness finds by a name it gives."""

from __future__ import annotations

import json
import pathlib
import re

import pytest

from hkvbench import harness

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["command"]) <= 32 and all(_line(w) for w in BENCH["command"])
    assert BENCH["paths"] == ["hkvbench"]
    assert all((ROOT / w).exists() for w in BENCH["command"][1:] if "/" in w)
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_configs():
    assert 1 <= len(BENCH["configs"]) <= 24
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert _line(c["source"]) and _line(c["why"]) and len(c["reduced"]) <= 16
        assert c["file"] == f"hkvbench/configs/{c['name']}.json"
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]


def test_workloads_have_their_files():
    names = [w["name"] for w in BENCH["workloads"]]
    assert len(names) == len(set(names)) and 1 <= len(names) <= 24
    pairs = {(w["config"], w["traffic"]) for w in BENCH["workloads"]}
    assert len(pairs) == len(names)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["chips"] in (1, 4)
        cell = harness.load_cell(w["name"], BENCH)
        assert (harness.HERE / "traffic" / f"{cell.mix['kind']}.py").exists()
        assert (harness.HERE / "ops" / f"{cell.work['op']}.py").exists()
        reported = {m["name"] for m in cell.metrics[0]}
        assert "setup_s" in reported and len(reported) >= 2 and cell.metrics[1]
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(names) // 4)


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_metrics(kind):
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH[kind]:
        keys = {"name", "unit", "better", "source"} | (
            {"bound"} if kind == "end_to_end" else {"layer", "moves"})
        assert set(m) - {"workloads"} == keys
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        assert set(m.get("workloads", [])) <= cells
        assert (harness.HERE / "metrics" / f"{m['name']}.py").exists()
        if kind == "end_to_end":
            assert m["source"] in ("host_clock", "device_trace")
            assert 0.01 <= m["bound"] <= 0.25
        else:
            assert _line(m["layer"]) and m["moves"] in e2e
            if m["name"].endswith("_roofline") or ".roofline" in m["name"]:
                assert m["unit"] == "%"
