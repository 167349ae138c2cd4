"""``BENCHMARK.json`` within its format's characters and cross-references,
and every name found by the harness."""

import json
import re
from pathlib import Path

import pytest

from helpers import BENCHMARK, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
BENCH = ROOT / "bench"


def test_keys_and_characters():
    b = BENCHMARK
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["bench"] and 1 <= b["run_seconds"] <= 51
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]] + [w["name"] for w in b["workloads"]]
    names += [c["name"] for c in b["configs"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert set(m) == {"name", "unit", "better", "bound", "source"} and 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
    for text in [w["why"] for w in b["workloads"]] + [c["why"] for c in b["configs"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in b["end_to_end"])


def test_moves_names_a_metric_each_cell_reports():
    e2e = {m["name"]: m for m in BENCHMARK["end_to_end"]}
    cells = [w["name"] for w in BENCHMARK["workloads"]]
    for m in BENCHMARK["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert cell in e2e[m["moves"]].get("workloads", cells)
    for cell in cells:
        assert any(cell in m.get("workloads", cells) for m in BENCHMARK["per_layer"])


@pytest.mark.parametrize("w", BENCHMARK["workloads"], ids=lambda w: w["name"])
def test_every_name_has_its_files(w):
    conf = next(c for c in BENCHMARK["configs"] if c["name"] == w["config"])
    spec = json.loads((ROOT / conf["file"]).read_text())
    assert conf["reduced"] == spec["reduced"] and conf["source"] == spec["source"]
    for path in (BENCH / "configs" / f"{w['config']}.py", BENCH / "reference" / f"{w['config']}.py",
                 BENCH / "workloads" / f"{w['traffic']}.json", BENCH / "limits" / f"{w['name']}.json"):
        assert path.is_file(), path
    assert w["chips"] == 1
    for m in BENCHMARK["end_to_end"] + BENCHMARK["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()


def test_a_full_check_fits_its_time():
    """2 + 14 x 24 runs at run_seconds + 60 s, 2 x 90 s a cell, 1200 s spare."""
    runs = 2 + 14 * 24
    assert runs * (BENCHMARK["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_command_runs_the_harness():
    assert BENCHMARK["command"] == ["python3", "bench/run.py"]
    assert Path(ROOT, BENCHMARK["command"][1]).is_file()
