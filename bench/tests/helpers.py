"""A cell at the port's smoke sizes, for CPU runs of the harness."""

import dataclasses
import json
import time
from pathlib import Path

import harness
from test_bench_weights import smoke_spec

ROOT = Path(__file__).resolve().parents[2]
BENCHMARK = json.loads((ROOT / "BENCHMARK.json").read_text())


def smoke_cell(name: str, dtype: str = "bfloat16", kv: str | None = None, **traffic) -> harness.Cell:
    """Cell ``name`` with its configuration at the port's smoke sizes and
    its traffic cut to a few short prompts (``traffic`` overrides)."""
    cell = harness.Cell.load(BENCHMARK, name)
    spec = smoke_spec(next(w["config"] for w in BENCHMARK["workloads"] if w["name"] == name), dtype)
    if kv:
        spec["kv_cache_dtype"] = kv
    t = dataclasses.replace(cell.traffic, **{"batch": 4, "new_tokens": 4, "median": 24, "min_len": 8,
                                             "max_len": 40, "multiple": 8, **traffic})
    return dataclasses.replace(cell, spec=spec, cfg=cell.config.model_config(spec), traffic=t)


def execute_cpu(cell, seed=2**31 + 11, trace=False):
    """One run of ``cell`` on the CPU: one wave (or the traced ones)."""
    return harness.execute(cell, seed, 0.0, trace, "cpu", time.perf_counter())
