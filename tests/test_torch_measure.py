"""Measured DSE in the port, against the reference.

Mirrors the measured-DSE tests of the reference's ``tests/test_registry.py``
and ``tests/test_pallas_exec.py``: with the same deterministic fake
``time_executor`` patched into both packages, the port picks the same
winner and keeps the same ``measured`` record as the reference, outputs
stay bit-equal, a warm recompile re-measures nothing, measured and modeled
cache keys are distinct, and a measured entry names the device that timed
it, so a CPU-timed winner never answers for the card.  The real timer is
exercised on the CPU, where each executor call runs the kernel's plain
version.
"""

import itertools

import numpy as np
import pytest
import torch

import repro
import repro.core.measure as ref_measure
from repro.core import zoo as ref_zoo
from repro.core.measure import synthetic_args as ref_synthetic_args
import repro_torch
import repro_torch.core.measure as measure
from repro_torch.core import pipeline, zoo
from repro_torch.core.schedule_cache import ScheduleCache, measured_selector
from repro_torch.core.strategy import workload_from_node
from repro_torch.kernels import gemm

#: the zoo builds measured DSE is held to: every accelerator and model at
#: bucket 16 (the chip smoke's measured builds) plus per-sample toycar
BUILDS = [
    (name, acc, batch)
    for name, batch in (("toycar_mlp", 16), ("qcnn", 16), ("transformer_block", 16), ("toycar_mlp", None))
    for acc in ("gemmini", "edge_npu")
]


class FakeTimer:
    """A deterministic stand-in for ``time_executor``: the n-th call
    returns the n-th value of a fixed sequence, so two packages that time
    the same candidates in the same order see the same latencies."""

    VALUES = (5e-6, 3e-6, 4e-6, 1e-6, 2e-6, 6e-6, 1.5e-6, 7e-6, 2.5e-6)

    def __init__(self):
        self.calls = 0
        self._it = itertools.cycle(self.VALUES)

    def __call__(self, executor, args, *, warmup=1, repeats=3):
        self.calls += 1
        return next(self._it)


@pytest.fixture
def fake_timers(monkeypatch):
    port, ref = FakeTimer(), FakeTimer()
    monkeypatch.setattr(measure, "time_executor", port)
    monkeypatch.setattr(ref_measure, "time_executor", ref)
    return port, ref


def _compile_both(name, acc, batch, k, tmp_path=None, mode="optimized"):
    port_target = dict(cache=False) if tmp_path is None else dict(cache_dir=tmp_path / "port")
    ref_target = dict(cache=False) if tmp_path is None else dict(cache_dir=tmp_path / "ref")
    got = repro_torch.compile(
        zoo.get_model(name).build(batch=batch),
        repro_torch.Target(acc, mode=mode, device="cpu", **port_target),
        options=repro_torch.CompileOptions(measure_top_k=k, fresh_backend=True),
    )
    want = repro.compile(
        ref_zoo.get_model(name).build(batch=batch),
        repro.Target(acc, mode=mode, **ref_target),
        options=repro.CompileOptions(measure_top_k=k, fresh_backend=True),
    )
    return got, want


def _unnamed(schedule) -> dict:
    """A schedule without its workload's name (the node's auto-generated
    name, from process-global counters that differ between the packages)."""
    d = schedule.to_dict()
    d["workload"] = {**d["workload"], "name": None}
    return d


def _results(module):
    return [
        module.ops[n].strategy.schedule_result
        for n in module.graph.toposort()
        if n in module.ops
    ]


def test_synthetic_args_equal_the_reference():
    module = repro_torch.compile(
        zoo.get_model("transformer_block").build(batch=4),
        repro_torch.Target("gemmini", device="cpu", cache=False),
    )
    ref = repro.compile(
        ref_zoo.get_model("transformer_block").build(batch=4), repro.Target("gemmini", cache=False)
    )
    ref_nodes = [n for n in ref.graph.toposort() if n in ref.ops]
    nodes = [n for n in module.graph.toposort() if n in module.ops]
    for node, ref_node in zip(nodes, ref_nodes):
        for seed in (0, 3):
            got, want = measure.synthetic_args(node, seed), ref_synthetic_args(ref_node, seed)
            assert len(got) == len(want)
            for g, w in zip(got, want):
                if w is None:
                    assert g is None
                else:
                    assert g.dtype == w.dtype
                    np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("name,acc,batch", BUILDS)
def test_measured_selection_equals_the_reference(fake_timers, name, acc, batch):
    got, want = _compile_both(name, acc, batch, k=8)
    port_timer, ref_timer = fake_timers
    assert port_timer.calls == ref_timer.calls == got.backend.n_measurements
    assert got.backend.n_measurements == want.backend.n_measurements > 0
    for g, w in zip(_results(got), _results(want)):
        assert g.measured == w.measured
        assert g.measured["k"] == len(g.measured["latencies_s"]) == min(8, len(g.top))
        assert _unnamed(g.best) == _unnamed(w.best)
        assert g.report == g.top[g.measured["winner"]][1]
    feeds = [zoo.get_model(name).feeds(seed, batch=batch) for seed in range(2)]
    for f in feeds:
        for x, y in zip(got.run(f), want.run(f)):
            np.testing.assert_array_equal(x, y)


def test_measurement_reranks_away_from_the_modeled_winner(fake_timers):
    """The fake puts the fastest time on the fourth candidate: where a node
    has four or more, the measured winner is not the modeled one."""
    got, _ = _compile_both("qcnn", "edge_npu", 16, k=8)
    moved = [r for r in _results(got) if r.measured["winner"] != 0]
    assert moved
    for r in moved:
        assert r.best == r.top[r.measured["winner"]][0]
        assert r.best != r.top[0][0]


@pytest.mark.parametrize("mode", ["naive", "baseline"])
def test_baseline_modes_measure_their_one_candidate(fake_timers, mode):
    got, want = _compile_both("qcnn", "gemmini", None, k=4, mode=mode)
    assert got.backend.n_measurements == want.backend.n_measurements == len(got.ops)
    for g, w in zip(_results(got), _results(want)):
        assert g.measured == w.measured and g.measured["k"] == 1


def test_warm_recompile_measures_nothing(fake_timers, tmp_path):
    target = repro_torch.Target("gemmini", device="cpu", cache_dir=tmp_path)
    opts = repro_torch.CompileOptions(measure_top_k=2, fresh_backend=True)
    cold = repro_torch.compile(zoo.get_model("toycar_mlp").build(batch=16), target, options=opts)
    assert cold.backend.n_measurements > 0
    warm = repro_torch.compile(zoo.get_model("toycar_mlp").build(batch=16), target, options=opts)
    assert warm.backend is not cold.backend
    assert warm.backend.n_measurements == 0
    assert warm.backend.scheduler.n_solver_calls == 0
    assert [r.measured for r in _results(warm)] == [r.measured for r in _results(cold)]
    # the modeled ranking was cached on the way: a modeled compile is warm too
    modeled = repro_torch.compile(
        zoo.get_model("toycar_mlp").build(batch=16), target,
        options=repro_torch.CompileOptions(fresh_backend=True),
    )
    assert modeled.backend.scheduler.n_solver_calls == 0
    assert all(r.measured is None for r in _results(modeled))


def test_measured_and_modeled_keys_are_distinct(fake_timers, tmp_path):
    module = repro_torch.compile(
        zoo.get_model("mlp_tiny").build(),
        repro_torch.Target("gemmini", device="cpu", cache_dir=tmp_path),
        options=repro_torch.CompileOptions(measure_top_k=2, fresh_backend=True),
    )
    node = next(n for n in module.graph.toposort() if n in module.ops)
    wl = workload_from_node(node)
    fp = module.backend.desc.fingerprint()
    solver = module.backend.scheduler.solver_id()
    modeled_key = ScheduleCache.key_for(wl, fp, "proposed", solver=solver)
    cpu_key = ScheduleCache.key_for(wl, fp, "proposed", solver=solver, selector=measured_selector(2, "cpu"))
    card_key = ScheduleCache.key_for(
        wl, fp, "proposed", solver=solver,
        selector=measured_selector(2, "cuda:NVIDIA H100 80GB HBM3"),
    )
    assert len({modeled_key, cpu_key, card_key}) == 3
    assert "|measured2@cpu|" in cpu_key
    ref_key = repro.ScheduleCache.key_for(wl, fp, "proposed", solver=solver, selector="measured2")
    assert ref_key not in (cpu_key, card_key)  # the one deliberate difference
    cache = module.backend.schedule_cache
    assert cache.get(cpu_key).measured is not None
    assert cache.get(modeled_key).measured is None
    assert cache.get(card_key) is None  # a CPU-timed winner never answers for the card


def test_a_cpu_measurement_never_answers_for_another_device(fake_timers, tmp_path, monkeypatch):
    target = repro_torch.Target("gemmini", device="cpu", cache_dir=tmp_path)
    opts = repro_torch.CompileOptions(measure_top_k=3, fresh_backend=True)
    cold = repro_torch.compile(zoo.get_model("mlp_tiny").build(), target, options=opts)
    assert cold.backend.n_measurements > 0
    # the same compile as timed on another device misses the CPU's entries
    monkeypatch.setattr(pipeline, "device_tag", lambda device: "cuda:NVIDIA H100 80GB HBM3")
    other = repro_torch.compile(zoo.get_model("mlp_tiny").build(), target, options=opts)
    assert other.backend.n_measurements == cold.backend.n_measurements
    assert other.backend.scheduler.n_solver_calls == 0  # the modeled ranking is shared


def test_device_tag_names_the_cpu():
    assert pipeline.device_tag(torch.device("cpu")) == "cpu"


def test_real_timer_times_the_executor_on_the_cpu():
    """``time_executor``: ``warmup`` untimed calls, then the best of
    ``repeats`` timed calls; every candidate of every node is timed."""
    calls = []

    def executor(*args):
        calls.append(args)
        return args[0]

    t = measure.time_executor(executor, [torch.zeros(2)], warmup=2, repeats=5)
    assert len(calls) == 7 and 0.0 <= t < 1.0
    gemm.reset_launches()
    module = repro_torch.compile(
        zoo.get_model("qcnn").build(batch=4),
        repro_torch.Target("edge_npu", device="cpu", cache=False),
        options=repro_torch.CompileOptions(measure_top_k=3, fresh_backend=True),
    )
    assert sum(gemm.LAUNCHES.values()) == 0  # the CPU runs the plain version
    for r in _results(module):
        assert r.measured["k"] == len(r.measured["latencies_s"])
        assert all(lat > 0 for lat in r.measured["latencies_s"])
    assert module.backend.n_measurements == sum(r.measured["k"] for r in _results(module))
    feeds = zoo.get_model("qcnn").feeds(seed=0, batch=4)
    want = repro.compile(ref_zoo.get_model("qcnn").build(batch=4), repro.Target("edge_npu", cache=False))
    np.testing.assert_array_equal(module.run(feeds)[0], want.run(feeds)[0])


def test_measure_top_k_validation():
    for bad in (0, -3, 2.5):
        with pytest.raises(ValueError, match="measure_top_k"):
            repro_torch.CompileOptions(measure_top_k=bad)
