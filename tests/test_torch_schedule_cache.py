"""The port's schedule cache, scheduler memo and backend memo, against the
reference.

Mirrors the cache half of the reference's ``tests/test_registry.py`` and
the memo half of ``tests/test_concurrency.py``: the cache keys of every
zoo workload, mode and description are the reference's strings, the
ranked ``ScheduleResult.top`` candidates are the reference's, a cache file
written by either package makes the other's compile warm (zero sweeps,
identical schedules), cold misses are single-flight, the backend memo is
a bounded LRU, and the compile options ``passes=`` / ``pass_context=`` /
``allow_host_fallback=False`` behave as the reference's.

Both packages compile golden graphs (``get_model(n).build(batch=b)``),
never zoo names through the reference's traced frontend (it fails under
jax 0.9).  Every cache lives under ``tmp_path``.
"""

import dataclasses
import json
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import repro
import repro.api as ref_api
from repro.core import ir as ref_ir
from repro.core import zoo as ref_zoo
from repro.core.strategy import workload_from_node as ref_workload
import repro_torch
import repro_torch.api as api
from repro_torch.core import ir, zoo
from repro_torch.core.arch_spec import GemmWorkload
from repro_torch.core.executor import compile_host_op
from repro_torch.core.passes import frontend_passes
from repro_torch.core.pass_manager import GraphPass, PassContext
from repro_torch.core.schedule_cache import (
    ScheduleCache,
    default_cache_dir,
    result_from_dict,
    result_to_dict,
)
from repro_torch.core.scheduler import MAX_TOP_CANDIDATES
from repro_torch.core.strategy import workload_from_node

ACCELS = ("gemmini", "edge_npu")
MODES = ("naive", "baseline", "optimized")
#: (model, accelerator, batch) of every zoo workload the port compiles
WORKLOADS = [
    (name, acc, batch)
    for name in sorted(zoo.ZOO)
    for acc in zoo.get_model(name).accelerators
    if acc in ACCELS
    for batch in (None, 16)
]


def _port(name, acc, mode="optimized", batch=None, **target):
    target.setdefault("cache", False)
    return repro_torch.compile(
        zoo.get_model(name).build(batch=batch),
        repro_torch.Target(acc, mode=mode, device="cpu", **target),
        options=repro_torch.CompileOptions(fresh_backend=True),
    )


def _ref(name, acc, mode="optimized", batch=None, **target):
    target.setdefault("cache", False)
    return repro.compile(
        ref_zoo.get_model(name).build(batch=batch),
        repro.Target(acc, mode=mode, **target),
        options=repro.CompileOptions(fresh_backend=True),
    )


def _accel_nodes(module):
    return [n for n in module.graph.toposort() if n in module.ops]


def _unnamed(schedule) -> dict:
    """A schedule as a dict without its workload's name, which is the
    node's auto-generated name (process-global counters differ between
    the packages)."""
    d = schedule.to_dict()
    d["workload"] = {**d["workload"], "name": None}
    return d


def _schedules(module):
    """Each accelerator step's schedule, in plan order."""
    return [_unnamed(module.ops[n].strategy.schedule) for n in _accel_nodes(module)]


def _ranked(result):
    return [(_unnamed(s), dataclasses.asdict(r)) for s, r in result.top]


# -- keys and ranked candidates ----------------------------------------------


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name,acc,batch", WORKLOADS)
def test_cache_keys_equal_the_reference(name, acc, batch, mode):
    got, want = _port(name, acc, mode, batch), _ref(name, acc, mode, batch)
    internal = repro_torch.Target(acc, mode=mode, device="cpu").internal_mode
    got_keys = [
        ScheduleCache.key_for(
            workload_from_node(n), got.backend.desc, internal,
            solver=got.backend.scheduler.solver_id(),
        )
        for n in _accel_nodes(got)
    ]
    want_keys = [
        repro.ScheduleCache.key_for(
            ref_workload(n), want.backend.desc, internal,
            solver=want.backend.scheduler.solver_id(),
        )
        for n in _accel_nodes(want)
    ]
    assert got_keys and got_keys == want_keys
    assert got.backend._cache_key(workload_from_node(_accel_nodes(got)[0]), internal) == want_keys[0]


@pytest.mark.parametrize("name,acc,batch", WORKLOADS)
def test_ranked_top_candidates_equal_the_reference(name, acc, batch):
    got, want = _port(name, acc, batch=batch), _ref(name, acc, batch=batch)
    for g, w in zip(_accel_nodes(got), _accel_nodes(want)):
        rg = got.backend.scheduler.schedule(workload_from_node(g))
        rw = want.backend.scheduler.schedule(ref_workload(w))
        assert 1 <= len(rg.top) <= MAX_TOP_CANDIDATES
        assert _ranked(rg) == _ranked(rw)
        assert rg.top[0] == (rg.best, rg.report)
        assert rg.ranked() == rg.top
        assert (rg.n_candidates, rg.n_infeasible) == (rw.n_candidates, rw.n_infeasible)


def test_result_round_trips_through_dict():
    backend = repro_torch.build_integrated_backend("edge_npu", cache=False)
    wl = GemmWorkload(N=96, C=72, K=24, in_bytes=1, w_bytes=1, out_bytes=4, name="rt")
    result = backend.scheduler.schedule(wl)
    back = result_from_dict(result_to_dict(result))
    assert back == result
    # a baseline result has no ranked list: ranked() still names its winner
    lone = dataclasses.replace(result, top=())
    assert lone.ranked() == ((result.best, result.report),)
    assert "top" not in result_to_dict(lone)


# -- cross-package cache files ----------------------------------------------


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name,acc", [("qcnn", "gemmini"), ("transformer_block", "edge_npu")])
def test_reference_cache_file_makes_the_port_warm(tmp_path, name, acc, mode):
    want = _ref(name, acc, mode, 16, cache=True, cache_dir=tmp_path)
    assert (tmp_path / "schedules.json").exists()
    got = _port(name, acc, mode, 16, cache=True, cache_dir=tmp_path)
    assert got.backend.scheduler.n_solver_calls == 0
    assert got.backend.schedule_cache.stats.misses == 0
    assert _schedules(got) == _schedules(want)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name,acc", [("toycar_mlp", "gemmini"), ("qcnn", "edge_npu")])
def test_port_cache_file_makes_the_reference_warm(tmp_path, name, acc, mode):
    got = _port(name, acc, mode, 16, cache=True, cache_dir=tmp_path)
    if mode == "optimized":
        assert got.backend.scheduler.n_solver_calls > 0
    want = _ref(name, acc, mode, 16, cache=True, cache_dir=tmp_path)
    assert want.backend.scheduler.n_solver_calls == 0
    assert want.backend.schedule_cache.stats.misses == 0
    assert _schedules(want) == _schedules(got)
    feeds = zoo.get_model(name).feeds(seed=3, batch=16)
    for g, w in zip(got.run(feeds), want.run(feeds)):
        np.testing.assert_array_equal(g, w)


def test_warm_compile_in_a_fresh_backend_does_zero_sweeps(tmp_path):
    cold = _port("qcnn", "edge_npu", cache=True, cache_dir=tmp_path)
    assert cold.backend.scheduler.n_solver_calls > 0
    assert cold.backend.schedule_cache.file.exists()
    warm = _port("qcnn", "edge_npu", cache=True, cache_dir=tmp_path)
    assert warm.backend is not cold.backend
    assert warm.backend.scheduler.n_solver_calls == 0
    assert warm.backend.schedule_cache.stats.hits >= 2
    assert warm.backend.schedule_cache.stats.misses == 0
    feeds = zoo.get_model("qcnn").feeds(seed=1)
    np.testing.assert_array_equal(warm.run(feeds)[0], cold.run(feeds)[0])


def test_every_mode_is_cached(tmp_path):
    backend = repro_torch.build_integrated_backend("edge_npu", cache_dir=tmp_path)
    for mode in MODES:
        backend.compile_graph(zoo.get_model("qcnn").build(), mode, device="cpu")
    assert backend.schedule_cache.stats.puts == 12  # 4 GEMM nodes x 3 modes
    warm = repro_torch.build_integrated_backend("edge_npu", cache_dir=tmp_path)
    for mode in MODES:
        warm.compile_graph(zoo.get_model("qcnn").build(), mode, device="cpu")
    assert warm.scheduler.n_solver_calls == 0
    assert warm.schedule_cache.stats.misses == 0


# -- the cache file ------------------------------------------------------------


def _result(name="h"):
    backend = repro_torch.build_integrated_backend("edge_npu", cache=False)
    return backend.scheduler.schedule(GemmWorkload(N=16, C=8, K=8, name=name))


def test_concurrent_writers_merge(tmp_path):
    ra, rb = _result("a"), _result("b")
    proc_a, proc_b = ScheduleCache(tmp_path), ScheduleCache(tmp_path)
    proc_b.put("key_b", rb)
    proc_b.flush()
    proc_a.put("key_a", ra)
    proc_a.flush()  # must not clobber proc_b's entry on disk
    merged = ScheduleCache(tmp_path)
    assert merged.get("key_a") == ra and merged.get("key_b") == rb


def test_concurrent_writer_hammer(tmp_path):
    result = _result()
    n_writers, n_rounds = 8, 5

    def hammer(writer: int) -> None:
        cache = ScheduleCache(tmp_path)
        for r in range(n_rounds):
            cache.put(f"key_{writer}_{r}", result)
            cache.flush()

    with ThreadPoolExecutor(max_workers=n_writers) as pool:
        list(pool.map(hammer, range(n_writers)))
    merged = ScheduleCache(tmp_path)
    assert len(merged) == n_writers * n_rounds
    assert not list(tmp_path.glob("*.tmp*"))
    json.loads(merged.file.read_text())


def test_clear_empties_the_disk_tier(tmp_path):
    cache = ScheduleCache(tmp_path)
    cache.put("k", _result())
    cache.flush()
    cache.clear()
    reloaded = ScheduleCache(tmp_path)
    assert len(reloaded) == 0 and reloaded.get("k") is None


def test_unwritable_location_degrades_to_memory(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    backend = repro_torch.build_integrated_backend("edge_npu", cache_dir=blocker / "cache")
    with pytest.warns(RuntimeWarning, match="not persistable"):
        module = backend.compile_graph(zoo.get_model("qcnn").build(), "proposed", device="cpu")
    assert backend.schedule_cache.path is None
    assert len(backend.schedule_cache) == 4
    feeds = zoo.get_model("qcnn").feeds(seed=0)
    want = _ref("qcnn", "edge_npu").run(feeds)[0]
    np.testing.assert_array_equal(module.run(feeds)[0], want)


def test_corrupt_file_is_an_empty_cache(tmp_path):
    cache = ScheduleCache(tmp_path)
    cache.file.write_text("{not json")
    assert len(ScheduleCache(tmp_path)) == 0


def test_default_directory_is_the_ports_own(tmp_path, monkeypatch):
    monkeypatch.delenv("REPRO_TORCH_CACHE_DIR", raising=False)
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path / "reference"))
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    assert default_cache_dir() == tmp_path / "home" / ".cache" / "repro_torch"
    monkeypatch.setenv("REPRO_TORCH_CACHE_DIR", str(tmp_path / "port"))
    assert default_cache_dir() == tmp_path / "port"
    backend = repro_torch.build_integrated_backend("gemmini")
    assert backend.schedule_cache.path == tmp_path / "port"


def test_target_validates_cache_options():
    with pytest.raises(repro_torch.TargetError, match="cache_dir given but cache=False"):
        repro_torch.Target("gemmini", cache=False, cache_dir="/tmp/x", device="cpu")
    target = repro_torch.Target("gemmini", device="cpu")
    assert (target.cache, target.cache_dir, target.parallel_dse) == (True, None, False)


# -- the scheduler -------------------------------------------------------------


def test_parallel_dse_matches_serial():
    wl = GemmWorkload(N=96, C=72, K=24, in_bytes=1, w_bytes=1, out_bytes=4)
    serial = repro_torch.build_integrated_backend("edge_npu", cache=False).scheduler
    parallel = repro_torch.build_integrated_backend(
        "edge_npu", cache=False, parallel_dse=True
    ).scheduler
    assert parallel.parallel and not serial.parallel
    assert serial.schedule(wl) == parallel.schedule(wl)


def test_single_flight_cold_miss(monkeypatch):
    """N threads missing on one cold workload run ONE sweep; the others
    wait for the leader's result."""
    scheduler = repro_torch.build_integrated_backend("gemmini", cache=False).scheduler
    wl = GemmWorkload(N=64, C=128, K=128, in_bytes=1, w_bytes=1, out_bytes=1)
    real = scheduler._schedule_uncached
    entered = threading.Event()
    release = threading.Event()

    def slow(workload):
        entered.set()
        assert release.wait(timeout=30)
        return real(workload)

    monkeypatch.setattr(scheduler, "_schedule_uncached", slow)
    n = 8
    with ThreadPoolExecutor(max_workers=n) as pool:
        futures = [pool.submit(scheduler.schedule, wl) for _ in range(n)]
        assert entered.wait(timeout=30)
        release.set()
        results = [f.result(timeout=60) for f in futures]
    assert scheduler.n_solver_calls == 1
    assert all(r is results[0] for r in results)


def test_single_flight_leader_failure_hands_over(monkeypatch):
    scheduler = repro_torch.build_integrated_backend("gemmini", cache=False).scheduler
    wl = GemmWorkload(N=32, C=64, K=64, in_bytes=1, w_bytes=1, out_bytes=1)
    real = scheduler._schedule_uncached
    calls = []

    def flaky(workload):
        calls.append(workload)
        if len(calls) == 1:
            raise RuntimeError("leader failed")
        return real(workload)

    monkeypatch.setattr(scheduler, "_schedule_uncached", flaky)
    with pytest.raises(RuntimeError, match="leader failed"):
        scheduler.schedule(wl)
    assert scheduler.schedule(wl).best is not None
    assert len(calls) == 2


def test_concurrent_compiles_sweep_each_workload_once(tmp_path):
    backend = repro_torch.build_integrated_backend("gemmini", cache_dir=tmp_path)
    model = zoo.get_model("toycar_mlp")
    feeds = model.feeds(seed=11)

    def compile_once(_):
        return backend.compile_graph(model.build(), "proposed", device="cpu").run(feeds)[0]

    with ThreadPoolExecutor(max_workers=6) as pool:
        results = list(pool.map(compile_once, range(6)))
    for r in results[1:]:
        np.testing.assert_array_equal(r, results[0])
    reference = backend.compile_graph(model.build(), "proposed", device="cpu")
    unique = {workload_from_node(n).key() for n in reference.ops}
    assert backend.scheduler.n_solver_calls == len(unique)
    warm = repro_torch.build_integrated_backend("gemmini", cache_dir=tmp_path)
    warm.compile_graph(model.build(), "proposed", device="cpu")
    assert warm.scheduler.n_solver_calls == 0


# -- the backend memo ------------------------------------------------------------


@pytest.fixture
def small_backend_memo(monkeypatch):
    repro_torch.clear_backend_cache()
    monkeypatch.setattr(api, "_BACKENDS_MAX", 3)
    yield
    repro_torch.clear_backend_cache()


def _targets(n: int) -> list:
    combos = [("gemmini", False), ("edge_npu", False), ("gemmini", True), ("edge_npu", True)]
    return [
        repro_torch.Target(acc, cache=False, parallel_dse=par, device="cpu")
        for acc, par in combos[:n]
    ]


def test_backend_memo_shares_one_backend_per_target():
    repro_torch.clear_backend_cache()
    a = repro_torch.Target("gemmini", cache=False, device="cpu")
    b = repro_torch.Target("gemmini", mode="naive", cache=False, device="cpu")
    assert repro_torch.backend_for(a) is repro_torch.backend_for(b)
    assert repro_torch.backend_for(a, fresh=True) is not repro_torch.backend_for(a)
    module = repro_torch.compile("mlp_tiny", a)
    assert module.backend is repro_torch.backend_for(a)
    repro_torch.clear_backend_cache()
    assert repro_torch.backend_for(a) is not module.backend


def test_backend_memo_is_lru_not_fifo(small_backend_memo):
    t1, t2, t3, t4 = _targets(4)
    b1 = repro_torch.backend_for(t1)
    b2 = repro_torch.backend_for(t2)
    b3 = repro_torch.backend_for(t3)
    assert repro_torch.backend_for(t1) is b1  # hit: t1 becomes most recent
    repro_torch.backend_for(t4)  # full: evicts t2 (least recent), not t1
    assert repro_torch.backend_for(t1) is b1
    assert repro_torch.backend_for(t3) is b3
    assert len(api._BACKENDS) <= api._BACKENDS_MAX
    assert repro_torch.backend_for(t2) is not b2  # rebuilt after eviction


def test_backend_memo_concurrent_resolution_shares_one_backend(small_backend_memo):
    target = repro_torch.Target("gemmini", cache=False, device="cpu")
    with ThreadPoolExecutor(max_workers=8) as pool:
        ids = list(pool.map(lambda _: id(repro_torch.backend_for(target)), range(32)))
    assert len(set(ids)) == 1


def test_backend_memo_concurrent_churn_stays_bounded(small_backend_memo):
    targets = _targets(4)
    with ThreadPoolExecutor(max_workers=8) as pool:
        list(pool.map(lambda i: repro_torch.backend_for(targets[i % 4]), range(48)))
    assert len(api._BACKENDS) <= api._BACKENDS_MAX


def test_backend_memo_key_fields_match_the_reference():
    """The memo keys on the reference's fields, plus (on the emulated route,
    which calls them) the description's compute intrinsics."""
    repro_torch.clear_backend_cache()
    repro_torch.backend_for(repro_torch.Target("edge_npu", cache=False, device="cpu", use_pallas=False))
    (key,) = api._BACKENDS
    ref_api.clear_backend_cache()
    ref_api.backend_for(repro.Target("edge_npu", cache=False))
    (ref_key,) = ref_api._BACKENDS
    assert key[:-1] == ref_key
    assert [name for name, _ in key[-1]] == ["edge_npu.mma", "edge_npu.mma_conv"]
    repro_torch.clear_backend_cache()
    repro_torch.backend_for(repro_torch.Target("edge_npu", cache=False, device="cpu"))
    (key,) = api._BACKENDS
    assert key[-1] is None and key[2] is True  # the kernel route calls no intrinsic
    repro_torch.clear_backend_cache()
    ref_api.clear_backend_cache()


# -- compile options ----------------------------------------------------------


def test_passes_override_replaces_the_pipeline():
    """``passes=`` replaces the mode pipeline; with no passes nothing is
    partitioned and the graph runs on the host, as the reference's does."""
    model = zoo.get_model("qcnn")
    got = repro_torch.compile(
        model.build(), repro_torch.Target("gemmini", device="cpu", cache=False),
        options=repro_torch.CompileOptions(passes=[]),
    )
    want = repro.compile(
        ref_zoo.get_model("qcnn").build(), repro.Target("gemmini", cache=False),
        options=repro.CompileOptions(passes=[]),
    )
    assert got.pass_report.passes == [] and not got.ops and not want.ops
    feeds = model.feeds(seed=5)
    np.testing.assert_array_equal(got.run(feeds)[0], want.run(feeds)[0])


@pytest.mark.parametrize("name", ["qcnn", "transformer_block"])
def test_unoptimized_pass_list_matches_the_reference(name):
    from repro.core.passes import frontend_passes as ref_frontend_passes

    got = repro_torch.compile(
        zoo.get_model(name).build(), repro_torch.Target("gemmini", device="cpu", cache=False),
        options=repro_torch.CompileOptions(
            passes=frontend_passes(repro_torch.REGISTRY.get("gemmini"), optimize=False)
        ),
    )
    want = repro.compile(
        ref_zoo.get_model(name).build(), repro.Target("gemmini", cache=False),
        options=repro.CompileOptions(
            passes=ref_frontend_passes(repro.REGISTRY.get("gemmini"), optimize=False)
        ),
    )
    assert got.pass_report.rewrites_by_pass() == want.pass_report.rewrites_by_pass()
    assert got.modeled_cycles() == want.modeled_cycles()
    feeds = zoo.get_model(name).feeds(seed=2)
    np.testing.assert_array_equal(got.run(feeds)[0], want.run(feeds)[0])


def test_pass_context_is_used_and_never_mutated(capsys):
    ctx = PassContext(trace=True)
    module = repro_torch.compile(
        "mlp_tiny", repro_torch.Target("gemmini", device="cpu", cache=False),
        options=repro_torch.CompileOptions(pass_context=ctx),
    )
    assert "[pass]" in capsys.readouterr().err
    assert ctx.desc is None and ctx.mode is None  # the caller's context is untouched
    assert module.pass_report.mode == "proposed"


def _dense_only_desc(registry=repro_torch.REGISTRY):
    """A gemmini variant that cannot run convolutions at all."""
    desc = registry.get("gemmini")
    for tag, cc in list(desc.core_computes.items()):
        if cc.op == "conv2d":
            del desc.core_computes[tag]
    return desc


@pytest.mark.parametrize("mode", MODES)
def test_host_fallback_runs_convs_on_the_host(mode):
    feeds = zoo.get_model("qcnn").feeds(seed=4)
    golden = ref_ir.execute_graph(ref_zoo.get_model("qcnn").build(), feeds)[0]
    want = repro.compile(
        ref_zoo.get_model("qcnn").build(),
        repro.Target(_dense_only_desc(repro.REGISTRY), mode=mode, cache=False),
    )
    module = repro_torch.compile(
        "qcnn", repro_torch.Target(_dense_only_desc(), mode=mode, device="cpu", cache=False)
    )
    convs = [n for n in module.graph.toposort() if "conv2d" in n.op]
    assert convs and all(n.target == "host" for n in convs)
    assert [n.op for n in module.graph.toposort()] == [n.op for n in want.graph.toposort()]
    got = module.run(feeds)[0]
    np.testing.assert_array_equal(got, want.run(feeds)[0])
    np.testing.assert_array_equal(got, golden)


@pytest.mark.parametrize("op", ["dense", "conv2d"])
def test_host_gemm_is_refused_on_a_card(op):
    """A dense or conv left on the host would be a plain GEMM on the card:
    a CUDA module refuses it when its plan is built (no card is needed to
    see that; the CPU lowering is the one above)."""
    if op == "dense":
        node = ir.dense(ir.input_((2, 4), "float32", name="x"), ir.const(np.ones((4, 3), np.float32)))
    else:
        node = ir.conv2d(ir.input_((1, 4, 4, 2), "int8", name="x"),
                         ir.const(np.ones((3, 3, 2, 4), np.int8)))
    with pytest.raises(NotImplementedError, match=f"{op} .* left on the host.*no plain GEMM on cuda"):
        compile_host_op(node, torch.device("cuda"))
    assert callable(compile_host_op(node, torch.device("cpu")))


def test_allow_host_fallback_false_raises_capability_error():
    with pytest.raises(repro_torch.CapabilityError) as exc:
        repro_torch.compile(
            "qcnn",
            repro_torch.Target(_dense_only_desc(), device="cpu", cache=False),
            options=repro_torch.CompileOptions(allow_host_fallback=False),
        )
    msg = str(exc.value)
    assert "conv2d" in msg and "supported core ops" in msg
    assert len(exc.value.problems) == 3  # two convs + the supported-ops line


def test_verify_gate_is_refused_until_ported():
    """The gate is ported: 'each' and 'final' compile and verify (a clean
    module passes, a broken pass is refused); an unknown mode is refused."""
    for mode in ("each", "final", "off"):
        assert repro_torch.CompileOptions(verify=mode).verify == mode
        module = repro_torch.compile(
            "qcnn", repro_torch.Target("edge_npu", device="cpu", cache=False),
            options=repro_torch.CompileOptions(verify=mode),
        )
        assert repro_torch.verify(module) == []

    def breaker(graph, ctx):
        graph.outputs[0].shape = (1, 3)
        return 1

    with pytest.raises(repro_torch.VerifyError, match="after pass 'breaker'"):
        repro_torch.compile(
            zoo.get_model("mlp_tiny").build(), repro_torch.Target("gemmini", device="cpu", cache=False),
            options=repro_torch.CompileOptions(
                verify="each", passes=[GraphPass(name="breaker", fn=breaker)]),
        )
    with pytest.raises(ValueError, match="invalid verify mode 'sometimes'"):
        repro_torch.CompileOptions(verify="sometimes")
