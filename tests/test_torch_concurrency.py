"""The port's compiled modules and backend memo under threads, on both
routes, held to the reference (``tests/test_concurrency.py``).

Each case runs on the kernel route (the port's default) and on the
emulated route (``use_pallas=False``), whose planned executors keep a
thread-local requantize scratch (``core/lowering.py``): 8 threads with
``sys.setswitchinterval(1e-6)`` drive one shared module, and every result
must be bit-equal to the sequential run, which is bit-equal to the
reference's.

Left out, because ``tests/test_torch_schedule_cache.py`` already holds
them on the kernel route: the memo's LRU order
(``test_backend_memo_is_lru_not_fifo``) and the cold-DSE single flight
across concurrent compiles
(``test_concurrent_compiles_sweep_each_workload_once``).  They are run
here again only where the route changes what they check.
"""

import sys
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import repro
from repro.core import ir as ref_ir
from repro.core import zoo as ref_zoo
import repro_torch
import repro_torch.api as api
from repro_torch.core import ir, zoo
from repro_torch.core.descriptions import make_gemmini_description
from repro_torch.core.strategy import workload_from_node
from repro_torch.kernels import gemm
from repro_torch.serve import MicroBatcher

THREADS = 8
ROUTES = pytest.mark.parametrize("use_pallas", [True, False], ids=["kernel", "emulated"])


@pytest.fixture(autouse=True)
def fine_grained_switching():
    """Frequent GIL hand-offs, so interleavings that would take minutes to
    surface appear within a few iterations; and no kernel launch on the CPU."""
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    gemm.reset_launches()
    try:
        yield
    finally:
        sys.setswitchinterval(prev)
    assert sum(gemm.LAUNCHES.values()) == 0


def _target(acc="gemmini", use_pallas=True, **kw):
    return repro_torch.Target(acc, cache=False, device="cpu", use_pallas=use_pallas, **kw)


def hammer(fn, n_calls: int, threads: int = THREADS) -> list:
    """``fn(i)`` for i in range(n_calls) from ``threads`` threads started
    together; returns the results in call order."""
    barrier = threading.Barrier(threads)

    def start(i):
        if i < threads:
            barrier.wait()
        return fn(i)

    with ThreadPoolExecutor(max_workers=threads) as pool:
        return list(pool.map(start, range(n_calls)))


def _qdense(m, w, b, batch):
    x = m.input_((batch, w.shape[1]), "int8", name="x")
    wq = m.quantize(m.transpose(m.const(w), (1, 0)), scale=0.0625)
    h = m.bias_add(m.dense(x, wq), m.const(b))
    return m.Graph([m.clip(m.requantize(h, scale=1.0 / 64.0), lo=-128, hi=127)], name="wide_qdense")


#: (batch, d_in, d_out, calls per thread): the reference's wide layer; a
#: short K with a wide output, where the fused epilogue is a large share of
#: a run; and one PE tile, where the planned executor feeds the intrinsic
#: the bias as its accumulator and requantizes straight after.  A scratch
#: shared between threads corrupts the last two within a few calls.
SHARED_SHAPES = {"reference": (64, 256, 256, 4), "wide_out": (64, 16, 512, 16), "one_tile": (16, 16, 16, 16)}


@ROUTES
@pytest.mark.parametrize("shape", sorted(SHARED_SHAPES))
def test_concurrent_run_on_shared_module_is_isolated(shape, use_pallas):
    """A quantized layer whose fused epilogue spans several GIL switches,
    one module shared by 8 threads, each with its own feeds: each thread
    always sees its own results, which are the reference's."""
    batch, d_in, d_out, iters = SHARED_SHAPES[shape]
    rng = np.random.default_rng(0)
    w = (rng.normal(size=(d_out, d_in)) * 0.05).astype(np.float32)
    b = rng.integers(-64, 64, size=(d_out,)).astype(np.int32)
    module = repro_torch.compile(_qdense(ir, w, b, batch), _target(use_pallas=use_pallas))
    feeds = [{"x": rng.integers(-128, 128, (batch, d_in)).astype(np.int8)} for _ in range(THREADS)]
    want = repro.compile(_qdense(ref_ir, w, b, batch), repro.Target("gemmini", cache=False))
    expected = [module.run(f)[0] for f in feeds]
    for e, f in zip(expected, feeds):
        np.testing.assert_array_equal(e, want.run(f)[0])
    got = hammer(lambda i: module.run(feeds[i % THREADS])[0], THREADS * iters)
    for i, out in enumerate(got):
        np.testing.assert_array_equal(out, expected[i % THREADS], err_msg=f"call {i}")


@ROUTES
@pytest.mark.parametrize("acc", ["gemmini", "edge_npu"])
@pytest.mark.parametrize("name", ["mlp_tiny", "qcnn", "transformer_block"])
def test_zoo_modules_planned_and_interpreted_from_threads(name, acc, use_pallas):
    """A zoo module run from 8 threads, planned and interpreted
    alternately: every result bit-equal to the sequential run."""
    model = zoo.get_model(name)
    module = repro_torch.compile(model.build(), _target(acc, use_pallas))
    feeds = [model.feeds(seed=s) for s in range(4)]
    expected = [module.run(f) for f in feeds]
    want = repro.compile(ref_zoo.get_model(name).build(), repro.Target(acc, cache=False))
    np.testing.assert_array_equal(expected[0][0], want.run(feeds[0])[0])
    got = hammer(lambda i: module.run(feeds[i % 4], use_plan=i % 2 == 0), 4 * THREADS)
    for i, outs in enumerate(got):
        for o, e in zip(outs, expected[i % 4], strict=True):
            np.testing.assert_array_equal(o, e, err_msg=f"call {i}")


@ROUTES
def test_concurrent_run_many_on_shared_batched_module(use_pallas):
    """A BatchedModule (bucketed plans over thread-safe bucket modules)
    serves a thread pool, and a MicroBatcher in front of it serves 8
    submitting threads: every caller gets bit-exact results."""
    model = zoo.get_model("mlp_tiny")
    batched = repro_torch.compile("mlp_tiny", _target(use_pallas=use_pallas),
                                  options=repro_torch.CompileOptions(batch_buckets=(1, 4)))
    traffic = [model.feeds(seed=s) for s in range(6)]
    expected = [o[0] for o in batched.run_many(traffic)]
    want = repro.compile(ref_zoo.get_model("mlp_tiny").build(), repro.Target("gemmini", cache=False))
    for e, f in zip(expected, traffic):
        np.testing.assert_array_equal(e, want.run(f)[0])
    got = hammer(lambda _: [o[0] for o in batched.run_many(traffic)], 3 * THREADS)
    for outs in got:
        for o, e in zip(outs, expected, strict=True):
            np.testing.assert_array_equal(o, e)
    batcher = MicroBatcher(batched, max_batch=4, max_delay_s=0.002)
    try:
        outs = hammer(lambda i: batcher.submit(traffic[i % 6]).result()[0], 4 * 6)
    finally:
        batcher.close()
    for i, o in enumerate(outs):
        np.testing.assert_array_equal(o, expected[i % 6])


# -- the backend memo -----------------------------------------------------------------


@pytest.fixture
def small_backend_memo(monkeypatch):
    repro_torch.clear_backend_cache()
    monkeypatch.setattr(api, "_BACKENDS_MAX", 3)
    yield
    repro_torch.clear_backend_cache()


def _targets(n: int) -> list:
    """Distinct memo keys on both routes, without touching a disk cache."""
    combos = [("gemmini", True), ("edge_npu", True), ("gemmini", False), ("edge_npu", False),
              ("tpu_v5e", True), ("tpu_v5e", False)]
    return [_target(acc, use_pallas) for acc, use_pallas in combos[:n]]


def test_backend_memo_eviction_drops_least_recently_used(small_backend_memo):
    """Emulated and kernel backends share one LRU: refreshing an entry
    keeps it, the least recently used goes."""
    t1, t2, t3, t4 = _targets(4)
    b2 = repro_torch.backend_for(t2)
    b1 = repro_torch.backend_for(t1)
    repro_torch.backend_for(t3)
    repro_torch.backend_for(t2)  # refresh t2
    repro_torch.backend_for(t4)  # evicts t1
    assert repro_torch.backend_for(t2) is b2
    assert len(api._BACKENDS) <= api._BACKENDS_MAX
    assert repro_torch.backend_for(t1) is not b1
    assert not t3.use_pallas and not repro_torch.backend_for(t3).use_pallas


@ROUTES
def test_backend_memo_concurrent_resolution_shares_one_backend(small_backend_memo, use_pallas):
    """Concurrent resolution of one target converges on one published
    backend (so its scheduler memo is shared), on either route."""
    target = _target(use_pallas=use_pallas)
    ids = hammer(lambda _: id(repro_torch.backend_for(target)), 4 * THREADS)
    assert len(set(ids)) == 1
    assert repro_torch.backend_for(target).use_pallas is use_pallas


def test_backend_memo_concurrent_churn_stays_bounded(small_backend_memo):
    targets = _targets(6)
    backends = hammer(lambda i: repro_torch.backend_for(targets[i % 6]), 6 * THREADS)
    assert len(api._BACKENDS) <= api._BACKENDS_MAX
    assert all(b.use_pallas is targets[i % 6].use_pallas for i, b in enumerate(backends))


@ROUTES
def test_cold_dse_single_flight_while_run_many_traffic_in_flight(tmp_path, use_pallas):
    """Cold compiles of one model hammer ONE backend with a persistent
    schedule cache while run_many traffic runs on a module of the same
    backend: one DSE sweep per unique workload, every compile and every
    served result bit-exact, and a fresh backend over the cache does no
    sweep at all."""
    backend = repro_torch.build_integrated_backend(
        make_gemmini_description(), cache=True, cache_dir=tmp_path, use_pallas=use_pallas)
    cpu = torch.device("cpu")
    model = zoo.get_model("qcnn")
    served = backend.compile_graph(zoo.get_model("mlp_tiny").build(), mode="proposed", device=cpu)
    serve_traffic = [zoo.get_model("mlp_tiny").feeds(seed=s) for s in range(4)]
    serve_expected = [o[0] for o in served.run_many(serve_traffic)]
    feeds = model.feeds(seed=11)
    stop = threading.Event()
    failures: list[str] = []

    def serve_loop():
        while not stop.is_set():
            outs = served.run_many(serve_traffic)
            if not all(np.array_equal(o[0], e) for o, e in zip(outs, serve_expected)):
                failures.append("serving output corrupted during compiles")
                return

    servers = [threading.Thread(target=serve_loop) for _ in range(2)]
    for t in servers:
        t.start()
    try:
        results = hammer(lambda _: backend.compile_graph(model.build(), mode="proposed", device=cpu)
                         .run(feeds)[0], 6, threads=6)
    finally:
        stop.set()
        for t in servers:
            t.join()
    assert not failures
    for r in results[1:]:
        np.testing.assert_array_equal(r, results[0])
    want = repro.compile(ref_zoo.get_model("qcnn").build(), repro.Target("gemmini", cache=False))
    np.testing.assert_array_equal(results[0], want.run(feeds)[0])
    reference = backend.compile_graph(model.build(), mode="proposed", device=cpu)
    unique = {(wl.N, wl.C, wl.K) for wl in (workload_from_node(n) for n in (*reference.ops, *served.ops))}
    assert backend.scheduler.n_solver_calls == len(unique)
    assert backend.schedule_cache.file.exists()
    warm = repro_torch.build_integrated_backend(
        make_gemmini_description(), cache=True, cache_dir=tmp_path, use_pallas=use_pallas)
    warm_mod = warm.compile_graph(model.build(), mode="proposed", device=cpu)
    assert warm.scheduler.n_solver_calls == 0
    np.testing.assert_array_equal(warm_mod.run(feeds)[0], results[0])
