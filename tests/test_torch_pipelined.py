"""Two-lane pipelined execution in the port, against the reference.

Mirrors the reference's ``tests/test_pipelined.py``: ``run_many(...,
pipelined=True)`` is bit-exact with the sequential plan loop on every zoo
model, accelerator and both fused and host-op-heavy modes (in the port it
runs that loop: see ``repro_torch.core.executor``); the build-time stage
assignment (each step's lane and cross-lane watermark, in plan order)
equals the reference's; a failure in either lane propagates and leaves the
module healthy.  On the CPU the accelerator lane runs the kernel's plain
version; the card's run is in ``chip_smoke.py``.
"""

import dataclasses
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import repro
from repro.core import zoo as ref_zoo
import repro_torch
from repro_torch.core import zoo
from repro_torch.kernels import gemm

MATRIX = [
    (name, acc, mode)
    for name in sorted(zoo.ZOO)
    for acc in zoo.get_model(name).accelerators
    if acc in ("gemmini", "edge_npu")
    for mode in ("optimized", "naive")  # fused and host-op-heavy plans
]


def _compile(name, acc, mode="optimized", batch=None):
    return repro_torch.compile(
        zoo.get_model(name).build(batch=batch),
        repro_torch.Target(acc, mode=mode, device="cpu", cache=False),
    )


def _assert_streams_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("name,acc,mode", MATRIX)
def test_pipelined_bit_exact_vs_sequential(name, acc, mode):
    module = _compile(name, acc, mode)
    model = zoo.get_model(name)
    traffic = [model.feeds(seed=s) for s in range(5)]
    gemm.reset_launches()
    sequential = module.run_many(traffic)
    pipelined = module.run_many(traffic, pipelined=True)
    _assert_streams_equal(pipelined, sequential)
    _assert_streams_equal([module.run(traffic[0], pipelined=True)], [module.run(traffic[0])])
    assert sum(gemm.LAUNCHES.values()) == 0  # the CPU runs the plain version


@pytest.mark.parametrize("batch", [None, 16])
@pytest.mark.parametrize("name,acc,mode", MATRIX)
def test_stage_assignment_equals_the_reference(name, acc, mode, batch):
    got = _compile(name, acc, mode, batch).finalize()
    want = repro.compile(
        ref_zoo.get_model(name).build(batch=batch), repro.Target(acc, mode=mode, cache=False)
    ).finalize()

    def stages(plan):  # node names differ between the packages
        return [{k: v for k, v in s.items() if k != "name"} for s in plan.stage_assignment()]

    assert stages(got) == stages(want)
    assert got.lane_sizes() == want.lane_sizes()


def test_stage_assignment_matches_offload_decisions():
    module = _compile("qcnn", "gemmini", "baseline")
    plan = module.finalize()
    stages = plan.stage_assignment()
    assert len(stages) == len(plan.steps)
    offloaded = {n.name for n in module.ops}
    for stage in stages:
        assert stage["lane"] == ("accel" if stage["name"] in offloaded else "host")
        (waits_key,) = [k for k in stage if k.startswith("waits_")]
        other = waits_key.removeprefix("waits_")
        assert 0 <= stage[waits_key] <= plan.lane_sizes()[other]
    sizes = plan.lane_sizes()
    assert sizes["host"] + sizes["accel"] == len(plan.steps)
    assert sizes["accel"] == len(module.ops)


def test_fully_fused_plan_has_an_empty_host_lane():
    """mlp_tiny optimized fuses every epilogue: the host lane is empty."""
    module = _compile("mlp_tiny", "gemmini", "optimized")
    assert module.finalize().lane_sizes()["host"] == 0
    traffic = [zoo.get_model("mlp_tiny").feeds(seed=s) for s in range(3)]
    _assert_streams_equal(module.run_many(traffic, pipelined=True), module.run_many(traffic))


def test_pipelined_under_a_thread_pool_is_bit_exact():
    """One shared module, several concurrent pipelined streams, each with
    its own arena."""
    module = _compile("toycar_mlp", "edge_npu", "naive")
    model = zoo.get_model("toycar_mlp")
    streams = [[model.feeds(seed=10 * t + s) for s in range(4)] for t in range(6)]
    expected = [module.run_many(tr) for tr in streams]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with ThreadPoolExecutor(max_workers=6) as pool:
            got = list(pool.map(lambda tr: module.run_many(tr, pipelined=True), streams))
    finally:
        sys.setswitchinterval(old)
    for exp_stream, got_stream in zip(expected, got):
        _assert_streams_equal(got_stream, exp_stream)


def test_batched_module_buckets_run_pipelined():
    module = repro_torch.compile(
        "transformer_block", repro_torch.Target("gemmini", device="cpu", cache=False, batch_size=4)
    )
    model = zoo.get_model("transformer_block")
    bucket = module.bucket_module(4)
    packed = [model.feeds(seed=s, batch=4) for s in range(3)]
    _assert_streams_equal(bucket.run_many(packed, pipelined=True), bucket.run_many(packed))


def _module_with_poisoned_accel_op(trip_after: int):
    """A qcnn module whose first accelerator op raises once ``trip_after``
    calls have gone through — plan rebuilt, so the poison is in the lane."""
    module = _compile("qcnn", "gemmini", "baseline")
    n = next(iter(module.ops))
    orig = module.ops[n].executor
    calls = [0]

    def poisoned(*args):
        calls[0] += 1
        if calls[0] > trip_after:
            raise RuntimeError("injected accel failure")
        return orig(*args)

    module.ops[n].executor = poisoned
    module.plan = None  # rebuild the plan with the poisoned executor
    return module


def test_accel_lane_failure_propagates_without_deadlock():
    module = _module_with_poisoned_accel_op(trip_after=2)
    traffic = [zoo.get_model("qcnn").feeds(seed=s) for s in range(6)]
    with pytest.raises(RuntimeError, match="injected accel failure"):
        module.run_many(traffic, pipelined=True)


def test_host_lane_failure_propagates_without_deadlock():
    module = _compile("qcnn", "gemmini", "baseline")
    plan = module.finalize()
    assert plan.lane_sizes()["host"] > 0
    i, step = next((i, s) for i, s in enumerate(plan.steps) if s.lane == "host")
    calls = [0]

    def poisoned(*args):
        calls[0] += 1
        if calls[0] > 1:
            raise RuntimeError("injected host failure")
        return step.fn(*args)

    module.plan = dataclasses.replace(
        plan, steps=plan.steps[:i] + (dataclasses.replace(step, fn=poisoned),) + plan.steps[i + 1 :]
    )
    traffic = [zoo.get_model("qcnn").feeds(seed=s) for s in range(6)]
    with pytest.raises(RuntimeError, match="injected host failure"):
        module.run_many(traffic, pipelined=True)
    # the module stays healthy after an aborted stream
    module.plan = plan
    _assert_streams_equal(module.run_many(traffic[:2], pipelined=True), module.run_many(traffic[:2]))


def test_pipelined_empty_traffic():
    assert _compile("mlp_tiny", "gemmini").run_many([], pipelined=True) == []


def test_pipelined_checks_feeds_first():
    module = _compile("qcnn", "gemmini", "naive")
    good = zoo.get_model("qcnn").feeds(seed=0)
    with pytest.raises(repro_torch.FeedError, match="unknown feed 'extra'"):
        module.run_many([good, {**good, "extra": 1}], pipelined=True)
