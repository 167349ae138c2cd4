"""The port's batch-bucketed modules against the reference's.

The bucket helpers (``is_stacked``, ``batched_shape``, ``pick_bucket``,
``plan_chunks``, ``_resolve_buckets``) equal the reference's over a sweep.
``repro_torch.compile(<zoo name>, Target(..., batch_size=16))`` returns a
``BatchedModule`` whose ``run_many`` is bit-equal to a reference
``repro.core.batching.BatchedModule`` assembled from the reference's
golden graphs per bucket (``repro.compile(build(batch=b))`` plus
``io_specs_from_graph(build())``; the reference's zoo-name compile goes
through its traced frontend, which fails under jax 0.9), and to
per-request runs of the port's per-sample module.
"""

import numpy as np
import pytest

import repro
from repro import api as ref_api
from repro.core import batching as ref_batching
from repro.core import zoo as ref_zoo
import repro_torch
from repro_torch import api
from repro_torch.core import batching, zoo
from repro_torch.kernels import gemm

BUCKET_SETS = [(1,), (4,), (1, 4), (1, 4, 16), (1, 4, 16, 64), (2, 8), (3, 5, 7)]
SHAPES = [(), (1,), (1, 16), (16, 64), (1, 12, 12, 8), (3, 1), (2, 3, 4)]


def test_bucket_helpers_match_reference():
    for shape in SHAPES:
        assert batching.is_stacked(shape) == ref_batching.is_stacked(shape)
        for b in (1, 2, 16):
            assert batching.batched_shape(shape, b) == ref_batching.batched_shape(shape, b)
    for buckets in BUCKET_SETS:
        for n in range(1, 150):
            assert batching.pick_bucket(buckets, n) == ref_batching.pick_bucket(buckets, n)
            chunks = batching.plan_chunks(buckets, n)
            assert chunks == ref_batching.plan_chunks(buckets, n)
            assert sum(chunks) == n
    assert batching.plan_chunks((1, 4, 16), 23) == [16, 4, 3]


@pytest.mark.parametrize("batch_size", [1, 2, 4, 5, 16, 17, 64])
@pytest.mark.parametrize("explicit", [None, (16, 1, 4, 4), (8,)])
def test_bucket_resolution_matches_reference(batch_size, explicit):
    got = api._resolve_buckets(
        repro_torch.Target("gemmini", device="cpu", cache=False, batch_size=batch_size),
        repro_torch.CompileOptions(batch_buckets=explicit),
    )
    want = ref_api._resolve_buckets(
        repro.Target("gemmini", cache=False, batch_size=batch_size),
        repro.CompileOptions(batch_buckets=explicit),
    )
    assert got == want


def test_invalid_buckets_and_batch_size_are_refused():
    target = repro_torch.Target("gemmini", device="cpu", cache=False)
    with pytest.raises(ValueError, match="bucket 0 must be a positive int") as e:
        repro_torch.compile("mlp_tiny", target, options=repro_torch.CompileOptions(batch_buckets=(0, 2.5)))
    assert "bucket 2.5" in str(e.value)
    with pytest.raises(ValueError, match="at least one bucket"):
        repro_torch.compile("mlp_tiny", target, options=repro_torch.CompileOptions(batch_buckets=()))
    with pytest.raises(repro_torch.TargetError, match="batch_size must be a positive int"):
        repro_torch.Target("gemmini", device="cpu", cache=False, batch_size=0)


def test_prebuilt_graph_with_buckets_raises():
    graph = zoo.get_model("mlp_tiny").build()
    with pytest.raises(ValueError, match="a prebuilt ir.Graph is fixed-shape"):
        repro_torch.compile(
            graph, repro_torch.Target("gemmini", device="cpu", cache=False, batch_size=4)
        )


def _ref_batched(name, mode, buckets):
    model = ref_zoo.get_model(name)
    target = repro.Target("gemmini", mode=mode, cache=False)
    inputs, outputs = ref_batching.io_specs_from_graph(model.build())
    return ref_batching.BatchedModule(
        modules={b: repro.compile(model.build(batch=b), target) for b in buckets},
        inputs=inputs,
        outputs=outputs,
        sample_module=repro.compile(model.build(), target),
    )


@pytest.mark.parametrize(
    "name,mode",
    [("mlp_tiny", "optimized"), ("qcnn", "naive"), ("transformer_block", "optimized"),
     ("transformer_block", "baseline")],
)
def test_batched_module_matches_reference_and_per_request_runs(name, mode):
    gemm.reset_launches()
    got = repro_torch.compile(name, repro_torch.Target("gemmini", mode=mode, device="cpu", cache=False, batch_size=16))
    assert isinstance(got, repro_torch.BatchedModule)
    assert got.bucket_sizes() == (1, 4, 16)
    assert str(got.device) == "cpu"
    ref = _ref_batched(name, mode, got.bucket_sizes())
    assert got.input_signature() == ref.input_signature()
    assert [(s.name, s.shape, s.dtype, s.stacked) for s in got.outputs] == [
        (s.name, s.shape, s.dtype, s.stacked) for s in ref.outputs
    ]
    for bucket in got.bucket_sizes():
        assert got.modeled_cycles(bucket) == ref.modeled_cycles(bucket)

    model = zoo.get_model(name)
    single = repro_torch.compile(name, repro_torch.Target("gemmini", mode=mode, device="cpu", cache=False))
    traffic = [model.feeds(seed) for seed in range(23)]
    per_request = [single.run(f) for f in traffic]
    for n in (1, 3, 7, 23):
        outs, want = got.run_many(traffic[:n]), ref.run_many(traffic[:n])
        assert len(outs) == n
        for i, (g, w) in enumerate(zip(outs, want)):
            assert len(g) == len(w) == 1
            for a, b in ((g[0], w[0]), (g[0], per_request[i][0])):
                assert a.dtype == b.dtype and a.shape == b.shape == ref.outputs[0].shape
                np.testing.assert_array_equal(a, b, err_msg=f"{name}/{mode} n={n} request {i}")
    np.testing.assert_array_equal(got.run(traffic[5])[0], per_request[5][0])
    assert sum(gemm.LAUNCHES.values()) == 0


def test_single_requests_take_the_unpadded_plan(monkeypatch):
    module = repro_torch.compile(
        "mlp_tiny", repro_torch.Target("gemmini", device="cpu", cache=False),
        options=repro_torch.CompileOptions(batch_buckets=(4,)),
    )
    calls = []
    for tag, m in (("sample", module.sample_module), ("bucket4", module.bucket_module(4))):
        monkeypatch.setattr(m, "run", lambda feeds, _run=m.run, _tag=tag: calls.append(_tag) or _run(feeds))
    feeds = [zoo.get_model("mlp_tiny").feeds(s) for s in range(6)]
    module.run_many(feeds[:1])
    assert calls == ["sample"]
    calls.clear()
    module.run_many(feeds)  # 4 + 2 (padded to 4)
    assert calls == ["bucket4", "bucket4"]


def test_batched_feed_validation_lists_every_problem():
    module = repro_torch.compile(
        "transformer_block", repro_torch.Target("gemmini", device="cpu", cache=False, batch_size=4)
    )
    with pytest.raises(repro_torch.FeedError) as e:
        module.run_many([{"y": np.zeros((16, 64), np.int8)}, {"x": np.zeros((1, 16, 64), np.int8)}])
    msg = str(e.value)
    assert "missing feed for input 'x'" in msg and "unknown feed 'y'" in msg
    assert "expected per-sample inputs: x: int8[16, 64]" in msg
