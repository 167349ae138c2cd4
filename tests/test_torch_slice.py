"""The port's compile-and-run path as a whole, against the reference.

``toycar_mlp`` and ``mlp_tiny`` x {naive, baseline, optimized} x batch
{1, 16} on gemmini, ``device="cpu"``: the post-pass op sequence and the
per-rule rewrite counts equal the reference's, and ``run``/``run_many``
outputs are bit-equal to ``repro.compile(model.build(batch=b),
Target("gemmini", mode=m, cache=False)).run(...)``.  On the CPU every
accelerator step runs the kernel's plain version, so the kernel launch
counter stays at 0.

The reference is compiled from its golden graphs (``build()``), never from
zoo names or ``trace()``: its traced frontend fails under jax 0.9 (the
importer knows ``pjit``, jax 0.9 emits ``jit``).
"""

import numpy as np
import pytest

import repro
from repro.core import ir as ref_ir
from repro.core import zoo as ref_zoo
import repro_torch
from repro_torch.core import ir, zoo
from repro_torch.kernels import gemm

MODELS = ("toycar_mlp", "mlp_tiny")
MODES = ("naive", "baseline", "optimized")
BATCHES = (1, 16)


def _ref_module(name, mode, batch):
    graph = ref_zoo.get_model(name).build(batch=batch)
    return repro.compile(graph, repro.Target("gemmini", mode=mode, cache=False))


def _port_module(name, mode, batch, **build_kw):
    graph = zoo.get_model(name).build(batch=batch, **build_kw)
    return repro_torch.compile(graph, repro_torch.Target("gemmini", mode=mode, device="cpu", cache=False))


def _assert_bit_equal(got, want, context):
    assert len(got) == len(want), context
    for g, w in zip(got, want):
        assert isinstance(g, np.ndarray), context
        assert g.dtype == w.dtype and g.shape == w.shape, context
        np.testing.assert_array_equal(g, w, err_msg=context)


@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", MODELS)
def test_slice_matches_reference(name, mode, batch):
    gemm.reset_launches()
    ref = _ref_module(name, mode, batch)
    got = _port_module(name, mode, batch)

    assert [n.op for n in got.graph.toposort()] == [n.op for n in ref.graph.toposort()]
    assert [n.target for n in got.graph.toposort()] == [n.target for n in ref.graph.toposort()]
    assert [(p.name, p.rewrites, p.detail, p.nodes_before, p.nodes_after) for p in got.pass_report.passes] == [
        (p.name, p.rewrites, p.detail, p.nodes_before, p.nodes_after) for p in ref.pass_report.passes
    ]
    assert got.input_signature() == ref.input_signature()
    assert got.modeled_cycles() == ref.modeled_cycles()

    model = zoo.get_model(name)
    feeds = [model.feeds(seed, batch=batch) for seed in range(4)]
    context = f"{name}/{mode}/batch{batch}"
    _assert_bit_equal(got.run(feeds[0]), ref.run(feeds[0]), context)
    for g, w in zip(got.run_many(feeds), ref.run_many(feeds)):
        _assert_bit_equal(g, w, context)
    assert sum(gemm.LAUNCHES.values()) == 0


def test_reference_parameters_carry_across():
    """``build(params=...)`` takes the reference's parameter dict (numpy),
    so other weights flow into both packages identically."""
    params = ref_zoo.mlp_params(zoo.TOYCAR_LAYERS, seed=5)
    ref_graph = ref_zoo.mlp_graph(zoo.TOYCAR_LAYERS, seed=5, name="toycar_mlp", batch=16)
    ref = repro.compile(ref_graph, repro.Target("gemmini", cache=False))
    got = _port_module("toycar_mlp", "optimized", 16, params=params)
    feeds = zoo.get_model("toycar_mlp").feeds(3, batch=16)
    _assert_bit_equal(got.run(feeds), ref.run(feeds), "seed-5 weights")
    default = _port_module("toycar_mlp", "optimized", 16)
    assert not np.array_equal(default.run(feeds)[0], got.run(feeds)[0])


def test_parameter_mismatch_lists_every_problem():
    params = zoo.mlp_params(zoo.MLP_TINY_LAYERS)
    params.pop("w0")
    params["b1"] = params["b1"].astype(np.int64)
    params["w2"] = params["w2"][:, :4]
    params["extra"] = np.zeros(3)
    with pytest.raises(ValueError) as e:
        zoo.get_model("mlp_tiny").build(params=params)
    msg = str(e.value)
    for part in ("missing parameter 'w0'", "unknown parameter 'extra'", "'b1' is int64", "'w2' is float32[16, 4]"):
        assert part in msg


def test_zoo_name_compiles_the_golden_graph():
    by_name = repro_torch.compile("mlp_tiny", repro_torch.Target("gemmini", device="cpu", cache=False))
    by_graph = _port_module("mlp_tiny", "optimized", None)
    feeds = zoo.get_model("mlp_tiny").feeds(1)
    _assert_bit_equal(by_name.run(feeds), by_graph.run(feeds), "zoo name")
    with pytest.raises(KeyError, match="available"):
        repro_torch.compile("resnet50", repro_torch.Target("gemmini", device="cpu", cache=False))


def test_feed_error_lists_every_problem():
    module = _port_module("mlp_tiny", "optimized", None)
    with pytest.raises(repro_torch.FeedError) as e:
        module.run({"y": np.zeros((1, 16), np.int8)})
    assert "missing feed for input 'x'" in str(e.value)
    assert "unknown feed 'y'" in str(e.value)
    assert isinstance(e.value, KeyError)
    with pytest.raises(repro_torch.FeedError, match=r"is int32\[1, 16\], expected int8\[1, 16\]"):
        module.run({"x": np.zeros((1, 16), np.int32)})


def _host_ops_graph(irm):
    """One graph that holds naive mode's host ops (transpose, quantize,
    bias_add, requantize, clip) and the other lowered host ops, built with
    the IR module ``irm`` (the reference's or the port's)."""
    rng = np.random.default_rng(0)
    x = irm.input_((4, 6), "int8", name="x")
    w = irm.const(rng.normal(size=(5, 6)).astype(np.float32))
    wq = irm.quantize(irm.transpose(w, (1, 0)), scale=0.03125)
    d = irm.bias_add(irm.dense(x, wq), irm.const(rng.integers(-50, 50, (5,)).astype(np.int32)))
    q = irm.clip(irm.requantize(d, scale=0.0078125), lo=-20, hi=20)
    f = irm.dequantize(q, scale=0.5)
    g = irm.gelu(irm.relu(irm.sub(f, irm.mul(f, f))))
    s = irm.softmax(irm.add(g, f))
    r = irm.reshape(s, (2, 10))
    return irm.Graph([r, q], name="host_ops")


def test_host_ops_follow_numpy_semantics():
    """The port's torch host ops agree with the reference's numpy executor
    on one graph that holds them all."""
    feeds = {"x": np.random.default_rng(1).integers(-128, 128, (4, 6)).astype(np.int8)}
    want = ref_ir.execute_graph(_host_ops_graph(ref_ir), feeds)
    graph = _host_ops_graph(ir)
    module = repro_torch.compile(graph, repro_torch.Target("gemmini", mode="naive", device="cpu", cache=False))
    got = module.run(feeds)
    np.testing.assert_array_equal(got[1], want[1])
    assert got[0].dtype == want[0].dtype
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6, atol=1e-7)


def test_unported_host_op_fails_at_compile_time():
    # a collective of the reference's sharded plans, which wait for their slice
    x = ir.input_((2, 4), "float32", name="x")
    gathered = ir.Node("all_gather", [x], shape=(2, 4), dtype="float32",
                       attrs={"group": 0, "rank": 0, "parts": 1, "axis": 0})
    graph = ir.Graph([gathered], name="collective")
    with pytest.raises(NotImplementedError, match="no torch lowering"):
        repro_torch.compile(graph, repro_torch.Target("gemmini", device="cpu", cache=False))
