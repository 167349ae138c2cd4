"""The port's traced frontend (``torch.export`` -> ``ir.Graph``) against the
reference.

Every zoo model traced from its plain-torch twin (``ZooModel.trace``) must
have the reference's golden op list, and compiled on the CPU it must be
bit-exact with the reference's golden graph compiled by ``repro.compile``,
with equal modeled cycles, in all three modes on gemmini and edge_npu.
The decode zoo's traced step, batched step and prefill must equal the
golden ones under ``ir.execute_graph``, with an equal ``CacheSpec``.

The reference is compiled from its golden graphs (``build()``), never from
``trace()``: its traced frontend fails under jax 0.9 (the importer knows
``pjit``, jax 0.9 emits ``jit``).  The idiom tests mirror
``tests/test_frontend.py`` one for one, in torch spellings.
"""

import numpy as np
import pytest
import torch

import repro
from repro.core import ir as ref_ir
from repro.core import zoo as ref_zoo
import repro_torch
from repro_torch.core import ir, zoo
from repro_torch.core.artifact import graph_fingerprint
from repro_torch.frontend import UnsupportedExportError, import_exported, nn, trace_batched, trace_model
from repro_torch.serve import ContinuousBatchingEngine, EngineConfig, random_requests

MODES = ("naive", "baseline", "optimized")
ACCELERATORS = ("gemmini", "edge_npu")


def _ops(graph) -> list[str]:
    return [n.op for n in graph.toposort()]


def _target(acc="gemmini", mode="optimized", **kw):
    return repro_torch.Target(acc, mode=mode, device="cpu", cache=False, **kw)


def _assert_bit_equal(got, want, context=""):
    assert len(got) == len(want), context
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, context
        np.testing.assert_array_equal(g, w, err_msg=context)


# -- zoo parity (the acceptance criterion) ------------------------------------


@pytest.mark.parametrize("model_name", sorted(zoo.ZOO))
def test_traced_graph_matches_golden_structure(model_name):
    model = zoo.get_model(model_name)
    assert _ops(model.trace()) == _ops(ref_zoo.get_model(model_name).build())
    assert _ops(model.trace(batch=4)) == _ops(ref_zoo.get_model(model_name).build(batch=4))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize(
    "model_name,acc",
    [(m.name, a) for m in zoo.ZOO.values() for a in m.accelerators if a in ACCELERATORS],
)
def test_traced_zoo_parity(model_name, acc, mode):
    """Traced-from-torch (port) vs the reference's golden graph: bit-exact
    outputs and identical modeled cycles through the full compile."""
    traced = repro_torch.compile(model_name, _target(acc, mode))
    golden = repro.compile(ref_zoo.get_model(model_name).build(), repro.Target(acc, mode=mode, cache=False))
    feeds = zoo.get_model(model_name).feeds(seed=7)
    _assert_bit_equal(traced.run(feeds), golden.run(feeds), f"{model_name}/{acc}/{mode}")
    assert traced.modeled_cycles() == golden.modeled_cycles()
    assert _ops(traced.graph) == _ops(golden.graph)


# -- idiom recognition --------------------------------------------------------


def test_quantize_requantize_dequantize_scales_exact():
    def fn(x):
        q = nn.quantize(x, 0.0625)
        r = nn.requantize(nn.dense(q, q), 0.015625)
        return nn.dequantize(r, 0.25)

    g = trace_model(fn, {"x": np.zeros((4, 4), np.float32)})
    by_op = {n.op: n for n in g.toposort()}
    assert _ops(g) == ["input", "quantize", "dense", "requantize", "dequantize"]
    assert by_op["quantize"].attrs["scale"] == 0.0625
    assert by_op["requantize"].attrs["scale"] == 0.015625
    assert by_op["dequantize"].attrs["scale"] == 0.25
    assert by_op["dense"].dtype == "int32"


def test_relu_named_call_and_maximum_idiom():
    x = {"x": np.zeros((3,), np.float32)}
    for fn in (
        torch.relu,
        lambda x: torch.maximum(x, torch.tensor(0.0)),
        lambda x: torch.clamp_min(x, 0),
        lambda x: torch.clamp(x, min=0),
    ):
        assert _ops(trace_model(fn, x)) == ["input", "relu"]


def test_gelu_tanh_chain_recognized():
    g = trace_model(
        lambda x: torch.nn.functional.gelu(x, approximate="tanh"), {"x": np.zeros((2, 3), np.float32)}
    )
    assert _ops(g) == ["input", "gelu"]
    with pytest.raises(UnsupportedExportError, match="tanh approximation"):
        trace_model(torch.nn.functional.gelu, {"x": np.zeros((2, 3), np.float32)})


def test_softmax_chain_recognized_with_axis():
    g = trace_model(lambda x: torch.softmax(x, dim=-1), {"x": np.zeros((2, 5), np.float32)})
    assert _ops(g) == ["input", "softmax"]
    assert g.outputs[0].attrs["axis"] == -1
    g = trace_model(lambda x: torch.softmax(x, dim=0), {"x": np.zeros((2, 5), np.float32)})
    assert g.outputs[0].attrs["axis"] == 0


def test_clip_on_tensor_becomes_clip_node():
    g = trace_model(lambda x: torch.clamp(x, 0, 127), {"x": np.zeros((4,), np.int8)})
    (out,) = g.outputs
    assert out.op == "clip" and out.attrs == {"lo": 0, "hi": 127}


def test_bias_broadcast_becomes_bias_add_but_residual_stays_add():
    def fn(x, params):
        h = nn.dense(x, params["w"]) + params["b"]  # (N,K) + (K,) -> bias_add
        return h + h  # same-shape add stays add

    g = trace_model(
        fn,
        {"x": np.zeros((2, 4), np.int8)},
        {"w": np.zeros((4, 4), np.int8), "b": np.zeros((4,), np.int32)},
    )
    assert _ops(g) == ["input", "const", "dense", "const", "bias_add", "add"]


def test_conv_pool_flatten_attrs():
    def fn(x, params):
        h = nn.conv2d(x, params["w"], stride=2, padding=1)
        h = nn.max_pool2d(h, size=2)
        return h.reshape(x.shape[0], -1)

    g = trace_model(
        fn,
        {"x": np.zeros((1, 8, 8, 3), np.int8)},
        {"w": np.zeros((3, 3, 3, 4), np.int8)},
    )
    conv = next(n for n in g.toposort() if n.op == "conv2d")
    pool = next(n for n in g.toposort() if n.op == "max_pool2d")
    assert conv.attrs == {"stride": 2, "padding": 1}
    assert pool.attrs == {"size": 2, "stride": 2}
    assert g.outputs[0].op == "reshape" and g.outputs[0].shape == (1, 16)


def test_transposed_matmul_keeps_layout_op_for_fold_pass():
    g = trace_model(
        lambda q, k: nn.dense(q, k.t()),
        {"q": np.zeros((4, 8), np.int8), "k": np.zeros((4, 8), np.int8)},
    )
    assert _ops(g) == ["input", "input", "transpose", "dense"]


def test_closure_constants_captured():
    w = torch.arange(12, dtype=torch.float32).reshape(4, 3)

    def fn(x):
        return nn.dense(x, w)

    g = trace_model(fn, {"x": np.zeros((2, 4), np.float32)})
    consts = [n for n in g.toposort() if n.op == "const"]
    assert len(consts) == 1 and np.array_equal(consts[0].value, w.numpy())


def test_semantic_equivalence_on_float_model():
    """For a float model with no rounding-sensitive idioms, the imported
    graph's reference execution matches torch's own eager evaluation."""
    w = np.random.default_rng(0).normal(size=(8, 4)).astype(np.float32)
    b = np.random.default_rng(1).normal(size=(4,)).astype(np.float32)

    def fn(x, params):
        return torch.relu(nn.dense(x, params["w"]) + params["b"])

    x = np.random.default_rng(2).normal(size=(3, 8)).astype(np.float32)
    g = trace_model(fn, {"x": x}, {"w": w, "b": b})
    got = ir.execute_graph(g, {"x": x})[0]
    want = fn(torch.from_numpy(x), {"w": torch.from_numpy(w), "b": torch.from_numpy(b)}).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)


# -- error reporting ----------------------------------------------------------


def test_unsupported_primitives_all_listed():
    def bad(x):
        return torch.sin(x) + torch.cos(x) * torch.sqrt(x)

    with pytest.raises(UnsupportedExportError) as exc:
        trace_model(bad, {"x": np.ones((2,), np.float32)})
    msg = "\n".join(exc.value.problems)
    assert "sin" in msg and "cos" in msg and "sqrt" in msg
    assert "supported ops:" in str(exc.value) and "repro_torch.dense" in str(exc.value)


def test_callable_without_example_inputs_is_rejected():
    with pytest.raises(ValueError, match="example_inputs"):
        repro_torch.compile(lambda x: x, _target())
    with pytest.raises(ValueError, match="zoo models carry their own inputs"):
        repro_torch.compile("mlp_tiny", _target(), example_inputs={"x": np.zeros((1, 16), np.int8)})
    with pytest.raises(TypeError, match="torch callable"):
        repro_torch.compile(42, _target())


# -- the front door over the tracer ------------------------------------------


def test_compile_callable_end_to_end():
    model = zoo.get_model("mlp_tiny")
    mod = repro_torch.compile(
        model.torch_fn,
        _target(),
        example_inputs=model.example_inputs(),
        params=model.params(),
    )
    feeds = model.feeds(seed=5)
    ref = ref_ir.execute_graph(ref_zoo.get_model("mlp_tiny").build(), feeds)[0]
    assert np.array_equal(mod.run(feeds)[0], ref)


def test_compile_callable_per_bucket():
    """A callable is built per bucket with batch-widened inputs; the
    batched module serves per-request feeds bit-equal to the golden
    graph."""
    model = zoo.get_model("toycar_mlp")
    served = repro_torch.compile(
        model.torch_fn,
        _target(batch_size=4),
        example_inputs=model.example_inputs(),
        params=model.params(),
    )
    assert served.bucket_sizes() == (1, 4)
    assert served.bucket_module(4).input_signature() == (("x", (4, 640), "int8"),)
    feeds = [model.feeds(seed=s) for s in range(5)]
    golden = ref_zoo.get_model("toycar_mlp").build()
    for f, got in zip(feeds, served.run_many(feeds)):
        _assert_bit_equal(got, ref_ir.execute_graph(golden, f))


def _count_exports(monkeypatch) -> list:
    calls = []
    real = torch.export.export

    def counted(*a, **kw):
        calls.append(kw.get("dynamic_shapes") is not None)
        return real(*a, **kw)

    monkeypatch.setattr(torch.export, "export", counted)
    return calls


@pytest.mark.parametrize("model_name", sorted(zoo.ZOO))
def test_trace_batched_exports_once_and_equals_per_bucket_traces(model_name, monkeypatch):
    """One export with a symbolic batch dim serves every bucket above 1,
    and one static export serves batch 1: each bucket's graph equals the
    one a static export at that batch gives, and the per-sample graph
    equals ``trace()``.  Only a model whose batched input gains a dim (the
    2-D transformer block) exports its per-sample form a third time."""
    model = zoo.get_model(model_name)
    calls = _count_exports(monkeypatch)
    sample, build = model.trace_batched()
    graphs = {b: build(b) for b in (1, 2, 3, 16)}
    stacked = model.batched_input_shape(1) != model.input_shape
    assert calls == ([True, False, False] if stacked else [True, False])
    monkeypatch.undo()
    assert graph_fingerprint(sample) == graph_fingerprint(model.trace())
    for b, g in graphs.items():
        assert graph_fingerprint(g) == graph_fingerprint(model.trace(batch=b)), b
        assert [n.shape for n in g.inputs()] == [model.batched_input_shape(b)]


def test_trace_batched_falls_back_for_a_callable_that_fixes_its_batch(monkeypatch):
    """A callable whose code pins the batch size cannot take a symbolic
    batch dim: it is exported once per bucket instead, and each bucket's
    graph is that bucket's static trace.  A branch on ``batch == 1`` keeps
    the symbolic export, and batch 1 takes the branch's other side."""
    w = (np.arange(640 * 4) % 7).astype(np.int8).reshape(640, 4)

    def pinned(x, p):
        h = nn.dense(x, p["w"])
        return h if x.shape[0] < 3 else torch.relu(h)

    def unit(x, p):
        h = nn.dense(x, p["w"])
        return h if x.shape[0] == 1 else torch.relu(h)

    example = {"x": np.zeros((1, 640), np.int8)}
    calls = _count_exports(monkeypatch)
    _, build = trace_batched(pinned, example, {"w": w})
    got = {b: build(b) for b in (1, 2, 4)}
    assert calls == [True, False, False, False]
    calls.clear()
    unit_sample, unit_build = trace_batched(unit, example, {"w": w})
    unit_got = {b: unit_build(b) for b in (1, 2, 4)}
    assert calls == [True, False]
    monkeypatch.undo()
    for fn, graphs in ((pinned, got), (unit, unit_got)):
        for b, g in graphs.items():
            want = trace_model(fn, {"x": np.zeros((b, 640), np.int8)}, {"w": w})
            assert graph_fingerprint(g) == graph_fingerprint(want), (fn.__name__, b)
    assert [n.op for n in unit_sample.toposort()] == ["input", "const", "dense"]
    assert "relu" in [n.op for n in unit_got[2].toposort()]


def test_params_are_named_by_their_path_and_accept_tensors():
    def fn(x, params):
        h = nn.dense(x, params["layers"][0]["w"])
        return nn.dense(h, params["layers"][1]["w"]) + params["b"]

    rng = np.random.default_rng(0)
    params = {
        "layers": [{"w": rng.normal(size=(4, 6)).astype(np.float32)},
                   {"w": torch.from_numpy(rng.normal(size=(6, 2)).astype(np.float32))}],
        "b": np.zeros((2,), np.float32),
    }
    g = trace_model(fn, {"x": torch.zeros(3, 4)}, params)
    consts = {n.name: n for n in g.toposort() if n.op == "const"}
    assert set(consts) == {"layers0w", "layers1w", "b"}
    np.testing.assert_array_equal(consts["layers1w"].value, params["layers"][1]["w"].numpy())
    assert g.name == "fn" and [n.name for n in g.inputs()] == ["x"]


def test_module_callable_parameters_become_constants():
    lin = torch.nn.Linear(4, 3, bias=False)

    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.lin = lin

        def forward(self, x):
            return torch.relu(nn.dense(x, self.lin.weight.t()))

    x = np.random.default_rng(3).normal(size=(2, 4)).astype(np.float32)
    g = trace_model(Net(), {"x": x}, name="net")
    consts = [n for n in g.toposort() if n.op == "const"]
    assert [n.name for n in consts] == ["lin.weight"]
    want = torch.relu(torch.from_numpy(x) @ lin.weight.detach().t()).numpy()
    np.testing.assert_allclose(ir.execute_graph(g, {"x": x})[0], want, rtol=1e-6)
    # the module's parameters come before its inputs in the export: the
    # symbolic batch dim is read off the input
    _, build = trace_batched(Net(), {"x": x[:1]}, name="net")
    np.testing.assert_allclose(ir.execute_graph(build(2), {"x": x})[0], want, rtol=1e-6)


def test_both_conversion_spellings_import_alike():
    """torch releases spell a dtype conversion as ``aten.to.dtype`` or as
    ``aten._to_copy``; the importer reads both into the same graph (and
    skips export's metadata assertions, whichever release emits them)."""
    model = zoo.get_model("mlp_tiny")
    params = {k: torch.from_numpy(v) for k, v in model.params().items()}

    class Twin(torch.nn.Module):
        def forward(self, x):
            return model.torch_fn(x, params)

    ep = torch.export.export(Twin(), (torch.zeros(1, 16, dtype=torch.int8),), strict=False)
    want = _ops(import_exported(ep, input_names=["x"], name="mlp_tiny"))
    rewritten = 0
    for node in ep.graph.nodes:
        if node.op == "call_function" and node.target is torch.ops.aten.to.dtype:
            node.target = torch.ops.aten._to_copy.default
            node.kwargs = {"dtype": node.args[1]}
            node.args = (node.args[0],)
            rewritten += 1
    assert rewritten == 2 * 8  # a quantize and a requantize per layer
    got = import_exported(ep, input_names=["x"], name="mlp_tiny")
    assert _ops(got) == want == _ops(ref_zoo.get_model("mlp_tiny").build())


def test_traced_graphs_are_fresh_copies():
    """Every ``trace()`` is a fresh graph: compiling one (the passes
    mutate it) leaves the next untouched."""
    model = zoo.get_model("mlp_tiny")
    first, second = model.trace(), model.trace()
    assert first is not second and first.toposort()[0] is not second.toposort()[0]
    before = _ops(second)
    repro_torch.compile(first, _target())
    assert _ops(second) == before == _ops(model.trace())


def test_custom_ops_eager_semantics():
    """The custom ops' eager bodies: integers accumulate wide; conv and
    pooling in NHWC/HWIO; the cache ops as the IR executes them."""
    rng = np.random.default_rng(4)
    x = rng.integers(-128, 128, (2, 5, 5, 3)).astype(np.int8)
    w = rng.integers(-128, 128, (3, 3, 3, 4)).astype(np.int8)
    xi, wi = ref_ir.input_(x.shape, "int8", name="x"), ref_ir.const(w)
    conv = ref_ir.conv2d(xi, wi, stride=2, padding=1)
    got = nn.conv2d(torch.from_numpy(x), torch.from_numpy(w), stride=2, padding=1)
    np.testing.assert_array_equal(got.numpy(), ref_ir.execute_node(conv, [x, w]))
    pool = ref_ir.max_pool2d(xi, size=2)
    np.testing.assert_array_equal(nn.max_pool2d(torch.from_numpy(x), 2).numpy(), ref_ir.execute_node(pool, [x]))
    a = rng.integers(-128, 128, (3, 300)).astype(np.int8)
    b = rng.integers(-128, 128, (300, 2)).astype(np.int8)
    dense = nn.dense(torch.from_numpy(a), torch.from_numpy(b))
    assert dense.dtype == torch.int32
    np.testing.assert_array_equal(dense.numpy(), a.astype(np.int64) @ b.astype(np.int64))
    cache = rng.integers(-128, 128, (2, 6, 4)).astype(np.int8)
    upd = rng.integers(-128, 128, (2, 1, 4)).astype(np.int8)
    pos = np.array([0, 5], np.int32)
    out = nn.kv_cache_append(*(torch.from_numpy(v) for v in (cache, upd, pos)))
    np.testing.assert_array_equal(out.numpy(), ref_ir.kv_append_ref(cache, upd, pos))
    np.testing.assert_array_equal(nn.kv_cache_read(out).numpy(), out.numpy())
    with pytest.raises(ValueError, match="out of bounds"):
        nn.kv_cache_append(torch.from_numpy(cache), torch.from_numpy(upd), torch.tensor([0, 6], dtype=torch.int32))


@pytest.mark.parametrize("model_name", ("mlp_tiny", "toycar_mlp", "qcnn"))
def test_twin_eager_run_equals_the_golden_graph(model_name):
    """The torch twin run eagerly (the custom ops' bodies) gives the golden
    graph's codes: the scales are powers of two and the accumulators stay
    far below 2**24, so float32 rounding is exact here."""
    model = zoo.get_model(model_name)
    feeds = model.feeds(seed=2)
    params = {k: torch.from_numpy(v) for k, v in model.params().items()}
    got = model.torch_fn(torch.from_numpy(feeds["x"]), params)
    np.testing.assert_array_equal(got.numpy(), ref_ir.execute_graph(ref_zoo.get_model(model_name).build(), feeds)[0])


# -- the decode zoo's traced forms ------------------------------------------


DECODE = zoo.get_decode_model("attn_decode")
REF_DECODE = ref_zoo.get_decode_model("attn_decode")


def _decode_feeds(seq, batch, seed=3):
    if seq == 1:
        return REF_DECODE.feeds(seed=seed, batch=batch)
    return {
        **REF_DECODE.example_inputs(seq=seq),
        "x": np.random.default_rng(seed).integers(-128, 128, (seq, REF_DECODE.d_model)).astype(np.int8),
        "mask": ref_zoo.prefill_mask(seq, REF_DECODE.max_len),
    }


@pytest.mark.parametrize("seq,batch", [(1, None), (1, 4), (1, 8), (16, None)])
def test_traced_decode_forms_match_golden(seq, batch):
    traced = DECODE.trace(seq=seq, batch=batch)
    golden = REF_DECODE.build(seq=seq, batch=batch)
    assert _ops(traced) == _ops(golden) and traced.name == golden.name
    assert traced.cache_spec == DECODE.build(seq=seq, batch=batch).cache_spec
    assert [(k, getattr(traced.cache_spec, k)) for k in ("max_len", "dtype", "layout", "state", "pos_input", "mask_input")] == [
        (k, getattr(golden.cache_spec, k)) for k in ("max_len", "dtype", "layout", "state", "pos_input", "mask_input")
    ]
    feeds = _decode_feeds(seq, batch)
    _assert_bit_equal(ir.execute_graph(traced, feeds), ref_ir.execute_graph(golden, feeds), f"seq {seq} batch {batch}")


def test_decode_name_compiles_the_traced_step():
    module = repro_torch.compile("attn_decode", _target())
    assert module.graph.name == "attn_decode" and module.graph.cache_spec.layout == "LD"
    feeds = REF_DECODE.feeds(seed=9)
    _assert_bit_equal(module.run(feeds), ref_ir.execute_graph(REF_DECODE.build(), feeds))


def test_engine_tokens_from_traced_graphs_equal_golden(monkeypatch):
    """The continuous-batching engine compiles ``trace(...)`` graphs; its
    tokens and vectors equal those of the same engine over the golden
    graphs."""
    cfg = EngineConfig(batch=3, prompt_len=6, max_new_tokens=5)
    target = _target()

    def serve():
        reqs = random_requests(DECODE, 5, cfg.prompt_len, seed=1)
        report = ContinuousBatchingEngine(DECODE, target, cfg).run(reqs)
        return [(r.tokens, r.vectors) for r in report.requests]

    traced = serve()
    monkeypatch.setattr(
        zoo.DecodeModel, "trace", lambda self, seq=1, batch=None: self.build(seq=seq, batch=batch)
    )
    golden = serve()
    assert len(traced) == 5
    for (t_tokens, t_vecs), (g_tokens, g_vecs) in zip(traced, golden):
        assert t_tokens == g_tokens
        assert all(np.array_equal(a, b) for a, b in zip(t_vecs, g_vecs))
