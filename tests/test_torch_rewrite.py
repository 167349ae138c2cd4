"""The port's declarative rewrite engine held to the reference
(``tests/test_rewrite.py``): one golden per pattern (fires on the minimal
graph, refuses when an intermediate has a second consumer or is a graph
output), the engine's bookkeeping, description-contributed patterns, and a
multi-output graph compiled and run in every mode.

Every case builds the same graph with each package's ``ir`` and applies
the same rules: the graph after them must be the reference's, node for node
(op, attributes, shape, dtype, wiring, constant bytes; node names differ,
since each package numbers its nodes), with the same fire counts.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import repro.core as ref_core
import repro.core.ir as ref_ir
import repro.core.passes as ref_passes
import repro.core.rewrite as ref_rewrite
from repro.core.descriptions import make_gemmini_description as ref_gemmini
import repro_torch.core as port_core
import repro_torch.core.ir as port_ir
import repro_torch.core.passes as port_passes
import repro_torch.core.rewrite as port_rewrite
from repro_torch.core.descriptions import make_gemmini_description

CPU = torch.device("cpu")
REF = SimpleNamespace(ir=ref_ir, passes=ref_passes, rw=ref_rewrite, core=ref_core, make_desc=ref_gemmini,
                      device={})
PORT = SimpleNamespace(ir=port_ir, passes=port_passes, rw=port_rewrite, core=port_core,
                       make_desc=make_gemmini_description, device={"device": CPU})
BOTH = pytest.mark.parametrize("pkg", [REF, PORT], ids=["reference", "port"])


def _norm(v):
    if isinstance(v, dict):
        return tuple(sorted((k, _norm(x)) for k, x in v.items()))
    if isinstance(v, (list, tuple)):
        return tuple(_norm(x) for x in v)
    if isinstance(v, np.ndarray):
        return ("array", v.dtype.str, v.shape, v.tobytes())
    if isinstance(v, np.generic):
        return v.item()
    return v


def image(graph):
    """The graph node for node in topological order, without node names."""
    order = graph.toposort()
    index = {n: i for i, n in enumerate(order)}
    nodes = [
        (n.op, _norm(n.attrs), tuple(n.shape), str(n.dtype), n.target,
         tuple(None if i is None else index[i] for i in n.inputs),
         None if n.value is None else _norm(np.asarray(n.value)))
        for n in order
    ]
    return nodes, [index[o] for o in graph.outputs]


def golden(build, rules_name):
    """Build with each package, apply its ``rules_name`` table; the graphs
    and fire counts must agree.  Returns the port's graph and count."""
    out = []
    for pkg in (REF, PORT):
        g = build(pkg)
        counters: dict[str, int] = {}
        n = pkg.rw.apply_rules(g, getattr(pkg.passes, rules_name), counters=counters)
        out.append((g, n, counters))
    (want, n_want, c_want), (got, n_got, c_got) = out
    assert image(got) == image(want)
    assert (n_got, c_got) == (n_want, c_want)
    return got, n_got


def _ops(g) -> list[str]:
    return [n.op for n in g.toposort()]


def _qchain(ir, x=None):
    """Minimal quantized chain: clip(requantize(bias_add(dense(x, w))))."""
    rng = np.random.default_rng(0)
    x = x if x is not None else ir.input_((2, 16), "int8", name="x")
    w = ir.const(rng.integers(-8, 8, (x.shape[-1], 8)).astype(np.int8))
    b = ir.const(rng.integers(-50, 50, (8,)).astype(np.int32))
    return ir.clip(ir.requantize(ir.bias_add(ir.dense(x, w), b), scale=0.05))


# -- per-pattern goldens ------------------------------------------------------------


def test_fuse_quantized_fires_on_minimal_graph():
    g, n = golden(lambda p: p.ir.Graph([_qchain(p.ir)]), "LEGALIZE_RULES")
    assert n == 1
    assert _ops(g) == ["input", "const", "const", "generalized_dense"]
    assert g.outputs[0].attrs["quantized"] is True and g.outputs[0].attrs["requant_scale"] == 0.05


def test_fuse_quantized_refuses_second_consumer():
    """A second consumer of the intermediate requantize blocks the fusion;
    the inner bias fusion still applies."""
    def build(p):
        chain = _qchain(p.ir)
        return p.ir.Graph([chain, p.ir.relu(chain.inputs[0])])

    g, _ = golden(build, "LEGALIZE_RULES")
    ops = _ops(g)
    assert "clip" in ops and "requantize" in ops and "generalized_dense" in ops


def test_fuse_quantized_refuses_interior_graph_output():
    def build(p):
        chain = _qchain(p.ir)
        return p.ir.Graph([chain, chain.inputs[0]])

    g, _ = golden(build, "LEGALIZE_RULES")
    assert "requantize" in _ops(g) and "clip" in _ops(g)
    feeds = {"x": np.random.default_rng(1).integers(-128, 128, (2, 16)).astype(np.int8)}
    ref = ref_ir.execute_graph(build(REF), feeds)
    for r, o in zip(ref, PORT.ir.execute_graph(g, feeds), strict=True):
        np.testing.assert_array_equal(o, r)


def _activation_graph(p, act, shared=False):
    ir = p.ir
    x = ir.input_((4, 32), "float32", name="x")
    w = ir.const(np.ones((32, 16), np.float32))
    b = ir.const(np.zeros(16, np.float32))
    ba = ir.bias_add(ir.dense(x, w), b)
    if shared:
        return ir.Graph([ir.relu(ba), ir.gelu(ba)])
    return ir.Graph([getattr(ir, act)(ba)])


@pytest.mark.parametrize("act", ["relu", "gelu"])
def test_fuse_activation_fires(act):
    graphs = [p.passes.legalize(_activation_graph(p, act)) for p in (REF, PORT)]
    assert image(graphs[1]) == image(graphs[0])
    gen = graphs[1].outputs[0]
    assert gen.op == "generalized_dense" and gen.attrs["activation"] == act


def test_fuse_activation_refuses_a_shared_bias_add():
    """A second consumer of the bias_add blocks the activation fusion; the
    bare bias fusion still applies, so both activations read one
    generalized op with no fused activation."""
    graphs = [p.passes.legalize(_activation_graph(p, None, shared=True)) for p in (REF, PORT)]
    assert image(graphs[1]) == image(graphs[0])
    ops = _ops(graphs[1])
    assert "relu" in ops and "gelu" in ops
    (gen,) = [n for n in graphs[1].toposort() if n.op == "generalized_dense"]
    assert gen.attrs["activation"] is None


def test_fold_transpose_transpose_identity_and_composed():
    g, n = golden(lambda p: p.ir.Graph([p.ir.transpose(p.ir.transpose(
        p.ir.input_((2, 3, 4), "float32", name="x"), (2, 1, 0)), (2, 1, 0))]), "FOLD_TRANSPOSE_RULES")
    assert n == 1 and g.outputs[0].op == "input"  # identity composition folds to the source
    g2, n2 = golden(lambda p: p.ir.Graph([p.ir.transpose(p.ir.transpose(
        p.ir.input_((2, 3, 4), "float32", name="y"), (1, 0, 2)), (2, 1, 0))]), "FOLD_TRANSPOSE_RULES")
    (t,) = [n for n in g2.toposort() if n.op == "transpose"]
    assert n2 == 1 and t.attrs["perm"] == (2, 0, 1) and t.shape == (4, 2, 3)
    xv = np.random.default_rng(0).normal(size=(2, 3, 4)).astype(np.float32)
    np.testing.assert_array_equal(PORT.ir.execute_graph(g2, {"y": xv})[0],
                                  xv.transpose((1, 0, 2)).transpose((2, 1, 0)))


def test_fold_transpose_transpose_refuses_shared_inner():
    def build(p):
        inner = p.ir.transpose(p.ir.input_((2, 3, 4), "float32", name="x"), (2, 1, 0))
        return p.ir.Graph([p.ir.transpose(inner, (2, 1, 0)), p.ir.relu(inner)])

    g, n = golden(build, "FOLD_TRANSPOSE_RULES")
    assert n == 0 and _ops(g).count("transpose") == 2


def test_fold_transpose_into_dense():
    def build(p):
        k = p.ir.input_((16, 64), "int8", name="k")
        q = p.ir.input_((16, 64), "int8", name="q")
        return p.ir.Graph([p.ir.dense(q, p.ir.transpose(k, (1, 0)))])

    g, n = golden(build, "FOLD_TRANSPOSE_RULES")
    gen = g.outputs[0]
    assert n == 1 and gen.op == "dense" and gen.attrs["transpose_b"] is True
    assert gen.inputs[1].name == "k" and "transpose" not in _ops(g)


def test_fold_transpose_into_dense_refuses_const_and_shared():
    def const_weight(p):
        x = p.ir.input_((4, 8), "int8", name="x")
        return p.ir.Graph([p.ir.dense(x, p.ir.transpose(p.ir.const(np.ones((16, 8), np.int8)), (1, 0)))])

    def shared(p):
        t = p.ir.transpose(p.ir.input_((16, 64), "int8", name="k"), (1, 0))
        return p.ir.Graph([p.ir.dense(p.ir.input_((16, 64), "int8", name="q"), t), p.ir.relu(t)])

    assert golden(const_weight, "FOLD_TRANSPOSE_RULES")[1] == 0
    assert golden(shared, "FOLD_TRANSPOSE_RULES")[1] == 0


def _gen_dense(p, x, k=8, quantized=False, seed=0):
    rng = np.random.default_rng(seed)
    w = p.ir.const(rng.integers(-8, 8, (x.shape[-1], k)).astype(np.int8))
    b = p.ir.const(rng.integers(-50, 50, (k,)).astype(np.int32))
    attrs = {"quantized": False, "activation": None}
    if quantized:
        attrs = {"quantized": True, "requant_scale": 0.05, "clip_lo": -128, "clip_hi": 127}
    return p.ir.Node("generalized_dense", [x, w, b], attrs, shape=(*x.shape[:-1], k),
                     dtype="int8" if quantized else "int32")


def test_fuse_residual_fires_minimal():
    def build(p):
        x = p.ir.input_((4, 8), "int8", name="x")
        return p.ir.Graph([p.ir.add(_gen_dense(p, x, quantized=True), x)])

    g, n = golden(build, "RESIDUAL_RULES")
    fused = g.outputs[0]
    assert n == 1 and fused.op == "generalized_dense" and fused.attrs["residual"] is True
    assert len(fused.inputs) == 4 and fused.inputs[3].name == "x"


def test_fuse_residual_rhs_and_refusals():
    def rhs(p):
        x = p.ir.input_((4, 8), "int8", name="x")
        return p.ir.Graph([p.ir.add(x, _gen_dense(p, x, quantized=True))])

    def shared(p):
        gen = _gen_dense(p, p.ir.input_((4, 8), "int8", name="x"), quantized=True)
        return p.ir.Graph([p.ir.add(gen, gen.inputs[0]), p.ir.relu(gen)])

    def broadcast(p):
        gen = _gen_dense(p, p.ir.input_((4, 8), "int8", name="x"), quantized=True)
        return p.ir.Graph([p.ir.add(gen, p.ir.const(np.ones((1, 8), np.int8)))])

    g, n = golden(rhs, "RESIDUAL_RULES")
    assert n == 1 and g.outputs[0].attrs["residual"] is True
    assert golden(shared, "RESIDUAL_RULES")[1] == 0
    assert golden(broadcast, "RESIDUAL_RULES")[1] == 0


def _conv_node(p, quantized):
    x = p.ir.input_((1, 6, 6, 4), "int8", name="x")
    w = p.ir.const(np.ones((3, 3, 4, 8), np.int8))
    attrs = {"stride": 1, "padding": 0}
    attrs.update({"quantized": True, "requant_scale": 0.1, "clip_lo": -128, "clip_hi": 127}
                 if quantized else {"quantized": False, "activation": None})
    return p.ir.Node("generalized_conv2d", [x, w, None], attrs, shape=(1, 4, 4, 8),
                     dtype="int8" if quantized else "int32")


def test_fuse_conv_pool_fires_minimal():
    g, n = golden(lambda p: p.ir.Graph([p.ir.max_pool2d(_conv_node(p, True), size=2, stride=2)]),
                  "CONV_POOL_RULES")
    fused = g.outputs[0]
    assert n == 1 and fused.op == "generalized_conv2d"
    assert fused.attrs["pool"] == {"size": 2, "stride": 2, "conv_shape": (1, 4, 4, 8)}
    assert fused.shape == (1, 2, 2, 8)


def test_fuse_conv_pool_refuses_shared_conv():
    def build(p):
        conv = _conv_node(p, False)
        return p.ir.Graph([p.ir.max_pool2d(conv, 2), p.ir.relu(conv)])

    assert golden(build, "CONV_POOL_RULES")[1] == 0


# -- engine mechanics ----------------------------------------------------------------


@BOTH
def test_match_pattern_wildcard_and_arity(pkg):
    ir, rw = pkg.ir, pkg.rw
    x = ir.input_((2, 4), "int8", name="x")
    w = ir.const(np.ones((4, 4), np.int8))
    d = ir.dense(x, w)
    g = ir.Graph([d])
    cons = {n: list(c) for n, c in g.consumers().items()}
    m = rw.match_pattern(rw.P("dense", rw.any_("a"), rw.any_("b")), d, cons, set())
    assert m is not None and m["a"] is x and m["b"] is w
    assert rw.match_pattern(rw.P("dense", rw.any_()), d, cons, set()) is None  # wrong arity


@BOTH
def test_wildcard_captures_absent_operand_as_none(pkg):
    ir, rw = pkg.ir, pkg.rw
    x = ir.input_((2, 4), "int8", name="x")
    w = ir.const(np.ones((4, 4), np.int8))
    gen = ir.Node("generalized_dense", [x, w, None], {"quantized": False, "activation": None},
                  shape=(2, 4), dtype="int32")
    g = ir.Graph([ir.relu(gen)])
    cons = {n: list(c) for n, c in g.consumers().items()}
    pat = rw.P("relu", rw.P("generalized_dense", rw.any_("a"), rw.any_("w"), rw.any_("bias")))
    m = rw.match_pattern(pat, g.outputs[0], cons, set())
    assert m is not None and m["bias"] is None and m["a"] is x and m["w"] is w


@BOTH
def test_rule_priority_is_list_order(pkg):
    ir, rw = pkg.ir, pkg.rw
    hits = []

    @rw.rule("first", rw.P("relu", rw.any_("src")))
    def r1(m, g):
        hits.append("first")
        return None  # decline: the next rule gets a chance

    @rw.rule("second", rw.P("relu", rw.any_("src")))
    def r2(m, g):
        hits.append("second")
        return None

    rw.apply_rules(ir.Graph([ir.relu(ir.input_((2,), "float32", name="x"))]), (r1, r2))
    assert hits == ["first", "second"]


def test_counters_record_rule_fires():
    _, n = golden(lambda p: p.ir.Graph([_qchain(p.ir)]), "LEGALIZE_RULES")
    counters: dict[str, int] = {}
    PORT.rw.apply_rules(PORT.ir.Graph([_qchain(PORT.ir)]), PORT.passes.LEGALIZE_RULES, counters=counters)
    assert n == 1 and counters == {"fuse-quantized-epilogue": 1}


def _absorb_requantize(p, desc):
    @desc.register_rewrite_pattern(
        "absorb-requantize", p.rw.P("requantize", p.rw.P("generalized_dense", capture="gen"))
    )
    def absorb(m, g):
        gen, root = m["gen"], m.root
        if gen.attrs.get("quantized"):
            return None
        return p.ir.Node(
            gen.op, list(gen.inputs),
            {**gen.attrs, "quantized": True, "requant_scale": root.attrs["scale"], "clip_lo": -128,
             "clip_hi": 127},
            shape=root.shape, dtype=root.dtype,
        )

    return desc


def test_description_contributed_pattern():
    """A target plugs in its own fusion pattern through the description:
    the compiled graph, report and output equal the reference's."""
    rng = np.random.default_rng(0)
    w_v = rng.integers(-8, 8, (16, 8)).astype(np.int8)
    b_v = rng.integers(-20, 20, (8,)).astype(np.int32)
    feeds = {"x": np.full((2, 16), 3, np.int8)}

    def build(ir):
        x = ir.input_((2, 16), "int8", name="x")
        return ir.Graph([ir.requantize(ir.bias_add(ir.dense(x, ir.const(w_v)), ir.const(b_v)), scale=0.5)])

    ref = ref_ir.execute_graph(build(ref_ir), feeds)[0]
    mods = []
    for p in (REF, PORT):
        backend = p.core.build_backend(_absorb_requantize(p, p.make_desc()))
        mods.append(backend.compile_graph(build(p.ir), mode="proposed", **p.device))
    want, got = mods
    assert image(got.graph) == image(want.graph)
    assert got.pass_report.rewrites_by_pass().get("target_patterns") == 1
    gen = [n for n in got.graph.toposort() if n.op == "generalized_dense"]
    assert gen and gen[0].attrs["quantized"] is True
    np.testing.assert_array_equal(got.run(feeds)[0], ref)
    assert got.modeled_cycles() == want.modeled_cycles()


@BOTH
def test_fixed_point_guard(pkg):
    ir, rw = pkg.ir, pkg.rw

    @rw.rule("spin", rw.P("relu", rw.any_("src")))
    def spin(m, g):
        return ir.Node("relu", [m["src"]], {}, shape=m.root.shape, dtype=m.root.dtype)

    with pytest.raises(RuntimeError, match="fixed point"):
        rw.apply_rules(ir.Graph([ir.relu(ir.input_((2,), "float32", name="x"))]), (spin,), max_rounds=5)


# -- multi-output graphs through the full pipeline -------------------------------------


@pytest.mark.parametrize("use_pallas", [True, False], ids=["kernel", "emulated"])
@pytest.mark.parametrize("mode", ["proposed", "c_toolchain", "naive"])
def test_multi_output_graph_compiles_and_runs(mode, use_pallas):
    """Both outputs survive compilation, the first feeding the second chain
    and observable: planned, interpreted and the reference all agree, and
    the compiled graph is the reference's."""
    def build(ir):
        x = ir.input_((2, 16), "int8", name="x")
        h1 = _qchain(ir, x)
        return ir.Graph([h1, _qchain(ir, h1)], name="two_heads")

    feeds = {"x": np.random.default_rng(2).integers(-128, 128, (2, 16)).astype(np.int8)}
    ref = ref_ir.execute_graph(build(ref_ir), feeds)
    want = ref_core.build_backend(ref_gemmini()).compile_graph(build(ref_ir), mode=mode)
    got = port_core.build_backend(make_gemmini_description(), use_pallas=use_pallas).compile_graph(
        build(port_ir), mode=mode, device=CPU)
    assert image(got.graph) == image(want.graph)
    assert got.modeled_cycles() == want.modeled_cycles()
    planned, interpreted = got.run(feeds), got.run(feeds, use_plan=False)
    assert len(planned) == 2
    for p, i, r in zip(planned, interpreted, ref, strict=True):
        np.testing.assert_array_equal(p, r)
        np.testing.assert_array_equal(i, r)
    if mode != "naive":
        gens = [n for n in got.graph.toposort() if n.op == "generalized_dense"]
        assert len(gens) == 2 and got.graph.outputs[0] is gens[0]
