"""The port's pass manager held to the reference (``tests/test_pass_manager.py``).

Per-pass instrumentation, the per-mode pipelines, CSE / DCE / constant
folding in one sweep, the graph's traversal caches and their invalidation,
the pass dump and ``REPRO_PASS_TRACE``, fusion that never costs modeled
cycles, and custom pass lists.  Every case builds the same graph with each
package's ``ir`` and runs the same passes: the graph after them must be the
reference's, node for node (op, attributes, shape, dtype, wiring, constant
bytes; node names differ, since each package numbers its nodes), with the
same report and the same outputs.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import repro.core as ref_core
import repro.core.ir as ref_ir
import repro.core.pass_manager as ref_pm
import repro.core.passes as ref_passes
import repro.core.rewrite as ref_rewrite
import repro.core.zoo as ref_zoo
from repro.core.descriptions import make_gemmini_description as ref_gemmini
import repro_torch.core as port_core
import repro_torch.core.ir as port_ir
import repro_torch.core.pass_manager as port_pm
import repro_torch.core.passes as port_passes
import repro_torch.core.rewrite as port_rewrite
import repro_torch.core.zoo as port_zoo
from repro_torch.core.descriptions import make_gemmini_description

CPU = torch.device("cpu")


def _package(core, ir, pm, passes, rewrite, zoo, make_desc, port):
    backend = core.build_backend(make_desc())

    def compile_graph(graph, mode="proposed", **kw):
        if port:
            kw["device"] = CPU
        return backend.compile_graph(graph, mode=mode, **kw)

    return SimpleNamespace(ir=ir, pm=pm, passes=passes, rewrite=rewrite, zoo=zoo,
                           backend=backend, desc=backend.desc, compile=compile_graph, port=port)


REF = _package(ref_core, ref_ir, ref_pm, ref_passes, ref_rewrite, ref_zoo, ref_gemmini, False)
PORT = _package(port_core, port_ir, port_pm, port_passes, port_rewrite, port_zoo, make_gemmini_description, True)
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


def report_image(report):
    """The report without its timings."""
    return [(p.name, p.rewrites, p.nodes_before, p.nodes_after, _norm(p.detail)) for p in report.passes]


def _qdense_graph(ir):
    rng = np.random.default_rng(0)
    x = ir.input_((4, 32), "int8", name="x")
    w_fp = ir.const(rng.normal(size=(16, 32)).astype(np.float32), name="w")
    w_q = ir.quantize(ir.transpose(w_fp, (1, 0)), scale=0.05)
    b = ir.const(np.zeros(16, np.int32), name="b")
    out = ir.clip(ir.requantize(ir.bias_add(ir.dense(x, w_q), b), scale=0.1))
    return ir.Graph([out], name="qdense")


def _both_compiled(build, mode="proposed", **kw):
    want = REF.compile(build(REF.ir), mode, **kw)
    got = PORT.compile(build(PORT.ir), mode, **kw)
    assert image(got.graph) == image(want.graph)
    assert report_image(got.pass_report) == report_image(want.pass_report)
    return got, want


def assert_bit_equal(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# -- report structure -----------------------------------------------------------------


def test_report_records_every_pass_as_the_reference():
    reports = []
    for pkg in (REF, PORT):
        g = _qdense_graph(pkg.ir)
        report = pkg.pm.PassManager(pkg.passes.frontend_passes(pkg.desc)).run(
            g, pkg.pm.PassContext(desc=pkg.desc, mode="proposed"))
        reports.append((report, image(g)))
    (want, want_g), (got, got_g) = reports
    assert got_g == want_g
    assert report_image(got) == report_image(want)
    assert [p.name for p in got.passes] == [
        "fold_transpose", "legalize", "fuse_residual", "fuse_conv_pool",
        "fold_constants", "cse", "dce", "partition",
    ]
    by_pass = got.rewrites_by_pass()
    assert by_pass == want.rewrites_by_pass()
    assert by_pass["legalize"] == 1 and by_pass["fold_constants"] == 2
    assert got.total_rewrites == want.total_rewrites >= 4
    for p in got.passes:
        assert p.duration_ms >= 0 and p.nodes_before >= p.nodes_after - 1
    d, e = got.to_dict(), want.to_dict()
    assert d["graph"] == e["graph"] == "qdense" and d["mode"] == e["mode"] == "proposed"
    assert d["passes"][1]["rules"] == e["passes"][1]["rules"] == {"fuse-quantized-epilogue": 1}
    strip = lambda rec: [{k: v for k, v in p.items() if k != "duration_ms"} for p in rec["passes"]]  # noqa: E731
    assert strip(d) == strip(e)
    assert "legalize" in got.summary()


@BOTH
def test_naive_mode_is_partition_only(pkg):
    assert [p.name for p in pkg.passes.passes_for_mode(pkg.desc, "naive")] == ["partition"]
    assert [p.name for p in pkg.passes.passes_for_mode(pkg.desc, "proposed")] == [
        p.name for p in pkg.passes.passes_for_mode(pkg.desc, "c_toolchain")
    ]


def test_pipelines_name_the_reference_passes():
    for mode in ("proposed", "c_toolchain", "naive"):
        assert [p.name for p in PORT.passes.passes_for_mode(PORT.desc, mode)] == [
            p.name for p in REF.passes.passes_for_mode(REF.desc, mode)]
    for optimize in (True, False):
        assert [p.name for p in PORT.passes.frontend_passes(PORT.desc, optimize=optimize)] == [
            p.name for p in REF.passes.frontend_passes(REF.desc, optimize=optimize)]


@pytest.mark.parametrize("mode", ["proposed", "c_toolchain", "naive"])
def test_compile_attaches_the_reference_pass_report(mode):
    got, want = _both_compiled(_qdense_graph, mode)
    assert got.pass_report is not None and got.pass_report.mode == mode
    if mode != "naive":
        assert got.pass_report.rewrites_by_pass()["legalize"] == 1
    assert got.modeled_cycles() == want.modeled_cycles()


# -- the optimization passes ----------------------------------------------------------


def _dup_graph(ir):
    rng = np.random.default_rng(0)
    x = ir.input_((2, 16), "int8", name="x")
    w1 = ir.const(rng.integers(-8, 8, (16, 8)).astype(np.int8))
    w2 = ir.const(np.array(w1.value))  # value-equal, distinct node
    return ir.Graph([ir.add(ir.dense(x, w1), ir.dense(x, w2))], name="dup")


def test_cse_merges_duplicate_subexpressions():
    feeds = {"x": np.random.default_rng(0).integers(-128, 128, (2, 16)).astype(np.int8)}
    ref = ref_ir.execute_graph(_dup_graph(ref_ir), feeds)[0]
    got, want = _both_compiled(_dup_graph)
    assert got.pass_report.rewrites_by_pass()["cse"] >= 2  # const + dense
    assert len([n for n in got.graph.toposort() if n.op == "dense"]) == 1  # one shared GEMM
    assert_bit_equal(got.run(feeds)[0], ref)
    assert_bit_equal(got.run(feeds, use_plan=False)[0], ref)
    assert got.modeled_cycles() == want.modeled_cycles()


def _noop_chain(ir):
    x = ir.input_((2, 16), "int8", name="x")
    h = ir.transpose(x, (0, 1))  # identity perm
    h = ir.reshape(h, (2, 16))  # identity reshape
    h = ir.clip(h, lo=-128, hi=127)  # full int8 range: cannot clip
    return ir.Graph([ir.relu(h)], name="noop_chain")


def test_dce_removes_no_effect_nodes():
    feeds = {"x": np.random.default_rng(0).integers(-128, 128, (2, 16)).astype(np.int8)}
    got, _ = _both_compiled(_noop_chain)
    assert got.pass_report.rewrites_by_pass()["dce"] == 3
    assert [n.op for n in got.graph.toposort()] == ["input", "relu"]
    assert_bit_equal(got.run(feeds)[0], np.maximum(feeds["x"], 0))


def test_dce_keeps_effective_clip_and_transpose():
    def build(ir):
        x = ir.input_((2, 16), "int8", name="x")
        return ir.Graph([ir.clip(ir.transpose(x, (1, 0)), lo=0, hi=127)])

    got, _ = _both_compiled(build)
    assert got.pass_report.rewrites_by_pass()["dce"] == 0
    ops = [n.op for n in got.graph.toposort()]
    assert "transpose" in ops and "clip" in ops


def test_fold_constants_single_sweep_collapses_chains():
    """The whole const preprocessing chain (transpose -> quantize) folds in
    one pass invocation, to the reference's folded constant."""
    graphs = []
    for pkg in (REF, PORT):
        g = _qdense_graph(pkg.ir)
        pkg.passes.fold_constants(g)
        graphs.append(image(g))
    assert graphs[1] == graphs[0]
    ops = [n[0] for n in graphs[1][0]]
    assert "transpose" not in ops and "quantize" not in ops


# -- graph traversal caching ------------------------------------------------------------


@BOTH
def test_toposort_and_consumers_are_cached(pkg):
    g = _qdense_graph(pkg.ir)
    o1 = g.toposort()
    assert g.toposort() is o1  # cache hit: same list object
    c1 = g.consumers()
    assert g.consumers() is c1


@BOTH
def test_replace_node_invalidates_cache(pkg):
    g = _qdense_graph(pkg.ir)
    o1 = list(g.toposort())
    old = g.outputs[0]
    new = pkg.ir.relu(old.inputs[0])
    g.replace_node(old, new)
    o2 = g.toposort()
    assert old not in o2 and new in o2
    assert o2 is not o1


@BOTH
def test_invalidate_after_manual_mutation(pkg):
    g = _qdense_graph(pkg.ir)
    clip = g.outputs[0]
    g.toposort()
    g.outputs = [clip.inputs[0]]  # manual structural edit...
    g.invalidate()  # ...requires explicit invalidation
    assert clip not in g.toposort()


# -- debugging hooks --------------------------------------------------------------------


def test_pass_dump_writes_the_reference_files(tmp_path):
    names = []
    for pkg, sub in ((REF, "ref"), (PORT, "port")):
        pkg.pm.PassManager(pkg.passes.frontend_passes(pkg.desc)).run(
            _qdense_graph(pkg.ir), pkg.pm.PassContext(desc=pkg.desc, mode="proposed", dump_dir=tmp_path / sub))
        names.append(sorted(p.name for p in (tmp_path / sub).iterdir()))
    assert names[1] == names[0]
    assert any("legalize_before" in f for f in names[1])
    assert any("legalize_after" in f for f in names[1])
    assert any("partition_after" in f for f in names[1])


def test_pass_trace_env(monkeypatch, capsys):
    monkeypatch.setenv("REPRO_PASS_TRACE", "1")
    lines = []
    for pkg in (REF, PORT):
        pkg.pm.PassManager(pkg.passes.frontend_passes(pkg.desc)).run(
            _qdense_graph(pkg.ir), pkg.pm.PassContext(desc=pkg.desc, mode="proposed"))
        err = capsys.readouterr().err
        # the line up to its timing
        lines.append([line.split(" ms")[0].rsplit(" ", 1)[0] for line in err.splitlines()
                      if line.startswith("[pass]")])
    assert lines[1] == lines[0] and len(lines[1]) == 8
    assert lines[1][1].startswith("[pass] qdense:legalize")


# -- fusion passes never cost cycles ----------------------------------------------------


def _zoo_compiled(name, optimize):
    mods = []
    for pkg in (REF, PORT):
        passes = None if optimize else pkg.passes.frontend_passes(pkg.desc, optimize=False)
        mods.append(pkg.compile(pkg.zoo.get_model(name).build(), "proposed", passes=passes))
    want, got = mods
    assert image(got.graph) == image(want.graph)
    assert got.modeled_cycles() == want.modeled_cycles()
    return got


def test_residual_and_transpose_fusion_cost_no_worse():
    opt = _zoo_compiled("transformer_block", True)
    base = _zoo_compiled("transformer_block", False)
    assert opt.modeled_cycles()["total"] <= base.modeled_cycles()["total"]
    by_pass = opt.pass_report.rewrites_by_pass()
    assert by_pass["fuse_residual"] == 2 and by_pass["fold_transpose"] == 1


def test_conv_pool_fusion_cost_no_worse():
    opt = _zoo_compiled("qcnn", True)
    base = _zoo_compiled("qcnn", False)
    assert opt.modeled_cycles()["total"] <= base.modeled_cycles()["total"]
    assert opt.pass_report.rewrites_by_pass()["fuse_conv_pool"] == 1


@pytest.mark.parametrize("name", ["transformer_block", "qcnn"])
def test_optimized_pipeline_stays_bit_exact_vs_unoptimized(name):
    feeds = ref_zoo.get_model(name).feeds(seed=11)
    ref = ref_ir.execute_graph(ref_zoo.get_model(name).build(), feeds)
    for optimize in (True, False):
        mod = _zoo_compiled(name, optimize)
        for p, r in zip(mod.run(feeds), ref, strict=True):
            assert_bit_equal(p, r)


def test_custom_pass_list_override():
    """``passes=[]`` replaces the mode pipeline: nothing runs, nothing is
    partitioned, and the graph stays on the host."""
    got, _ = _both_compiled(_qdense_graph, passes=[])
    assert got.pass_report.passes == [] and not got.ops
    feeds = {"x": np.random.default_rng(1).integers(-128, 128, (4, 32)).astype(np.int8)}
    assert_bit_equal(got.run(feeds)[0], ref_ir.execute_graph(_qdense_graph(ref_ir), feeds)[0])


def test_gelu_residual_epilogue_in_the_graph_executor():
    """The generalized-op semantics cover the fused gelu activation and
    residual epilogues: the rewritten graph executes as the reference's."""
    rng = np.random.default_rng(0)
    w_v = rng.normal(size=(16, 16)).astype(np.float32)
    b_v = rng.normal(size=(16,)).astype(np.float32)
    feeds = {"x": rng.normal(size=(4, 16)).astype(np.float32)}

    def build(ir):
        x = ir.input_((4, 16), "float32", name="x")
        return ir.Graph([ir.add(ir.gelu(ir.bias_add(ir.dense(x, ir.const(w_v)), ir.const(b_v))), x)])

    ref = ref_ir.execute_graph(build(ref_ir), feeds)[0]
    images = []
    for pkg in (REF, PORT):
        g = build(pkg.ir)
        pkg.rewrite.apply_rules(g, pkg.passes.LEGALIZE_RULES)
        pkg.rewrite.apply_rules(g, pkg.passes.RESIDUAL_RULES)
        (gen,) = [n for n in g.toposort() if n.op == "generalized_dense"]
        assert gen.attrs["activation"] == "gelu" and gen.attrs["residual"] is True
        assert_bit_equal(pkg.ir.execute_graph(g, feeds)[0], ref)
        images.append(image(g))
    assert images[1] == images[0]
