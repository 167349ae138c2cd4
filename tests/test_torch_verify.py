"""The port's static verifier (``repro_torch.core.verify``) against the
reference's (``repro.core.verify``).

The mutation corpus of ``tests/test_verify.py`` that needs no collectives:
each broken graph or plan is built once with each package's IR and must
give the same diagnostics (code and message; node names differ between the
packages) from the port as from the reference.  Around it: zero
diagnostics across every module the port compiles, the pass-invariant gate
(``each`` / ``final`` / off by default), ``S_SCHEDULE`` from a corrupt
cached schedule, and the tampered-artifact refusals of ``load`` and the
write-through store.
"""

import json

import numpy as np
import pytest
import torch

import repro
from repro.core import ir as ref_ir
from repro.core import verify as ref_verify
from repro.core import zoo as ref_zoo
from repro.core.executor import ExecutionPlan as RefPlan
from repro.core.executor import PlanStep as RefStep
import repro_torch
from repro_torch.core import ir, verify, zoo
from repro_torch.core.artifact import _read_arrays, graph_fingerprint, graph_from_dict
from repro_torch.core.executor import ExecutionPlan, PlanStep
from repro_torch.core.pass_manager import GraphPass, PassContext, PassManager
from repro_torch.core.strategy import workload_from_node

MODES = ("naive", "baseline", "optimized")
#: each IR package's own zoo
ZOOS = {ir: zoo, ref_ir: ref_zoo}


def _target(acc="gemmini", mode="optimized", **kw):
    return repro_torch.Target(acc, mode=mode, device="cpu", **{"cache": False, **kw})


def codes(diags):
    return {d.code for d in diags}


def _findings(diags):
    """What both packages must agree on: code and message, in order."""
    return [(d.code, d.message) for d in diags]


# ---------------------------------------------------------------------------
# the graph corpus: each builder takes an IR package and its registry
# ---------------------------------------------------------------------------


def _qdense(pkg):
    x = pkg.input_((4, 8), "int8", name="x")
    w = pkg.const(np.ones((8, 16), dtype=np.int8), name="w")
    y = pkg.dense(x, w)
    return pkg.Graph(outputs=[y], name="qdense"), y


def legal_graph(pkg, reg):
    return _qdense(pkg)[0], None


def wrong_dense_k_dim(pkg, reg):
    g, y = _qdense(pkg)
    y.shape = (4, 12)
    return g, None


def transposed_b_read_untransposed(pkg, reg):
    x = pkg.input_((4, 8), "int8", name="x")
    w = pkg.const(np.ones((16, 8), dtype=np.int8))
    y = pkg.Node("dense", [x, w], {"transpose_b": True}, shape=(4, 8), dtype="int32")
    return pkg.Graph(outputs=[y], name="tb"), None


def transposed_b_legal(pkg, reg):
    g, _ = transposed_b_read_untransposed(pkg, reg)
    g.outputs[0].shape = (4, 16)
    return g, None


def float_dense_offloaded(pkg, reg):
    x = pkg.input_((4, 8), "float32", name="x")
    y = pkg.dense(x, pkg.const(np.ones((8, 16), dtype=np.float32)))
    y.target = "accel"
    return pkg.Graph(outputs=[y], name="float_offload"), reg.get("gemmini")


def float_dense_on_host(pkg, reg):
    g, desc = float_dense_offloaded(pkg, reg)
    g.outputs[0].target = "host"
    return g, desc


def offloaded_cache_op(pkg, reg):
    read = pkg.kv_cache_read(pkg.input_((8, 4), "int8", name="k_cache"))
    read.target = "accel"
    return pkg.Graph(outputs=[read], name="cache_offload"), None


def offloaded_append_in_decode_step(pkg, reg):
    g = ZOOS[pkg].get_decode_model("attn_decode").build(batch=2)
    next(n for n in g.toposort() if n.op == "kv_cache_append").target = "accel"
    return g, reg.get("gemmini")


def cycle(pkg, reg):
    x = pkg.input_((2, 2), "float32", name="x")
    a = pkg.relu(x)
    b = pkg.relu(a)
    a.inputs[0] = b
    return pkg.Graph(outputs=[b], name="cyclic"), None


def dangling_input(pkg, reg):
    r = pkg.relu(pkg.input_((2, 2), "float32", name="x"))
    r.inputs[0] = None
    return pkg.Graph(outputs=[r], name="dangling"), None


def generalized_without_bias(pkg, reg):
    x = pkg.input_((4, 8), "int8", name="x")
    w = pkg.const(np.ones((8, 16), dtype=np.int8))
    y = pkg.Node("generalized_dense", [x, w, None], {}, shape=(4, 16), dtype="int32")
    return pkg.Graph(outputs=[y], name="gen"), None


def generalized_without_x(pkg, reg):
    g, _ = generalized_without_bias(pkg, reg)
    g.outputs[0].inputs[0] = None
    return g, None


def _cache_graph(pkg, spec):
    cache = pkg.input_((8, 4), "int8", name="k_cache")
    new = pkg.kv_cache_append(cache, pkg.input_((1, 4), "int8", name="upd"),
                              pkg.input_((), "int32", name="pos"))
    g = pkg.Graph(outputs=[new], name="dec")
    g.cache_spec = pkg.CacheSpec(**spec)
    return g, None


def cache_spec_legal(pkg, reg):
    return _cache_graph(pkg, dict(max_len=8, state=(("k_cache", 0),)))


def cache_spec_unknown_input(pkg, reg):
    return _cache_graph(pkg, dict(max_len=8, state=(("v_cache", 0),)))


def cache_spec_output_out_of_range(pkg, reg):
    return _cache_graph(pkg, dict(max_len=8, state=(("k_cache", 3),)))


def cache_spec_wrong_capacity(pkg, reg):
    return _cache_graph(pkg, dict(max_len=64, state=(("k_cache", 0),)))


def cache_spec_bad_layout_and_dtype(pkg, reg):
    return _cache_graph(pkg, dict(max_len=8, layout="bshd", dtype="int32", state=(("k_cache", 0),)))


def cache_spec_pos_not_an_input(pkg, reg):
    return _cache_graph(pkg, dict(max_len=8, pos_input="step", state=(("k_cache", 0),)))


def decode_step_state_rewired(pkg, reg):
    g = ZOOS[pkg].get_decode_model("attn_decode").build()
    g.cache_spec = pkg.CacheSpec(max_len=64, state=(("k_cache", 0), ("v_cache", 2)))
    return g, None


def bad_transpose_perm(pkg, reg):
    t = pkg.transpose(pkg.input_((2, 3), "float32", name="x"), (1, 0))
    t.attrs["perm"] = (0, 0)
    return pkg.Graph(outputs=[t], name="perm"), None


def missing_clip_attr(pkg, reg):
    c = pkg.clip(pkg.input_((2, 3), "int32", name="x"))
    del c.attrs["lo"]
    return pkg.Graph(outputs=[c], name="noclip"), None


def unknown_op(pkg, reg):
    y = pkg.Node("frobnicate", [pkg.input_((2, 2), "float32", name="x")], shape=(2, 2), dtype="float32")
    return pkg.Graph(outputs=[y], name="unknown"), None


def duplicate_input_names(pkg, reg):
    a = pkg.input_((2, 2), "float32", name="x")
    b = pkg.input_((2, 2), "float32", name="x")
    return pkg.Graph(outputs=[pkg.add(a, b)], name="dup"), None


def relu_changes_dtype(pkg, reg):
    r = pkg.relu(pkg.input_((2, 2), "int8", name="x"))
    r.dtype = "float32"
    return pkg.Graph(outputs=[r], name="dtype"), None


def mixed_dense_operand_dtypes(pkg, reg):
    y = pkg.dense(pkg.input_((4, 8), "int8", name="x"), pkg.const(np.ones((8, 16), dtype=np.float32)))
    return pkg.Graph(outputs=[y], name="mixed"), None


def const_value_disagrees(pkg, reg):
    w = pkg.const(np.ones((3, 3), dtype=np.int8))
    w.shape = (2, 2)
    w.dtype = "int32"
    return pkg.Graph(outputs=[pkg.relu(w)], name="badconst"), None


def append_update_wider_than_cache(pkg, reg):
    cache = pkg.input_((8, 4), "int8", name="k_cache")
    app = pkg.kv_cache_append(cache, pkg.input_((1, 4), "int8", name="u"), pkg.input_((), "int32", name="p"))
    app.inputs[1] = pkg.input_((9, 4), "int8", name="wide")
    return pkg.Graph(outputs=[app], name="wide_append"), None


#: (builder, the code it must produce, or None for a clean graph)
GRAPH_CORPUS = [
    (legal_graph, None),
    (wrong_dense_k_dim, "G_SHAPE"),
    (transposed_b_read_untransposed, "G_SHAPE"),
    (transposed_b_legal, None),
    (float_dense_offloaded, "G_TARGET"),
    (float_dense_on_host, None),
    (offloaded_cache_op, "G_TARGET"),
    (offloaded_append_in_decode_step, "G_TARGET"),
    (cycle, "G_CYCLE"),
    (dangling_input, "G_DANGLING"),
    (generalized_without_bias, None),
    (generalized_without_x, "G_DANGLING"),
    (cache_spec_legal, None),
    (cache_spec_unknown_input, "G_CACHE"),
    (cache_spec_output_out_of_range, "G_CACHE"),
    (cache_spec_wrong_capacity, "G_CACHE"),
    (cache_spec_bad_layout_and_dtype, "G_CACHE"),
    (cache_spec_pos_not_an_input, "G_CACHE"),
    (decode_step_state_rewired, "G_CACHE"),
    (bad_transpose_perm, "G_ATTRS"),
    (missing_clip_attr, "G_ATTRS"),
    (unknown_op, "G_OP"),
    (duplicate_input_names, "G_SSA"),
    (relu_changes_dtype, "G_DTYPE"),
    (mixed_dense_operand_dtypes, "G_DTYPE"),
    (const_value_disagrees, "G_DTYPE"),
    (append_update_wider_than_cache, "G_SHAPE"),
]


@pytest.mark.parametrize("build,code", GRAPH_CORPUS, ids=[b.__name__ for b, _ in GRAPH_CORPUS])
def test_graph_corpus_matches_the_reference(build, code):
    got = verify.verify_graph(*build(ir, repro_torch.REGISTRY))
    want = ref_verify.verify_graph(*build(ref_ir, repro.REGISTRY))
    assert _findings(got) == _findings(want)
    if code is None:
        assert got == []
    else:
        assert code in codes(got)
    if code == "G_CYCLE":
        assert codes(got) == {"G_CYCLE"}


def test_const_value_disagreeing_with_node_is_G_SHAPE_and_G_DTYPE():
    assert {"G_SHAPE", "G_DTYPE"} <= codes(verify.verify_graph(*const_value_disagrees(ir, None)))


# ---------------------------------------------------------------------------
# the plan corpus
# ---------------------------------------------------------------------------


def _plan(pkg, steps, *, n_slots=8, inputs=(("x", 1),), outputs=(1,)):
    if pkg == "ref":
        return RefPlan(n_slots=n_slots, input_slots=tuple(inputs), const_slots=(),
                       steps=tuple(RefStep(*s) for s in steps), output_slots=tuple(outputs))
    return ExecutionPlan(device=torch.device("cpu"), n_slots=n_slots, input_slots=tuple(inputs),
                         const_slots=(), steps=tuple(PlanStep(*s) for s in steps),
                         output_slots=tuple(outputs))


def _step(slot, args, name="s"):
    return (slot, lambda *a: a[0] if a else None, tuple(args), "relu", name, "host")


PLAN_CORPUS = {
    "read_before_write": (dict(steps=[_step(2, (5,))], outputs=(2,)), "P_UNWRITTEN"),
    "clobbered_slot": (dict(steps=[_step(2, (1,)), _step(2, (1,), "again")], outputs=(2,)), "P_CLOBBER"),
    "step_writes_an_input_slot": (dict(steps=[_step(1, (1,))], outputs=(1,)), "P_CLOBBER"),
    "undefined_output": (dict(steps=[_step(2, (1,))], outputs=(5,)), "P_OUTPUT"),
    "slot_outside_arena": (dict(steps=[_step(9, (1,))], n_slots=4, outputs=(1,)), "P_BOUNDS"),
    "input_outside_arena": (dict(steps=[], inputs=(("x", 7),), n_slots=4, outputs=()), "P_BOUNDS"),
    "legal": (dict(steps=[_step(2, (1,)), _step(3, (2, 1))], outputs=(3,)), None),
}


@pytest.mark.parametrize("case", PLAN_CORPUS)
def test_plan_corpus_matches_the_reference(case):
    kw, code = PLAN_CORPUS[case]
    got = verify.verify_plan(_plan("port", **kw))
    want = ref_verify.verify_plan(_plan("ref", **kw))
    assert _findings(got) == _findings(want)
    assert [d.where for d in got] == [d.where for d in want]
    assert (got == []) if code is None else (code in codes(got))


@pytest.mark.parametrize(
    "model,form", [("mlp_tiny", None), ("attn_decode", None), ("attn_decode", 4)],
    ids=["mlp_tiny", "attn_decode", "attn_decode_b4"],
)
def test_compiled_plans_are_clean_and_an_injected_race_is_P_RACE(model, form):
    # naive mode interleaves host epilogues with accel GEMMs, so the stage
    # assignment has real cross-lane watermarks to tamper with
    graph = (zoo.get_decode_model(model).build(batch=form) if model in zoo.DECODE_ZOO
             else zoo.get_model(model).build())
    plan = repro_torch.compile(graph, _target(mode="naive")).finalize()
    assert verify.verify_plan(plan) == []
    recorded = {k: list(v) for k, v in plan.recorded_lane_steps().items()}
    assert {k: [s[0] for s in v] for k, v in recorded.items()} == {
        k: [s.slot for s in plan.steps if s.lane == k] for k in ("host", "accel")
    }
    lane, idx = next((lane, i) for lane, steps in recorded.items()
                     for i, s in enumerate(steps) if s[3] > 0)
    slot, fn, args, need = recorded[lane][idx]
    recorded[lane][idx] = (slot, fn, args, need - 1)
    plan._lane_steps = {k: tuple(v) for k, v in recorded.items()}
    assert "P_RACE" in codes(verify.verify_plan(plan))
    # a lane that lost a step is desynchronized
    plan._lane_steps = {**plan._lane_steps, lane: plan._lane_steps[lane][:-1]}
    assert any("desynchronized" in d.message for d in verify.verify_plan(plan))


def test_recorded_lane_steps_have_the_reference_shape():
    port = repro_torch.compile(zoo.get_model("mlp_tiny").build(), _target(mode="naive")).finalize()
    ref = repro.compile(ref_zoo.get_model("mlp_tiny").build(),
                        repro.Target("gemmini", mode="naive", cache=False)).finalize()

    def shape(plan):
        return {k: [(s[0], tuple(s[2]), s[3]) for s in v] for k, v in plan.recorded_lane_steps().items()}

    assert shape(port) == shape(ref)


# ---------------------------------------------------------------------------
# the front door and the zero-diagnostic sweep
# ---------------------------------------------------------------------------


def test_collect_dispatches_and_verify_raises():
    g, y = _qdense(ir)
    assert repro_torch.verify(g) == []
    y.shape = (4, 12)
    with pytest.raises(repro_torch.VerifyError) as ei:
        repro_torch.verify(g)
    assert any(d.code == "G_SHAPE" for d in ei.value.diagnostics)
    assert "G_SHAPE" in str(ei.value) and "Graph 'qdense'" in str(ei.value)
    with pytest.raises(TypeError, match="repro_torch.verify"):
        verify.collect(42)


def test_sweep_is_clean_on_every_zoo_and_decode_module(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("REPRO_TORCH_CACHE_DIR", str(tmp_path))
    assert verify.main(["--sweep", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    # 4 zoo models x 2 descriptions x devices 1 and 4 (the default axis),
    # + the decode zoo's step at devices 1, every mode
    assert "verified 54 compile(s), 0 with diagnostics" in out
    assert "ok   attn_decode x edge_npu:naive@cpu" in out
    assert "ok   toycar_mlp x gemmini:optimized@cpu@4dev(data=1,model=4)" in out


@pytest.mark.parametrize("acc", ("gemmini", "edge_npu"))
def test_every_decode_form_and_batched_module_is_clean(acc):
    model = zoo.get_decode_model("attn_decode")
    for mode in MODES:
        for kw in (dict(), dict(batch=8), dict(seq=32)):
            module = repro_torch.compile(model.build(**kw), _target(acc, mode),
                                         options=repro_torch.CompileOptions(verify="each"))
            assert verify.collect(module) == [], (mode, kw)
    batched = repro_torch.compile("transformer_block", _target(acc, batch_size=4))
    assert verify.collect(batched) == []


def test_resolve_verify_modes(monkeypatch):
    for v, want in (("each", "each"), ("final", "final"), ("off", "off"), ("1", "each"), ("0", "off")):
        assert verify.resolve_verify(v) == want == ref_verify.resolve_verify(v)
    monkeypatch.delenv("REPRO_VERIFY", raising=False)
    assert verify.resolve_verify(None) == "off"
    monkeypatch.setenv("REPRO_VERIFY", "each")
    assert verify.resolve_verify(None) == "each"
    monkeypatch.setenv("REPRO_VERIFY", "1")
    assert verify.resolve_verify(None) == "each"
    with pytest.raises(ValueError, match="REPRO_VERIFY"):
        verify.resolve_verify("sometimes")
    with pytest.raises(ValueError):
        repro_torch.CompileOptions(verify="sometimes")


# ---------------------------------------------------------------------------
# the pass-invariant gate
# ---------------------------------------------------------------------------


def _breaker(graph, ctx):
    graph.outputs[0].dtype = "float32"  # relu must preserve int8
    return 1


def _fixer(graph, ctx):
    graph.outputs[0].dtype = "int8"
    return 1


def _relu_graph(name):
    return ir.Graph(outputs=[ir.relu(ir.input_((2, 4), "int8", name="x"))], name=name)


def test_pass_gate_attributes_the_offending_pass():
    pm = PassManager([GraphPass(name="benign", fn=lambda g, c: 0), GraphPass(name="breaker", fn=_breaker)],
                     verify="each")
    with pytest.raises(repro_torch.VerifyError) as ei:
        pm.run(_relu_graph("gated"), PassContext())
    assert "after pass 'breaker'" in str(ei.value) and "benign" not in str(ei.value)
    assert any(d.code == "G_DTYPE" for d in ei.value.diagnostics)
    # a broken input graph is the frontend's, not pass 0's
    broken = _relu_graph("broken_input")
    broken.outputs[0].dtype = "float32"
    with pytest.raises(repro_torch.VerifyError, match="before any pass ran"):
        PassManager([GraphPass(name="benign", fn=lambda g, c: 0)], verify="each").run(broken)


def test_pass_gate_final_mode_checks_once_at_the_end():
    pm = PassManager([GraphPass(name="b", fn=_breaker), GraphPass(name="f", fn=_fixer)], verify="final")
    pm.run(_relu_graph("finalgate"), PassContext())  # transiently broken is fine
    with pytest.raises(repro_torch.VerifyError, match="after the pass pipeline"):
        PassManager([GraphPass(name="b", fn=_breaker)], verify="final").run(_relu_graph("ends_broken"))


def test_pass_gate_off_by_default(monkeypatch):
    monkeypatch.delenv("REPRO_VERIFY", raising=False)
    PassManager([GraphPass(name="breaker", fn=_breaker)]).run(_relu_graph("ungated"), PassContext())
    monkeypatch.setenv("REPRO_VERIFY", "each")
    with pytest.raises(repro_torch.VerifyError):
        PassManager([GraphPass(name="breaker", fn=_breaker)]).run(_relu_graph("env"), PassContext())


def test_compile_options_verify_gates_a_compile():
    passes = [GraphPass(name="breaker", fn=_breaker)]
    for mode in ("each", "final"):
        with pytest.raises(repro_torch.VerifyError, match="breaker" if mode == "each" else "pipeline"):
            repro_torch.compile(_relu_graph(f"opt_{mode}"), _target(),
                                options=repro_torch.CompileOptions(verify=mode, passes=passes))
    repro_torch.compile(_relu_graph("opt_off"), _target(),
                        options=repro_torch.CompileOptions(verify="off", passes=passes))
    module = repro_torch.compile("mlp_tiny", _target(), options=repro_torch.CompileOptions(verify="each"))
    assert verify.collect(module) == []


# ---------------------------------------------------------------------------
# S_SCHEDULE: a selected schedule that violates the hardware
# ---------------------------------------------------------------------------


def test_corrupt_cached_schedule_fails_compile_with_S_SCHEDULE(tmp_path):
    target = _target(cache=True, cache_dir=tmp_path)
    fresh = repro_torch.CompileOptions(fresh_backend=True)
    module = repro_torch.compile("mlp_tiny", target, options=fresh)
    backend = module.backend
    node = next(n for n in module.graph.toposort() if n.target == "accel")
    key = backend._cache_key(workload_from_node(node), "proposed")
    cached = backend.schedule_cache.get(key)
    assert cached is not None
    cached.best.temporal[-1]["N"] *= 7  # the factors no longer cover the padded dim
    backend.schedule_cache.put(key, cached)
    backend.schedule_cache.flush()
    with pytest.raises(repro_torch.VerifyError) as ei:
        repro_torch.compile("mlp_tiny", target, options=fresh)
    assert {d.code for d in ei.value.diagnostics} == {"S_SCHEDULE"}
    assert "selected schedule for node" in str(ei.value)
    assert "factors product" in str(ei.value)


# ---------------------------------------------------------------------------
# artifacts are verified before execution
# ---------------------------------------------------------------------------


def _tamper_host_node_shape(path):
    """Grow one host node's shape and recompute the graph fingerprint, so
    every content check passes and only static verification can notice."""
    manifest = json.loads((path / "manifest.json").read_text())
    node = next(nd for nd in manifest["graph"]["nodes"]
                if nd["op"] in ("requantize", "clip", "bias_add", "quantize"))
    node["shape"] = [d + 1 for d in node["shape"]]
    tampered = graph_from_dict(manifest["graph"], _read_arrays(path, manifest))
    manifest["graph_fingerprint"] = graph_fingerprint(tampered)
    (path / "manifest.json").write_text(json.dumps(manifest))


@pytest.mark.parametrize("model", ["mlp_tiny", "attn_decode"])
def test_tampered_artifact_is_refused_by_the_verifier(tmp_path, model):
    module = repro_torch.compile(model, _target(mode="naive"))
    path = repro_torch.save(module, tmp_path / "art")
    assert verify.collect(repro_torch.load(path, device="cpu")) == []
    _tamper_host_node_shape(path)
    with pytest.raises(repro_torch.VerifyError) as ei:
        repro_torch.load(path, device="cpu")
    assert any(d.code == "G_SHAPE" for d in ei.value.diagnostics)
    # the reference refuses the same artifact the same way
    with pytest.raises(ref_verify.VerifyError) as ref_ei:
        repro.load(path)
    assert _findings(ei.value.diagnostics) == _findings(ref_ei.value.diagnostics)
    assert verify.main([str(path), "--device", "cpu"]) == 1


def test_artifact_store_treats_verify_failure_as_miss(tmp_path):
    opts = repro_torch.CompileOptions(artifact_dir=tmp_path, fresh_backend=True)
    repro_torch.compile("mlp_tiny", _target(mode="naive"), options=opts)
    entry = next(tmp_path.glob("*/*/manifest.json")).parent
    _tamper_host_node_shape(entry)
    with pytest.warns(RuntimeWarning, match="unusable compile artifact"):
        module = repro_torch.compile("mlp_tiny", _target(mode="naive"), options=opts)
    assert verify.collect(module) == []


def test_verify_cli_passes_a_clean_artifact(tmp_path, capsys):
    path = repro_torch.save(repro_torch.compile("attn_decode", _target()), tmp_path / "dec")
    assert verify.main([str(path), "--device", "cpu"]) == 0
    assert f"ok   {path}" in capsys.readouterr().out
