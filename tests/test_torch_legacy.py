"""The port's legacy integration surface and the extended-CoSA MIP, held to
the reference on the CPU.

The deprecated two-step flow (``integrate`` + ``backend.compile``), the
functional pass wrappers, the configurators, ``Target.with_mode``, the
demo graph, the packages' exports and the MIP solver behave as the
reference's do.
"""

import warnings

import numpy as np
import pytest

import repro
import repro.core as ref_core
from repro.core import passes as ref_passes
from repro.core.arch_spec import GemmWorkload as RefWorkload
from repro.core.configurators import BackendConfigurator as RefBackendConfigurator
from repro.core.configurators import FrontendConfigurator as RefFrontendConfigurator
from repro.core.cosa.mip import CosaMIP as RefCosaMIP
from repro.core.deprecation import ReproDeprecationWarning as RefDeprecation
from repro.core.descriptions import make_gemmini_description as ref_gemmini
from repro.core.example_graphs import quantized_conv_dense_graph as ref_qconv_dense
from repro.core.scheduler import ExtendedCosaScheduler as RefScheduler
from repro.core.zoo import get_model as ref_get_model
import repro_torch
import repro_torch.core as core
from repro_torch.core import passes
from repro_torch.core.arch_spec import GemmWorkload
from repro_torch.core.configurators import BackendConfigurator, FrontendConfigurator
from repro_torch.core.cosa.mip import CosaMIP
from repro_torch.core.deprecation import ReproDeprecationWarning
from repro_torch.core.descriptions import make_gemmini_description
from repro_torch.core.example_graphs import quantized_conv_dense_graph
from repro_torch.core.scheduler import ExtendedCosaScheduler
from repro_torch.core.zoo import get_model

#: the port's names for the reference's exports it renames (recorded in
#: ROADMAP.md): the traced frontend's error is torch.export's
RENAMED = {"UnsupportedJaxprError": "UnsupportedExportError"}


def graph_summary(graph):
    """Everything a compile reads from a graph, in topological order, without
    the process-global node names."""
    order = graph.toposort()
    index = {n: i for i, n in enumerate(order)}
    return [
        (n.op, tuple(n.shape), n.dtype, n.target, sorted((k, repr(v)) for k, v in n.attrs.items()),
         [None if i is None else index[i] for i in n.inputs],
         None if n.value is None else np.asarray(n.value).tobytes())
        for n in order
    ]


def assert_bit_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def deprecations(fn, category):
    """``fn()``'s result and how many ``category`` warnings it raised."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = fn()
    return out, sum(issubclass(w.category, category) for w in caught)


def test_example_graph_matches_the_reference():
    for seed in (0, 3):
        assert graph_summary(quantized_conv_dense_graph(seed)) == graph_summary(ref_qconv_dense(seed))


@pytest.mark.parametrize("use_pallas", [False, True])
def test_integrate_and_backend_compile_warn_and_match(use_pallas):
    backend, n = deprecations(
        lambda: repro_torch.integrate("gemmini", use_pallas=use_pallas, cache=False), ReproDeprecationWarning
    )
    assert n == 1 and backend.use_pallas is use_pallas
    with pytest.warns(ReproDeprecationWarning, match=r"CompilerBackend\.compile\(\) is deprecated"):
        module = backend.compile(quantized_conv_dense_graph(), device="cpu")
    with pytest.warns(RefDeprecation, match=r"repro\.integrate\(\) is deprecated"):
        ref_backend = repro.integrate("gemmini", cache=False)
    with pytest.warns(RefDeprecation, match=r"CompilerBackend\.compile\(\) is deprecated"):
        ref_module = ref_backend.compile(ref_qconv_dense())
    front = repro_torch.compile(
        quantized_conv_dense_graph(),
        repro_torch.Target("gemmini", device="cpu", cache=False, use_pallas=use_pallas),
    )
    x = np.random.default_rng(1).integers(-128, 128, (1, 10, 10, 8)).astype(np.int8)
    want = ref_module.run({"x": x})
    assert_bit_equal(module.run({"x": x}), want)
    assert_bit_equal(front.run({"x": x}), want)
    assert module.modeled_cycles() == front.modeled_cycles() == ref_module.modeled_cycles()
    assert graph_summary(module.graph) == graph_summary(ref_module.graph)


def test_functional_pass_wrappers_match_and_do_not_warn():
    desc, ref_desc = make_gemmini_description(), ref_gemmini()
    wrappers = [
        (lambda g: passes.legalize(g), lambda g: ref_passes.legalize(g)),
        (lambda g: passes.fold_constants(g), lambda g: ref_passes.fold_constants(g)),
        (lambda g: passes.partition(g, desc), lambda g: ref_passes.partition(g, ref_desc)),
        (lambda g: passes.run_frontend(g, desc), lambda g: ref_passes.run_frontend(g, ref_desc)),
        (lambda g: passes.run_frontend(g, desc, fold=False, do_legalize=False),
         lambda g: ref_passes.run_frontend(g, ref_desc, fold=False, do_legalize=False)),
    ]
    for name in ("qcnn", "transformer_block"):
        for port_fn, ref_fn in wrappers:
            got, n = deprecations(lambda: port_fn(get_model(name).build()), ReproDeprecationWarning)
            want, ref_n = deprecations(lambda: ref_fn(ref_get_model(name).build()), RefDeprecation)
            assert n == ref_n == 0
            assert graph_summary(got) == graph_summary(want)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_configurators_match_the_reference(use_pallas):
    graph = FrontendConfigurator(make_gemmini_description()).configure(get_model("qcnn").build())
    ref_graph = RefFrontendConfigurator(ref_gemmini()).configure(ref_get_model("qcnn").build())
    assert graph_summary(graph) == graph_summary(ref_graph)
    unlegalized = FrontendConfigurator(make_gemmini_description()).configure(
        get_model("qcnn").build(), fold=False, legalize=False
    )
    ref_unlegalized = RefFrontendConfigurator(ref_gemmini()).configure(
        ref_get_model("qcnn").build(), fold=False, legalize=False
    )
    assert graph_summary(unlegalized) == graph_summary(ref_unlegalized)

    backend = BackendConfigurator(make_gemmini_description()).configure(use_pallas=use_pallas)
    ref_backend = RefBackendConfigurator(ref_gemmini()).configure()
    assert backend.use_pallas is use_pallas
    module = backend.compile_graph(get_model("qcnn").build(), "proposed", device="cpu")
    ref_module = ref_backend.compile_graph(ref_get_model("qcnn").build(), "proposed")
    feeds = ref_get_model("qcnn").feeds(4)
    assert_bit_equal(module.run(feeds), ref_module.run(feeds))
    assert module.modeled_cycles() == ref_module.modeled_cycles()
    bad = make_gemmini_description()
    bad.intrinsics.clear()
    with pytest.raises(ValueError, match="invalid accelerator description"):
        BackendConfigurator(bad).configure()


def test_target_with_mode_and_route():
    t = repro_torch.Target("edge_npu", device="cpu", use_pallas=False, cache=False)
    naive = t.with_mode("naive")
    assert naive.mode == "naive" and naive.use_pallas is False and naive.device == "cpu"
    assert t.mode == "optimized"
    ref = repro.Target("edge_npu").with_mode("naive")
    assert (naive.mode, naive.accelerator) == (ref.mode, ref.accelerator)
    assert naive.describe() == "edge_npu:naive@cpu/emulated"
    assert repro_torch.Target("edge_npu", device="cpu").describe() == "edge_npu:optimized@cpu"
    assert repro_torch.Target("edge_npu").use_pallas is True
    parsed = repro_torch.Target.parse("gemmini:baseline", device="cpu", use_pallas=False)
    assert parsed == repro_torch.Target("gemmini", mode="baseline", device="cpu", use_pallas=False)
    emulated = repro_torch.backend_for(parsed)
    kernel = repro_torch.backend_for(repro_torch.Target("gemmini", mode="baseline", device="cpu"))
    assert emulated is not kernel and not emulated.use_pallas and kernel.use_pallas
    assert repro_torch.backend_for(parsed.with_mode("naive")) is emulated


def test_exports_match_the_reference():
    assert sorted(core.__all__) == sorted(ref_core.__all__)
    for name in core.__all__:
        assert getattr(core, name) is not None
    want = {RENAMED.get(n, n) for n in repro.__all__}
    assert want <= set(repro_torch.__all__)
    # what the port adds: its module type, the decode zoo's helpers
    assert set(repro_torch.__all__) - want == {
        "CompiledModule", "DECODE_ZOO", "decode_model_names", "get_decode_model",
    }
    for name in ("integrate", "ReproDeprecationWarning", "conv2d_as_gemm"):
        assert getattr(repro_torch, name) is getattr(core, name)


def _workloads():
    return [(16, 16, 16), (100, 72, 16), (1, 640, 128), (64, 24, 8)]


def test_schedulers_agree_on_the_solver_and_its_schedules():
    """Where pulp is absent both packages report the heuristic and give
    the same schedules; where it is present, both ask the MIP."""
    for use_mip in (True, False):
        port = ExtendedCosaScheduler(make_gemmini_description().arch, use_mip=use_mip)
        ref = RefScheduler(ref_gemmini().arch, use_mip=use_mip)
        assert port.solver_id() == ref.solver_id()
        for n, c, k in _workloads():
            got = port.schedule(GemmWorkload(N=n, C=c, K=k, name="g")).best
            want = ref.schedule(RefWorkload(N=n, C=c, K=k, name="g")).best
            assert got.to_dict() == want.to_dict()


def test_mip_without_pulp_returns_none_as_the_reference():
    try:
        import pulp  # noqa: F401
    except ImportError:
        pass
    else:
        pytest.skip("pulp is installed: the MIP's schedules are compared instead")
    arch, ref_arch = make_gemmini_description().arch, ref_gemmini().arch
    for df, ref_df in zip(arch.dataflows, ref_arch.dataflows):
        got = CosaMIP(GemmWorkload(N=16, C=16, K=16, name="g"), arch, df, (1 / 3,) * 3, False)
        want = RefCosaMIP(RefWorkload(N=16, C=16, K=16, name="g"), ref_arch, ref_df, (1 / 3,) * 3, False)
        assert got.padded_dims == want.padded_dims and got.factors == want.factors
        assert got.solve() is None and want.solve() is None


def test_mip_schedules_match_the_reference():
    pytest.importorskip("pulp")
    arch, ref_arch = make_gemmini_description().arch, ref_gemmini().arch
    for n, c, k in _workloads():
        for df, ref_df in zip(arch.dataflows, ref_arch.dataflows):
            for shares in arch.constraints.memory_share_candidates:
                got = CosaMIP(GemmWorkload(N=n, C=c, K=k, name="g"), arch, df, shares, False).solve()
                want = RefCosaMIP(RefWorkload(N=n, C=c, K=k, name="g"), ref_arch, ref_df, shares, False).solve()
                assert (got is None) == (want is None)
                if got is not None:
                    assert got.to_dict() == want.to_dict()
