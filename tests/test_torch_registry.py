"""The port's integration registry and the end-to-end system, held to the
reference (``tests/test_registry.py`` and ``tests/test_system.py``).

Registration (duplicate, ``override``, ``exist_ok``), the validation
errors (the same problem lists, word for word), the output-stationary-only
accelerator, edge_npu in three modes on both routes, the cycle-model
ordering, integration by name and by description, and the backend on
gemmini and tpu_v5e: each on both packages, same inputs, bit-equal
outputs and equal modeled cycles.

Left out, because an existing port test already holds them to the
reference: the schedule cache's cases (round trip, warm compile with zero
sweeps, every mode cached, concurrent writers and the writer hammer,
clear, unwritable location, corrupt file) and parallel DSE are in
``tests/test_torch_schedule_cache.py`` (``test_result_round_trips_through_dict``,
``test_warm_compile_in_a_fresh_backend_does_zero_sweeps``,
``test_every_mode_is_cached``, ``test_concurrent_writers_merge``,
``test_concurrent_writer_hammer``, ``test_clear_empties_the_disk_tier``,
``test_unwritable_location_degrades_to_memory``,
``test_corrupt_file_is_an_empty_cache``, ``test_parallel_dse_matches_serial``);
the deprecated ``integrate`` / ``backend.compile`` pair is in
``tests/test_torch_legacy.py::test_integrate_and_backend_compile_warn_and_match``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import repro
from repro.core import build_backend as ref_build_backend
from repro.core import conv2d_as_gemm as ref_conv2d_as_gemm
from repro.core import ir as ref_ir
from repro.core.arch_spec import GemmWorkload as RefGemmWorkload
from repro.core.arch_spec import OUTPUT_STATIONARY as REF_OS
from repro.core.descriptions import make_edge_npu_description as ref_edge_npu
from repro.core.descriptions import make_gemmini_description as ref_gemmini
from repro.core.descriptions import make_tpu_v5e_description as ref_tpu_v5e
from repro.core.example_graphs import quantized_conv_dense_graph as ref_conv_dense_graph
from repro.core.registry import AcceleratorRegistry as RefRegistry
from repro.core.registry import IntegrationError as RefIntegrationError
from repro.core.schedule_cache import ScheduleCache as RefScheduleCache
import repro_torch
from repro_torch.core import build_backend, conv2d_as_gemm, ir
from repro_torch.core.arch_spec import OUTPUT_STATIONARY, GemmWorkload
from repro_torch.core.descriptions import (
    make_edge_npu_description,
    make_gemmini_description,
    make_tpu_v5e_description,
)
from repro_torch.core.example_graphs import quantized_conv_dense_graph
from repro_torch.core.registry import AcceleratorRegistry, IntegrationError
from repro_torch.core.schedule_cache import ScheduleCache
from repro_torch.kernels import gemm

X = np.random.default_rng(1).integers(-128, 128, (1, 10, 10, 8)).astype(np.int8)
REF = ref_ir.execute_graph(ref_conv_dense_graph(), {"x": X})[0]
MODES = ("proposed", "c_toolchain", "naive")
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _no_launches():
    gemm.reset_launches()
    yield
    assert sum(gemm.LAUNCHES.values()) == 0, "a CPU tensor launched the CUDA kernel"


def assert_bit_equal(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# -- the registry ---------------------------------------------------------------------


def test_builtin_descriptions_registered_as_in_the_reference():
    builtin = {"gemmini", "tpu_v5e", "edge_npu"}
    assert builtin <= set(repro_torch.REGISTRY.names())
    assert builtin <= set(repro.REGISTRY.names())
    assert "edge_npu" in repro_torch.REGISTRY


def test_unknown_name_lists_the_known_ones():
    with pytest.raises(KeyError, match="edge_npu") as got:
        repro_torch.REGISTRY.get("not_a_real_accelerator")
    with pytest.raises(KeyError) as want:
        repro.REGISTRY.get("not_a_real_accelerator")
    assert "unknown accelerator 'not_a_real_accelerator'; registered:" in str(got.value)
    assert "unknown accelerator 'not_a_real_accelerator'; registered:" in str(want.value)


@pytest.mark.parametrize("registry,edge,gem", [
    (RefRegistry, ref_edge_npu, ref_gemmini),
    (AcceleratorRegistry, make_edge_npu_description, make_gemmini_description),
], ids=["reference", "port"])
def test_duplicate_override_and_exist_ok(registry, edge, gem):
    reg = registry()
    reg.register("a", edge)
    with pytest.raises(ValueError, match="accelerator 'a' already registered"):
        reg.register("a", edge)
    reg.register("a", gem, override=True)
    assert reg.get("a").name == "gemmini"
    # the builtin registration path: an earlier (user) factory wins
    reg = registry()
    reg.register("a", edge)
    reg.register("a", gem, exist_ok=True)
    assert reg.get("a").name == "edge_npu"
    # as a decorator, and unregister
    reg.register("b")(gem)
    assert reg.names() == ["a", "b"] and "b" in reg
    reg.unregister("b")
    assert "b" not in reg


def _problems(build, desc, err_type):
    with pytest.raises(err_type) as e:
        build(desc)
    return e.value.problems, str(e.value)


def _both_problems(mutate):
    """The IntegrationError problems of the same broken description on both
    packages."""
    want = _problems(repro.build_integrated_backend, mutate(ref_edge_npu(), ref=True), RefIntegrationError)
    got = _problems(repro_torch.build_integrated_backend, mutate(make_edge_npu_description(), ref=False),
                    IntegrationError)
    return got, want


def test_undersized_buffer_is_refused_with_the_same_problems():
    def mutate(desc, ref):
        levels = list(desc.arch.levels)
        levels[1] = dataclasses.replace(levels[1], size_bytes=100)  # < 3 PE tiles
        desc.arch = dataclasses.replace(desc.arch, levels=tuple(levels))
        return desc

    got, want = _both_problems(mutate)
    assert got == want
    assert any("PE tile per buffered operand" in p for p in got[0])


def test_missing_intrinsics_are_refused_with_the_same_problems():
    def mutate(desc, ref):
        desc.intrinsics.clear()
        return desc

    got, want = _both_problems(mutate)
    assert got == want
    msgs = "\n".join(got[0])
    assert "no compute intrinsic" in msgs and "no memory intrinsics" in msgs


def test_missing_tile_limits_are_refused_with_the_same_problems():
    def mutate(desc, ref):
        for intr in desc.intrinsics.values():
            if intr.kind == "compute":
                intr.tile_limits = None
        return desc

    got, want = _both_problems(mutate)
    assert got == want and any("tile_limits" in p for p in got[0])


def test_description_validate_lists_equal_the_reference():
    for make_port, make_ref in ((make_gemmini_description, ref_gemmini),
                                (make_edge_npu_description, ref_edge_npu),
                                (make_tpu_v5e_description, ref_tpu_v5e)):
        port, ref = make_port(), make_ref()
        assert port.validate() == ref.validate() == []
        port.intrinsics.clear()
        ref.intrinsics.clear()
        assert port.validate() == ref.validate() and port.validate()


@pytest.mark.parametrize("use_pallas", [True, False], ids=["kernel", "emulated"])
def test_os_only_accelerator_works_in_proposed_mode(use_pallas):
    """An output-stationary-only description compiles in 'proposed' mode,
    bit-equal to the reference; the WS-based baseline modes fail at compile
    time with the reference's message."""
    ref_desc, desc = ref_edge_npu(), make_edge_npu_description()
    ref_desc.arch = dataclasses.replace(ref_desc.arch, dataflows=(REF_OS,))
    desc.arch = dataclasses.replace(desc.arch, dataflows=(OUTPUT_STATIONARY,))
    ref_backend = repro.build_integrated_backend(ref_desc, cache=False)
    backend = repro_torch.build_integrated_backend(desc, cache=False, use_pallas=use_pallas)
    want = ref_backend.compile_graph(ref_conv_dense_graph(), mode="proposed")
    got = backend.compile_graph(quantized_conv_dense_graph(), mode="proposed", device=CPU)
    assert_bit_equal(got.run({"x": X})[0], REF)
    assert got.modeled_cycles() == want.modeled_cycles()
    assert [s["dataflow"] for s in got.schedules().values()] == ["OS", "OS"]
    with pytest.raises(ValueError, match="no 'WS' dataflow") as e_port:
        backend.compile_graph(quantized_conv_dense_graph(), mode="c_toolchain", device=CPU)
    with pytest.raises(ValueError) as e_ref:
        ref_backend.compile_graph(ref_conv_dense_graph(), mode="c_toolchain")
    assert str(e_port.value) == str(e_ref.value)


# -- edge_npu end to end (the proof of abstraction) -------------------------------------


@pytest.mark.parametrize("use_pallas", [True, False], ids=["kernel", "emulated"])
@pytest.mark.parametrize("mode", MODES)
def test_edge_npu_three_modes_bit_exact(mode, use_pallas):
    want = repro.build_integrated_backend("edge_npu", cache=False).compile_graph(
        ref_conv_dense_graph(), mode=mode)
    backend = repro_torch.build_integrated_backend("edge_npu", cache=False, use_pallas=use_pallas)
    got = backend.compile_graph(quantized_conv_dense_graph(), mode=mode, device=CPU)
    assert_bit_equal(got.run({"x": X})[0], REF)
    assert_bit_equal(got.run({"x": X}, use_plan=False)[0], REF)
    assert got.modeled_cycles() == want.modeled_cycles() and got.modeled_cycles()["total"] > 0
    assert [n.op for n in got.graph.toposort()] == [n.op for n in want.graph.toposort()]


def test_edge_npu_cycle_model_ordering():
    backend = repro_torch.build_integrated_backend("edge_npu", cache=False)
    ref_backend = repro.build_integrated_backend("edge_npu", cache=False)
    cycles = {m: backend.compile_graph(quantized_conv_dense_graph(), mode=m, device=CPU).modeled_cycles()["total"]
              for m in MODES}
    want = {m: ref_backend.compile_graph(ref_conv_dense_graph(), mode=m).modeled_cycles()["total"]
            for m in MODES}
    assert cycles == want
    assert cycles["proposed"] <= 1.2 * cycles["c_toolchain"]
    assert cycles["naive"] > 3 * cycles["c_toolchain"]


def test_integrate_by_name_and_by_description_agree():
    by_name = repro_torch.build_integrated_backend("edge_npu", cache=False)
    by_desc = repro_torch.build_integrated_backend(make_edge_npu_description(), cache=False)
    assert by_name.desc.fingerprint() == by_desc.desc.fingerprint() == ref_edge_npu().fingerprint()
    m1 = by_name.compile_graph(quantized_conv_dense_graph(), mode="proposed", device=CPU)
    m2 = by_desc.compile_graph(quantized_conv_dense_graph(), mode="proposed", device=CPU)
    assert_bit_equal(m1.run({"x": X})[0], m2.run({"x": X})[0])


def test_cache_key_separates_modes_arch_and_solver(tmp_path):
    cache, ref_cache = ScheduleCache(tmp_path / "p"), RefScheduleCache(tmp_path / "r")
    wl, ref_wl = GemmWorkload(N=8, C=8, K=8), RefGemmWorkload(N=8, C=8, K=8)
    edge, gem = make_edge_npu_description(), make_gemmini_description()
    k_edge = cache.key_for(wl, edge, "proposed")
    assert k_edge != cache.key_for(wl, edge, "naive")
    assert k_edge != cache.key_for(wl, gem, "proposed")
    # the fingerprint is stable across fresh instantiations of one description
    assert k_edge == cache.key_for(wl, make_edge_npu_description(), "proposed")
    # MIP- and heuristic-produced schedules never shadow each other
    assert k_edge != cache.key_for(wl, edge, "proposed", solver="heuristic")
    assert k_edge == ref_cache.key_for(ref_wl, ref_edge_npu(), "proposed")
    assert cache.key_for(wl, edge, "proposed", solver="heuristic") == ref_cache.key_for(
        ref_wl, ref_edge_npu(), "proposed", solver="heuristic")


# -- the system: description -> backend -> compile -> execute (tests/test_system.py) -------


def _qdense_graph(ir_mod, seed=0):
    rng = np.random.default_rng(seed)
    x = ir_mod.input_((4, 96), "int8", name="x")
    w_fp = ir_mod.const(rng.normal(size=(80, 96)).astype(np.float32) * 0.02, name="w_fp")
    w_q = ir_mod.quantize(ir_mod.transpose(w_fp, (1, 0)), scale=0.02)
    b = ir_mod.const(rng.integers(-100, 100, size=(80,)).astype(np.int32), name="bias")
    out = ir_mod.clip(ir_mod.requantize(ir_mod.bias_add(ir_mod.dense(x, w_q), b), scale=0.25))
    return ir_mod.Graph([out], name="qdense")


XQ = np.random.default_rng(1).integers(-128, 128, size=(4, 96)).astype(np.int8)
REF_Q = ref_ir.execute_graph(_qdense_graph(ref_ir), {"x": XQ})[0]


@pytest.mark.parametrize("use_pallas", [True, False], ids=["kernel", "emulated"])
@pytest.mark.parametrize("acc", ["gemmini", "tpu_v5e"])
@pytest.mark.parametrize("mode", MODES)
def test_backend_modes_bit_exact(acc, mode, use_pallas):
    makers = {"gemmini": (ref_gemmini, make_gemmini_description),
              "tpu_v5e": (ref_tpu_v5e, make_tpu_v5e_description)}
    ref_make, make = makers[acc]
    want = ref_build_backend(ref_make()).compile_graph(_qdense_graph(ref_ir), mode=mode)
    got = build_backend(make(), use_pallas=use_pallas).compile_graph(_qdense_graph(ir), mode=mode, device=CPU)
    assert_bit_equal(got.run({"x": XQ})[0], REF_Q)
    assert got.modeled_cycles() == want.modeled_cycles()


def test_system_cycle_model_ordering():
    """The paper's headline: proposed ~= C toolchain << naive, the naive gap
    from host-side work; the same cycles as the reference."""
    backend, ref_backend = build_backend(make_gemmini_description()), ref_build_backend(ref_gemmini())
    cycles = {}
    for mode in MODES:
        c = backend.compile_graph(_qdense_graph(ir), mode=mode, device=CPU).modeled_cycles()
        assert c == ref_backend.compile_graph(_qdense_graph(ref_ir), mode=mode).modeled_cycles()
        cycles[mode] = c
    assert cycles["proposed"]["total"] <= 1.2 * cycles["c_toolchain"]["total"]
    assert cycles["naive"]["total"] > 3 * cycles["c_toolchain"]["total"]
    assert cycles["naive"]["host"] > 0.5 * cycles["naive"]["total"]


def test_scheduled_kernel_policy_routes_lm_gemms_through_the_scheduler():
    """Model GEMMs route through the generated backend's scheduler: the
    routed ``dense`` agrees with the unrouted one and the scheduler saw the
    workload (the reference's check, on the port's LM layer)."""
    from repro_torch.kernels.policy import scheduled_kernels
    from repro_torch.models import layers as L

    backend = build_backend(make_tpu_v5e_description())
    gen = torch.Generator().manual_seed(0)
    p = L.init_dense(gen, 256, 512)
    x = torch.randn((64, 256), generator=gen)
    base = L.dense(p, x)
    with scheduled_kernels(backend):
        routed = L.dense(p, x)
    torch.testing.assert_close(routed, base, rtol=1e-4, atol=1e-4)
    assert len(backend.scheduler._cache) >= 1


def test_conv2d_as_gemm_workload():
    wl = conv2d_as_gemm(1, 32, 32, 16, 64, 3, 3, stride=1)
    assert wl.N == 30 * 30 and wl.C == 9 * 16 and wl.K == 64
    want = ref_conv2d_as_gemm(1, 32, 32, 16, 64, 3, 3, stride=1)
    assert (wl.N, wl.C, wl.K, wl.in_bytes, wl.w_bytes, wl.out_bytes) == (
        want.N, want.C, want.K, want.in_bytes, want.w_bytes, want.out_bytes)


@pytest.mark.parametrize("use_pallas", [True, False], ids=["kernel", "emulated"])
def test_conv2d_end_to_end_quantized(use_pallas):
    """A quantized conv2d legalizes to one generalized op on the
    accelerator, scheduled as its im2col GEMM (paper §3.2), bit-equal to the
    reference in both scheduled modes."""
    rng = np.random.default_rng(0)
    w_v = rng.integers(-8, 8, (3, 3, 8, 16)).astype(np.int8)
    b_v = rng.integers(-50, 50, (16,)).astype(np.int32)
    xv = rng.integers(-128, 128, (2, 12, 12, 8)).astype(np.int8)

    def graph(m):
        x = m.input_((2, 12, 12, 8), "int8", name="x")
        out = m.clip(m.requantize(m.bias_add(m.conv2d(x, m.const(w_v, name="w"), stride=1),
                                             m.const(b_v, name="b")), scale=0.05))
        return m.Graph([out], name="qconv")

    ref = ref_ir.execute_graph(graph(ref_ir), {"x": xv})[0]
    backend = build_backend(make_gemmini_description(), use_pallas=use_pallas)
    ref_backend = ref_build_backend(ref_gemmini())
    for mode in ("proposed", "c_toolchain"):
        mod = backend.compile_graph(graph(ir), mode=mode, device=CPU)
        assert_bit_equal(mod.run({"x": xv})[0], ref)
        assert mod.modeled_cycles() == ref_backend.compile_graph(graph(ref_ir), mode=mode).modeled_cycles()
        gen = [n for n in mod.graph.toposort() if n.op == "generalized_conv2d"]
        assert gen and gen[0].target == "accel"
