"""The port's scheduling core against the reference's.

For every GEMM workload of ``toycar_mlp`` and ``mlp_tiny`` at serving
batches 1 and 16, and every mode, the port must pick the same schedule,
model the same cycles and derive the same kernel config as the reference
does on ``Target("gemmini", mode, cache=False)`` (whose kernel configs are
taken as its interpret-mode ones, which keep the schedule's exact tiles).

Both packages run the greedy heuristic: the port has no MIP, and the
reference falls back to the heuristic without ``pulp``.  With ``pulp``
installed the reference would solve the MIP, so these tests skip there.
"""

import dataclasses
import importlib.util

import pytest

import repro
from repro.core import zoo as ref_zoo
from repro.core.arch_spec import GemmWorkload as RefWorkload
from repro.core.baselines import c_toolchain_schedule as ref_c_toolchain
from repro.core.baselines import naive_schedule as ref_naive
from repro.core.descriptions import make_gemmini_description as ref_gemmini
from repro.core.lowering import kernel_config_for as ref_kernel_config_for
from repro.core.scheduler import ExtendedCosaScheduler as RefScheduler
from repro.core.simulator import simulate as ref_simulate
from repro.core.strategy import workload_from_node as ref_workload
import repro_torch
from repro_torch.core import zoo
from repro_torch.core.arch_spec import GemmWorkload
from repro_torch.core.baselines import c_toolchain_schedule, naive_schedule
from repro_torch.core.descriptions import make_gemmini_description
from repro_torch.core.lowering import kernel_config_for
from repro_torch.core.scheduler import ExtendedCosaScheduler
from repro_torch.core.simulator import simulate

pytestmark = pytest.mark.skipif(
    importlib.util.find_spec("pulp") is not None,
    reason="pulp is installed: the reference solves the MIP, which the port has not ported",
)

MODELS = ("toycar_mlp", "mlp_tiny")
MODES = ("naive", "baseline", "optimized")
BATCHES = (1, 16)


def _ref_module(name, mode, batch):
    graph = ref_zoo.get_model(name).build(batch=batch)
    return repro.compile(graph, repro.Target("gemmini", mode=mode, cache=False))


def _port_module(name, mode, batch):
    graph = zoo.get_model(name).build(batch=batch)
    return repro_torch.compile(graph, repro_torch.Target("gemmini", mode=mode, device="cpu", cache=False))


def _workload_shapes():
    """(N, C, K) of every GEMM of the slice's models: each MLP layer folds
    the serving batch into N."""
    shapes = set()
    for layers in (zoo.TOYCAR_LAYERS, zoo.MLP_TINY_LAYERS):
        for batch in BATCHES:
            shapes.update((batch, c, k) for c, k in zip(layers, layers[1:]))
    return sorted(shapes)


WORKLOADS = [RefWorkload(N=n, C=c, K=k, name=f"gemm_{n}x{c}x{k}") for n, c, k in _workload_shapes()]


def test_workload_list_covers_the_reference_graphs():
    seen = set()
    for name in MODELS:
        for batch in BATCHES:
            for n in _ref_module(name, "optimized", batch).ops:
                wl = ref_workload(n)
                seen.add((wl.N, wl.C, wl.K, wl.in_bytes, wl.w_bytes, wl.out_bytes))
    assert seen == {(w.N, w.C, w.K, w.in_bytes, w.w_bytes, w.out_bytes) for w in WORKLOADS}


def _schedule_dicts(module):
    """The module's schedules in plan order, without the workload's node
    name (names carry each package's own process-global counter)."""
    out = []
    for d in module.schedules().values():
        out.append({**d, "workload": {k: v for k, v in d["workload"].items() if k != "name"}})
    return out


def _port_workload(wl: RefWorkload) -> GemmWorkload:
    return GemmWorkload(**dataclasses.asdict(wl))


@pytest.mark.parametrize("wl", WORKLOADS, ids=lambda w: f"{w.N}x{w.C}x{w.K}")
def test_extended_cosa_picks_the_reference_schedule(wl):
    ref_sched = RefScheduler(ref_gemmini().arch)
    port_sched = ExtendedCosaScheduler(make_gemmini_description().arch)
    ref, got = ref_sched.schedule(wl), port_sched.schedule(_port_workload(wl))
    assert got.best.to_dict() == ref.best.to_dict()
    assert got.report.total_cycles == ref.report.total_cycles
    assert (got.n_candidates, got.n_infeasible) == (ref.n_candidates, ref.n_infeasible)
    # every point of the sweep, not only the winner, agrees
    ref_points, port_points = ref_sched._candidates(), port_sched._candidates()
    assert len(port_points) == len(ref_points)
    for ref_c, port_c in zip(ref_points, port_points):
        want = ref_sched._eval_candidate(wl, *ref_c)
        have = port_sched._eval_candidate(_port_workload(wl), *port_c)
        assert (have is None) == (want is None)
        if want is not None:
            assert have[0].to_dict() == want[0].to_dict()
            assert dataclasses.asdict(have[1]) == dataclasses.asdict(want[1])


@pytest.mark.parametrize("wl", WORKLOADS, ids=lambda w: f"{w.N}x{w.C}x{w.K}")
def test_baseline_schedules_match_the_reference(wl):
    ref_arch, arch = ref_gemmini().arch, make_gemmini_description().arch
    pw = _port_workload(wl)
    for ref_fn, fn in ((ref_c_toolchain, c_toolchain_schedule), (ref_naive, naive_schedule)):
        ref_s, got_s = ref_fn(wl, ref_arch), fn(pw, arch)
        assert got_s.to_dict() == ref_s.to_dict()
        for kw in (
            {},
            {"fused_loop_instructions": False},
            {"folded_preprocessing": False, "host_epilogue": True},
        ):
            assert dataclasses.asdict(simulate(got_s, arch, **kw)) == dataclasses.asdict(
                ref_simulate(ref_s, ref_arch, **kw)
            )


@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", MODELS)
def test_compiled_schedules_cycles_and_kernel_configs(name, mode, batch):
    ref = _ref_module(name, mode, batch)
    got = _port_module(name, mode, batch)
    assert _schedule_dicts(got) == _schedule_dicts(ref)
    assert got.modeled_cycles() == ref.modeled_cycles()
    ref_cfgs = []
    for n, op in ref.ops.items():
        cfg = dataclasses.asdict(ref_kernel_config_for(ref.desc, ref.backend.mapping_gen, n, op.strategy))
        assert cfg.pop("interpret") is True  # no TPU here: the exact-tile config
        ref_cfgs.append(cfg)
    got_cfgs = [
        dataclasses.asdict(kernel_config_for(got.desc, got.backend.mapping_gen, n, op.strategy))
        for n, op in got.ops.items()
    ]
    assert got_cfgs == ref_cfgs
    assert [op.executor.kernel_config for op in got.ops.values()] == [
        kernel_config_for(got.desc, got.backend.mapping_gen, n, op.strategy)
        for n, op in got.ops.items()
    ]


def test_description_fingerprint_and_validation_match():
    assert make_gemmini_description().fingerprint() == ref_gemmini().fingerprint()
    assert repro_torch.validate_description(make_gemmini_description()) == []


def test_invalid_description_lists_every_problem():
    desc = make_gemmini_description()
    desc.core_computes.clear()
    desc.intrinsics = {k: v for k, v in desc.intrinsics.items() if v.kind != "memory"}
    with pytest.raises(repro_torch.IntegrationError) as e:
        repro_torch.build_integrated_backend(desc)
    assert len(e.value.problems) == 2
