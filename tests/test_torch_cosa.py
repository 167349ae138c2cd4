"""The port's extended-CoSA scheduler held to the reference
(``tests/test_cosa.py`` and ``tests/test_scheduling_fixes.py``).

Prime factors and alignment padding, the heuristic always valid (a
derandomized hypothesis sweep, so every run draws the same shapes) and
equal to the reference's schedule, the paper's Eq. 1 instruction limit,
double buffering within the buffer, the scheduler's sweep and memo, the
YAML round trips, and the simulator's double-buffer lead with and without
buffered levels: each on both packages, the same schedules and the same
cycle reports.

The MIP case skips where ``pulp`` is absent, as the reference's MIP does
not solve there.  Left out, because ``tests/test_torch_schedule_cache.py``
already holds them: the scheduler's single-flight cold miss and the failed
leader's hand-off (``test_single_flight_cold_miss``,
``test_single_flight_leader_failure_hands_over``).
"""

import dataclasses
import importlib.util
import math

import pytest
from hypothesis import given, settings, strategies as st

from repro.core.arch_spec import ArchSpec as RefArchSpec
from repro.core.arch_spec import GemmWorkload as RefGemmWorkload
from repro.core.arch_spec import HardwareConstraints as RefConstraints
from repro.core.arch_spec import MemLevel as RefMemLevel
from repro.core.cosa.factors import pad_to_alignment as ref_pad, prime_factors as ref_primes
from repro.core.cosa.heuristic import solve_heuristic as ref_solve_heuristic
from repro.core.cosa.mip import solve_mip as ref_solve_mip
from repro.core.descriptions import make_edge_npu_description as ref_edge_npu
from repro.core.descriptions import make_gemmini_description as ref_gemmini
from repro.core.descriptions import make_tpu_v5e_description as ref_tpu
from repro.core.schedule import Schedule as RefSchedule
from repro.core.scheduler import ExtendedCosaScheduler as RefScheduler
from repro.core.simulator import simulate as ref_simulate
from repro_torch.core.arch_spec import GEMM_DIMS, ArchSpec, GemmWorkload, HardwareConstraints, MemLevel
from repro_torch.core.cosa.factors import pad_to_alignment, prime_factors
from repro_torch.core.cosa.heuristic import solve_heuristic
from repro_torch.core.cosa.mip import solve_mip
from repro_torch.core.descriptions import (
    make_edge_npu_description,
    make_gemmini_description,
    make_tpu_v5e_description,
)
from repro_torch.core.schedule import Schedule, validate_schedule
from repro_torch.core.scheduler import ExtendedCosaScheduler
from repro_torch.core.simulator import simulate

GEMMINI, REF_GEMMINI = make_gemmini_description().arch, ref_gemmini().arch
TPU, REF_TPU = make_tpu_v5e_description().arch, ref_tpu().arch
EDGE, REF_EDGE = make_edge_npu_description().arch, ref_edge_npu().arch
THIRDS = (1 / 3, 1 / 3, 1 / 3)


def _wl(n, c, k, ref=False, **kw):
    kw = {"in_bytes": 1, "w_bytes": 1, "out_bytes": 4, **kw}
    return (RefGemmWorkload if ref else GemmWorkload)(N=n, C=c, K=k, **kw)


def test_prime_factors():
    assert prime_factors(12) == (2, 2, 3)
    assert prime_factors(1) == ()
    assert prime_factors(97) == (97,)
    for n in (64, 27392, 102400, 524288, 1, 97, 12, 1000003):
        assert math.prod(prime_factors(n)) == n and prime_factors(n) == ref_primes(n)


def test_pad_to_alignment():
    assert pad_to_alignment(100, 16) % 16 == 0
    assert pad_to_alignment(100, 16) >= 100
    assert pad_to_alignment(128, 128) == 128
    for n in (1, 7, 100, 129, 1000, 4099):
        for a in (1, 8, 16, 32, 128):
            assert pad_to_alignment(n, a) == ref_pad(n, a)


@settings(max_examples=20, deadline=None, derandomize=True)
@given(n=st.integers(1, 2048), c=st.integers(1, 2048), k=st.integers(1, 2048))
def test_heuristic_schedule_always_valid_and_the_reference(n, c, k):
    """Every heuristic schedule satisfies every hardware constraint
    (coverage, Eq. 1, spatial levels, memory shares), and is the
    reference's schedule."""
    for df, ref_df in zip(GEMMINI.dataflows, REF_GEMMINI.dataflows, strict=True):
        s = solve_heuristic(_wl(n, c, k), GEMMINI, df, THIRDS, True)
        want = ref_solve_heuristic(_wl(n, c, k, ref=True), REF_GEMMINI, ref_df, THIRDS, True)
        assert (s is None) == (want is None)
        if s is not None:
            assert validate_schedule(s, GEMMINI) == []
            assert s.to_dict() == want.to_dict()


@pytest.mark.parametrize("dims", [(64, 64, 64), (256, 256, 256), (640, 128, 8)])
def test_mip_schedule_valid_and_competitive(dims):
    if importlib.util.find_spec("pulp") is None:
        pytest.skip("pulp is not installed: neither package's MIP solves here")
    wl = _wl(*dims)
    df = GEMMINI.dataflow("WS")
    mip = solve_mip(wl, GEMMINI, df, THIRDS, True)
    heur = solve_heuristic(wl, GEMMINI, df, THIRDS, True)
    assert mip is not None and validate_schedule(mip, GEMMINI) == [] and heur is not None
    assert simulate(mip, GEMMINI).total_cycles <= 2.0 * simulate(heur, GEMMINI).total_cycles
    want = ref_solve_mip(_wl(*dims, ref=True), REF_GEMMINI, REF_GEMMINI.dataflow("WS"), THIRDS, True)
    assert mip.to_dict() == want.to_dict()


@pytest.mark.parametrize("dims", [(512, 512, 512), (1, 4096, 8), (1000, 3, 77)])
def test_eq1_instruction_limit_enforced(dims):
    """Paper Eq. (1): PE-level factors never exceed DIM; the best schedule
    is the reference's."""
    sched = ExtendedCosaScheduler(GEMMINI).schedule(_wl(*dims)).best
    pe = sched.pe_tile()
    for j in GEMM_DIMS:
        assert pe[j] <= GEMMINI.pe_dim
    assert sched.to_dict() == RefScheduler(REF_GEMMINI).schedule(_wl(*dims, ref=True)).best.to_dict()


def test_double_buffer_fits_the_buffer_as_in_the_reference():
    """The double-buffered footprint (2x the tile) fits within the
    buffered level, and the schedule and its footprint are the
    reference's."""
    s_db = solve_heuristic(_wl(1024, 1024, 1024), GEMMINI, GEMMINI.dataflow("WS"), THIRDS, True)
    want = ref_solve_heuristic(_wl(1024, 1024, 1024, ref=True), REF_GEMMINI,
                               REF_GEMMINI.dataflow("WS"), THIRDS, True)
    lvl = GEMMINI.buffered_levels()[0]
    assert s_db.double_buffer
    assert s_db.level_footprint(lvl) <= GEMMINI.levels[lvl].size_bytes
    assert s_db.level_footprint(lvl) == want.level_footprint(lvl)
    single = solve_heuristic(_wl(1024, 1024, 1024), GEMMINI, GEMMINI.dataflow("WS"), THIRDS, False)
    assert not single.double_buffer and single.level_footprint(lvl) <= GEMMINI.levels[lvl].size_bytes


def test_scheduler_sweep_and_memo():
    sched = ExtendedCosaScheduler(TPU)
    wl = _wl(512, 512, 512, in_bytes=2, w_bytes=2)
    r1 = sched.schedule(wl)
    assert sched.schedule(wl) is r1  # memoized
    assert r1.n_candidates >= 4  # dataflows x shares x dbuf combos explored
    assert validate_schedule(r1.best, TPU) == []
    want = RefScheduler(REF_TPU).schedule(_wl(512, 512, 512, ref=True, in_bytes=2, w_bytes=2))
    assert r1.n_candidates == want.n_candidates and r1.best.to_dict() == want.best.to_dict()
    assert r1.report.total_cycles == want.report.total_cycles


@pytest.mark.parametrize("name", ["gemmini", "tpu_v5e", "edge_npu"])
def test_archspec_yaml_roundtrip(name):
    arch, ref = {"gemmini": (GEMMINI, REF_GEMMINI), "tpu_v5e": (TPU, REF_TPU), "edge_npu": (EDGE, REF_EDGE)}[name]
    text = arch.to_yaml()
    assert text == ref.to_yaml()
    back = ArchSpec.from_yaml(text)
    assert back.pe_dim == arch.pe_dim and back.num_levels == arch.num_levels
    assert [d.name for d in back.dataflows] == [d.name for d in arch.dataflows]
    assert back.to_yaml() == text
    assert RefArchSpec.from_yaml(text).to_yaml() == text  # the reference reads the port's


def test_schedule_yaml_output():
    s = ExtendedCosaScheduler(GEMMINI).schedule(_wl(128, 128, 128)).best
    d = s.to_dict()
    assert d["workload"]["N"] == 128 and len(d["levels"]) == GEMMINI.num_levels
    want = RefScheduler(REF_GEMMINI).schedule(_wl(128, 128, 128, ref=True)).best
    assert s.to_yaml() and s.to_yaml() == want.to_yaml()
    assert Schedule.from_dict(d) == s and RefSchedule.from_dict(d).to_dict() == d


# -- the simulator's double-buffer lead (tests/test_scheduling_fixes.py) -------------


def _bufferless_arch(ref=False):
    mem, cons, arch = (RefMemLevel, RefConstraints, RefArchSpec) if ref else (MemLevel, HardwareConstraints, ArchSpec)
    return arch(
        name="bufferless",
        levels=(mem("pe", size_bytes=0, holds=()), mem("dram", size_bytes=0, bytes_per_cycle=8.0)),
        constraints=cons(pe_dim=8),
    )


def _tiny_schedule(ref=False):
    ones = {"N": 1, "C": 1, "K": 1}
    return (RefSchedule if ref else Schedule)(
        workload=(RefGemmWorkload if ref else GemmWorkload)(N=8, C=8, K=8, name="tiny"),
        arch_name="bufferless",
        dataflow="WS",
        temporal=({"N": 8, "C": 8, "K": 8}, dict(ones)),
        spatial=(dict(ones), dict(ones)),
        memory_shares=THIRDS,
        double_buffer=True,
        loop_order=("K", "C", "N"),
    )


def _report(rep):
    return dataclasses.asdict(rep) if dataclasses.is_dataclass(rep) else vars(rep)


@pytest.mark.parametrize("double_buffer", [True, False])
def test_double_buffer_lead_skipped_without_buffered_levels(double_buffer):
    """With no buffered level the lead term charges no fill: the
    double-buffered core time is exactly max(busy, dma), the unbuffered one
    additive; the reports are the reference's."""
    sched = dataclasses.replace(_tiny_schedule(), double_buffer=double_buffer)
    rep = simulate(sched, _bufferless_arch())
    want = ref_simulate(dataclasses.replace(_tiny_schedule(ref=True), double_buffer=double_buffer),
                        _bufferless_arch(ref=True))
    assert _report(rep) == _report(want)
    busy = rep.compute_cycles + rep.overhead_cycles
    expect = max(busy, rep.dma_cycles) if double_buffer else busy + rep.dma_cycles
    assert rep.total_cycles == pytest.approx(expect)


def test_double_buffer_lead_still_charged_with_buffers():
    """On edge_npu's buffered hierarchy the lead fill is modeled: the
    double-buffered form of the scheduler's best schedule costs more than
    max(busy, dma), as in the reference (whose own test skips when the best
    schedule does not double-buffer; here it is made to)."""
    wl, ref_wl = GemmWorkload(N=64, C=64, K=64, name="lead"), RefGemmWorkload(N=64, C=64, K=64, name="lead")
    best = ExtendedCosaScheduler(EDGE, use_mip=False).schedule(wl).best
    ref_best = RefScheduler(REF_EDGE, use_mip=False).schedule(ref_wl).best
    assert best.to_dict() == ref_best.to_dict()
    s = dataclasses.replace(best, double_buffer=True)
    rep = simulate(s, EDGE)
    assert _report(rep) == _report(ref_simulate(dataclasses.replace(ref_best, double_buffer=True), REF_EDGE))
    busy = rep.compute_cycles + rep.overhead_cycles
    assert rep.total_cycles > max(busy, rep.dma_cycles)
