"""The scheduling loop of Fig. 2(b): sweep tuning parameters, solve the
extended-CoSA MIP per combination, evaluate candidates on the cycle model,
return the best schedule.

::

    for dataflow in accelerator.dataflows:
        for shares in constraints.memory_share_candidates:      # uneven map
            for dbuf in constraints.double_buffer_candidates:   # dbl buffer
                schedule = solve_extended_cosa(workload, dataflow, shares, dbuf)
                score    = cycle_model(schedule)                # "hardware"
    best = argmin(score)

Schedules are memoized per workload for the scheduler's lifetime, since a
model re-uses the same GEMM shapes across layers.

Port of ``repro.core.scheduler``: plain Python and numpy.  The
extended-CoSA MIP (``repro.core.cosa.mip``) is not ported yet, so every
candidate is solved by the greedy heuristic.  That is also what the
reference runs when ``pulp`` is not installed (its ``solve_mip`` returns
None there); where ``pulp`` is installed the reference would solve the
MIP, so ``use_mip=True`` is refused there instead of answered differently.
The reference's thread-pool sweep, single-flight cache and ranked
candidates for measured DSE come with their slices.
"""

from __future__ import annotations

import importlib.util
from dataclasses import dataclass, field
from itertools import product

from repro_torch.core.arch_spec import ArchSpec, Dataflow, GemmWorkload
from repro_torch.core.cosa.heuristic import solve_heuristic
from repro_torch.core.schedule import Schedule, validate_schedule
from repro_torch.core.simulator import SimReport, simulate


@dataclass(frozen=True)
class ScheduleResult:
    best: Schedule
    report: SimReport
    n_candidates: int
    n_infeasible: int


@dataclass
class ExtendedCosaScheduler:
    arch: ArchSpec
    #: the reference's switch: True asks for the MIP, which answers only
    #: where ``pulp`` is installed (see the module docstring)
    use_mip: bool = True
    _cache: dict = field(default_factory=dict)

    def __post_init__(self):
        if self.use_mip and importlib.util.find_spec("pulp") is not None:
            raise NotImplementedError(
                "use_mip=True: pulp is installed, so the reference would solve "
                "the extended-CoSA MIP, which is not ported yet; pass "
                "use_mip=False to schedule with the greedy heuristic"
            )

    def schedule(self, workload: GemmWorkload) -> ScheduleResult:
        key = workload.key()
        result = self._cache.get(key)
        if result is None:
            result = self._cache[key] = self._sweep(workload)
        return result

    def _candidates(self) -> list[tuple[Dataflow, tuple, bool]]:
        """The sweep's (dataflow, memory shares, double buffering) points,
        in the order ties break."""
        c = self.arch.constraints
        return list(
            product(
                self.arch.dataflows,
                c.memory_share_candidates,
                c.double_buffer_candidates,
            )
        )

    def _eval_candidate(
        self, workload: GemmWorkload, dataflow: Dataflow, shares: tuple, dbuf: bool
    ) -> tuple[Schedule, SimReport] | None:
        """One sweep point's schedule and cycle report, or None when it has
        no valid schedule."""
        sched = solve_heuristic(workload, self.arch, dataflow, shares, dbuf)
        if sched is None:
            return None
        if validate_schedule(sched, self.arch):
            return None
        return sched, simulate(sched, self.arch)

    def _sweep(self, workload: GemmWorkload) -> ScheduleResult:
        evaluated = [self._eval_candidate(workload, *c) for c in self._candidates()]
        feasible = [e for e in evaluated if e is not None]
        if not feasible:
            raise RuntimeError(
                f"no feasible schedule for {workload.name} "
                f"{workload.N}x{workload.C}x{workload.K} on {self.arch.name}"
            )
        # min() keeps the first of equal scores: ties break on candidate order
        best, best_report = min(feasible, key=lambda e: e[1].total_cycles)
        return ScheduleResult(
            best=best,
            report=best_report,
            n_candidates=len(feasible),
            n_infeasible=len(evaluated) - len(feasible),
        )
