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

Schedules are cached per (workload, arch) in-process because models re-use
the same GEMM shapes across layers; ``repro_torch.core.schedule_cache``
adds the cross-process persistent tier keyed by arch fingerprint + mode.

``parallel=True`` fans the per-candidate solve+simulate work out over a
thread pool for cold-cache compiles; the result is deterministic (ties
break on candidate order, identical to the serial sweep).

Port of ``repro.core.scheduler``: plain Python and numpy.  With
``use_mip=True`` each candidate is solved by the extended-CoSA MIP
(``repro_torch.core.cosa.mip``) where ``pulp`` is installed, and by the
greedy heuristic where it is not or where the MIP finds no schedule, as
in the reference.
"""

from __future__ import annotations

import importlib.util
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from itertools import product

from repro_torch.core.arch_spec import ArchSpec, Dataflow, GemmWorkload
from repro_torch.core.cosa.heuristic import solve_heuristic
from repro_torch.core.cosa.mip import solve_mip
from repro_torch.core.schedule import Schedule, validate_schedule
from repro_torch.core.simulator import SimReport, simulate

#: how many ranked candidates a DSE sweep retains alongside the winner —
#: enough for measured re-ranking (``CompileOptions.measure_top_k``)
#: without bloating the persistent cache.
MAX_TOP_CANDIDATES = 8


def mip_installable() -> bool:
    """Whether ``pulp`` is importable here, so that ``use_mip=True``
    solves the MIP."""
    return importlib.util.find_spec("pulp") is not None


@dataclass(frozen=True)
class ScheduleResult:
    best: Schedule
    report: SimReport
    n_candidates: int
    n_infeasible: int
    #: ranked (Schedule, SimReport) candidates by modeled cycles, best
    #: first (``top[0]`` is ``(best, report)`` on modeled results); empty
    #: on single-candidate baselines.
    top: tuple = ()
    #: wall-clock selection record when measured DSE re-ranked the top
    #: candidates (see ``CompilerBackend._measure_candidates``), else None.
    measured: dict | None = None

    def ranked(self) -> tuple:
        """Ranked candidates for measurement; never empty."""
        return self.top or ((self.best, self.report),)


@dataclass
class ExtendedCosaScheduler:
    arch: ArchSpec
    #: True asks for the MIP, which answers only where ``pulp`` is
    #: installed (see the module docstring)
    use_mip: bool = True
    mip_time_limit_s: float = 10.0
    parallel: bool = False
    max_workers: int | None = None
    # number of cold DSE sweeps performed (i.e. extended-CoSA invocations
    # that were not answered from a cache) — asserted on by cache tests.
    n_solver_calls: int = 0
    _cache: dict = field(default_factory=dict)
    _lock: threading.Lock = field(default_factory=threading.Lock)
    # single-flight bookkeeping: workload key -> Event set once the leading
    # thread has published (or abandoned) the result for that key.
    _inflight: dict = field(default_factory=dict)

    def solver_id(self) -> str:
        """Which solver actually produces schedules — 'mip' only when the
        MIP is both requested and installable.  Part of the persistent
        cache key (spelled as the reference spells it, so the two
        packages' entries share keys), so installing pulp (or flipping
        use_mip) invalidates schedules produced by the other solver."""
        if self.use_mip and mip_installable():
            return "mip"
        return "heuristic"

    def schedule(self, workload: GemmWorkload) -> ScheduleResult:
        """Cached scheduling with single-flight cold misses: when several
        threads miss on the same workload key concurrently, exactly one runs
        the DSE sweep; the others wait on it and return the published result
        (no duplicate sweeps, ``n_solver_calls`` counts each key once).  If
        the leader fails, one waiter takes over as the new leader."""
        key = workload.key()
        while True:
            with self._lock:
                if key in self._cache:
                    return self._cache[key]
                done = self._inflight.get(key)
                if done is None:
                    done = self._inflight[key] = threading.Event()
                    break  # this thread leads the cold miss
            done.wait()
        try:
            result = self._schedule_uncached(workload)
            with self._lock:
                self._cache[key] = result
            return result
        finally:
            with self._lock:
                self._inflight.pop(key, None)
                done.set()

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
        sched = None
        if self.use_mip:
            sched = solve_mip(
                workload, self.arch, dataflow, shares, dbuf, time_limit_s=self.mip_time_limit_s
            )
        if sched is None:
            sched = solve_heuristic(workload, self.arch, dataflow, shares, dbuf)
        if sched is None:
            return None
        if validate_schedule(sched, self.arch):
            return None
        return sched, simulate(sched, self.arch)

    def _schedule_uncached(self, workload: GemmWorkload) -> ScheduleResult:
        with self._lock:
            self.n_solver_calls += 1
        candidates = self._candidates()
        if self.parallel and len(candidates) > 1:
            with ThreadPoolExecutor(max_workers=self.max_workers) as pool:
                evaluated = list(
                    pool.map(lambda c: self._eval_candidate(workload, *c), candidates)
                )
        else:
            evaluated = [self._eval_candidate(workload, *c) for c in candidates]
        feasible = [e for e in evaluated if e is not None]
        if not feasible:
            raise RuntimeError(
                f"no feasible schedule for {workload.name} "
                f"{workload.N}x{workload.C}x{workload.K} on {self.arch.name}"
            )
        # stable sort: ties break on candidate order, as the serial sweep's
        # strict argmin (and the same with parallel=True)
        ranked = sorted(feasible, key=lambda e: e[1].total_cycles)
        best, best_report = ranked[0]
        return ScheduleResult(
            best=best,
            report=best_report,
            n_candidates=len(feasible),
            n_infeasible=len(evaluated) - len(feasible),
            top=tuple(ranked[:MAX_TOP_CANDIDATES]),
        )
