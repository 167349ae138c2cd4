"""End-to-end compilation flow: staged passes -> strategies -> mapped
executables + cycle model (paper Fig. 1).

  1. **frontend lowering** — ``passes.passes_for_mode`` builds the
     per-mode pass list (legalization rule tables, target-contributed
     patterns, residual/pool fusion, constant folding, CSE/DCE,
     partitioning) and the ``PassManager`` runs it with per-pass
     instrumentation;
  2. **strategy & schedule selection** — ``CompilerBackend`` resolves an
     extended-CoSA (or baseline-heuristic) schedule per accelerator node;
  3. **backend lowering** — ``lowering.make_accel_executor`` turns each
     (node, strategy) into a launch of the scheduled GEMM kernel;
  4. **plan building** — the compiled graph lowers to a slot-indexed
     ``ExecutionPlan`` on the module's device (``executor``).

Three modes reproduce the paper's evaluation matrix (§4, Table 2):

  * ``proposed``    — full optimization pipeline + extended-CoSA
                      scheduling + fused loop issue.
  * ``c_toolchain`` — same frontend, but schedules come from the Gemmini
                      ``tiled_matmul_auto``-style heuristic (the manually
                      implemented C-function toolchain).
  * ``naive``       — stock BYOC/UMA: partitioning only (QNN epilogue ops
                      stay as host ops, weight transposition/quantization
                      run per inference), naive schedules, per-tile
                      instruction issue.

Port of ``repro.core.pipeline``, without the verify gate, the shard
pass and the deprecated two-step ``compile``.  A selected schedule that
violates a hardware constraint raises ``ScheduleError`` where the
reference raises its ``VerifyError``.  Measured DSE times the executor on
the module's device, and its cache entries name that device
(``schedule_cache.measured_selector``).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable

import torch

from repro_torch.core.baselines import c_toolchain_schedule, naive_schedule
from repro_torch.core.executor import CompiledModule, CompiledOp, to_tensor
from repro_torch.core.ir import Graph, Node
from repro_torch.core.lowering import make_accel_executor
from repro_torch.core.mapping import MappingGenerator
from repro_torch.core.pass_manager import PassContext, PassManager
from repro_torch.core.passes import passes_for_mode
from repro_torch.core.schedule import validate_schedule
from repro_torch.core.schedule_cache import ScheduleCache, measured_selector
from repro_torch.core.scheduler import ExtendedCosaScheduler, ScheduleResult
from repro_torch.core.simulator import simulate
from repro_torch.core.strategy import StrategyGenerator, workload_from_node

MODES = ("proposed", "c_toolchain", "naive")

#: the user-facing mode names of the ``Target`` API (paper §4 matrix);
#: each maps onto one of the internal ``MODES``.
PUBLIC_MODES = ("naive", "baseline", "optimized")

_MODE_ALIASES = {
    "optimized": "proposed",
    "baseline": "c_toolchain",
    "naive": "naive",
    # internal names remain accepted everywhere
    "proposed": "proposed",
    "c_toolchain": "c_toolchain",
}


def resolve_mode(mode: str) -> str:
    """Canonicalize a public or internal mode name to the internal one."""
    try:
        return _MODE_ALIASES[mode]
    except (KeyError, TypeError):
        raise ValueError(
            f"unknown mode {mode!r}; expected one of {PUBLIC_MODES} "
            f"(or internal {MODES})"
        ) from None


class ScheduleError(ValueError):
    """A selected schedule violates a hardware constraint; ``.problems``
    lists every violation."""

    def __init__(self, subject: str, problems: list[str]):
        self.problems = problems
        bullet = "\n  - ".join(problems)
        super().__init__(f"{subject}:\n  - {bullet}")


def device_tag(device: torch.device) -> str:
    """The device a measurement ran on, as measured cache keys name it:
    ``cpu`` or ``cuda:<card name>``."""
    device = torch.device(device)
    if device.type == "cuda":
        return f"cuda:{torch.cuda.get_device_name(device)}"
    return device.type


@dataclass
class CompilerBackend:
    """The generated TVM-style backend (output of the configurators)."""

    desc: object  # AcceleratorDescription
    scheduler: ExtendedCosaScheduler
    strategy_gen: StrategyGenerator
    mapping_gen: MappingGenerator
    #: persistent cross-process schedule store keyed by (workload, arch
    #: fingerprint, mode), attached by ``build_integrated_backend``
    schedule_cache: ScheduleCache | None = None
    # wall-clock candidate timings performed by measured DSE — warm boots
    # with ``measure_top_k`` set must keep this at zero (cache tests).
    n_measurements: int = 0
    # the description (and the scheduler's solver) are frozen once the
    # backend is generated, so hash/probe them at most once per backend.
    _desc_fingerprint: str | None = None
    _solver_id: str | None = None

    # -- stage 2: strategy / schedule selection -----------------------------
    def _cache_key(self, wl, mode: str, selector: str = "modeled") -> str:
        if self._desc_fingerprint is None:
            self._desc_fingerprint = self.desc.fingerprint()
        if self._solver_id is None:
            self._solver_id = self.scheduler.solver_id()
        return ScheduleCache.key_for(
            wl, self._desc_fingerprint, mode, solver=self._solver_id, selector=selector
        )

    def _schedule_for(
        self,
        node: Node,
        mode: str,
        measure_top_k: int | None = None,
        device: torch.device | None = None,
    ) -> ScheduleResult:
        """The schedule of one accelerator node: the cycle model's argmin,
        or with ``measure_top_k`` the wall-clock winner of its K best
        candidates timed on ``device``."""
        wl = workload_from_node(node)
        if measure_top_k is None:
            return self._checked_schedule(node, self._modeled_schedule_for(wl, mode))
        if device is None:
            raise ValueError("measured DSE needs the device to time candidates on")
        mkey = None
        if self.schedule_cache is not None:
            mkey = self._cache_key(
                wl, mode, selector=measured_selector(measure_top_k, device_tag(device))
            )
            cached = self.schedule_cache.get(mkey)
            if cached is not None:
                return self._checked_schedule(node, cached)
        # the modeled ranking feeds the measurement and is cached under its
        # own key, so a later compile without measure_top_k is warm too
        modeled = self._modeled_schedule_for(wl, mode)
        result = self._measure_candidates(node, modeled, measure_top_k, device)
        if mkey is not None:
            self.schedule_cache.put(mkey, result)
        return self._checked_schedule(node, result)

    def _checked_schedule(self, node: Node, result: ScheduleResult) -> ScheduleResult:
        """Hold every selected schedule — modeled winners, measured-DSE
        winners and cache hits alike — to ``schedule.validate_schedule``: a
        schedule that violates a hardware constraint (e.g. a corrupt or
        stale cache entry for a since-shrunk scratchpad) fails compilation
        instead of lowering to a kernel."""
        errors = validate_schedule(result.best, self.desc.arch)
        if errors:
            raise ScheduleError(
                f"selected schedule for node {node.name!r} on {self.desc.name!r}",
                list(errors),
            )
        return result

    def _modeled_schedule_for(self, wl, mode: str) -> ScheduleResult:
        key = None
        if self.schedule_cache is not None:
            key = self._cache_key(wl, mode)
            cached = self.schedule_cache.get(key)
            if cached is not None:
                return cached
        result = self._schedule_uncached(wl, mode)
        if key is not None:
            self.schedule_cache.put(key, result)
        return result

    def _measure_candidates(
        self, node: Node, modeled: ScheduleResult, k: int, device: torch.device
    ) -> ScheduleResult:
        """Re-rank the top-``k`` modeled candidates by measured latency of
        the lowered executor on ``device``; the wall-clock winner becomes
        ``best`` and the raw timings ride along in ``measured`` (persisted
        with the schedule, so warm boots skip both the sweep and the
        stopwatch)."""
        from repro_torch.core.measure import synthetic_args, time_executor

        cands = modeled.ranked()[:k]
        args = [None if a is None else to_tensor(a, device) for a in synthetic_args(node)]
        latencies = []
        for sched, rep in cands:
            sr = ScheduleResult(
                best=sched,
                report=rep,
                n_candidates=modeled.n_candidates,
                n_infeasible=modeled.n_infeasible,
            )
            strat = self.strategy_gen.generate(node, sr)
            latencies.append(time_executor(self.executor_for(node, strat), args))
            self.n_measurements += 1
        winner = min(range(len(latencies)), key=latencies.__getitem__)
        best, report = cands[winner]
        return ScheduleResult(
            best=best,
            report=report,
            n_candidates=modeled.n_candidates,
            n_infeasible=modeled.n_infeasible,
            top=modeled.top,
            measured={
                "k": len(cands),
                "winner": winner,
                "latencies_s": latencies,
                "modeled_cycles": [r.total_cycles for _, r in cands],
            },
        )

    def _schedule_uncached(self, wl, mode: str) -> ScheduleResult:
        if mode == "proposed":
            return self.scheduler.schedule(wl)
        if not any(df.name == "WS" for df in self.desc.arch.dataflows):
            raise ValueError(
                f"mode {mode!r} schedules the weight-stationary baseline, but "
                f"{self.desc.name!r} declares no 'WS' dataflow; use "
                f"mode='proposed' or add WEIGHT_STATIONARY to arch.dataflows"
            )
        if mode == "c_toolchain":
            sched = c_toolchain_schedule(wl, self.desc.arch)
        elif mode == "naive":
            sched = naive_schedule(wl, self.desc.arch)
        else:
            raise ValueError(f"unknown mode {mode!r}")
        rep = simulate(sched, self.desc.arch)
        return ScheduleResult(best=sched, report=rep, n_candidates=1, n_infeasible=0)

    # -- stage 3: backend lowering ------------------------------------------
    def executor_for(self, node: Node, strategy) -> Callable:
        """Lower one (node, strategy) to its executable kernel — the single
        spelling used by compile, measured DSE, and artifact restore (which
        rebuilds executors from persisted schedules with zero DSE)."""
        return make_accel_executor(self.desc, self.mapping_gen, node, strategy)

    # -- the compile entry point --------------------------------------------
    def compile_graph(
        self,
        graph: Graph,
        mode: str = "proposed",
        *,
        device: torch.device,
        passes: list | None = None,
        pass_context: PassContext | None = None,
        measure_top_k: int | None = None,
    ) -> CompiledModule:
        """Compile a graph: run the mode's pass pipeline, schedule every
        accelerator node, lower executors, and build the execution plan on
        ``device``.

        ``mode`` accepts public (``optimized``/``baseline``/``naive``) or
        internal names.  ``passes`` overrides the per-mode pipeline with an
        explicit pass list (testing / experimentation); ``pass_context``
        overrides the trace/dump instrumentation context (pass tracing and
        IR dumps also switch on with ``REPRO_PASS_TRACE`` /
        ``REPRO_PASS_DUMP``).  ``measure_top_k`` enables measured DSE: the
        K best modeled candidates per node are timed on the lowered
        executor on ``device`` and the wall-clock winner is selected
        (cached under a ``measured_selector`` key).
        """
        mode = resolve_mode(mode)
        device = torch.device(device)
        pm = PassManager(passes_for_mode(self.desc, mode) if passes is None else passes)
        # never mutate a caller-supplied context: it may be shared across
        # backends or concurrent compiles
        ctx = replace(pass_context or PassContext(), desc=self.desc, mode=mode)
        report = pm.run(graph, ctx)
        module = CompiledModule(
            graph=graph,
            desc=self.desc,
            mode=mode,
            device=device,
            pass_report=report,
            backend=self,
        )
        for n in graph.toposort():
            if n.target != "accel":
                continue
            sr = self._schedule_for(n, mode, measure_top_k, device)
            strat = self.strategy_gen.generate(n, sr)
            module.ops[n] = CompiledOp(
                node=n, strategy=strat, executor=self.executor_for(n, strat)
            )
        if self.schedule_cache is not None:
            self.schedule_cache.flush()
        # precompute the execution plan (topo order, slot indices, device
        # constants) once here, so every run() is a flat loop over steps.
        module.finalize()
        return module
