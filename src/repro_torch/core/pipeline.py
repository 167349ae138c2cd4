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

Port of ``repro.core.pipeline``, without the schedule cache, measured DSE,
the verify gate and the deprecated two-step ``compile``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.core.baselines import c_toolchain_schedule, naive_schedule
from repro_torch.core.executor import CompiledModule, CompiledOp
from repro_torch.core.ir import Graph, Node
from repro_torch.core.lowering import make_accel_executor
from repro_torch.core.mapping import MappingGenerator
from repro_torch.core.pass_manager import PassContext, PassManager
from repro_torch.core.passes import passes_for_mode
from repro_torch.core.schedule import validate_schedule
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


@dataclass
class CompilerBackend:
    """The generated TVM-style backend (output of the configurators)."""

    desc: object  # AcceleratorDescription
    scheduler: ExtendedCosaScheduler
    strategy_gen: StrategyGenerator
    mapping_gen: MappingGenerator

    # -- stage 2: strategy / schedule selection -----------------------------
    def _schedule_for(self, node: Node, mode: str) -> ScheduleResult:
        """Select the schedule of one accelerator node and hold it to
        ``schedule.validate_schedule``: a schedule that violates a hardware
        constraint fails compilation instead of lowering to a kernel."""
        result = self._schedule(workload_from_node(node), mode)
        errors = validate_schedule(result.best, self.desc.arch)
        if errors:
            raise ScheduleError(
                f"selected schedule for node {node.name!r} on {self.desc.name!r}",
                list(errors),
            )
        return result

    def _schedule(self, wl, mode: str) -> ScheduleResult:
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
        """Lower one (node, strategy) to its executable kernel."""
        return make_accel_executor(self.desc, self.mapping_gen, node, strategy)

    # -- the compile entry point --------------------------------------------
    def compile_graph(
        self, graph: Graph, mode: str = "proposed", *, device: torch.device
    ) -> CompiledModule:
        """Compile a graph: run the mode's pass pipeline, schedule every
        accelerator node, lower executors, and build the execution plan on
        ``device``.

        ``mode`` accepts public (``optimized``/``baseline``/``naive``) or
        internal names.  Pass tracing and IR dumps are switched on with
        ``REPRO_PASS_TRACE`` / ``REPRO_PASS_DUMP`` (``pass_manager``).
        """
        mode = resolve_mode(mode)
        pm = PassManager(passes_for_mode(self.desc, mode))
        report = pm.run(graph, PassContext(desc=self.desc, mode=mode))
        module = CompiledModule(
            graph=graph,
            desc=self.desc,
            mode=mode,
            device=torch.device(device),
            pass_report=report,
            backend=self,
        )
        for n in graph.toposort():
            if n.target != "accel":
                continue
            strat = self.strategy_gen.generate(n, self._schedule_for(n, mode))
            module.ops[n] = CompiledOp(
                node=n, strategy=strat, executor=self.executor_for(n, strat)
            )
        # precompute the execution plan (topo order, slot indices, device
        # constants) once here, so every run() is a flat loop over steps.
        module.finalize()
        return module
