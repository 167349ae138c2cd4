"""Staged pass manager: named, instrumented compiler passes (paper §3.3).

Lowering is a sequence of graph passes; the ``PassManager`` runs them in
order and records, per pass, the number of rewrites applied, the wall
time, and the node count before/after.  Per-mode pipelines are pass-*list*
configurations (see ``passes.frontend_passes``), not if-branches inside a
monolithic pipeline.

Debugging hooks (also settable via environment variables, so a failing
compile can be traced without touching code):

  * ``REPRO_PASS_TRACE=1``   — print a one-line summary per pass to stderr;
  * ``REPRO_PASS_DUMP=DIR``  — write the graph summary before and after
    every pass to ``DIR/<graph>_<NN>_<pass>_{before,after}.txt``.

The resulting ``PipelineReport`` is attached to every ``CompiledModule``
(``module.pass_report``), so "what did the optimizer actually do" is
always one attribute away.

Port of ``repro.core.pass_manager``: plain Python, with the reference's
static-verification gate (``PassManager(verify=...)``, env
``REPRO_VERIFY``; see ``repro_torch.core.verify``).
"""

from __future__ import annotations

import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable

from repro_torch.core.ir import Graph
from repro_torch.core.rewrite import RewriteRule, apply_rules

TRACE_ENV = "REPRO_PASS_TRACE"
DUMP_ENV = "REPRO_PASS_DUMP"


@dataclass
class PassContext:
    """Per-run state threaded through every pass."""

    desc: Any = None  # AcceleratorDescription (partitioning needs it)
    mode: str | None = None
    trace: bool | None = None  # None -> read REPRO_PASS_TRACE
    dump_dir: str | Path | None = None  # None -> read REPRO_PASS_DUMP

    def resolved_trace(self) -> bool:
        if self.trace is not None:
            return self.trace
        return os.environ.get(TRACE_ENV, "") not in ("", "0")

    def resolved_dump_dir(self) -> Path | None:
        d = self.dump_dir if self.dump_dir is not None else os.environ.get(DUMP_ENV)
        return Path(d) if d else None


@dataclass
class GraphPass:
    """One named unit of rewriting.  ``fn(graph, ctx)`` mutates the graph
    in place and returns the number of changes it applied (``None`` counts
    as 0 — e.g. an analysis/marking pass like partitioning)."""

    name: str
    fn: Callable[[Graph, PassContext], int | None]
    description: str = ""
    #: rule-level fire counts for rewrite passes, populated per run
    detail: dict[str, int] = field(default_factory=dict, repr=False)

    def run(self, graph: Graph, ctx: PassContext) -> tuple[int, dict[str, int]]:
        self.detail = {}
        n = self.fn(graph, ctx)
        return (n or 0), dict(self.detail)


def rewrite_pass(
    name: str, rules: list[RewriteRule] | tuple[RewriteRule, ...], description: str = ""
) -> GraphPass:
    """A pass that drives a declarative rule table to its fixed point."""
    p: GraphPass

    def fn(graph: Graph, ctx: PassContext) -> int:
        return apply_rules(graph, rules, counters=p.detail)

    p = GraphPass(name=name, fn=fn, description=description)
    return p


@dataclass(frozen=True)
class PassStats:
    name: str
    rewrites: int
    duration_ms: float
    nodes_before: int
    nodes_after: int
    detail: dict[str, int] = field(default_factory=dict)

    def to_dict(self) -> dict:
        d = {
            "name": self.name,
            "rewrites": self.rewrites,
            "duration_ms": round(self.duration_ms, 4),
            "nodes_before": self.nodes_before,
            "nodes_after": self.nodes_after,
        }
        if self.detail:
            d["rules"] = dict(self.detail)
        return d


@dataclass
class PipelineReport:
    """Instrumentation record of one PassManager run over one graph."""

    graph_name: str
    mode: str | None
    passes: list[PassStats] = field(default_factory=list)

    @property
    def total_rewrites(self) -> int:
        return sum(p.rewrites for p in self.passes)

    def rewrites_by_pass(self) -> dict[str, int]:
        return {p.name: p.rewrites for p in self.passes}

    def to_dict(self) -> dict:
        return {
            "graph": self.graph_name,
            "mode": self.mode,
            "total_rewrites": self.total_rewrites,
            "passes": [p.to_dict() for p in self.passes],
        }

    def summary(self) -> str:
        head = f"optimization report for {self.graph_name!r}"
        if self.mode:
            head += f" (mode={self.mode})"
        lines = [head]
        for p in self.passes:
            line = (
                f"  {p.name:<18} rewrites={p.rewrites:<4} "
                f"nodes {p.nodes_before:>3} -> {p.nodes_after:<3} "
                f"{p.duration_ms:8.2f} ms"
            )
            if p.detail:
                fired = ", ".join(f"{k} x{v}" for k, v in sorted(p.detail.items()))
                line += f"  [{fired}]"
            lines.append(line)
        lines.append(f"  total rewrites: {self.total_rewrites}")
        return "\n".join(lines)


@dataclass
class PassManager:
    """Runs a pass list over a graph with per-pass instrumentation.

    ``verify`` is the pass-invariant gate: ``'each'`` re-verifies the graph
    after every pass (and once before the first, so a broken *input* graph
    is attributed to the frontend rather than to pass 0), ``'final'``
    verifies once after the pipeline, ``'off'`` disables the gate.  ``None``
    defers to the ``REPRO_VERIFY`` environment variable (default off).
    A violation raises ``repro_torch.core.verify.VerifyError`` whose subject
    names the offending pass and the rewrite rules it fired."""

    passes: list[GraphPass]
    verify: str | None = None

    def resolved_verify(self) -> str:
        from repro_torch.core.verify import resolve_verify

        return resolve_verify(self.verify)

    @staticmethod
    def _verify_graph(graph: Graph, ctx: PassContext, subject: str) -> None:
        from repro_torch.core.verify import VerifyError, verify_graph

        diags = verify_graph(graph, ctx.desc)
        if diags:
            raise VerifyError(subject, diags)

    def run(self, graph: Graph, ctx: PassContext | None = None) -> PipelineReport:
        ctx = ctx or PassContext()
        trace = ctx.resolved_trace()
        verify = self.resolved_verify()
        dump_dir = ctx.resolved_dump_dir()
        if dump_dir is not None:
            dump_dir.mkdir(parents=True, exist_ok=True)
        report = PipelineReport(graph_name=graph.name, mode=ctx.mode)
        if verify == "each":
            self._verify_graph(graph, ctx, f"graph {graph.name!r} before any pass ran")
        for i, p in enumerate(self.passes):
            nodes_before = len(graph.toposort())
            if dump_dir is not None:
                self._dump(dump_dir, graph, i, p.name, "before")
            t0 = time.perf_counter()
            rewrites, detail = p.run(graph, ctx)
            dt_ms = (time.perf_counter() - t0) * 1e3
            nodes_after = len(graph.toposort())
            if dump_dir is not None:
                self._dump(dump_dir, graph, i, p.name, "after")
            report.passes.append(
                PassStats(
                    name=p.name,
                    rewrites=rewrites,
                    duration_ms=dt_ms,
                    nodes_before=nodes_before,
                    nodes_after=nodes_after,
                    detail=detail,
                )
            )
            if trace:
                print(
                    f"[pass] {graph.name}:{p.name} rewrites={rewrites} "
                    f"nodes {nodes_before}->{nodes_after} {dt_ms:.2f}ms",
                    file=sys.stderr,
                )
            if verify == "each":
                fired = (
                    " (rules fired: "
                    + ", ".join(f"{k} x{v}" for k, v in sorted(detail.items()))
                    + ")"
                    if detail
                    else ""
                )
                self._verify_graph(
                    graph, ctx, f"graph {graph.name!r} after pass {p.name!r}{fired}"
                )
        if verify == "final":
            self._verify_graph(graph, ctx, f"graph {graph.name!r} after the pass pipeline")
        return report

    @staticmethod
    def _dump(dump_dir: Path, graph: Graph, i: int, name: str, stage: str) -> None:
        safe = name.replace("/", "_")
        path = dump_dir / f"{graph.name}_{i:02d}_{safe}_{stage}.txt"
        path.write_text(graph.summary() + "\n")
