"""Declarative pattern-rewrite engine for the graph IR.

The Frontend Configurator's rewrites (legalization, epilogue fusion,
layout folding) used to be hand-rolled traversals: each rule re-ran a full
``toposort()`` after every single rewrite and re-derived the consumers map
from scratch.  Following TVM's pass infrastructure and MATCH's pattern
tables, patterns are now *data*:

  * an ``OpPattern`` tree describes an op chain (op names per position,
    operand sub-patterns, optional per-node predicates);
  * a ``RewriteRule`` pairs a pattern with a ``build(match, graph)``
    callback that constructs the replacement node (or returns ``None`` to
    decline a structural match);
  * ``apply_rules`` drives all rules to a fixed point with ONE worklist
    traversal per round: the topological order and the consumers map are
    computed once per round and updated incrementally as rewrites splice
    nodes in and out.

Matching semantics (the contract every fusion rule relies on):

  * the pattern root is the *anchor* — the downstream end of the chain —
    and may have any number of consumers (it is replaced in place);
  * every other op-constrained pattern node is *interior*: it must have
    exactly one consumer and must not be a graph output, otherwise fusing
    it away would change observable values;
  * ``any_()`` wildcards match operands (including absent ``None``
    operands) without constraining them.

Anchors are visited consumers-before-producers (reverse topological
order), so the longest chain rooted downstream wins before a sub-pattern
rooted at one of its interior nodes can fire — e.g. the full quantized
``clip(requantize(bias_add(dense)))`` chain is fused before the bare
``bias_add(dense)`` rule ever sees its bias_add.  Rules are tried in list
order at each anchor, so list position is rule priority.

Port of ``repro.core.rewrite``: plain Python and numpy, copied with import changes
only unless noted here.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from repro_torch.core.ir import Graph, Node

WILDCARD = "*"


@dataclass(frozen=True)
class OpPattern:
    """One position in a pattern tree.

    ``ops`` is the set of op names accepted here (``("*",)`` matches any
    node — a wildcard operand).  ``operands`` constrains the node's inputs
    positionally; ``None`` leaves arity and operands unconstrained.
    ``where`` is an extra predicate on the matched node.  Interior nodes
    are single-consumer by contract; ``allow_multi_use=True`` opts out
    (used for operands that may be shared, like a residual input).
    """

    ops: tuple[str, ...]
    operands: tuple["OpPattern", ...] | None = None
    capture: str | None = None
    where: Callable[[Node], bool] | None = None
    allow_multi_use: bool = False

    def is_wildcard(self) -> bool:
        return self.ops == (WILDCARD,)


def P(
    ops: str | tuple[str, ...] | list[str],
    *operands: OpPattern,
    capture: str | None = None,
    where: Callable[[Node], bool] | None = None,
    allow_multi_use: bool = False,
) -> OpPattern:
    """Pattern constructor: ``P("clip", P("requantize", ...))``."""
    ops_t = (ops,) if isinstance(ops, str) else tuple(ops)
    return OpPattern(
        ops=ops_t,
        operands=tuple(operands) if operands else None,
        capture=capture,
        where=where,
        allow_multi_use=allow_multi_use,
    )


def any_(capture: str | None = None) -> OpPattern:
    """Wildcard operand: matches any node (or an absent ``None`` operand)."""
    return OpPattern(ops=(WILDCARD,), capture=capture, allow_multi_use=True)


@dataclass
class Match:
    """A successful pattern match: the anchor, named captures, and the
    interior nodes the rewrite will fuse away."""

    root: Node
    captures: dict[str, Node | None]
    interior: list[Node]

    def __getitem__(self, name: str) -> Node | None:
        return self.captures[name]


@dataclass(frozen=True)
class RewriteRule:
    """A named rewrite: when ``pattern`` matches at an anchor, ``build``
    returns the replacement node (or ``None`` to decline)."""

    name: str
    pattern: OpPattern
    build: Callable[[Match, Graph], Node | None]


def rule(name: str, pattern: OpPattern):
    """Decorator sugar: ``@rule("fuse-x", P(...))`` over a build function."""

    def deco(build: Callable[[Match, Graph], Node | None]) -> RewriteRule:
        return RewriteRule(name=name, pattern=pattern, build=build)

    return deco


def match_pattern(
    pattern: OpPattern,
    node: Node,
    consumers: dict[Node, list[Node]],
    output_ids: set[int],
) -> Match | None:
    """Match ``pattern`` anchored at ``node`` against the current graph
    state (``consumers``/``output_ids`` supply the use counts)."""
    captures: dict[str, Node | None] = {}
    interior: list[Node] = []

    def rec(p: OpPattern, n: Node | None, is_root: bool) -> bool:
        if n is None:
            # absent optional operand: only a wildcard tolerates it (the
            # capture is still recorded, as None, so build fns can read it)
            if not p.is_wildcard():
                return False
            if p.capture is not None:
                captures[p.capture] = None
            return True
        if not p.is_wildcard() and n.op not in p.ops:
            return False
        if p.where is not None and not p.where(n):
            return False
        if not is_root and not p.is_wildcard() and not p.allow_multi_use:
            if len(consumers.get(n, ())) != 1 or id(n) in output_ids:
                return False
        if p.capture is not None:
            captures[p.capture] = n
        if not is_root and not p.is_wildcard():
            interior.append(n)
        if p.operands is not None:
            if len(p.operands) != len(n.inputs):
                return False
            return all(
                rec(sp, i, False) for sp, i in zip(p.operands, n.inputs)
            )
        return True

    if rec(pattern, node, True):
        return Match(root=node, captures=captures, interior=interior)
    return None


def _consumer_map(order: list[Node]) -> dict[Node, list[Node]]:
    cons: dict[Node, list[Node]] = {n: [] for n in order}
    for n in order:
        for i in n.inputs:
            if i is not None:
                cons.setdefault(i, []).append(n)
    return cons


def _splice(
    graph: Graph, old: Node, new: Node, consumers: dict[Node, list[Node]]
) -> None:
    """Replace ``old`` with ``new`` using the round's consumer map — no
    full-graph traversal — and keep the map usable for the rest of the
    round (entries only ever become conservative, never wrong)."""
    preexisting = new in consumers
    for c in consumers.get(old, ()):  # targeted rewire
        c.inputs = [new if i is old else i for i in c.inputs]
    old_consumers = consumers.pop(old, [])
    consumers[new] = consumers.get(new, []) + old_consumers
    if any(o is old for o in graph.outputs):
        graph.outputs = [new if o is old else o for o in graph.outputs]
    if not preexisting:
        # a freshly built node: register it as a consumer of its inputs
        # (an existing node — e.g. folding back to the original source —
        # already holds those edges)
        for i in new.inputs:
            if i is not None:
                consumers.setdefault(i, []).append(new)
    graph.invalidate()


def apply_rules(
    graph: Graph,
    rules: list[RewriteRule] | tuple[RewriteRule, ...],
    counters: dict[str, int] | None = None,
    max_rounds: int = 100,
) -> int:
    """Drive ``rules`` to a fixed point over ``graph``; returns the total
    number of rewrites applied.  ``counters`` (rule name -> fire count) is
    updated in place when given.

    Each round walks the current topological order once, in reverse, and
    splices rewrites through an incrementally-maintained consumers map;
    only the *next* round pays for a fresh traversal.  Stale consumer
    entries within a round can at worst delay a match to the next round —
    the fixed point is unaffected.
    """
    total = 0
    for _ in range(max_rounds):
        order = graph.toposort()
        consumers = _consumer_map(order)
        output_ids = {id(o) for o in graph.outputs}
        removed: set[Node] = set()
        fired = 0
        for node in reversed(order):
            if node in removed:
                continue
            for r in rules:
                m = match_pattern(r.pattern, node, consumers, output_ids)
                if m is None:
                    continue
                new = r.build(m, graph)
                if new is None:
                    continue
                _splice(graph, node, new, consumers)
                output_ids.discard(id(node))
                output_ids.update(
                    id(o) for o in graph.outputs if o is new
                )
                removed.add(node)
                removed.update(m.interior)
                if counters is not None:
                    counters[r.name] = counters.get(r.name, 0) + 1
                fired += 1
                break
        total += fired
        if fired == 0:
            return total
    raise RuntimeError(
        f"rewrite did not reach a fixed point within {max_rounds} rounds "
        f"(rules: {[r.name for r in rules]})"
    )
