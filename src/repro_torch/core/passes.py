"""Compiler passes of the integration flow (paper §3.3), as declarative
rule tables over the pattern-rewrite engine plus a handful of function
passes, composed into per-mode pipelines by ``frontend_passes`` /
``passes_for_mode`` and run by the ``PassManager``.

Legalization (the Frontend Configurator): the quantized multi-op sequence
(dense -> bias_add -> requantize -> clip) and the float sequences
(dense -> bias_add [-> activation]) rewrite into *generalized* operators
so TIR-level lowering sees a single op (§3.3).  On top of it, the
optimization layer the hand-rolled traversals could not express cheaply:

  * ``fold_transpose``   — transpose∘transpose composition and folding a
    non-constant matrix transpose into the consuming dense
    (``transpose_b`` — the accelerator reads the operand transposed);
  * ``fuse_residual``    — add-of-generalized-op becomes a fused residual
    epilogue (transformer skip connections stay on the accelerator);
  * ``fuse_conv_pool``   — max_pool2d over a generalized conv2d becomes a
    fused pooling epilogue;
  * ``cse``              — common-subexpression elimination (structural,
    including value-equal constants);
  * ``dce``              — no-effect-node elimination (identity
    transposes/reshapes, full-range clips).  Classic unreachable-code DCE
    is implicit in this IR: graphs are defined by reachability from their
    outputs, so rewrites can never leave dead nodes behind.

``fold_constants`` evaluates constant subgraphs at compile time — the pass
the paper had to fight TVM for; the naive BYOC mode skips the whole
optimization pipeline and pays at run time, reproducing Table 2's blowup.
``partition`` marks accelerator-supported operators (BYOC-style) last.

Accelerator descriptions can contribute target-specific patterns via
``AcceleratorDescription.register_rewrite_pattern`` — they run right after
the generic legalization rules.

Port of ``repro.core.passes``: the three per-mode pipelines, without the
shard-partitioning pass (``make_shard_pass``) that waits for the sharded
slice of the port.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.accel import AcceleratorDescription
from repro_torch.core import ir
from repro_torch.core.ir import Graph, Node, const, execute_node
from repro_torch.core.pass_manager import GraphPass, PassContext, rewrite_pass
from repro_torch.core.rewrite import Match, P, any_, rule

_CORE_OPS = ("dense", "conv2d")
_GENERALIZED = ("generalized_dense", "generalized_conv2d")


def _gen_op_for(core: Node) -> str:
    return "generalized_dense" if core.op == "dense" else "generalized_conv2d"


# ---------------------------------------------------------------------------
# Legalization rules (longest chain first; the engine anchors downstream-
# first, so the quantized chain wins over its bias_add sub-pattern).
# ---------------------------------------------------------------------------


@rule(
    "fuse-quantized-epilogue",
    P(
        "clip",
        P(
            "requantize",
            P("bias_add", P(_CORE_OPS, capture="core"), any_("bias")),
            capture="rq",
        ),
    ),
)
def _fuse_quantized(m: Match, graph: Graph) -> Node | None:
    """clip(requantize(bias_add(dense|conv2d))) -> one generalized op."""
    core, rq, root = m["core"], m["rq"], m.root
    return Node(
        _gen_op_for(core),
        [core.inputs[0], core.inputs[1], m["bias"]],
        {
            **core.attrs,
            "quantized": True,
            "requant_scale": rq.attrs["scale"],
            "clip_lo": root.attrs["lo"],
            "clip_hi": root.attrs["hi"],
        },
        shape=root.shape,
        dtype=root.dtype,
    )


@rule(
    "fuse-activation",
    P(
        ("relu", "gelu"),
        P("bias_add", P(_CORE_OPS, capture="core"), any_("bias")),
    ),
)
def _fuse_activation(m: Match, graph: Graph) -> Node | None:
    """activation(bias_add(dense|conv2d)) -> one generalized op."""
    core, root = m["core"], m.root
    return Node(
        _gen_op_for(core),
        [core.inputs[0], core.inputs[1], m["bias"]],
        {**core.attrs, "quantized": False, "activation": root.op},
        shape=root.shape,
        dtype=root.dtype,
    )


@rule(
    "fuse-bias",
    P("bias_add", P(_CORE_OPS, capture="core"), any_("bias")),
)
def _fuse_bias(m: Match, graph: Graph) -> Node | None:
    """bias_add(dense|conv2d) -> one generalized op (no epilogue)."""
    core, root = m["core"], m.root
    return Node(
        _gen_op_for(core),
        [core.inputs[0], core.inputs[1], m["bias"]],
        {**core.attrs, "quantized": False, "activation": None},
        shape=root.shape,
        dtype=root.dtype,
    )


LEGALIZE_RULES = (_fuse_quantized, _fuse_activation, _fuse_bias)


# ---------------------------------------------------------------------------
# Optimization rules.
# ---------------------------------------------------------------------------


@rule("fold-transpose-transpose", P("transpose", P("transpose", any_("src"), capture="inner")))
def _fold_transpose_transpose(m: Match, graph: Graph) -> Node | None:
    """transpose(transpose(x)) -> x (identity) or one composed transpose."""
    src, inner, root = m["src"], m["inner"], m.root
    p1 = inner.attrs["perm"]
    p2 = root.attrs["perm"]
    combined = tuple(p1[j] for j in p2)
    if combined == tuple(range(len(combined))):
        if src.shape != root.shape or src.dtype != root.dtype:
            return None
        return src
    return Node(
        "transpose",
        [src],
        {"perm": combined},
        shape=root.shape,
        dtype=root.dtype,
    )


@rule(
    "fold-transpose-into-dense",
    P("dense", any_("x"), P("transpose", any_("w"), capture="t")),
)
def _fold_transpose_into_dense(m: Match, graph: Graph) -> Node | None:
    """dense(x, transpose(w)) -> dense(x, w, transpose_b=True): the mapped
    executor reads the weight operand transposed (a free view on the host
    targets) instead of materializing a layout op.  Applies to the 2-D
    weight transpose and to the batched matmul's last-two-dims transpose
    (attention K^T with a leading batch dim).  Constant transposes are
    left alone — constant folding removes them entirely at compile time,
    which is strictly better than re-reading them transposed per run."""
    w, t, root = m["w"], m["t"], m.root
    if w is None or w.is_const() or len(w.shape) not in (2, 3):
        return None
    swap_last_two = (1, 0) if len(w.shape) == 2 else (0, 2, 1)
    if t.attrs["perm"] != swap_last_two or root.attrs.get("transpose_b"):
        return None
    return Node(
        "dense",
        [m["x"], w],
        {**root.attrs, "transpose_b": True},
        shape=root.shape,
        dtype=root.dtype,
    )


FOLD_TRANSPOSE_RULES = (_fold_transpose_transpose, _fold_transpose_into_dense)


def _residual_build(gen: Node, res: Node, root: Node) -> Node | None:
    if gen.attrs.get("residual"):
        return None  # one residual operand per op
    if gen.shape != root.shape or res.shape != root.shape:
        return None  # no broadcasting in the fused epilogue
    if gen.dtype != root.dtype:
        return None
    return Node(
        gen.op,
        [*gen.inputs, res],
        {**gen.attrs, "residual": True},
        shape=root.shape,
        dtype=root.dtype,
    )


@rule("fuse-residual", P("add", P(_GENERALIZED, capture="gen"), any_("res")))
def _fuse_residual_lhs(m: Match, graph: Graph) -> Node | None:
    """add(generalized_op, residual) -> fused residual epilogue."""
    return _residual_build(m["gen"], m["res"], m.root)


@rule("fuse-residual-rhs", P("add", any_("res"), P(_GENERALIZED, capture="gen")))
def _fuse_residual_rhs(m: Match, graph: Graph) -> Node | None:
    """add(residual, generalized_op) — addition commutes, same fusion."""
    if m["res"] is m["gen"]:
        return None
    return _residual_build(m["gen"], m["res"], m.root)


RESIDUAL_RULES = (_fuse_residual_lhs, _fuse_residual_rhs)


@rule("fuse-conv-pool", P("max_pool2d", P("generalized_conv2d", capture="conv")))
def _fuse_conv_pool(m: Match, graph: Graph) -> Node | None:
    """max_pool2d(generalized_conv2d) -> fused pooling epilogue.  The
    pooled shape becomes the node shape; the conv's own output shape is
    kept in the pool attrs so the executor can reshape before pooling."""
    conv, root = m["conv"], m.root
    if conv.attrs.get("pool") or conv.attrs.get("residual"):
        # residual-then-pool would reorder the epilogue stages; decline
        return None
    return Node(
        conv.op,
        list(conv.inputs),
        {
            **conv.attrs,
            "pool": {
                "size": root.attrs["size"],
                "stride": root.attrs["stride"],
                "conv_shape": tuple(conv.shape),
            },
        },
        shape=root.shape,
        dtype=root.dtype,
    )


CONV_POOL_RULES = (_fuse_conv_pool,)


# ---------------------------------------------------------------------------
# Function passes: constant folding, CSE, DCE, partitioning.
# ---------------------------------------------------------------------------


def _rewire(graph: Graph, replace: dict[Node, Node]) -> None:
    """Apply a node-replacement map over the whole graph in one sweep."""
    order = graph.toposort()
    for n in order:
        if n in replace:
            continue
        new_inputs = [
            replace.get(i, i) if i is not None else None for i in n.inputs
        ]
        if any(a is not b for a, b in zip(new_inputs, n.inputs)):
            n.inputs = new_inputs
    graph.outputs = [replace.get(o, o) for o in graph.outputs]
    graph.invalidate()


def _fold_constants(graph: Graph, ctx: PassContext | None = None) -> int:
    """Evaluate nodes whose inputs are all constants, in ONE topological
    sweep (inputs fold before their consumers are visited, so a whole
    constant chain collapses in a single pass).  Runs registered constant
    preprocessing (weight transpose/quantize) at compile time — the key
    enabler the paper identifies in §4."""
    folded: dict[Node, Node] = {}
    for n in graph.toposort():
        if n.op in ("input", "const") or n.op.startswith("generalized"):
            continue
        ins = [folded.get(i, i) if i is not None else None for i in n.inputs]
        if not ins or not all(i is not None and i.is_const() for i in ins):
            continue
        try:
            val = execute_node(n, [i.value for i in ins])
        except NotImplementedError:
            continue
        folded[n] = const(np.asarray(val), name=f"folded_{n.name}")
    if folded:
        _rewire(graph, folded)
    return len(folded)


def _freeze_attr(v):
    if isinstance(v, dict):
        return tuple(sorted((k, _freeze_attr(x)) for k, x in v.items()))
    if isinstance(v, (list, tuple)):
        return tuple(_freeze_attr(x) for x in v)
    if isinstance(v, np.ndarray):
        return (v.dtype.str, v.shape, v.tobytes())
    return v


def _cse(graph: Graph, ctx: PassContext | None = None) -> int:
    """Common-subexpression elimination: structurally identical nodes
    (same op, same resolved inputs, same attrs/shape/dtype) and value-equal
    constants collapse onto one representative."""
    table: dict = {}
    replace: dict[Node, Node] = {}
    for n in graph.toposort():
        if n.op == "input":
            continue  # inputs are distinct feeds even when shapes agree
        if n.op == "const":
            key = ("const", n.dtype, n.shape, n.value.tobytes())
        else:
            ins = tuple(
                id(replace.get(i, i)) if i is not None else None for i in n.inputs
            )
            key = (n.op, ins, n.shape, n.dtype, _freeze_attr(n.attrs))
        try:
            canon = table.get(key)
        except TypeError:  # unhashable attr payload: leave the node alone
            continue
        if canon is not None:
            replace[n] = canon
        else:
            table[key] = n
    if replace:
        _rewire(graph, replace)
    return len(replace)


def _covers_dtype_range(dtype: str, lo, hi) -> bool:
    if not (dtype.startswith("int") or dtype.startswith("uint")):
        return False
    info = np.iinfo(dtype)
    return lo <= info.min and hi >= info.max


def _dce(graph: Graph, ctx: PassContext | None = None) -> int:
    """Dead-node elimination.  Unreachable nodes cannot exist in this IR
    (a graph IS its reachable set), so "dead" means *no effect*: identity
    transposes/reshapes and clips that cannot clip their dtype's range.
    Those still cost buffer slots and plan steps, so they go."""
    replace: dict[Node, Node] = {}
    for n in graph.toposort():
        if not n.inputs or n.inputs[0] is None:
            continue
        src = replace.get(n.inputs[0], n.inputs[0])
        if src.shape != n.shape or src.dtype != n.dtype:
            continue
        if n.op == "transpose" and n.attrs["perm"] == tuple(range(len(n.shape))):
            replace[n] = src
        elif n.op in ("reshape", "flatten"):
            replace[n] = src
        elif n.op == "clip" and _covers_dtype_range(
            n.dtype, n.attrs["lo"], n.attrs["hi"]
        ):
            replace[n] = src
    if replace:
        _rewire(graph, replace)
    return len(replace)


def _partition(graph: Graph, ctx: PassContext) -> int:
    """Mark accelerator-supported operators (BYOC-style partitioning)."""
    desc: AcceleratorDescription = ctx.desc
    supported = desc.supported_ops()
    marked = 0
    for n in graph.toposort():
        base = n.op.replace("generalized_", "")
        x = n.inputs[0] if n.inputs else None
        operand_dtype = x.dtype if x is not None else n.dtype
        if (
            base in supported
            and n.op != "input"
            and n.op not in ir.CACHE_OPS  # state stays host-resident
            and desc.supports_dtype(n.op, operand_dtype)
        ):
            n.target = "accel"
            marked += 1
        else:
            n.target = "host"
    return marked


# ---------------------------------------------------------------------------
# Pipelines: per-mode pass-list configurations.
# ---------------------------------------------------------------------------


def _capability_filtered(rules, desc: AcceleratorDescription):
    """Capability negotiation for legalization: fusing a chain into a
    generalized op is only useful when the target can actually run the core
    op — a host-resident generalized op has no executor.  Chains whose core
    the description does not support stay as plain ops, which the host
    executes cleanly after partitioning."""
    from repro_torch.core.rewrite import RewriteRule

    supported = desc.supported_ops()

    def filtered(r):
        def build(m: Match, graph: Graph, _build=r.build):
            core = m.captures.get("core")
            if core is not None:
                x = core.inputs[0] if core.inputs else None
                dtype = x.dtype if x is not None else core.dtype
                if core.op not in supported or not desc.supports_dtype(
                    core.op, dtype
                ):
                    return None
            return _build(m, graph)

        return RewriteRule(name=r.name, pattern=r.pattern, build=build)

    return tuple(filtered(r) for r in rules)


def frontend_passes(
    desc: AcceleratorDescription,
    *,
    legalize: bool = True,
    fold: bool = True,
    optimize: bool | None = None,
) -> list[GraphPass]:
    """Build the frontend pipeline as a pass list.  ``optimize`` defaults
    to ``legalize`` (the naive BYOC baseline runs neither)."""
    optimize = legalize if optimize is None else optimize
    passes: list[GraphPass] = []
    if optimize:
        passes.append(
            rewrite_pass(
                "fold_transpose",
                FOLD_TRANSPOSE_RULES,
                "compose/absorb layout transposes",
            )
        )
    if legalize:
        passes.append(
            rewrite_pass(
                "legalize",
                _capability_filtered(LEGALIZE_RULES, desc),
                "fuse chains into generalized ops",
            )
        )
        target_rules = tuple(getattr(desc, "rewrite_rules", ()) or ())
        if target_rules:
            passes.append(
                rewrite_pass(
                    "target_patterns",
                    target_rules,
                    f"{desc.name} description-contributed patterns",
                )
            )
    if optimize:
        passes.append(
            rewrite_pass("fuse_residual", RESIDUAL_RULES, "fuse skip-connection adds")
        )
        passes.append(
            rewrite_pass("fuse_conv_pool", CONV_POOL_RULES, "fuse pooling epilogues")
        )
    if fold:
        passes.append(
            GraphPass("fold_constants", _fold_constants, "evaluate const subgraphs")
        )
    if optimize:
        passes.append(GraphPass("cse", _cse, "deduplicate common subexpressions"))
        passes.append(GraphPass("dce", _dce, "drop no-effect nodes"))
    passes.append(GraphPass("partition", _partition, "mark accelerator regions"))
    return passes


def passes_for_mode(desc: AcceleratorDescription, mode: str) -> list[GraphPass]:
    """The per-mode pipeline configuration (paper §4 evaluation matrix).
    ``naive`` is stock BYOC: partitioning only — no legalization, no
    folding, no graph optimization."""
    if mode == "naive":
        return frontend_passes(desc, legalize=False, fold=False)
    return frontend_passes(desc)
