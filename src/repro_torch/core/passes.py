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

Port of ``repro.core.passes``: the three per-mode pipelines, the
shard-partitioning pass of sharded plans (``make_shard_pass``), and the
functional wrappers of the pre-PassManager surface (``legalize``,
``fold_constants``, ``partition``, ``run_frontend``).
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.accel import AcceleratorDescription
from repro_torch.core.collective import ShardSpec
from repro_torch.core import ir
from repro_torch.core.ir import Graph, Node, const, execute_node
from repro_torch.core.pass_manager import GraphPass, PassContext, PassManager, rewrite_pass
from repro_torch.core.rewrite import Match, P, any_, apply_rules, rule

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
# Shard partitioning (sharded ExecutionPlans, ``Target(devices=N)``).
# ---------------------------------------------------------------------------


def _shard_candidates(graph: Graph, desc: AcceleratorDescription) -> list[Node]:
    """Accelerator-eligible core ops in toposort order.  The POSITION in
    this list keys each node's collective group: per-shard graph clones
    (``ir.clone_graph``) preserve toposort order, so index ``i`` names the
    same logical node on every shard regardless of process-global node
    counters."""
    supported = desc.supported_ops()
    out = []
    for n in graph.toposort():
        base = n.op.replace("generalized_", "")
        if base not in ("dense", "conv2d"):
            continue
        x = n.inputs[0] if n.inputs else None
        dtype = x.dtype if x is not None else n.dtype
        if base in supported and desc.supports_dtype(n.op, dtype):
            out.append(n)
    return out


#: per-shard slice floor: a shard narrower than one SIMD-lane quantum pays
#: pure collective overhead for near-zero work, so such dims never split.
#: The floor is deliberately NOT the full tile alignment — a sub-tile
#: shard's accel work saturates at one padded tile (no win, no loss), but
#: the epilogues the gather sinks below (``_sink_gathers``) and the
#: narrower collective payloads still scale with 1/P.
_MIN_SHARD_DIM = 4


def _softmax_in_epilogue(n: Node, consumers: dict[Node, list[Node]]) -> bool:
    """True when ``n``'s sole-consumer elementwise epilogue chain reaches a
    softmax.  Softmax normalizes along the LAST axis, so a cols split's
    all_gather (axis -1) can never sink past it — but a rows split's
    axis-0 gather commutes with the whole chain, letting ``_sink_gathers``
    push the epilogues down to the 1/P slice."""
    cur = n
    while True:
        cs = consumers.get(cur, ())
        if len(cs) != 1:
            return False
        nxt = cs[0]
        if nxt.op not in _GATHER_SINK_OPS or tuple(nxt.shape) != tuple(
            cur.shape
        ):
            return False
        if nxt.op == "softmax":
            return True
        cur = nxt


def _plan_split(
    n: Node, mp: int, consumers: dict[Node, list[Node]]
) -> str | None:
    """Choose the tensor-parallel split of one core op, or None.

    * ``heads`` — the batched 3-D dense (both operands activations with a
      leading batch/heads dim): split the instance dim across shards.
    * ``cols``  — split the output-column (K) dim: disjoint weight columns
      per shard, partial outputs concatenate (no reduction, so nonlinear
      fused epilogues stay correct per shard).
    * ``rows``  — split GEMM rows of a 2-D input; preferred over ``cols``
      when the epilogue chain contains a softmax (see
      ``_softmax_in_epilogue``), the fallback otherwise.

    A split is only taken when the dim divides evenly AND the per-shard
    slice stays at or above ``_MIN_SHARD_DIM`` lanes.
    """
    base = n.op.replace("generalized_", "")
    if base == "dense":
        w = n.inputs[1]
        if len(w.shape) == 3:  # batched matmul: heads split
            b = n.inputs[0].shape[0]
            return "heads" if b % mp == 0 and b >= mp else None
        k = w.shape[0] if n.attrs.get("transpose_b") else w.shape[1]
        cols_ok = k % mp == 0 and k // mp >= _MIN_SHARD_DIM
        rows = n.inputs[0].shape[0] if len(n.inputs[0].shape) == 2 else 0
        rows_ok = bool(rows) and rows % mp == 0 and rows // mp >= _MIN_SHARD_DIM
        if rows_ok and (not cols_ok or _softmax_in_epilogue(n, consumers)):
            return "rows"
        return "cols" if cols_ok else None
    co = n.inputs[1].shape[-1]  # conv2d HWIO weights
    if co % mp == 0 and co // mp >= _MIN_SHARD_DIM:
        return "cols"
    return None


def _shard_operand(x: Node | None, axis: int, rank: int, parts: int) -> Node | None:
    """Slice one operand for this shard: constants slice at compile time
    (the folded weight panel never materializes fully on the shard),
    activations go through a shard_slice host op."""
    if x is None:
        return None
    if x.is_const():
        ax = axis % x.value.ndim
        size = x.value.shape[ax] // parts
        idx = [slice(None)] * x.value.ndim
        idx[ax] = slice(rank * size, (rank + 1) * size)
        return const(
            np.ascontiguousarray(x.value[tuple(idx)]),
            name=f"{x.name}_shard{rank}",
        )
    return ir.shard_slice(x, axis, rank, parts)


def _shard_node(n: Node, split: str, spec: ShardSpec, group: str) -> Node:
    """Build the sharded clone of ``n`` + its re-materializing all_gather."""
    mp, rank = spec.model, spec.model_rank
    base = n.op.replace("generalized_", "")
    inputs = list(n.inputs)
    attrs = {**n.attrs}
    if split == "heads":
        inputs[0] = _shard_operand(inputs[0], 0, rank, mp)
        inputs[1] = _shard_operand(inputs[1], 0, rank, mp)
        shape = (n.shape[0] // mp, *n.shape[1:])
        gather_axis = 0
    elif split == "rows":
        inputs[0] = _shard_operand(inputs[0], 0, rank, mp)
        if attrs.get("residual") and len(inputs) > 3:
            inputs[3] = _shard_operand(inputs[3], 0, rank, mp)
        shape = (n.shape[0] // mp, *n.shape[1:])
        gather_axis = 0
    else:  # cols
        if base == "dense":
            w_axis = 0 if attrs.get("transpose_b") else 1
        else:
            w_axis = len(inputs[1].shape) - 1  # conv2d: HWIO output channels
        inputs[1] = _shard_operand(inputs[1], w_axis, rank, mp)
        if len(inputs) > 2:  # generalized op bias (may be None)
            inputs[2] = _shard_operand(inputs[2], 0, rank, mp)
        if attrs.get("residual") and len(inputs) > 3:
            inputs[3] = _shard_operand(inputs[3], -1, rank, mp)
        if "pool" in attrs:  # fused pooling: the conv's own shape narrows
            cs = attrs["pool"]["conv_shape"]
            attrs["pool"] = {
                **attrs["pool"],
                "conv_shape": (*cs[:-1], cs[-1] // mp),
            }
        shape = (*n.shape[:-1], n.shape[-1] // mp)
        gather_axis = -1
    sharded = Node(n.op, inputs, attrs, shape=shape, dtype=n.dtype)
    return ir.all_gather(
        sharded, gather_axis, group=group, rank=rank, parts=mp
    )


#: unary elementwise ops an all_gather may sink below: applying the op to
#: the gathered tensor equals gathering the op applied per-slice, provided
#: the op never mixes elements ACROSS the gather axis (softmax normalizes
#: along the last axis, so it only commutes with gathers on other axes).
_GATHER_SINK_OPS = {
    "requantize",
    "quantize",
    "dequantize",
    "clip",
    "relu",
    "gelu",
    "softmax",
}


def _sink_gathers(graph: Graph) -> int:
    """Push all_gathers below sole-consumer elementwise epilogue chains:
    ``ew(all_gather(x))`` -> ``all_gather(ew(x))``.  The epilogue then runs
    on the shard's 1/P slice instead of the full gathered tensor — without
    this, a host-epilogue-heavy model (the transformer's quantize/softmax/
    requantize chain) is Amdahl-capped no matter how well its GEMMs split.
    The collective's group id rides along unchanged, so the rendezvous
    still pairs the same logical gather across shards; payloads that sink
    below a (re)quantize also shrink to the narrow dtype."""
    changed = 0
    while True:
        consumers: dict[Node, list[Node]] = {}
        for n in graph.toposort():
            for i in n.inputs:
                if i is not None:
                    consumers.setdefault(i, []).append(n)
        moved = False
        for n in graph.toposort():
            if n.op not in _GATHER_SINK_OPS:
                continue
            g = n.inputs[0]
            if g is None or g.op != "all_gather":
                continue
            if len(consumers.get(g, ())) != 1 or any(
                o is g for o in graph.outputs
            ):
                continue
            if tuple(n.shape) != tuple(g.shape):
                continue  # not elementwise w.r.t. this tensor
            axis = g.attrs["axis"] % len(g.shape)
            if n.op == "softmax" and axis == len(n.shape) - 1:
                continue  # softmax normalizes along the gathered axis
            parts = g.attrs["parts"]
            shard_shape = list(n.shape)
            shard_shape[axis] //= parts
            inner = Node(
                n.op,
                [g.inputs[0]],
                dict(n.attrs),
                shape=tuple(shard_shape),
                dtype=n.dtype,
            )
            sunk = ir.all_gather(
                inner,
                axis,
                group=g.attrs["group"],
                rank=g.attrs["rank"],
                parts=parts,
            )
            graph.replace_node(n, sunk)
            changed += 1
            moved = True
            break  # the consumer map is stale after a rewrite
        if not moved:
            return changed


def make_shard_pass(spec: ShardSpec) -> GraphPass:
    """The shard-partitioning pass of ``Target(devices=N)`` compiles: runs
    right before ``partition`` on each shard's graph clone.  Tensor-
    parallel (mesh ``model`` axis): every accelerator-eligible core op that
    benefits is rewritten to compute this shard's slice and immediately
    ``all_gather`` the full value back (split -> compute -> gather, no SPMD
    propagation — every visible tensor stays replicated, so the rest of
    the pipeline is untouched).  Data-parallel (mesh ``data`` axis): the
    api layer retraces each batch bucket at ``bucket/data`` rows and this
    pass appends one batch-axis all_gather per graph output."""

    def _shard(graph: Graph, ctx: PassContext) -> int:
        desc: AcceleratorDescription = ctx.desc
        stateful = [n.name for n in graph.toposort() if n.op in ir.CACHE_OPS]
        if stateful:
            # capability negotiation: KV-cache state is host-resident and
            # per-request — splitting it across a mesh would need state
            # placement the runtime doesn't model yet.  Refuse loudly
            # rather than emit silently-wrong replicated plans.
            raise ValueError(
                "stateful decode graphs cannot be shard-partitioned: "
                f"graph {graph.name!r} carries KV-cache ops {stateful}; "
                "compile with Target(devices=1) and scale decode via "
                "repro_torch.serve.ContinuousBatchingEngine slots instead"
            )
        changed = 0
        if spec.model > 1:
            consumers: dict[Node, list[Node]] = {}
            for node in graph.toposort():
                for i in node.inputs:
                    if i is not None:
                        consumers.setdefault(i, []).append(node)
            for idx, n in enumerate(_shard_candidates(graph, desc)):
                split = _plan_split(n, spec.model, consumers)
                if split is None:
                    continue
                group = f"c{idx}|m|d{spec.data_rank}"
                gathered = _shard_node(n, split, spec, group)
                graph.replace_node(n, gathered)
                changed += 1
            if changed:
                changed += _sink_gathers(graph)
        if spec.data > 1:
            for i, out in enumerate(graph.outputs):
                g = ir.all_gather(
                    out,
                    0,
                    group=f"out{i}|d|m{spec.model_rank}",
                    rank=spec.data_rank,
                    parts=spec.data,
                )
                graph.outputs[i] = g
                changed += 1
            graph.invalidate()
        return changed

    return GraphPass(
        "shard",
        _shard,
        f"tensor/data-parallel split for mesh shard "
        f"(d{spec.data_rank}, m{spec.model_rank}) of "
        f"{spec.data}x{spec.model}",
    )


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


def passes_for_mode(
    desc: AcceleratorDescription, mode: str, shard: ShardSpec | None = None
) -> list[GraphPass]:
    """The per-mode pipeline configuration (paper §4 evaluation matrix).
    ``naive`` is stock BYOC: partitioning only — no legalization, no
    folding, no graph optimization.  A ``shard`` spec (``Target(devices=
    N)``) inserts the shard-partitioning pass right before ``partition``
    in every mode; ``devices == 1`` compiles the identical pipeline (and
    thus a collective-free plan)."""
    if mode == "naive":
        passes = frontend_passes(desc, legalize=False, fold=False)
    else:
        passes = frontend_passes(desc)
    if shard is not None and shard.devices > 1:
        passes.insert(len(passes) - 1, make_shard_pass(shard))
    return passes


# ---------------------------------------------------------------------------
# Back-compat functional API (the pre-PassManager surface).
# ---------------------------------------------------------------------------


def legalize(graph: Graph) -> Graph:
    """Fuse op sequences into generalized operators (rules in priority
    order; the engine drives them to a fixed point)."""
    apply_rules(graph, LEGALIZE_RULES)
    return graph


def fold_constants(graph: Graph) -> Graph:
    _fold_constants(graph)
    return graph


def partition(graph: Graph, desc: AcceleratorDescription) -> Graph:
    _partition(graph, PassContext(desc=desc))
    return graph


def run_frontend(
    graph: Graph,
    desc: AcceleratorDescription,
    *,
    fold: bool = True,
    do_legalize: bool = True,
) -> Graph:
    """The Frontend Configurator's pass pipeline (§3.3) through the
    PassManager: legalization + optimization, constant folding, then graph
    partitioning.  Returns the (mutated) graph; use
    ``PassManager(frontend_passes(...)).run(graph, ...)`` directly when the
    instrumentation report is needed."""
    pm = PassManager(frontend_passes(desc, legalize=do_legalize, fold=fold))
    pm.run(graph, PassContext(desc=desc))
    return graph
