"""repro_torch.verify — the static verification layer (IR type-checker,
pass-invariant gate, plan lifetime/race analysis, collective deadlock
detection).

Every ``ir.Node`` carries its (shape, dtype) fixed at construction, so a
buggy rewrite rule, shard split, or hand-edited artifact can produce an
inconsistent graph that nothing catches until execution silently
diverges.  This module re-derives everything a graph/plan claims about itself from an
*independent* transfer table and reports every violation as a structured
:class:`Diagnostic` (collect-all, like ``IntegrationError``):

  * :func:`verify_graph`   — shape/dtype transfer for every op ``ir.py``
    defines (dense incl. the batched 3-D form, conv2d, collectives, cache
    ops),
    SSA/acyclicity, attribute schemas, target legality (``supports_dtype``
    on offloaded nodes, cache ops host-pinned), and ``CacheSpec``
    state-wiring consistency;
  * :func:`verify_plan`    — arena-slot def/use simulation over
    ``ExecutionPlan`` steps (read-before-write, clobbered slots, slot
    bounds, undefined outputs) plus an independent re-derivation of the
    stage assignment's cross-lane watermarks — a static race detector for
    a two-lane executor;
  * :func:`verify_collectives` — cross-shard consistency of the collective
    sequences a sharded plan set issues: every group's membership must be
    complete and identical in (op, parts, axis, dtype, contribution
    shape), and every pair of shards must order their common groups
    identically — the two ways a ``CollectiveSession`` deadlocks or
    mis-reduces at run time;
  * :func:`verify` / :func:`collect` — the dispatching front door
    (``repro_torch.verify(module_or_graph)``), raising :class:`VerifyError`
    on any diagnostic.

The pass-invariant gate lives in ``pass_manager.PassManager`` (``verify=
'each'|'final'|'off'``, env ``REPRO_VERIFY``); ``repro_torch.load`` runs
the verifier on every restored artifact before first use.

Diagnostic codes:

  ==============  =====================================================
  ``G_CYCLE``     graph contains a dependency cycle
  ``G_OP``        op outside the IR's op set
  ``G_DANGLING``  missing (None) input in a non-optional operand slot
  ``G_SSA``       duplicate input feed names / malformed input-const node
  ``G_ATTRS``     attribute schema violation (missing/ill-typed attrs)
  ``G_SHAPE``     node shape disagrees with the re-derived transfer
  ``G_DTYPE``     node/operand dtype disagrees with the transfer rule
  ``G_TARGET``    target legality (unsupported offload, cache op on accel)
  ``G_CACHE``     CacheSpec state wiring inconsistent with the graph
  ``P_BOUNDS``    plan step slot index outside the arena
  ``P_UNWRITTEN`` plan step reads a slot no earlier step defines
  ``P_CLOBBER``   plan step overwrites a live (already defined) slot
  ``P_OUTPUT``    plan output slot never defined
  ``P_RACE``      recorded cross-lane watermark below the required one
  ``C_MISMATCH``  collective group membership/shape/op mismatch
  ``C_ORDER``     two shards order their common collectives differently
  ``S_SCHEDULE``  selected schedule violates a hardware constraint
  ==============  =====================================================

CLI::

    python -m repro_torch.core.verify <artifact_dir>   # verify a saved artifact
    python -m repro_torch.core.verify --sweep          # zoo x accel x mode x devices

Port of ``repro.core.verify`` with the same codes and messages.  The CLI
also takes ``--device`` (the torch device the modules are compiled or
loaded for); ``--devices`` is the sweep's mesh-size axis, as in the
reference.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from repro_torch.core import ir
from repro_torch.core.executor import _NONE_SLOT, ExecutionPlan

VERIFY_ENV = "REPRO_VERIFY"

#: every op the IR defines (the transfer table below covers each of them).
KNOWN_OPS = (
    ir.HOST_OPS
    | ir.GENERALIZED_OPS
    | ir.COLLECTIVE_OPS
    | {"dense", "conv2d", "input", "const"}
)


def resolve_verify(explicit: str | None = None) -> str:
    """Canonicalize a verify-gate mode: the explicit value if given, else
    the ``REPRO_VERIFY`` environment variable (``1`` means ``each``)."""
    v = explicit if explicit is not None else os.environ.get(VERIFY_ENV, "")
    if v in ("", "0", "off"):
        return "off"
    if v == "1":
        return "each"
    if v in ("each", "final"):
        return v
    raise ValueError(
        f"invalid verify mode {v!r}; expected 'each', 'final', or 'off' "
        f"(settable via {VERIFY_ENV})"
    )


@dataclass(frozen=True)
class Diagnostic:
    """One structured verification finding."""

    code: str
    where: str  # node name / plan step / shard key the finding anchors to
    message: str

    def __str__(self) -> str:
        return f"[{self.code}] {self.where}: {self.message}"


class VerifyError(ValueError):
    """Static verification failed; ``.diagnostics`` lists every finding."""

    def __init__(self, subject: str, diagnostics: list[Diagnostic]):
        self.subject = subject
        self.diagnostics = list(diagnostics)
        bullet = "\n  - ".join(str(d) for d in self.diagnostics)
        super().__init__(f"verification failed for {subject}:\n  - {bullet}")


# ---------------------------------------------------------------------------
# graph verifier: the independent shape/dtype transfer table
# ---------------------------------------------------------------------------

#: ops whose output dtype must equal their first operand's dtype.
_DTYPE_PRESERVING = {
    "relu",
    "gelu",
    "clip",
    "transpose",
    "reshape",
    "flatten",
    "im2col",
    "max_pool2d",
    "shard_slice",
    "all_gather",
    "all_reduce",
    "reduce_scatter",
    "kv_cache_read",
    "kv_cache_append",
    "add",
    "sub",
    "mul",
    "bias_add",
}

#: ops whose output shape must equal their first operand's shape.
_SHAPE_PRESERVING = {
    "relu",
    "gelu",
    "clip",
    "requantize",
    "quantize",
    "dequantize",
    "softmax",
    "bias_add",
    "all_reduce",
    "kv_cache_read",
}

#: fixed operand arity per op (generalized ops are special-cased: 3 inputs,
#: or 4 with a fused residual).
_ARITY = {
    "input": 0,
    "const": 0,
    "dense": 2,
    "conv2d": 2,
    "add": 2,
    "sub": 2,
    "mul": 2,
    "bias_add": 2,
    "relu": 1,
    "gelu": 1,
    "clip": 1,
    "requantize": 1,
    "quantize": 1,
    "dequantize": 1,
    "transpose": 1,
    "reshape": 1,
    "flatten": 1,
    "im2col": 1,
    "softmax": 1,
    "max_pool2d": 1,
    "shard_slice": 1,
    "all_gather": 1,
    "all_reduce": 1,
    "reduce_scatter": 1,
    "kv_cache_read": 1,
    "kv_cache_append": 3,
}

#: required attribute keys per op (checked before the transfer runs).
_REQUIRED_ATTRS = {
    "conv2d": ("stride", "padding"),
    "generalized_conv2d": ("stride", "padding"),
    "transpose": ("perm",),
    "reshape": ("shape",),
    "clip": ("lo", "hi"),
    "requantize": ("scale",),
    "quantize": ("scale",),
    "dequantize": ("scale",),
    "max_pool2d": ("size", "stride"),
    "shard_slice": ("axis", "rank", "parts"),
    "all_gather": ("group", "rank", "parts", "axis"),
    "all_reduce": ("group", "rank", "parts", "axis"),
    "reduce_scatter": ("group", "rank", "parts", "axis"),
}


def _is_int(v) -> bool:
    return isinstance(v, (int, np.integer)) and not isinstance(v, bool)


def _dense_transfer(x, w, attrs) -> tuple[tuple[int, ...] | None, list[str]]:
    """Expected output shape of (generalized_)dense given operand shapes.

    2-D weights: ``x[..., C] @ w[C, K]`` (``transpose_b`` means ``w`` is
    stored ``(K, C)`` and read swapped); 3-D weights are the batched
    activation-activation matmul ``x[B, M, C] @ w[B, C, K]``.
    """
    tb = bool(attrs.get("transpose_b"))
    if len(w) == 3:
        if len(x) != 3:
            return None, [f"batched dense needs a 3-D input, got {list(x)}"]
        c_w = w[-1] if tb else w[-2]
        k = w[-2] if tb else w[-1]
        errs = []
        if x[0] != w[0]:
            errs.append(f"batched dense batch dims differ: {x[0]} vs {w[0]}")
        if x[-1] != c_w:
            errs.append(
                f"dense contraction mismatch: input C={x[-1]} vs weight C={c_w}"
            )
        if errs:
            return None, errs
        return (x[0], x[1], k), []
    if len(w) == 2:
        if len(x) < 1:
            return None, [f"dense input must have a contraction dim, got {list(x)}"]
        c_w = w[1] if tb else w[0]
        k = w[0] if tb else w[1]
        if x[-1] != c_w:
            return None, [
                f"dense contraction mismatch: input C={x[-1]} vs weight C={c_w}"
            ]
        return (*x[:-1], k), []
    return None, [f"dense weight must be 2-D or 3-D, got {list(w)}"]


def _conv_transfer(x, w, attrs) -> tuple[tuple[int, ...] | None, list[str]]:
    """Expected NHWC conv2d output shape for HWIO weights."""
    if len(x) != 4 or len(w) != 4:
        return None, [
            f"conv2d needs NHWC input and HWIO weights, got {list(x)} / {list(w)}"
        ]
    stride, padding = attrs.get("stride", 1), attrs.get("padding", 0)
    if not _is_int(stride) or stride < 1 or not _is_int(padding) or padding < 0:
        return None, [f"bad stride/padding: {stride!r}/{padding!r}"]
    n, h, wd, c = x
    kh, kw, ci, co = w
    if c != ci:
        return None, [f"conv2d channel mismatch: input C={c} vs weight CI={ci}"]
    oh = (h + 2 * padding - kh) // stride + 1
    ow = (wd + 2 * padding - kw) // stride + 1
    if oh < 1 or ow < 1:
        return None, [f"conv2d window larger than input: out {oh}x{ow}"]
    return (n, oh, ow, co), []


def _pool_transfer(shape, size, stride) -> tuple[tuple[int, ...] | None, list[str]]:
    if len(shape) != 4:
        return None, [f"max_pool2d needs an NHWC input, got {list(shape)}"]
    if not _is_int(size) or size < 1 or not _is_int(stride) or stride < 1:
        return None, [f"bad pool size/stride: {size!r}/{stride!r}"]
    n, h, w, c = shape
    oh = (h - size) // stride + 1
    ow = (w - size) // stride + 1
    if oh < 1 or ow < 1:
        return None, [f"pool window larger than input: out {oh}x{ow}"]
    return (n, oh, ow, c), []


class _GraphChecker:
    """One verification walk over one graph; accumulates diagnostics."""

    def __init__(self, graph: ir.Graph, desc=None):
        self.graph = graph
        self.desc = desc
        self.diags: list[Diagnostic] = []

    def diag(self, code: str, node, message: str) -> None:
        where = f"{node.name} ({node.op})" if node is not None else self.graph.name
        self.diags.append(Diagnostic(code, where, message))

    # -- structure -----------------------------------------------------------
    def run(self) -> list[Diagnostic]:
        try:
            order = self.graph.toposort()
        except ValueError:
            self.diags.append(
                Diagnostic(
                    "G_CYCLE",
                    self.graph.name,
                    "graph contains a dependency cycle (toposort failed); "
                    "structural checks skipped",
                )
            )
            return self.diags
        in_graph = set(order)
        names_seen: dict[str, str] = {}
        for n in order:
            if n.op not in KNOWN_OPS:
                self.diag("G_OP", n, f"op {n.op!r} is not an IR op")
                continue
            if n.op == "input":
                prev = names_seen.get(n.name)
                if prev is not None:
                    self.diag(
                        "G_SSA",
                        n,
                        f"duplicate input name {n.name!r} (feeds are keyed "
                        f"by name; each input must be unique)",
                    )
                names_seen[n.name] = n.op
            self._check_structure(n, in_graph)
            self._check_attrs(n)
            self._check_transfer(n)
            self._check_target(n)
        self._check_cache_spec()
        return self.diags

    def _check_structure(self, n: ir.Node, in_graph: set) -> None:
        arity = _ARITY.get(n.op)
        if n.op in ir.GENERALIZED_OPS:
            if len(n.inputs) not in (3, 4):
                self.diag(
                    "G_DANGLING",
                    n,
                    f"expected 3 operands (x, w, bias) or 4 (+residual), "
                    f"got {len(n.inputs)}",
                )
                return
            for i, x in enumerate(n.inputs):
                if x is None and i < 2:
                    self.diag("G_DANGLING", n, f"operand {i} is None")
                elif x is not None and x not in in_graph:
                    self.diag("G_DANGLING", n, f"operand {i} not in this graph")
            return
        if arity is not None and len(n.inputs) != arity:
            self.diag(
                "G_DANGLING",
                n,
                f"expected {arity} operand(s), got {len(n.inputs)}",
            )
            return
        for i, x in enumerate(n.inputs):
            if x is None:
                self.diag(
                    "G_DANGLING",
                    n,
                    f"operand {i} is None (only generalized-op bias/residual "
                    f"operands may be absent)",
                )
            elif x not in in_graph:
                self.diag("G_DANGLING", n, f"operand {i} not in this graph")
        if n.op == "const":
            if n.value is None:
                self.diag("G_SSA", n, "const node carries no value")
            else:
                v = np.asarray(n.value)
                if tuple(v.shape) != tuple(n.shape):
                    self.diag(
                        "G_SHAPE",
                        n,
                        f"const value shape {list(v.shape)} != node shape "
                        f"{list(n.shape)}",
                    )
                if str(v.dtype) != n.dtype:
                    self.diag(
                        "G_DTYPE",
                        n,
                        f"const value dtype {v.dtype} != node dtype {n.dtype}",
                    )
        if any((not _is_int(d)) or d < 1 for d in n.shape):
            self.diag("G_SHAPE", n, f"non-positive dim in shape {list(n.shape)}")

    def _check_attrs(self, n: ir.Node) -> None:
        missing = [k for k in _REQUIRED_ATTRS.get(n.op, ()) if k not in n.attrs]
        if missing:
            self.diag("G_ATTRS", n, f"missing required attr(s) {missing}")
            return
        if n.op == "transpose":
            perm = n.attrs["perm"]
            if tuple(sorted(perm)) != tuple(range(len(n.shape))):
                self.diag(
                    "G_ATTRS",
                    n,
                    f"perm {list(perm)} is not a permutation of a rank-"
                    f"{len(n.shape)} tensor's axes",
                )
        if n.op == "clip" and n.attrs["lo"] > n.attrs["hi"]:
            self.diag(
                "G_ATTRS", n, f"clip lo {n.attrs['lo']} > hi {n.attrs['hi']}"
            )
        if n.op in ir.COLLECTIVE_OPS or n.op == "shard_slice":
            rank, parts = n.attrs["rank"], n.attrs["parts"]
            if not _is_int(parts) or parts < 1:
                self.diag("G_ATTRS", n, f"parts must be a positive int, got {parts!r}")
            elif not _is_int(rank) or not (0 <= rank < parts):
                self.diag("G_ATTRS", n, f"rank {rank!r} outside [0, {parts})")
            if n.op in ir.COLLECTIVE_OPS and not isinstance(
                n.attrs["group"], str
            ):
                self.diag(
                    "G_ATTRS", n, f"group must be a str, got {n.attrs['group']!r}"
                )
        if n.op in ir.GENERALIZED_OPS and n.attrs.get("quantized"):
            missing = [
                k
                for k in ("requant_scale", "clip_lo", "clip_hi")
                if k not in n.attrs
            ]
            if missing:
                self.diag(
                    "G_ATTRS", n, f"quantized epilogue missing attr(s) {missing}"
                )
        if n.op in ir.GENERALIZED_OPS:
            act = n.attrs.get("activation")
            if act not in (None, "relu", "gelu"):
                self.diag("G_ATTRS", n, f"unknown fused activation {act!r}")
        if n.op == "generalized_dense" and "pool" in n.attrs:
            self.diag("G_ATTRS", n, "pooling epilogue on a dense op")

    # -- the transfer table --------------------------------------------------
    def _check_transfer(self, n: ir.Node) -> None:
        # structural problems already reported make the transfer unreliable
        if any(
            d.where.startswith(f"{n.name} ")
            and d.code in ("G_DANGLING", "G_ATTRS", "G_OP")
            for d in self.diags
        ):
            return
        op = n.op
        ins = n.inputs
        if op in ("input", "const"):
            return
        x = ins[0] if ins else None
        expected: tuple[int, ...] | None = None
        errs: list[str] = []
        if op in ("dense", "generalized_dense"):
            expected, errs = _dense_transfer(x.shape, ins[1].shape, n.attrs)
            if x.dtype != ins[1].dtype:
                self.diag(
                    "G_DTYPE",
                    n,
                    f"operand dtypes differ: {x.dtype} vs {ins[1].dtype}",
                )
        elif op in ("conv2d", "generalized_conv2d"):
            expected, errs = _conv_transfer(x.shape, ins[1].shape, n.attrs)
            if x.dtype != ins[1].dtype:
                self.diag(
                    "G_DTYPE",
                    n,
                    f"operand dtypes differ: {x.dtype} vs {ins[1].dtype}",
                )
            if op == "generalized_conv2d" and "pool" in n.attrs and expected:
                pool = n.attrs["pool"]
                if tuple(pool.get("conv_shape", ())) != expected:
                    errs.append(
                        f"pool.conv_shape {list(pool.get('conv_shape', ()))} != "
                        f"re-derived conv shape {list(expected)}"
                    )
                    expected = None
                else:
                    expected, perrs = _pool_transfer(
                        expected, pool.get("size"), pool.get("stride")
                    )
                    errs.extend(perrs)
        elif op in _SHAPE_PRESERVING:
            expected = tuple(x.shape)
        elif op in ("add", "sub", "mul"):
            try:
                expected = tuple(np.broadcast_shapes(x.shape, ins[1].shape))
            except ValueError:
                errs.append(
                    f"operands do not broadcast: {list(x.shape)} vs "
                    f"{list(ins[1].shape)}"
                )
        elif op == "transpose":
            perm = n.attrs["perm"]
            if len(perm) != len(x.shape):
                errs.append(
                    f"perm rank {len(perm)} != operand rank {len(x.shape)}"
                )
            else:
                expected = tuple(x.shape[p] for p in perm)
        elif op in ("reshape", "flatten"):
            target = (
                tuple(n.attrs["shape"]) if op == "reshape" else tuple(n.shape)
            )
            if int(np.prod(target)) != int(np.prod(x.shape)):
                errs.append(
                    f"reshape changes element count: {list(x.shape)} -> "
                    f"{list(target)}"
                )
            else:
                expected = target
        elif op == "im2col":
            expected = None  # declared, never constructed; no transfer rule
        elif op == "max_pool2d":
            expected, errs = _pool_transfer(
                x.shape, n.attrs["size"], n.attrs["stride"]
            )
        elif op in ("shard_slice", "reduce_scatter"):
            ax = n.attrs["axis"] % len(x.shape) if x.shape else 0
            parts = n.attrs["parts"]
            if ax >= len(x.shape):
                errs.append(f"axis {ax} outside rank {len(x.shape)}")
            elif x.shape[ax] % parts:
                errs.append(
                    f"dim {ax} of {list(x.shape)} not divisible by {parts}"
                )
            else:
                expected = tuple(
                    d // parts if i == ax else d for i, d in enumerate(x.shape)
                )
        elif op == "all_gather":
            ax = n.attrs["axis"] % len(x.shape) if x.shape else 0
            if ax >= len(x.shape):
                errs.append(f"axis {ax} outside rank {len(x.shape)}")
            else:
                expected = tuple(
                    d * n.attrs["parts"] if i == ax else d
                    for i, d in enumerate(x.shape)
                )
        elif op == "kv_cache_append":
            cache, update, pos = ins
            expected = tuple(cache.shape)
            if update.dtype != cache.dtype:
                self.diag(
                    "G_DTYPE",
                    n,
                    f"update dtype {update.dtype} != cache dtype {cache.dtype}",
                )
            if (
                len(update.shape) != len(cache.shape)
                or update.shape[:-2] != cache.shape[:-2]
                or update.shape[-1] != cache.shape[-1]
                or update.shape[-2] > cache.shape[-2]
            ):
                errs.append(
                    f"update shape {list(update.shape)} incompatible with "
                    f"cache {list(cache.shape)}"
                )
            if pos.shape not in ((), cache.shape[:-2]):
                errs.append(
                    f"pos shape {list(pos.shape)} must be scalar or the "
                    f"cache's leading dims {list(cache.shape[:-2])}"
                )
        if errs:
            for e in errs:
                self.diag("G_SHAPE", n, e)
        elif expected is not None and tuple(n.shape) != expected:
            self.diag(
                "G_SHAPE",
                n,
                f"declared shape {list(n.shape)} != re-derived "
                f"{list(expected)}",
            )
        self._check_dtype(n)
        # generalized-op extra operands: bias broadcastable, residual exact
        if op in ir.GENERALIZED_OPS and expected is not None:
            bias = ins[2] if len(ins) > 2 else None
            if bias is not None:
                # the fused epilogue shape is the node's own (pooling may
                # have narrowed it); bias applies to the pre-pool GEMM out
                gemm_out = (
                    expected
                    if "pool" not in n.attrs
                    else tuple(n.attrs["pool"]["conv_shape"])
                )
                try:
                    ok = (
                        tuple(np.broadcast_shapes(bias.shape, gemm_out))
                        == gemm_out
                    )
                except ValueError:
                    ok = False
                if not ok:
                    self.diag(
                        "G_SHAPE",
                        n,
                        f"bias shape {list(bias.shape)} does not broadcast "
                        f"to {list(gemm_out)}",
                    )
            res = ins[3] if len(ins) > 3 else None
            if res is not None:
                if tuple(res.shape) != tuple(n.shape):
                    self.diag(
                        "G_SHAPE",
                        n,
                        f"residual shape {list(res.shape)} != node shape "
                        f"{list(n.shape)}",
                    )
                if res.dtype != n.dtype:
                    self.diag(
                        "G_DTYPE",
                        n,
                        f"residual dtype {res.dtype} != node dtype {n.dtype}",
                    )

    def _check_dtype(self, n: ir.Node) -> None:
        x = n.inputs[0] if n.inputs else None
        if x is None:
            return
        if n.op in _DTYPE_PRESERVING and n.dtype != x.dtype:
            self.diag(
                "G_DTYPE",
                n,
                f"declared dtype {n.dtype} != operand dtype {x.dtype} "
                f"({n.op} preserves its operand's dtype)",
            )
        elif n.op == "dequantize" and n.dtype != "float32":
            self.diag("G_DTYPE", n, f"dequantize must produce float32, not {n.dtype}")
        elif n.op == "softmax":
            want = "float32" if x.dtype.startswith(("int", "uint")) else x.dtype
            if n.dtype != want:
                self.diag(
                    "G_DTYPE",
                    n,
                    f"softmax over {x.dtype} must produce {want}, not {n.dtype}",
                )
        if n.op in ("add", "sub", "mul", "bias_add"):
            b = n.inputs[1]
            if b is not None and b.dtype != x.dtype:
                self.diag(
                    "G_DTYPE",
                    n,
                    f"operand dtypes differ: {x.dtype} vs {b.dtype}",
                )

    # -- target legality -----------------------------------------------------
    def _check_target(self, n: ir.Node) -> None:
        if n.target not in ("host", "accel"):
            self.diag("G_TARGET", n, f"unknown target {n.target!r}")
            return
        if n.target != "accel":
            return
        if n.op in ir.CACHE_OPS:
            self.diag(
                "G_TARGET",
                n,
                "cache ops are host-resident by contract and must never be "
                "offloaded",
            )
            return
        if n.op in ("input", "const") or n.op in ir.COLLECTIVE_OPS:
            self.diag("G_TARGET", n, f"{n.op} nodes cannot be offloaded")
            return
        if self.desc is None:
            return
        base = n.op.replace("generalized_", "")
        x = n.inputs[0] if n.inputs else None
        operand_dtype = x.dtype if x is not None else n.dtype
        if base not in self.desc.supported_ops():
            self.diag(
                "G_TARGET",
                n,
                f"offloaded, but {self.desc.name!r} registers no core "
                f"compute for {base!r}",
            )
        elif not self.desc.supports_dtype(n.op, operand_dtype):
            self.diag(
                "G_TARGET",
                n,
                f"offloaded with {operand_dtype} operands, which "
                f"{self.desc.name!r}'s datapath cannot execute exactly",
            )

    # -- CacheSpec wiring ----------------------------------------------------
    def _check_cache_spec(self) -> None:
        spec = self.graph.cache_spec
        if spec is None:
            return
        g = self.graph

        def cache_diag(msg: str) -> None:
            self.diags.append(Diagnostic("G_CACHE", f"{g.name}.cache_spec", msg))

        if spec.layout not in ("LD", "BLD"):
            cache_diag(f"layout must be 'LD' or 'BLD', got {spec.layout!r}")
        if not _is_int(spec.max_len) or spec.max_len < 1:
            cache_diag(f"max_len must be a positive int, got {spec.max_len!r}")
            return
        inputs_by_name = {n.name: n for n in g.inputs()}
        for in_name, out_idx in spec.state:
            node = inputs_by_name.get(in_name)
            if node is None:
                cache_diag(
                    f"state names cache input {in_name!r}, which is not a "
                    f"graph input"
                )
                continue
            if not _is_int(out_idx) or not (0 <= out_idx < len(g.outputs)):
                cache_diag(
                    f"state wires {in_name!r} to output {out_idx}, but the "
                    f"graph has {len(g.outputs)} output(s)"
                )
                continue
            out = g.outputs[out_idx]
            if tuple(out.shape) != tuple(node.shape) or out.dtype != node.dtype:
                cache_diag(
                    f"state output {out_idx} is {out.dtype}{list(out.shape)} "
                    f"but cache input {in_name!r} is "
                    f"{node.dtype}{list(node.shape)} — feeding it back would "
                    f"not type-check"
                )
            if node.dtype != spec.dtype:
                cache_diag(
                    f"cache input {in_name!r} is {node.dtype}, spec says "
                    f"{spec.dtype}"
                )
            if len(node.shape) >= 2 and node.shape[-2] != spec.max_len:
                cache_diag(
                    f"cache input {in_name!r} has sequence capacity "
                    f"{node.shape[-2]}, spec says max_len={spec.max_len}"
                )
        if spec.state and spec.pos_input not in inputs_by_name:
            cache_diag(
                f"pos_input {spec.pos_input!r} is not a graph input"
            )


def verify_graph(graph: ir.Graph, desc=None) -> list[Diagnostic]:
    """Run every graph-level analysis; returns all diagnostics (never
    raises on a broken graph — that is :func:`verify`'s job)."""
    return _GraphChecker(graph, desc).run()


# ---------------------------------------------------------------------------
# plan analysis: arena def/use + the cross-lane watermark race detector
# ---------------------------------------------------------------------------


def _expected_lane_steps(plan: ExecutionPlan) -> dict[str, list]:
    """Independently re-derive the two-lane stage assignment and cross-lane
    watermarks from the plan's step list (the same dominance rule
    ``ExecutionPlan.__post_init__`` encodes: a step must wait until the
    other lane has completed every step producing one of its operands)."""
    producer: dict[int, tuple[str, int]] = {}
    lanes: dict[str, list] = {"host": [], "accel": []}
    for s in plan.steps:
        lane = s.lane if s.lane in lanes else "host"
        other = "accel" if lane == "host" else "host"
        need = 0
        for a in s.arg_slots:
            p = producer.get(a)
            if p is not None and p[0] == other:
                need = max(need, p[1] + 1)
        producer[s.slot] = (lane, len(lanes[lane]))
        lanes[lane].append((s.slot, tuple(s.arg_slots), need))
    return lanes


def verify_plan(plan: ExecutionPlan) -> list[Diagnostic]:
    """Simulate arena-slot def/use over the plan's steps and re-check the
    stage assignment's precomputed cross-lane watermarks (which a two-lane
    executor would wait on; ``pipelined=True`` runs the sequential loop)."""
    diags: list[Diagnostic] = []
    n = plan.n_slots

    def diag(code: str, where: str, msg: str) -> None:
        diags.append(Diagnostic(code, where, msg))

    defined: set[int] = {_NONE_SLOT}
    for name, slot in plan.input_slots:
        if not (0 < slot < n):
            diag("P_BOUNDS", f"input {name!r}", f"slot {slot} outside arena of {n}")
        elif slot in defined:
            diag("P_CLOBBER", f"input {name!r}", f"slot {slot} already defined")
        else:
            defined.add(slot)
    for slot, _value in plan.const_slots:
        if not (0 < slot < n):
            diag("P_BOUNDS", "const", f"slot {slot} outside arena of {n}")
        elif slot in defined:
            diag("P_CLOBBER", "const", f"slot {slot} already defined")
        else:
            defined.add(slot)
    for i, s in enumerate(plan.steps):
        where = f"step {i} {s.name!r} ({s.op})"
        for a in s.arg_slots:
            if not (0 <= a < n):
                diag("P_BOUNDS", where, f"reads slot {a} outside arena of {n}")
            elif a not in defined:
                diag(
                    "P_UNWRITTEN",
                    where,
                    f"reads slot {a} before any step defines it",
                )
        if not (0 < s.slot < n):
            diag(
                "P_BOUNDS",
                where,
                f"writes slot {s.slot} outside the writable arena [1, {n})",
            )
        elif s.slot in defined:
            diag(
                "P_CLOBBER",
                where,
                f"writes slot {s.slot}, which is already live (each slot is "
                f"defined exactly once)",
            )
        else:
            defined.add(s.slot)
    for i, slot in enumerate(plan.output_slots):
        if not (0 <= slot < n) or slot not in defined:
            diag("P_OUTPUT", f"output {i}", f"slot {slot} is never defined")
    # -- cross-lane watermark dominance (the two-lane race detector) ---------
    expected = _expected_lane_steps(plan)
    recorded = plan.recorded_lane_steps()
    for lane in ("host", "accel"):
        exp, rec = expected[lane], recorded.get(lane, ())
        if len(exp) != len(rec):
            diag(
                "P_RACE",
                f"lane {lane!r}",
                f"recorded lane has {len(rec)} steps, step list implies "
                f"{len(exp)} — lanes desynchronized",
            )
            continue
        for k, ((slot, args, need), r) in enumerate(zip(exp, rec)):
            r_slot, _fn, r_args, r_need = r
            if r_slot != slot or tuple(r_args) != args:
                diag(
                    "P_RACE",
                    f"lane {lane!r} step {k}",
                    f"recorded step writes slot {r_slot} from {list(r_args)}, "
                    f"step list implies slot {slot} from {list(args)}",
                )
            elif r_need < need:
                diag(
                    "P_RACE",
                    f"lane {lane!r} step {k} (slot {slot})",
                    f"recorded cross-lane watermark {r_need} does not "
                    f"dominate the required {need}: the "
                    f"{'accel' if lane == 'host' else 'host'} lane may not "
                    f"have produced an operand when this step runs",
                )
    return diags


# ---------------------------------------------------------------------------
# collective checker: cross-shard sequence consistency (deadlock detection)
# ---------------------------------------------------------------------------


def collective_sequence(graph: ir.Graph) -> list[dict]:
    """The ordered multi-participant collectives this shard's plan issues:
    one record per rendezvous, in toposort (== plan step) order."""
    seq = []
    for n in graph.toposort():
        if n.op in ir.COLLECTIVE_OPS and n.attrs.get("parts", 1) > 1:
            contrib = n.inputs[0]
            seq.append(
                {
                    "group": n.attrs["group"],
                    "op": n.op,
                    "rank": n.attrs["rank"],
                    "parts": n.attrs["parts"],
                    "axis": n.attrs["axis"],
                    "dtype": n.dtype,
                    "shape": tuple(contrib.shape) if contrib is not None else (),
                    "node": n.name,
                }
            )
    return seq


def verify_collectives(shards) -> list[Diagnostic]:
    """Check that every shard of a plan set issues a mutually consistent
    collective sequence.  ``shards`` maps a shard key (e.g. a ``(data,
    model)`` mesh coordinate) to an ``ir.Graph``, a ``CompiledModule``, or
    a prebuilt sequence from :func:`collective_sequence`.

    Two properties make the ``CollectiveSession`` rendezvous sound, and
    both are decidable statically:

      1. **membership** — each group is joined by exactly ranks ``0 ..
         parts-1``, once each, with identical (op, parts, axis, dtype,
         contribution shape) — anything else mis-reduces or hangs waiting
         for an absent rank (``C_MISMATCH``);
      2. **order** — any two shards issue their *common* groups in the same
         relative order — otherwise each blocks on the group the other has
         not reached yet: a deadlock (``C_ORDER``).
    """
    diags: list[Diagnostic] = []
    seqs: dict = {}
    for key, obj in dict(shards).items():
        if isinstance(obj, ir.Graph):
            seqs[key] = collective_sequence(obj)
        elif hasattr(obj, "graph"):
            seqs[key] = collective_sequence(obj.graph)
        else:
            seqs[key] = list(obj)
    groups: dict[str, list] = {}
    for key, seq in seqs.items():
        seen_here: set[str] = set()
        for rec in seq:
            g = rec["group"]
            if g in seen_here:
                diags.append(
                    Diagnostic(
                        "C_MISMATCH",
                        f"shard {key}",
                        f"group {g!r} issued more than once by one shard",
                    )
                )
            seen_here.add(g)
            groups.setdefault(g, []).append((key, rec))
    for g, members in sorted(groups.items()):
        parts = members[0][1]["parts"]
        ranks = sorted(rec["rank"] for _, rec in members)
        if ranks != list(range(parts)):
            diags.append(
                Diagnostic(
                    "C_MISMATCH",
                    f"group {g!r}",
                    f"participating ranks {ranks} != expected "
                    f"{list(range(parts))} (parts={parts}) — the rendezvous "
                    f"would wait forever",
                )
            )
        ref = members[0][1]
        for key, rec in members[1:]:
            difference = [
                f"{f}: {ref[f]!r} vs {rec[f]!r}"
                for f in ("op", "parts", "axis", "dtype", "shape")
                if rec[f] != ref[f]
            ]
            if difference:
                diags.append(
                    Diagnostic(
                        "C_MISMATCH",
                        f"group {g!r}",
                        f"shard {key} disagrees with shard {members[0][0]} "
                        f"on {'; '.join(difference)}",
                    )
                )
    keys = sorted(seqs)
    for i, a in enumerate(keys):
        for b in keys[i + 1 :]:
            groups_a = {r["group"] for r in seqs[a]}
            groups_b = {r["group"] for r in seqs[b]}
            common = groups_a & groups_b
            order_a = [r["group"] for r in seqs[a] if r["group"] in common]
            order_b = [r["group"] for r in seqs[b] if r["group"] in common]
            if order_a != order_b:
                first = next(
                    (
                        (x, y)
                        for x, y in zip(order_a, order_b)
                        if x != y
                    ),
                    (order_a[-1] if order_a else "?", order_b[-1] if order_b else "?"),
                )
                diags.append(
                    Diagnostic(
                        "C_ORDER",
                        f"shards {a} / {b}",
                        f"common collectives issued in different orders "
                        f"(first divergence: {first[0]!r} vs {first[1]!r}) — "
                        f"each shard would block on a group the other has "
                        f"not reached: deadlock",
                    )
                )
    return diags


# ---------------------------------------------------------------------------
# the dispatching front door
# ---------------------------------------------------------------------------


def collect(obj, desc=None) -> list[Diagnostic]:
    """Run every applicable analysis on ``obj`` and return ALL diagnostics
    (an empty list means verified clean).  Accepts an ``ir.Graph``, a
    ``CompiledModule``, a ``ShardedModule``, a ``BatchedModule``, or a bare
    ``ExecutionPlan``."""
    from repro_torch.core.batching import BatchedModule
    from repro_torch.core.executor import CompiledModule
    from repro_torch.core.sharded import ShardedModule

    if isinstance(obj, ir.Graph):
        return verify_graph(obj, desc)
    if isinstance(obj, ExecutionPlan):
        return verify_plan(obj)
    if isinstance(obj, CompiledModule):
        return verify_graph(obj.graph, desc or obj.desc) + verify_plan(
            obj.finalize()
        )
    if isinstance(obj, ShardedModule):
        diags: list[Diagnostic] = []
        for key, shard in sorted(obj.shards.items()):
            for d in collect(shard, desc):
                diags.append(
                    Diagnostic(d.code, f"shard {key}: {d.where}", d.message)
                )
        diags.extend(verify_collectives(obj.shards))
        return diags
    if isinstance(obj, BatchedModule):
        diags = []
        for b in obj.bucket_sizes():
            for d in collect(obj.bucket_module(b), desc):
                diags.append(
                    Diagnostic(d.code, f"bucket {b}: {d.where}", d.message)
                )
        if obj.sample_module is not None:
            for d in collect(obj.sample_module, desc):
                diags.append(
                    Diagnostic(d.code, f"sample: {d.where}", d.message)
                )
        return diags
    raise TypeError(
        f"repro_torch.verify() takes an ir.Graph, ExecutionPlan, CompiledModule, "
        f"ShardedModule, or BatchedModule; got {type(obj).__name__}"
    )


def verify(obj, desc=None) -> list[Diagnostic]:
    """``repro_torch.verify``: statically verify a graph or compiled module.

    Raises :class:`VerifyError` listing every diagnostic if anything is
    inconsistent; returns the (empty) diagnostic list otherwise."""
    diags = collect(obj, desc)
    if diags:
        subject = getattr(obj, "name", None) or getattr(
            getattr(obj, "graph", None), "name", None
        ) or type(obj).__name__
        raise VerifyError(f"{type(obj).__name__} {subject!r}", diags)
    return diags


# ---------------------------------------------------------------------------
# CLI: verify an artifact, or sweep the model zoo (the CI verify tier)
# ---------------------------------------------------------------------------


def _report(label: str, diags: list[Diagnostic]) -> bool:
    if diags:
        print(f"FAIL {label}")
        for d in diags:
            print(f"  - {d}")
        return False
    print(f"ok   {label}")
    return True


def _sweep(accelerators, modes, device_counts, device: str) -> int:
    import repro_torch
    from repro_torch.core.zoo import DECODE_ZOO, ZOO

    failed = checked = 0
    # stateful decode graphs refuse sharding; verify them at devices=1 (the
    # decode-step form, as the front door compiles it)
    models = [(name, model, device_counts) for name, model in sorted(ZOO.items())]
    models += [(name, model, (1,)) for name, model in sorted(DECODE_ZOO.items())]
    for name, model, counts in models:
        for accel in accelerators:
            if accel not in model.accelerators:
                continue
            for mode in modes:
                for devices in counts:
                    target = repro_torch.Target(
                        accel,
                        mode=mode,
                        device=device,
                        mesh=None if devices == 1 else (1, devices),
                    )
                    try:
                        diags = collect(repro_torch.compile(name, target=target))
                    except VerifyError as e:
                        diags = e.diagnostics
                    checked += 1
                    failed += not _report(f"{name} x {target.describe()}", diags)
    print(f"verified {checked} compile(s), {failed} with diagnostics")
    return 1 if failed else 0


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.core.verify",
        description="statically verify compiled modules / AOT artifacts",
    )
    ap.add_argument(
        "artifact", nargs="?", help="path of a saved artifact to verify"
    )
    ap.add_argument(
        "--sweep",
        action="store_true",
        help="compile and verify zoo x accelerators x modes x device counts",
    )
    ap.add_argument(
        "--accelerators", default="gemmini,edge_npu", help="comma-separated"
    )
    ap.add_argument(
        "--modes", default="naive,baseline,optimized", help="comma-separated"
    )
    ap.add_argument("--devices", default="1,4", help="comma-separated mesh sizes")
    ap.add_argument(
        "--device",
        default="cuda",
        help="device the modules are compiled or loaded for: cuda (default) or cpu",
    )
    args = ap.parse_args(argv)
    if args.sweep:
        return _sweep(
            tuple(args.accelerators.split(",")),
            tuple(args.modes.split(",")),
            tuple(int(d) for d in args.devices.split(",")),
            args.device,
        )
    if not args.artifact:
        ap.error("give an artifact path or --sweep")
    import repro_torch

    # under ``python -m repro_torch.core.verify`` this file runs as __main__
    # while the library raises the canonical VerifyError — catch that class,
    # not (only) this module-copy's
    from repro_torch.core.verify import VerifyError as _CanonicalVerifyError

    try:
        module = repro_torch.load(args.artifact, device=args.device)  # load verifies
    except (VerifyError, _CanonicalVerifyError) as e:
        return int(not _report(args.artifact, e.diagnostics))
    # be explicit anyway (covers future load paths)
    return int(not _report(args.artifact, collect(module)))


if __name__ == "__main__":
    raise SystemExit(main())
