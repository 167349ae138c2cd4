"""Traced-torch frontend: import a plain PyTorch callable into core IR.

``trace_model(fn, example_inputs, params)`` runs ``torch.export.export``
on a small wrapper module and walks the exported graph node by node,
translating each ATen or ``repro_torch`` op into ``repro_torch.core.ir``
nodes.  Two kinds of translation cooperate:

* **direct ops** map 1:1 onto IR ops — the ``repro_torch::dense`` /
  ``conv2d`` / ``max_pool2d`` / ``kv_cache_read`` / ``kv_cache_append``
  custom ops of ``frontend.nn``; ``permute``/``t``/``transpose`` ->
  ``transpose``; ``view``/``reshape``/``squeeze``/``flatten`` ->
  ``reshape``; ``add``/``sub``/``mul``; ``relu`` (and ``clamp_min(x, 0)``,
  ``maximum(x, 0)``); ``gelu(approximate="tanh")``; ``softmax``; a
  ``clamp`` on a realized tensor -> ``clip``;

* **idiom chains** recognize the multi-op sequences plain torch produces
  for ops the IR models as one node: ``div -> round -> clamp -> to(int8)``
  -> ``quantize``, ``mul -> round -> clamp -> to(int)`` -> ``requantize``,
  ``to(float32) -> mul(scale)`` -> ``dequantize``, a broadcast 1-D bias add
  -> ``bias_add`` (a same-shape residual add stays ``add``).

Low-level ops (``div``, ``round``, a scaled ``mul``, a dtype conversion,
a clamp of a rounded value) are held as *pending* symbolic records rather
than IR nodes; they are legal only as interior steps of a recognized
idiom.  Anything that cannot be translated is collected and reported in
ONE ``UnsupportedExportError`` listing every problem.

``params`` leaves (tensors or numpy arrays, in nested dicts or lists)
enter the export as inputs and become ``ir.const`` nodes named by their
path, as the reference names them; tensors the callable closes over
(export's lifted constants) and the parameters of an ``nn.Module``
callable become constants too.  Weight preprocessing written in the
callable (transposes, quantization) stays graph ops, so compile-time
constant folding — and the naive mode's run-time cost for skipping it —
work exactly as for hand-built graphs.

Port of ``repro.frontend.importer`` onto ``torch.export``.  Export's own
no-op nodes (``aten._assert_tensor_metadata`` and the other assertions,
which newer torch releases insert) are skipped, and both spellings of a
dtype conversion (``aten.to.dtype``, ``aten._to_copy``) are read.  The
importer is target-independent: capability negotiation against the
``AcceleratorDescription`` happens in the partitioning pass.

``trace_batched`` exports once with a symbolic leading batch dim
(``torch.export.Dim``) and imports that one program per batch bucket,
substituting the bucket size for the symbol; batch 1 takes one static
export of its own.  A server with five buckets pays for two exports, not
five.
"""

from __future__ import annotations

import functools
import operator
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.core import ir
from repro_torch.core.batching import batched_shape

#: exported op -> IR construct it lowers to (the docs table and the
#: "supported ops" listing of ``UnsupportedExportError``)
SUPPORTED_OPS: dict[str, str] = {
    "repro_torch.dense": "dense (leading dims fold into M; a 3-D weight is a batched matmul)",
    "repro_torch.conv2d": "conv2d",
    "repro_torch.max_pool2d": "max_pool2d",
    "repro_torch.kv_cache_read": "kv_cache_read",
    "repro_torch.kv_cache_append": "kv_cache_append",
    "aten.permute": "transpose",
    "aten.t": "transpose",
    "aten.transpose": "transpose",
    "aten.numpy_T": "transpose",
    "aten.view": "reshape",
    "aten.reshape": "reshape",
    "aten.squeeze": "reshape (unit dims drop as a free view)",
    "aten.unsqueeze": "reshape",
    "aten.flatten": "reshape",
    "aten.add": "add / bias_add (broadcast 1-D bias idiom)",
    "aten.sub": "sub",
    "aten.mul": "mul / dequantize (to(float32) * scale idiom) / requantize interior",
    "aten.relu": "relu",
    "aten.clamp_min": "relu (clamp_min(x, 0))",
    "aten.maximum": "relu (maximum(x, 0))",
    "aten.gelu": "gelu (approximate='tanh')",
    "aten.softmax": "softmax",
    "aten._softmax": "softmax",
    "aten.clamp": "clip / quantize and requantize interior",
    "aten.to": "quantize / requantize chain sinks, dequantize",
    "aten._to_copy": "quantize / requantize chain sinks, dequantize",
    "aten.div": "quantize interior (round(x / scale) idiom)",
    "aten.round": "quantize / requantize interior",
}

#: ops that pass their operand through unchanged (a copy, or a lifted
#: constant's materialization)
_IDENTITY_OPS = {"aten.clone", "aten.detach", "aten.detach_", "aten.lift_fresh_copy"}
SUPPORTED_OPS.update((op, "(identity)") for op in _IDENTITY_OPS)

_RESHAPE_OPS = {"aten.view", "aten.reshape", "aten.squeeze", "aten.unsqueeze", "aten.flatten"}


class UnsupportedExportError(ValueError):
    """The exported callable uses constructs the frontend cannot import;
    ``.problems`` lists every one of them."""

    def __init__(self, name: str, problems: list[str]):
        self.problems = problems
        bullet = "\n  - ".join(problems)
        super().__init__(
            f"cannot import exported function {name!r} into core IR:\n  - {bullet}\n"
            f"(supported ops: {', '.join(sorted(SUPPORTED_OPS))})"
        )


@dataclass
class _Lit:
    """A Python scalar appearing inline in an op's arguments."""

    val: Any


@dataclass(eq=False)
class _Pending:
    """A low-level op held symbolically until an idiom consumes it;
    ``node`` memoizes its realization, so a value used twice is one IR
    node."""

    op: str
    args: list  # ir.Node | _Pending | _Lit
    shape: tuple
    dtype: str
    node: ir.Node | None = None


def _is_lit(x) -> bool:
    return isinstance(x, _Lit)


def _is_pend(x, op: str | None = None) -> bool:
    return isinstance(x, _Pending) and (op is None or x.op == op)


def _lit_and_other(a, b):
    """(literal, other operand) of a binary op, or (None, None)."""
    if _is_lit(a) and not _is_lit(b):
        return a, b
    if _is_lit(b) and not _is_lit(a):
        return b, a
    return None, None


def _is_int_dtype(dtype: str) -> bool:
    return dtype.startswith(("int", "uint"))


def dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def op_name(node) -> str:
    """``aten.clamp`` for ``torch.ops.aten.clamp.default``."""
    return str(node.target).rsplit(".", 1)[0]


def _bind(node) -> dict[str, Any]:
    """The node's arguments by schema name, defaults filled in."""
    schema = node.target._schema
    out = {}
    for i, a in enumerate(schema.arguments):
        if i < len(node.args):
            out[a.name] = node.args[i]
        elif a.name in node.kwargs:
            out[a.name] = node.kwargs[a.name]
        elif a.has_default_value():
            out[a.name] = a.default_value
    return out


def _skipped(node) -> bool:
    """Export's no-op nodes: tensor-metadata and shape assertions."""
    name = str(node.target)
    return not node.users and ("assert" in name or "constrain_range" in name)


@dataclass
class _Importer:
    name: str
    #: symbol -> size, for a program exported with symbolic dims
    sizes: dict = field(default_factory=dict)
    env: dict = field(default_factory=dict)
    problems: list[str] = field(default_factory=list)

    def concrete(self, value):
        """A plain Python scalar for an int or a symbolic size."""
        if isinstance(value, (torch.SymInt, torch.SymBool, torch.SymFloat)):
            kind = {torch.SymInt: int, torch.SymBool: bool, torch.SymFloat: float}[type(value)]
            return kind(value.node.expr.xreplace(self.sizes))
        return value

    # -- plumbing -----------------------------------------------------------
    def fail(self, msg: str, shape, dtype) -> ir.Node:
        """Record a problem and return a placeholder so the walk continues
        and every remaining problem is still collected."""
        if msg not in self.problems:
            self.problems.append(msg)
        return ir.Node("unsupported", [], shape=tuple(shape), dtype=str(dtype))

    def read(self, arg):
        if isinstance(arg, torch.fx.Node):
            return self.env[arg]
        if isinstance(arg, (bool, int, float)):
            return _Lit(arg)
        return arg

    def lit_const(self, lit: _Lit, dtype: str) -> ir.Node:
        return ir.const(np.asarray(lit.val, dtype=dtype))

    def realize(self, x, dtype: str | None = None) -> ir.Node:
        """Force a value into an IR node (raising idioms where possible);
        a literal becomes a constant of ``dtype``."""
        if isinstance(x, ir.Node):
            return x
        if _is_lit(x):
            return self.lit_const(x, dtype or np.asarray(x.val).dtype.name)
        assert isinstance(x, _Pending), x
        if x.node is None:
            x.node = self._realize_pending(x)
        return x.node

    def _realize_pending(self, x: _Pending) -> ir.Node:
        if x.op == "convert":
            src = self.realize(x.args[0])
            if x.dtype == src.dtype:
                return src
            if x.dtype == "float32" and _is_int_dtype(src.dtype):
                # plain to(float32): dequantize with unit scale is the
                # bit-exact IR spelling (convert then * 1.0)
                return ir.dequantize(src, scale=1.0)
            return self.fail(
                f"dtype conversion {src.dtype} -> {x.dtype} outside a "
                f"quantize/requantize chain",
                x.shape,
                x.dtype,
            )
        if x.op == "mul":
            lit, other = _lit_and_other(*x.args)
            if _is_pend(other, "convert"):
                node = self._match_dequantize(*x.args)
                if node is not None:
                    return node
            base = self.realize(other)
            if x.dtype == "float32" and _is_int_dtype(base.dtype):
                # int * python float promotes to float32: to(float32) * s
                return ir.dequantize(base, scale=float(lit.val))
            if base.dtype == x.dtype:
                return ir.mul(base, self.lit_const(lit, x.dtype))
            return self.fail(
                f"mul of {base.dtype} by a scalar gives {x.dtype}, which no IR op "
                f"computes; convert explicitly",
                x.shape,
                x.dtype,
            )
        return self.fail(
            f"{x.op!r} is only supported inside a recognized idiom "
            f"(quantize / requantize / dequantize)",
            x.shape,
            x.dtype,
        )

    # -- idiom matchers -----------------------------------------------------
    def _match_quant_chain(self, pend, out_dtype: str) -> ir.Node | None:
        """to(int) over clamp(round(...)): quantize (round of a division)
        or requantize (saturating round of a scaled value)."""
        if not _is_pend(pend, "clip"):
            return None
        inner, lo, hi = pend.args
        if not (_is_lit(lo) and _is_lit(hi) and _is_pend(inner, "round")):
            return None
        lo, hi = float(lo.val), float(hi.val)
        core = inner.args[0]
        if _is_pend(core, "div") and _is_lit(core.args[1]) and not _is_lit(core.args[0]):
            if (lo, hi) != (-128.0, 127.0):
                return None
            x = self.realize(core.args[0])
            return ir.quantize(x, scale=float(core.args[1].val), dtype=out_dtype)
        # requantize: round(x * scale) saturating to the out range
        scale, base = self._match_scaled(core)
        if base is None:
            return None
        info = np.iinfo(out_dtype)
        if (lo, hi) != (float(info.min), float(info.max)):
            return None
        return ir.requantize(base, scale=scale, out_dtype=out_dtype)

    def _match_scaled(self, x):
        """x * scale (x integer, promoted to float, or converted first): the
        interior of requantize.  A conversion-mul pair the ``mul`` handler
        already raised to a ``dequantize`` node unwraps too."""
        if isinstance(x, ir.Node) and x.op == "dequantize":
            return x.attrs["scale"], x.inputs[0]
        if _is_pend(x, "mul"):
            lit, other = _lit_and_other(*x.args)
            if lit is None:
                return None, None
            if _is_pend(other, "convert"):
                other = other.args[0]
            if isinstance(other, ir.Node):
                return float(lit.val), other
        return None, None

    def _match_dequantize(self, a, b) -> ir.Node | None:
        """mul(to(x, float32), scale) -> dequantize."""
        lit, other = _lit_and_other(a, b)
        if lit is None or not (_is_pend(other, "convert") and other.dtype == "float32"):
            return None
        src = other.args[0]
        if not (isinstance(src, ir.Node) and _is_int_dtype(src.dtype)):
            return None
        return ir.dequantize(src, scale=float(lit.val))

    def _match_bias_add(self, a: ir.Node, b: ir.Node, dtype: str) -> ir.Node | None:
        """add(x, b) with a 1-D bias over the last dim of a wider x."""
        for x, bias in ((a, b), (b, a)):
            if (
                len(bias.shape) == 1
                and len(x.shape) >= 2
                and x.shape[-1] == bias.shape[0]
                and x.dtype == dtype
            ):
                return ir.bias_add(x, bias)
        return None

    # -- per-node translation -----------------------------------------------
    def process(self, graph: torch.fx.Graph) -> list:
        """Walk every node; returns the realized graph outputs."""
        outputs = []
        for node in graph.nodes:
            if node.op == "placeholder":
                continue
            if node.op == "output":
                outputs = [self.read(a) for a in pytree.tree_leaves(node.args[0])]
                continue
            if node.op != "call_function" or _skipped(node):
                if node.op != "call_function":
                    self.problems.append(f"{node.op} node {node.name!r} is not supported")
                continue
            try:
                self.env[node] = self.call(node)
            except Exception as e:  # collect, placeholder, keep walking
                shape, dtype = self.meta(node)
                self.env[node] = self.fail(f"{op_name(node)}: {e}", shape, dtype)
        return outputs

    def meta(self, node) -> tuple[tuple[int, ...], str]:
        val = node.meta.get("val")
        if isinstance(val, torch.Tensor):
            return tuple(int(self.concrete(d)) for d in val.shape), dtype_name(val.dtype)
        return (), "float32"

    def call(self, node):
        val = node.meta.get("val")
        if isinstance(val, (torch.SymInt, torch.SymBool, torch.SymFloat)):
            # arithmetic on symbolic sizes (``x.shape[0]``): its value at
            # this import's sizes
            return _Lit(self.concrete(val))
        if node.target is operator.getitem:
            src, idx = self.read(node.args[0]), node.args[1]
            return src[idx]
        name = op_name(node)
        args = {k: self.read(v) for k, v in _bind(node).items()}
        vals = list(args.values())
        shape, dtype = self.meta(node)
        out = self.translate(name, args, vals, shape, dtype)
        if isinstance(out, ir.Node) and out.op != "unsupported" and (
            tuple(out.shape) != shape or out.dtype != dtype
        ):
            raise ValueError(
                f"the IR op {out.op!r} gives {out.dtype}{list(out.shape)} where torch "
                f"gives {dtype}{list(shape)}"
            )
        return out

    def translate(self, name: str, args: dict, vals: list, shape, dtype: str):
        pend = lambda op, operands: _Pending(op, operands, shape, dtype)  # noqa: E731
        if name in _IDENTITY_OPS:
            return vals[0]
        if name == "repro_torch.dense":
            x, w = (self.realize(v) for v in vals)
            return ir.dense(x, w, out_dtype=dtype)
        if name == "repro_torch.conv2d":
            x, w = self.realize(args["x"]), self.realize(args["w"])
            return ir.conv2d(
                x, w, stride=int(args["stride"].val), padding=int(args["padding"].val), out_dtype=dtype
            )
        if name == "repro_torch.max_pool2d":
            size = int(args["size"].val)
            stride = args.get("stride")
            stride = size if stride is None else int(stride.val)
            return ir.max_pool2d(self.realize(args["x"]), size=size, stride=stride)
        if name == "repro_torch.kv_cache_read":
            return ir.kv_cache_read(self.realize(vals[0]))
        if name == "repro_torch.kv_cache_append":
            cache, update, pos = (self.realize(v) for v in vals)
            return ir.kv_cache_append(cache, update, pos)
        if name in ("aten.permute", "aten.t", "aten.transpose", "aten.numpy_T"):
            x = self.realize(vals[0])
            rank = len(x.shape)
            if name == "aten.permute":
                perm = tuple(int(d) % rank for d in args["dims"])
            elif name == "aten.transpose":
                a, b = int(args["dim0"].val) % rank, int(args["dim1"].val) % rank
                perm = list(range(rank))
                perm[a], perm[b] = perm[b], perm[a]
            else:
                perm = tuple(reversed(range(rank)))
            return ir.transpose(x, tuple(perm))
        if name in _RESHAPE_OPS:
            # the exported shape is the new shape (-1 and squeezed dims
            # resolved): dropping or adding unit dims is a free view too
            return ir.reshape(self.realize(vals[0]), shape)
        if name in ("aten.add", "aten.sub"):
            if "alpha" in args and args["alpha"] is not None and float(args["alpha"].val) != 1.0:
                raise ValueError("add/sub with alpha != 1")
            a, b = (self.realize(v, dtype) for v in vals[:2])
            if name == "aten.add":
                node = self._match_bias_add(a, b, dtype)
                if node is not None:
                    return node
                return ir.add(a, b)
            return ir.sub(a, b)
        if name == "aten.mul":
            a, b = vals[:2]
            node = self._match_dequantize(a, b)
            if node is not None:
                return node
            lit, _ = _lit_and_other(a, b)
            if lit is not None:
                return pend("mul", [a, b])
            return ir.mul(self.realize(a), self.realize(b))
        if name == "aten.div":
            if args.get("rounding_mode") is not None:
                raise ValueError(f"div with rounding_mode={args['rounding_mode']!r}")
            return pend("div", vals[:2])
        if name == "aten.round":
            if "decimals" in args:
                raise ValueError("round with decimals")
            return pend("round", vals[:1])
        if name == "aten.clamp":
            x, lo, hi = args["self"], args.get("min"), args.get("max")
            if _is_pend(x, "round") and _is_lit(lo) and _is_lit(hi):
                return pend("clip", [x, lo, hi])
            node = self.realize(x)
            if _is_lit(lo) and _is_lit(hi):
                as_py = int if _is_int_dtype(node.dtype) else float
                return ir.clip(node, lo=as_py(lo.val), hi=as_py(hi.val))
            if _is_lit(lo) and hi is None and float(lo.val) == 0.0:
                return ir.relu(node)
            raise ValueError("clamp needs scalar bounds on both sides (or min=0 for relu)")
        if name == "aten.clamp_min":
            if not (_is_lit(args["min"]) and float(args["min"].val) == 0.0):
                raise ValueError("clamp_min other than 0")
            return ir.relu(self.realize(args["self"]))
        if name == "aten.relu":
            return ir.relu(self.realize(vals[0]))
        if name == "aten.maximum":
            for x, other in (vals[:2], vals[1::-1]):
                if (
                    isinstance(other, ir.Node)
                    and other.is_const()
                    and other.value.ndim == 0
                    and float(other.value) == 0.0
                ):
                    return ir.relu(self.realize(x))
            raise ValueError("maximum of two tensors (only maximum(x, 0) is relu)")
        if name == "aten.gelu":
            if args.get("approximate", "none") != "tanh":
                raise ValueError("gelu(approximate='none'): the IR's gelu is the tanh approximation")
            return ir.gelu(self.realize(vals[0]))
        if name in ("aten.softmax", "aten._softmax"):
            x = self.realize(vals[0])
            if name == "aten.softmax" and args.get("dtype") is not None:
                raise ValueError("softmax with a dtype")
            rank = len(x.shape)
            d = int(args["dim"].val) % rank
            return ir.softmax(x, axis=-1 if d == rank - 1 else d)
        if name in ("aten.to", "aten._to_copy"):
            src = vals[0]
            if _is_int_dtype(dtype):
                node = self._match_quant_chain(src, dtype)
                if node is not None:
                    return node
            return pend("convert", [src])
        raise ValueError("unsupported op")


def _numpy(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def _as_tensor(value) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value.detach()
    return torch.from_numpy(np.array(value))


class _Traced(torch.nn.Module):
    """``fn(*inputs)`` or ``fn(*inputs, params)``, with the param leaves as
    positional inputs of the export (so they stay graph inputs, bound to
    constants by the importer, rather than lifted closures)."""

    def __init__(self, fn, n_inputs: int, spec):
        super().__init__()
        self.fn = fn
        self.n_inputs = n_inputs
        self.spec = spec

    def forward(self, *args):
        inputs = args[: self.n_inputs]
        if self.spec is None:
            return self.fn(*inputs)
        return self.fn(*inputs, pytree.tree_unflatten(list(args[self.n_inputs :]), self.spec))


def _path_name(path) -> str:
    """The reference's parameter name: the path keys joined."""
    return "".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)


def import_exported(
    ep,
    *,
    input_names: list[str],
    param_leaves: list = (),
    param_names: list[str] = (),
    name: str = "traced",
    batch: int | None = None,
) -> ir.Graph:
    """Import an ``ExportedProgram`` whose user inputs are the graph
    inputs named by ``input_names`` followed by ``param_leaves`` (bound to
    constants named ``param_names``).  Lifted constants, parameters and
    buffers become constants named by their target.  ``batch`` is the
    size of the symbolic leading dim of the inputs, for a program that
    ``trace_batched`` exported with one."""
    from torch.export.graph_signature import InputKind

    imp = _Importer(name)
    placeholders = [n for n in ep.graph.nodes if n.op == "placeholder"]
    specs = ep.graph_signature.input_specs
    if len(placeholders) != len(specs):
        raise ValueError(f"{len(placeholders)} placeholders for {len(specs)} input specs")
    n_user = sum(s.kind == InputKind.USER_INPUT for s in specs)
    if n_user != len(input_names) + len(param_leaves):
        raise ValueError(
            f"exported {n_user} user inputs but got {len(input_names)} example "
            f"inputs + {len(param_leaves)} param leaves"
        )
    user = 0
    for ph, spec in zip(placeholders, specs):
        if spec.kind == InputKind.USER_INPUT:
            if user < len(input_names):
                lead = ph.meta["val"].shape[0] if ph.meta["val"].dim() else None
                if batch is not None and isinstance(lead, torch.SymInt):
                    imp.sizes[lead.node.expr] = batch
                shape, dtype = imp.meta(ph)
                imp.env[ph] = ir.input_(shape, dtype, name=input_names[user])
            else:
                j = user - len(input_names)
                imp.env[ph] = ir.const(_numpy(param_leaves[j]), name=param_names[j] or "")
            user += 1
        elif spec.kind == InputKind.CONSTANT_TENSOR:
            imp.env[ph] = ir.const(_numpy(ep.constants[spec.target]))
        elif spec.kind in (InputKind.PARAMETER, InputKind.BUFFER):
            value = ep.state_dict.get(spec.target, ep.constants.get(spec.target))
            imp.env[ph] = ir.const(_numpy(value), name=spec.target.removeprefix("fn."))
        else:
            imp.problems.append(f"input {ph.name!r} of kind {spec.kind.name} is not supported")
    outputs = [imp.realize(o) for o in imp.process(ep.graph)]
    if imp.problems:
        raise UnsupportedExportError(name, imp.problems)
    return ir.Graph(outputs, name=name)


def _export(fn, inputs: list[torch.Tensor], params, *, dynamic_batch: bool = False):
    """Export ``fn(*inputs)`` (or ``fn(*inputs, params)``) on the wrapper
    module; returns the program, the param leaves and their names.
    ``dynamic_batch`` makes the leading dim of every input one symbol of
    at least 2."""
    spec, leaves, names = None, [], []
    if params is not None:
        flat, spec = pytree.tree_flatten_with_path(params)
        leaves = [leaf for _, leaf in flat]
        names = [_path_name(path) for path, _ in flat]
    dynamic_shapes = None
    if dynamic_batch:
        batch = torch.export.Dim("batch", min=2)
        dynamic_shapes = (tuple([{0: batch}] * len(inputs) + [None] * len(leaves)),)
    ep = torch.export.export(
        _Traced(fn, len(inputs), spec),
        (*inputs, *[_as_tensor(v) for v in leaves]),
        dynamic_shapes=dynamic_shapes,
        strict=False,
    )
    return ep, leaves, names


def trace_model(
    fn,
    example_inputs: dict[str, Any],
    params: Any = None,
    *,
    name: str | None = None,
) -> ir.Graph:
    """Export ``fn(*inputs)`` (or ``fn(*inputs, params)``) with
    ``torch.export`` and import it into an ``ir.Graph``.

    ``example_inputs`` maps graph-input names to example arrays or tensors
    (only shape and dtype matter).  ``params`` is an optional tree (nested
    dicts, lists, tuples) of weight arrays or tensors; passing weights
    here (instead of closing over them) keeps their preprocessing as graph
    ops, and names each constant by its path in the tree.
    """
    inputs = [_as_tensor(v) for v in example_inputs.values()]
    ep, leaves, names = _export(fn, inputs, params)
    return import_exported(
        ep,
        input_names=list(example_inputs),
        param_leaves=leaves,
        param_names=names,
        name=name or getattr(fn, "__name__", "traced"),
    )


def trace_batched(
    fn,
    example_inputs: dict[str, Any],
    params: Any = None,
    *,
    name: str | None = None,
) -> tuple[ir.Graph, Callable[[int], ir.Graph]]:
    """The per-sample graph and a ``build(batch) -> ir.Graph`` for the
    batch buckets of ``fn``, from as few exports as the shapes allow.

    ``example_inputs`` are per-sample; bucket ``b`` widens each to
    ``batching.batched_shape(shape, b)``.  The callable is exported once
    with a symbolic leading dim of at least 2 on every input, and
    ``build(b)`` imports that program with the symbol set to ``b``.  Batch
    1 takes a static export of its own, since export traces a symbolic
    size as one that is not 1; the per-sample graph is imported from it
    where widening to 1 leaves every shape as it is, else it is a static
    export too.  A callable that fixes its batch size (so export refuses
    the symbolic dim) is exported once per bucket instead.
    """
    from torch._dynamo.exc import UserError, UserErrorType

    name = name or getattr(fn, "__name__", "traced")
    sample = {k: _as_tensor(v) for k, v in example_inputs.items()}

    def widened(b: int) -> list[torch.Tensor]:
        return [torch.zeros(batched_shape(tuple(v.shape), b), dtype=v.dtype) for v in sample.values()]

    try:
        dynamic = _export(fn, widened(2), params, dynamic_batch=True)
    except UserError as e:
        if e.error_type != UserErrorType.CONSTRAINT_VIOLATION:
            raise
        dynamic = None

    @functools.cache
    def static(b: int):
        return _export(fn, widened(b), params)

    def build(b: int) -> ir.Graph:
        ep, leaves, names = dynamic if b > 1 and dynamic is not None else static(b)
        return import_exported(
            ep, input_names=list(sample), param_leaves=leaves, param_names=names, name=name, batch=b
        )

    if all(batched_shape(tuple(v.shape), 1) == tuple(v.shape) for v in sample.values()):
        return build(1), build
    return trace_model(fn, sample, params, name=name), build
