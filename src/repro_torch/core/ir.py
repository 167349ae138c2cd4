"""Graph IR — the Relay stand-in for the integration flow (paper §3.3).

A small typed op-graph: nodes carry an op name, input edges, attributes and
an output (shape, dtype).  The frontend builds it; legalization rewrites
quantized multi-op sequences into generalized operators; partitioning marks
accelerator-supported regions; constant folding evaluates const subgraphs
(including registered preprocessing) at compile time.

Ops are deliberately the ones the paper's flow deals with: quantized dense
and conv sequences (QNN dense -> bias_add -> requantize -> clip), layout
preprocessing (transpose / reshape / im2col / quantize), elementwise ops
the host executes, and the *generalized* fused operators the legalization
pass introduces.

Port of ``repro.core.ir``: the graph, the builders and the numpy reference
executor, which constant folding runs at compile time.  The collective,
shard and KV-cache ops (and ``CacheSpec``) wait for the sharded and decode
slices of the port.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any

import numpy as np

_counter = itertools.count()

# Ops the host side of a plan executes (torch ops on the module's device).
HOST_OPS = {
    "add",
    "sub",
    "mul",
    "relu",
    "gelu",
    "clip",
    "requantize",
    "quantize",
    "dequantize",
    "bias_add",
    "transpose",
    "reshape",
    "flatten",
    "im2col",
    "softmax",
    "max_pool2d",
}

# Multi-op sequences the legalizer fuses into these generalized operators.
GENERALIZED_OPS = {"generalized_dense", "generalized_conv2d"}


@dataclass
class Node:
    op: str
    inputs: list["Node"]
    attrs: dict[str, Any] = field(default_factory=dict)
    shape: tuple[int, ...] = ()
    dtype: str = "float32"
    name: str = ""
    # set by partitioning: "accel" or "host"
    target: str = "host"
    # constant payload for "const" nodes
    value: np.ndarray | None = None

    def __post_init__(self):
        if not self.name:
            self.name = f"{self.op}_{next(_counter)}"

    def is_const(self) -> bool:
        return self.op == "const"

    def __repr__(self):
        ins = ", ".join(i.name for i in self.inputs)
        return f"{self.name}: {self.op}({ins}) -> {self.dtype}{list(self.shape)} [{self.target}]"

    # hash/eq by identity so nodes can live in sets/dicts while mutable
    def __hash__(self):
        return id(self)

    def __eq__(self, other):
        return self is other


@dataclass
class Graph:
    """A single-output dataflow graph (multi-output via the outputs list).

    The topological order and the consumers map are cached: the rewrite
    engine and the passes walk them every round, and recomputing a full
    DFS per query made the old fixed-point loops O(n^2).  Anything that
    mutates graph structure *through the Graph API* (``replace_node``)
    invalidates the caches automatically; code that rewires ``Node.inputs``
    or reassigns ``outputs`` directly must call ``invalidate()``.
    """

    outputs: list[Node]
    name: str = "graph"
    _order: list[Node] | None = field(
        default=None, init=False, repr=False, compare=False
    )
    _consumers: dict[Node, list[Node]] | None = field(
        default=None, init=False, repr=False, compare=False
    )

    def invalidate(self) -> None:
        """Drop cached traversal state after a structural mutation."""
        self._order = None
        self._consumers = None

    def toposort(self) -> list[Node]:
        """Inputs-before-consumers order.  The returned list is the cache —
        treat it as read-only (it is replaced, never mutated, so iterating
        a snapshot across rewrites stays safe)."""
        if self._order is not None:
            return self._order
        seen: dict[Node, bool] = {}
        order: list[Node] = []

        def visit(n: Node):
            if n in seen:
                if not seen[n]:
                    raise ValueError("cycle in graph")
                return
            seen[n] = False
            for i in n.inputs:
                if i is not None:  # optional operands (e.g. absent bias)
                    visit(i)
            seen[n] = True
            order.append(n)

        for out in self.outputs:
            visit(out)
        self._order = order
        return order

    def nodes(self) -> list[Node]:
        return self.toposort()

    def inputs(self) -> list[Node]:
        return [n for n in self.toposort() if n.op == "input"]

    def consumers(self) -> dict[Node, list[Node]]:
        """Node -> consuming nodes (read-only; cached with the order)."""
        if self._consumers is not None:
            return self._consumers
        cons: dict[Node, list[Node]] = {n: [] for n in self.toposort()}
        for n in self.toposort():
            for i in n.inputs:
                if i is not None:
                    cons[i].append(n)
        self._consumers = cons
        return cons

    def replace_node(self, old: Node, new: Node) -> None:
        """Rewire every consumer of `old` to consume `new`."""
        for n in self.toposort():
            n.inputs = [new if i is old else i for i in n.inputs]
        self.outputs = [new if o is old else o for o in self.outputs]
        self.invalidate()

    def summary(self) -> str:
        lines = [f"graph {self.name}:"]
        for n in self.toposort():
            lines.append(f"  {n!r}")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# Builder API (what the frontend / examples use to construct graphs).
# ---------------------------------------------------------------------------


def input_(shape, dtype="float32", name="") -> Node:
    return Node("input", [], shape=tuple(shape), dtype=dtype, name=name or "")


def const(value: np.ndarray, name="") -> Node:
    value = np.asarray(value)
    return Node(
        "const",
        [],
        shape=tuple(value.shape),
        dtype=str(value.dtype),
        value=value,
        name=name or "",
    )


def _binary_shape(a: Node, b: Node) -> tuple[int, ...]:
    return np.broadcast_shapes(a.shape, b.shape)


def dense(x: Node, w: Node, **attrs) -> Node:
    """QNN/fp dense: x[..., C] @ w[C, K] (weights already in (C, K) layout).

    A 3-D ``w`` is the *batched* activation-activation matmul (attention
    scores/context with a leading batch dim): ``x[B, M, C] @ w[B, C, K]``.
    Weight-operand denses instead fold every leading dim of ``x`` into the
    GEMM M dimension, so a batched input IS the batched GEMM.
    """
    out_dtype = attrs.pop("out_dtype", "int32" if x.dtype.startswith("int") else x.dtype)
    if len(w.shape) == 3:
        if len(x.shape) != 3 or x.shape[0] != w.shape[0] or x.shape[-1] != w.shape[-2]:
            raise ValueError(f"batched dense shape mismatch {x.shape} @ {w.shape}")
        return Node(
            "dense",
            [x, w],
            attrs,
            shape=(x.shape[0], x.shape[1], w.shape[-1]),
            dtype=out_dtype,
        )
    if x.shape[-1] != w.shape[0]:
        raise ValueError(f"dense shape mismatch {x.shape} @ {w.shape}")
    return Node(
        "dense",
        [x, w],
        attrs,
        shape=(*x.shape[:-1], w.shape[1]),
        dtype=out_dtype,
    )


def conv2d(x: Node, w: Node, stride=1, padding=0, **attrs) -> Node:
    """NHWC conv with HWIO weights."""
    n, h, wd, c = x.shape
    kh, kw, ci, co = w.shape
    assert c == ci, (x.shape, w.shape)
    oh = (h + 2 * padding - kh) // stride + 1
    ow = (wd + 2 * padding - kw) // stride + 1
    out_dtype = attrs.pop("out_dtype", "int32" if x.dtype.startswith("int") else x.dtype)
    return Node(
        "conv2d",
        [x, w],
        {"stride": stride, "padding": padding, **attrs},
        shape=(n, oh, ow, co),
        dtype=out_dtype,
    )


def bias_add(x: Node, b: Node) -> Node:
    return Node("bias_add", [x, b], shape=x.shape, dtype=x.dtype)


def requantize(x: Node, scale: float, out_dtype="int8") -> Node:
    return Node("requantize", [x], {"scale": scale}, shape=x.shape, dtype=out_dtype)


def clip(x: Node, lo=-128, hi=127) -> Node:
    return Node("clip", [x], {"lo": lo, "hi": hi}, shape=x.shape, dtype=x.dtype)


def quantize(x: Node, scale: float, dtype="int8") -> Node:
    return Node("quantize", [x], {"scale": scale}, shape=x.shape, dtype=dtype)


def dequantize(x: Node, scale: float) -> Node:
    return Node("dequantize", [x], {"scale": scale}, shape=x.shape, dtype="float32")


def transpose(x: Node, perm=None) -> Node:
    perm = tuple(perm) if perm is not None else tuple(reversed(range(len(x.shape))))
    shape = tuple(x.shape[p] for p in perm)
    return Node("transpose", [x], {"perm": perm}, shape=shape, dtype=x.dtype)


def reshape(x: Node, shape) -> Node:
    return Node("reshape", [x], {"shape": tuple(shape)}, shape=tuple(shape), dtype=x.dtype)


def flatten(x: Node) -> Node:
    n = x.shape[0]
    rest = int(np.prod(x.shape[1:]))
    return reshape(x, (n, rest))


def relu(x: Node) -> Node:
    return Node("relu", [x], shape=x.shape, dtype=x.dtype)


def gelu(x: Node) -> Node:
    return Node("gelu", [x], shape=x.shape, dtype=x.dtype)


def max_pool2d(x: Node, size: int = 2, stride: int | None = None) -> Node:
    """NHWC max pooling with a square window (no padding)."""
    stride = size if stride is None else stride
    n, h, w, c = x.shape
    oh = (h - size) // stride + 1
    ow = (w - size) // stride + 1
    return Node(
        "max_pool2d",
        [x],
        {"size": size, "stride": stride},
        shape=(n, oh, ow, c),
        dtype=x.dtype,
    )


def softmax(x: Node, axis: int = -1) -> Node:
    out_dtype = "float32" if x.dtype.startswith(("int", "uint")) else x.dtype
    return Node("softmax", [x], {"axis": axis}, shape=x.shape, dtype=out_dtype)


def add(a: Node, b: Node) -> Node:
    return Node("add", [a, b], shape=_binary_shape(a, b), dtype=a.dtype)


def sub(a: Node, b: Node) -> Node:
    return Node("sub", [a, b], shape=_binary_shape(a, b), dtype=a.dtype)


def mul(a: Node, b: Node) -> Node:
    return Node("mul", [a, b], shape=_binary_shape(a, b), dtype=a.dtype)


# ---------------------------------------------------------------------------
# Reference executor (host semantics; used by tests and constant folding).
# ---------------------------------------------------------------------------


def gelu_ref(x: np.ndarray) -> np.ndarray:
    """The single gelu definition (tanh approximation) every execution path
    shares — the interpreter, the host-op fast path, and the fused
    generalized-op epilogues must be bit-identical."""
    xf = x.astype(np.float64)
    inner = np.sqrt(2.0 / np.pi) * (xf + 0.044715 * xf**3)
    return 0.5 * xf * (1.0 + np.tanh(inner))


def max_pool2d_ref(x: np.ndarray, size: int, stride: int) -> np.ndarray:
    """NHWC window max, exact for every dtype (pure comparisons)."""
    n, h, w, c = x.shape
    oh = (h - size) // stride + 1
    ow = (w - size) // stride + 1
    out = x[:, : oh * stride : stride, : ow * stride : stride, :]
    for i in range(size):
        for j in range(size):
            if i == 0 and j == 0:
                continue
            out = np.maximum(
                out, x[:, i : i + oh * stride : stride, j : j + ow * stride : stride, :]
            )
    return out


def execute_node(n: Node, inputs: list[np.ndarray]) -> np.ndarray:
    op = n.op
    if op == "const":
        return n.value
    if op == "dense":
        x, w = inputs
        if n.attrs.get("transpose_b"):
            w = w.swapaxes(-2, -1)
        return (x.astype(np.int64) @ w.astype(np.int64)).astype(n.dtype) if n.dtype.startswith("int") else (x @ w).astype(n.dtype)
    if op == "conv2d":
        x, w = inputs
        s, p = n.attrs["stride"], n.attrs["padding"]
        if p:
            x = np.pad(x, ((0, 0), (p, p), (p, p), (0, 0)))
        nb, h, wd, c = x.shape
        kh, kw, _, co = w.shape
        oh = (h - kh) // s + 1
        ow = (wd - kw) // s + 1
        acc_dt = np.int64 if n.dtype.startswith("int") else np.float64
        out = np.zeros((nb, oh, ow, co), dtype=acc_dt)
        for i in range(kh):
            for j in range(kw):
                patch = x[:, i : i + oh * s : s, j : j + ow * s : s, :].astype(acc_dt)
                out += np.einsum("nhwc,co->nhwo", patch, w[i, j].astype(acc_dt))
        return out.astype(n.dtype)
    if op == "bias_add":
        return (inputs[0].astype(np.int64) + inputs[1].astype(np.int64)).astype(n.dtype) if n.dtype.startswith("int") else inputs[0] + inputs[1]
    if op == "requantize":
        # TVM QNN semantics: scale then *saturating* cast to the out dtype.
        out = np.round(inputs[0].astype(np.float64) * n.attrs["scale"])
        if n.dtype.startswith("int") or n.dtype.startswith("uint"):
            info = np.iinfo(n.dtype)
            out = np.clip(out, info.min, info.max)
        return out.astype(n.dtype)
    if op == "clip":
        return np.clip(inputs[0], n.attrs["lo"], n.attrs["hi"]).astype(n.dtype)
    if op == "quantize":
        return np.clip(
            np.round(inputs[0] / n.attrs["scale"]), -128, 127
        ).astype(n.dtype)
    if op == "dequantize":
        return inputs[0].astype(np.float32) * n.attrs["scale"]
    if op == "transpose":
        return np.transpose(inputs[0], n.attrs["perm"])
    if op == "reshape":
        return inputs[0].reshape(n.attrs["shape"])
    if op == "flatten":
        return inputs[0].reshape(n.shape)
    if op == "relu":
        return np.maximum(inputs[0], 0)
    if op == "gelu":
        return gelu_ref(inputs[0]).astype(n.dtype)
    if op == "max_pool2d":
        return max_pool2d_ref(inputs[0], n.attrs["size"], n.attrs["stride"])
    if op == "softmax":
        ax = n.attrs.get("axis", -1)
        x = inputs[0].astype(np.float64)
        e = np.exp(x - np.max(x, axis=ax, keepdims=True))
        return (e / np.sum(e, axis=ax, keepdims=True)).astype(n.dtype)
    if op == "add":
        return inputs[0] + inputs[1]
    if op == "sub":
        return inputs[0] - inputs[1]
    if op == "mul":
        return inputs[0] * inputs[1]
    if op == "generalized_dense":
        x, w, b = inputs[:3]
        if n.attrs.get("transpose_b"):
            w = w.swapaxes(-2, -1)
        # integer operands always accumulate wide (the systolic-array
        # semantics); int32-wrapping on the final cast matches the unfused
        # dense + bias_add chain exactly (mod-2^32 addition commutes).
        if n.attrs.get("quantized") or x.dtype.kind in "iu":
            acc = x.astype(np.int64) @ w.astype(np.int64)
        else:
            acc = x @ w
        if b is not None:
            acc = acc + b
        if n.attrs.get("quantized"):
            acc = np.round(acc.astype(np.float64) * n.attrs["requant_scale"])
            acc = np.clip(acc, n.attrs["clip_lo"], n.attrs["clip_hi"])
        elif n.attrs.get("activation") == "relu":
            acc = np.maximum(acc, 0)
        elif n.attrs.get("activation") == "gelu":
            acc = gelu_ref(acc)
        out = acc.astype(n.dtype)
        if len(inputs) > 3 and inputs[3] is not None:
            out = out + inputs[3]  # fused residual epilogue
        return out
    if op == "generalized_conv2d":
        # evaluated through its dense form after im2col by the executor
        raise NotImplementedError("generalized_conv2d executes via backend lowering")
    raise NotImplementedError(f"execute_node: {op}")


def execute_graph(graph: Graph, feeds: dict[str, np.ndarray]) -> list[np.ndarray]:
    vals: dict[Node, np.ndarray] = {}
    for n in graph.toposort():
        if n.op == "input":
            if n.name not in feeds:
                raise KeyError(f"missing feed for input {n.name!r}")
            vals[n] = np.asarray(feeds[n.name])
        else:
            vals[n] = execute_node(n, [vals[i] if i is not None else None for i in n.inputs])
    return [vals[o] for o in graph.outputs]
