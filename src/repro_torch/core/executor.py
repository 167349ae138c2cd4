"""The planned graph executor: host-op compilation, the slot-indexed
execution plan, and the compiled module (execution + cycle model).

Everything a plan executes is torch on the module's device.  Constants
(folded weight panels, biases) are copied to the device once, when the
plan is built; feeds are converted once, on entry; outputs come back as
numpy arrays, as the reference returns them.

Port of ``repro.core.executor``: ``ExecutionPlan`` with its build-time
stage assignment, ``build_plan``, ``CompiledModule.run``/``run_many``
(sequential; ``pipelined=True`` runs the same loop), ``FeedError``, ``input_signature``,
``modeled_cycles`` and ``schedules``.  The per-node interpreter
(``use_plan=False``) and the collective and KV-cache ops wait for their
slices.  Host ops are torch ops with every cast written out: numpy 2 and
torch promote differently, so each op computes in the dtype numpy's
promotion would give, decided when the plan is built.

``pipelined=True`` keeps the reference's signature and its build-time
stage assignment (each step's lane and cross-lane watermark, which the
artifact manifest records), and runs the sequential loop: the same fns on
the same operands, so the same launches and bit-exact outputs.  The
reference overlaps its two lanes on two threads; in the port both lanes
issue work onto one card from GIL-bound Python, and a two-thread version
of that design ran 1.8-3.9x slower than the sequential loop on an H100
wherever both lanes had steps (``PERF.md``).  A lane design that wins
(one stream per lane) is still open.

A dense or conv that the description leaves on the host runs here, as
the reference's ``ir.execute_node`` computes it, only on the CPU: on a
card it would be a plain GEMM beside the kernel, so a module on ``cuda``
refuses it when its plan is built, at compile or load time.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.accel import AcceleratorDescription
from repro_torch.core.ir import Graph, Node
from repro_torch.core.simulator import simulate
from repro_torch.core.strategy import Strategy, dtype_bytes, gemm_instances
from repro_torch.kernels.ref import torch_dtype

# Zero-copy view ops: free in the cycle model (no data movement, the host
# just reinterprets the buffer).  One canonical set so the cycle model and
# the layout-op class below can never disagree about what a view is.
FREE_VIEW_OPS = {"reshape", "flatten"}

# host-op cost classes for the cycle model
_LAYOUT_OPS = {"transpose", "im2col", "quantize"} | FREE_VIEW_OPS
_EPILOGUE_OPS = {
    "requantize",
    "clip",
    "bias_add",
    "dequantize",
    "relu",
    "gelu",
    "add",
    "sub",
    "mul",
    "softmax",
    "max_pool2d",
}


def result_dtype(*dtypes: str) -> torch.dtype:
    """The dtype numpy's promotion gives for arrays of these dtypes."""
    try:
        return torch_dtype(str(np.result_type(*[np.dtype(d) for d in dtypes])))
    except TypeError:  # bfloat16 has no numpy dtype here
        out = torch_dtype(dtypes[0])
        for d in dtypes[1:]:
            out = torch.promote_types(out, torch_dtype(d))
        return out


def _float_result(dtype: str) -> torch.dtype:
    """numpy's dtype for ``array op python_float``: a float array keeps its
    dtype, anything else becomes float64."""
    t = torch_dtype(dtype)
    return t if t.is_floating_point else torch.float64


def max_pool2d(x: torch.Tensor, size: int, stride: int) -> torch.Tensor:
    """NHWC window max, exact for every dtype (pure comparisons); the
    reference's ``ir.max_pool2d_ref`` on tensors."""
    _, h, w, _ = x.shape
    oh = (h - size) // stride + 1
    ow = (w - size) // stride + 1
    out = x[:, : oh * stride : stride, : ow * stride : stride, :]
    for i in range(size):
        for j in range(size):
            if i == 0 and j == 0:
                continue
            out = torch.maximum(
                out, x[:, i : i + oh * stride : stride, j : j + ow * stride : stride, :]
            )
    return out


@dataclass
class CompiledOp:
    node: Node
    strategy: Strategy
    executor: Callable[..., torch.Tensor]


def compile_host_op(n: Node, device: torch.device) -> Callable[..., torch.Tensor]:
    """Specialize one host op into a torch closure on ``device``, with the
    semantics of the reference's ``compile_host_op`` (numpy): scalars are
    device tensors of the dtype numpy would compute in, and every result
    is cast to the dtype the numpy expression yields."""
    op, attrs = n.op, n.attrs
    dt = torch_dtype(n.dtype)
    in_dtypes = [i.dtype for i in n.inputs if i is not None]

    def scalar(value, dtype: torch.dtype) -> torch.Tensor:
        return torch.tensor(value, dtype=dtype, device=device)

    if op == "relu":
        return lambda x: torch.clamp_min(x, 0)
    if op == "gelu":
        c = scalar(math.sqrt(2.0 / math.pi), torch.float64)

        def _gelu(x):
            xf = x.to(torch.float64)
            inner = c * (xf + 0.044715 * torch.pow(xf, 3))
            return (0.5 * xf * (1.0 + torch.tanh(inner))).to(dt)

        return _gelu
    if op in ("add", "sub", "mul"):
        rt = result_dtype(*in_dtypes)
        fn = {"add": torch.add, "sub": torch.sub, "mul": torch.mul}[op]
        return lambda a, b: fn(a.to(rt), b.to(rt))
    if op == "clip":
        lo, hi = attrs["lo"], attrs["hi"]
        return lambda x: torch.clamp(x, lo, hi).to(dt)
    if op == "requantize":
        scale = scalar(attrs["scale"], torch.float64)
        if n.dtype.startswith(("int", "uint")):
            info = np.iinfo(n.dtype)
            lo, hi = int(info.min), int(info.max)
            return lambda x: torch.clamp(
                torch.round(x.to(torch.float64) * scale), lo, hi
            ).to(dt)
        return lambda x: torch.round(x.to(torch.float64) * scale).to(dt)
    if op == "quantize":
        qt = _float_result(in_dtypes[0])
        scale = scalar(attrs["scale"], qt)
        return lambda x: torch.clamp(torch.round(x.to(qt) / scale), -128, 127).to(dt)
    if op == "dequantize":
        scale = scalar(attrs["scale"], torch.float32)
        return lambda x: x.to(torch.float32) * scale
    if op == "transpose":
        perm = tuple(attrs["perm"])
        return lambda x: x.permute(perm)
    if op in FREE_VIEW_OPS:
        shape = tuple(attrs["shape"] if op == "reshape" else n.shape)
        return lambda x: x.reshape(shape)
    if op == "max_pool2d":
        size, stride = attrs["size"], attrs["stride"]
        return lambda x: max_pool2d(x, size, stride)
    if op == "bias_add":
        if n.dtype.startswith("int"):
            return lambda x, b: (x.to(torch.int64) + b.to(torch.int64)).to(dt)
        rt = result_dtype(*in_dtypes)
        return lambda x, b: x.to(rt) + b.to(rt)
    if op == "softmax":
        ax = attrs.get("axis", -1)

        def _softmax(x):
            xf = x.to(torch.float64)
            e = torch.exp(xf - torch.amax(xf, dim=ax, keepdim=True))
            return (e / torch.sum(e, dim=ax, keepdim=True)).to(dt)

        return _softmax
    if op in ("dense", "conv2d") and device.type != "cpu":
        raise NotImplementedError(
            f"{n.name}: {op} {list(n.shape)} ({n.dtype}) is left on the host, "
            f"and the port runs no plain GEMM on {device.type}: use a description "
            f"that offloads it, or compile for the CPU"
        )
    if op == "dense":
        transpose_b = bool(attrs.get("transpose_b"))

        def _dense(x, w):
            return _host_matmul(x, w.transpose(-2, -1) if transpose_b else w, dt)

        return _dense
    if op == "conv2d":
        stride, padding = attrs["stride"], attrs["padding"]

        def _conv(x, w):
            kh, kw, ci, co = w.shape
            cols = im2col(x, kh, kw, stride, padding)
            out = _host_matmul(cols, w.reshape(kh * kw * ci, co), dt)
            oh = (x.shape[1] + 2 * padding - kh) // stride + 1
            ow = (x.shape[2] + 2 * padding - kw) // stride + 1
            return out.reshape(x.shape[0], oh, ow, co)

        return _conv
    raise NotImplementedError(
        f"{n.name}: host op {op!r} has no torch lowering in the port yet"
    )


def _host_matmul(x: torch.Tensor, w: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """A dense or conv left on the host (CPU tensors only), as the
    reference's ``ir.execute_node`` computes it: integers accumulate
    exactly in int64 and cast to the node's dtype; floats multiply in
    their own dtype."""
    if dt.is_floating_point:
        return (x @ w).to(dt)
    return (x.to(torch.int64) @ w.to(torch.int64)).to(dt)


def im2col(x: torch.Tensor, kh: int, kw: int, stride: int, padding: int) -> torch.Tensor:
    """NHWC patches as GEMM rows: row (b, i, j), columns (kh, kw, c) — the
    reference's ``_im2col`` order — so the conv is exactly the scheduled
    GEMM with HWIO weights flattened to (kh*kw*ci, co) (§3.2)."""
    if padding:
        n, h, wd, c = x.shape
        xp = x.new_zeros((n, h + 2 * padding, wd + 2 * padding, c))
        xp[:, padding : padding + h, padding : padding + wd, :] = x
        x = xp
    n, _, _, c = x.shape
    cols = x.unfold(1, kh, stride).unfold(2, kw, stride)  # n, oh, ow, c, kh, kw
    oh, ow = cols.shape[1], cols.shape[2]
    return cols.permute(0, 1, 2, 4, 5, 3).reshape(n * oh * ow, kh * kw * c)


class FeedError(KeyError, ValueError):
    """A ``run``/``run_many`` feeds dict does not match the module's input
    signature; the message lists every unknown and missing name plus the
    expected signature.  Subclasses ``KeyError`` so callers catching a
    missing-feed error keep working."""

    def __init__(self, message: str):
        self.message = message
        super().__init__(message)

    def __str__(self):  # KeyError would repr() the message
        return self.message


# arena slot 0 permanently holds None so optional (absent) operands can be
# addressed like any other input slot.
_NONE_SLOT = 0


def to_tensor(value, device: torch.device) -> torch.Tensor:
    """One numpy value as a tensor on ``device`` (one copy at most)."""
    arr = np.asarray(value)
    if not arr.flags.writeable or not arr.flags.c_contiguous:
        arr = np.array(arr, order="C")
    return torch.from_numpy(arr).to(device)


@dataclass
class PlanStep:
    """One computed node: write ``fn(*arena[arg_slots])`` into ``slot``.

    ``lane`` is the pipeline stage the step is assigned to at plan-build
    time: ``"accel"`` for accelerator-offloaded steps, ``"host"`` for
    everything else (see ``ExecutionPlan.stage_assignment``)."""

    slot: int
    fn: Callable[..., torch.Tensor]
    arg_slots: tuple[int, ...]
    op: str
    name: str
    lane: str = "host"


@dataclass
class ExecutionPlan:
    """Compile-time execution plan: topological op order, input/output slot
    indices, and pre-resolved per-step callables over a flat buffer arena.

    ``CompiledModule.run`` walks ``steps`` as a flat loop — no graph
    traversal, no dict-of-Node hashing, no per-call op dispatch.  The
    constants are device tensors made once, here, and every arena shares
    them.

    Steps additionally carry the reference's dependency-aware *stage
    assignment*, computed here at build time: each step belongs to a lane
    (``host`` / ``accel``) and records the cross-lane watermark a two-lane
    executor would wait for (how many steps of the *other* lane must have
    run before its operands exist)."""

    device: torch.device
    n_slots: int
    input_slots: tuple[tuple[str, int], ...]  # (feed name, arena slot)
    const_slots: tuple[tuple[int, torch.Tensor], ...]
    steps: tuple[PlanStep, ...]
    output_slots: tuple[int, ...]

    def __post_init__(self):
        # flat (slot, fn, arg_slots) triples: the hot loop avoids dataclass
        # attribute lookups entirely.
        self._fast_steps = tuple((s.slot, s.fn, s.arg_slots) for s in self.steps)
        # stage assignment: split steps into the two lanes, preserving topo
        # order within each, and compute per-step cross-lane watermarks.
        producer: dict[int, tuple[str, int]] = {}  # slot -> (lane, ordinal)
        lanes: dict[str, list[int]] = {"host": [], "accel": []}
        for s in self.steps:
            lane = s.lane if s.lane in lanes else "host"
            other = "accel" if lane == "host" else "host"
            need = 0
            for a in s.arg_slots:
                p = producer.get(a)
                if p is not None and p[0] == other:
                    need = max(need, p[1] + 1)
            producer[s.slot] = (lane, len(lanes[lane]))
            lanes[lane].append(need)
        self._lane_waits = {k: tuple(v) for k, v in lanes.items()}

    def new_arena(self) -> list:
        arena: list = [None] * self.n_slots
        for slot, value in self.const_slots:
            arena[slot] = value
        return arena

    def execute(self, feeds: dict[str, np.ndarray], arena: list) -> list[torch.Tensor]:
        for name, slot in self.input_slots:
            try:
                arena[slot] = to_tensor(feeds[name], self.device)
            except KeyError:
                raise KeyError(f"missing feed for input {name!r}") from None
        for slot, fn, arg_slots in self._fast_steps:
            arena[slot] = fn(*[arena[i] for i in arg_slots])
        return [arena[i] for i in self.output_slots]

    # -- stage assignment -----------------------------------------------------
    def stage_assignment(self) -> tuple[dict, ...]:
        """The build-time pipeline stage of every step: ``(name, op, lane,
        cross-lane watermark)`` — introspection for tests, docs, and the
        artifact manifest."""
        out = []
        counts = {"host": 0, "accel": 0}
        for s in self.steps:
            lane = s.lane if s.lane in counts else "host"
            other = "accel" if lane == "host" else "host"
            need = self._lane_waits[lane][counts[lane]]
            counts[lane] += 1
            out.append({"name": s.name, "op": s.op, "lane": lane, f"waits_{other}": need})
        return tuple(out)

    def lane_sizes(self) -> dict[str, int]:
        return {k: len(v) for k, v in self._lane_waits.items()}


def build_plan(
    graph: Graph, ops: dict[Node, CompiledOp], device: torch.device
) -> ExecutionPlan:
    """Lower a compiled graph to its execution plan (one toposort, ever)."""
    order = graph.toposort()
    slot_of: dict[Node, int] = {n: i + 1 for i, n in enumerate(order)}
    input_slots: list[tuple[str, int]] = []
    const_slots: list[tuple[int, torch.Tensor]] = []
    steps: list[PlanStep] = []
    for n in order:
        slot = slot_of[n]
        if n.op == "input":
            input_slots.append((n.name, slot))
        elif n.op == "const":
            const_slots.append((slot, to_tensor(n.value, device)))
        else:
            arg_slots = tuple(
                _NONE_SLOT if i is None else slot_of[i] for i in n.inputs
            )
            fn = ops[n].executor if n in ops else compile_host_op(n, device)
            lane = "accel" if n in ops else "host"
            steps.append(PlanStep(slot, fn, arg_slots, n.op, n.name, lane))
    return ExecutionPlan(
        device=device,
        n_slots=len(order) + 1,
        input_slots=tuple(input_slots),
        const_slots=tuple(const_slots),
        steps=tuple(steps),
        output_slots=tuple(slot_of[o] for o in graph.outputs),
    )


def to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


@dataclass
class CompiledModule:
    graph: Graph
    desc: AcceleratorDescription
    mode: str
    device: torch.device
    ops: dict[Node, CompiledOp] = field(default_factory=dict)
    # built once by compile(); None only for hand-assembled modules.
    plan: ExecutionPlan | None = None
    #: PipelineReport from the PassManager run that lowered the graph
    pass_report: Any = None
    #: the CompilerBackend that produced this module
    backend: Any = field(default=None, repr=False)
    _feed_names: frozenset | None = field(default=None, repr=False)

    # -- input signature / feed validation ----------------------------------
    def input_signature(self) -> tuple[tuple[str, tuple[int, ...], str], ...]:
        """(name, shape, dtype) for every graph input, in topological order."""
        return tuple((n.name, n.shape, n.dtype) for n in self.graph.inputs())

    def _check_feeds(self, feeds: dict[str, np.ndarray]) -> None:
        """Validate feeds up front against the input signature: ONE error
        listing every unknown name, missing name, and shape/dtype mismatch."""
        if self._feed_names is None:
            self._feed_names = frozenset(n.name for n in self.graph.inputs())
        problems = []
        if feeds.keys() != self._feed_names:
            for name in sorted(self._feed_names - feeds.keys()):
                problems.append(f"missing feed for input {name!r}")
            for name in sorted(feeds.keys() - self._feed_names):
                problems.append(f"unknown feed {name!r}")
        for name, shape, dtype in self.input_signature():
            if name not in feeds:
                continue
            value = np.asarray(feeds[name])
            if value.shape != shape or str(value.dtype) != dtype:
                problems.append(
                    f"feed {name!r} is {value.dtype}{list(value.shape)}, "
                    f"expected {dtype}{list(shape)}"
                )
        if not problems:
            return
        sig = ", ".join(
            f"{name}: {dtype}{list(shape)}"
            for name, shape, dtype in self.input_signature()
        )
        bullet = "\n  - ".join(problems)
        raise FeedError(
            f"feeds do not match the module's inputs:\n  - {bullet}\n"
            f"expected inputs: {sig or '<none>'}"
        )

    # -- execution ---------------------------------------------------------
    def finalize(self) -> ExecutionPlan:
        """Build (or return) the execution plan."""
        if self.plan is None:
            self.plan = build_plan(self.graph, self.ops, self.device)
        return self.plan

    def run(
        self, feeds: dict[str, np.ndarray], *, pipelined: bool = False
    ) -> list[np.ndarray]:
        """Execute the module on its device; outputs come back as numpy.
        ``pipelined=True`` runs the same sequential loop (see the module
        docstring)."""
        self._check_feeds(feeds)
        plan = self.finalize()
        return [to_numpy(t) for t in plan.execute(feeds, plan.new_arena())]

    def run_many(
        self,
        feeds_list: list[dict[str, np.ndarray]],
        *,
        pipelined: bool = False,
    ) -> list[list[np.ndarray]]:
        """Repeated invocation over a list of feeds (serving-style traffic):
        one arena for the whole loop, every call enqueued before the first
        result is copied back.  ``pipelined=True`` runs the same loop (see
        the module docstring)."""
        for feeds in feeds_list:
            self._check_feeds(feeds)
        plan = self.finalize()
        arena = plan.new_arena()
        outs = [plan.execute(feeds, arena) for feeds in feeds_list]
        return [[to_numpy(t) for t in call] for call in outs]

    # -- cycle model ---------------------------------------------------------
    def modeled_cycles(self) -> dict[str, float]:
        """Total modeled cycles: accelerator ops via the schedule simulator,
        residual host ops (unfolded preprocessing / unfused epilogues in
        naive mode) via per-byte host costs.  ``comm`` (collectives of
        sharded plans) is zero until the sharded slice."""
        arch = self.desc.arch
        accel = 0.0
        host = 0.0
        fused = self.mode != "naive"
        for n in self.graph.toposort():
            if n in self.ops:
                rep = simulate(
                    self.ops[n].strategy.schedule,
                    arch,
                    folded_preprocessing=True,  # graph structure carries it
                    fused_loop_instructions=fused,
                )
                # batched matmuls replay the scheduled per-sample GEMM once
                # per batch instance; everything else folds batch into M
                # and is already covered by the schedule itself.
                accel += rep.total_cycles * gemm_instances(n)
            elif n.op in _LAYOUT_OPS and n.op not in FREE_VIEW_OPS:
                nbytes = math.prod(n.shape) * dtype_bytes(n.dtype)
                host += nbytes * arch.host_preproc_cycles_per_byte
            elif n.op in _EPILOGUE_OPS:
                in_bytes = (
                    math.prod(n.inputs[0].shape) * dtype_bytes(n.inputs[0].dtype)
                    if n.inputs
                    else 0
                )
                host += in_bytes * arch.host_epilogue_cycles_per_byte
        return {
            "accel": accel,
            "host": host,
            "comm": 0.0,
            "total": accel + host,
        }

    def schedules(self) -> dict[str, Any]:
        return {
            n.name: op.strategy.schedule.to_dict() for n, op in self.ops.items()
        }
