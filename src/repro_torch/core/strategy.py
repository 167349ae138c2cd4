"""Strategy Generator (paper §3.3).

Binds the user-defined computation function (from the functional
description) and a schedule to each accelerator-supported operator.  The
paper's insight: UMA bypasses TE scheduling, so scheduling happens at the
TIR level via the Mapping Generator — here, the Strategy carries the
workload extracted from the graph node plus the extended-CoSA schedule the
backend resolved for it.

Port of ``repro.core.strategy``: plain Python and numpy, copied with import changes
only unless noted here.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from repro_torch.core.accel import AcceleratorDescription, CoreComputeDef
from repro_torch.core.arch_spec import GemmWorkload
from repro_torch.core.ir import Node
from repro_torch.core.scheduler import ScheduleResult


_DTYPE_BYTES = {
    "int8": 1,
    "uint8": 1,
    "int16": 2,
    "bfloat16": 2,
    "float16": 2,
    "int32": 4,
    "float32": 4,
    "int64": 8,
    "float64": 8,
}


def dtype_bytes(dtype: str) -> int:
    return _DTYPE_BYTES.get(dtype, 4)


def gemm_instances(node: Node) -> int:
    """How many independent GEMM instances the node executes per call.

    1 for everything except the batched activation-activation matmul
    (3-D weight operand), whose leading dims are block-diagonal batch
    instances that cannot fold into M — the executor replays the scheduled
    per-sample GEMM once per instance, and the cycle model charges it as
    many times."""
    base = node.op.replace("generalized_", "")
    if base == "dense" and len(node.inputs[1].shape) == 3:
        return node.inputs[0].shape[0]
    return 1


def workload_from_node(node: Node) -> GemmWorkload:
    """Extract the GEMM workload of a (generalized) dense/conv node.

    Weight-operand denses fold every leading input dim (the serving batch
    included) into the GEMM M dimension, so the scheduler sees the batched
    shape as ONE workload.  Batched matmuls (3-D weight) schedule the
    per-sample GEMM; see ``gemm_instances``."""
    x, w = node.inputs[0], node.inputs[1]
    base = node.op.replace("generalized_", "")
    if base == "dense" and len(w.shape) == 3:
        # batched matmul: x[B, M, C] @ w[B, C, K]
        n_dim = x.shape[-2]
        c_dim = x.shape[-1]
        k_dim = w.shape[-2] if node.attrs.get("transpose_b") else w.shape[-1]
    elif base == "dense":
        n_dim = math.prod(x.shape[:-1])
        c_dim = x.shape[-1]
        # a folded layout transpose (transpose_b) means the 2-D weight
        # operand arrives as (K, C); the effective GEMM is unchanged.
        k_dim = w.shape[-2] if node.attrs.get("transpose_b") else w.shape[-1]
    elif base == "conv2d":
        stride = node.attrs.get("stride", 1)
        padding = node.attrs.get("padding", 0)
        nb, h, wd, ci = x.shape
        kh, kw, _, co = w.shape
        oh = (h + 2 * padding - kh) // stride + 1
        ow = (wd + 2 * padding - kw) // stride + 1
        n_dim = nb * oh * ow
        c_dim = kh * kw * ci
        k_dim = co
    else:
        raise ValueError(f"not a GEMM-family node: {node.op}")
    # accumulator width: int32 for quantized, f32 otherwise
    quantized = node.attrs.get("quantized", False) or x.dtype.startswith("int")
    return GemmWorkload(
        N=n_dim,
        C=c_dim,
        K=k_dim,
        in_bytes=dtype_bytes(x.dtype),
        w_bytes=dtype_bytes(w.dtype),
        out_bytes=4 if quantized else dtype_bytes(node.dtype),
        name=node.name,
    )


@dataclass
class Strategy:
    """Lowering strategy for one accelerator-offloaded operator."""

    node: Node
    compute: CoreComputeDef
    workload: GemmWorkload
    schedule_result: ScheduleResult

    @property
    def schedule(self):
        return self.schedule_result.best


@dataclass
class StrategyGenerator:
    desc: AcceleratorDescription

    def generate(self, node: Node, schedule_result: ScheduleResult) -> Strategy:
        base = node.op.replace("generalized_", "")
        compute = self.desc.compute_for_op(base)
        return Strategy(
            node=node,
            compute=compute,
            workload=workload_from_node(node),
            schedule_result=schedule_result,
        )
