"""Backend lowering: (node, strategy) -> executable callable.

Every accelerator step lowers to the scheduled GEMM kernel
(``repro_torch.kernels``): the schedule becomes the kernel config,
quantized ops take the int8 kernel with fused requant+clip, convs run
im2col first, batched 3-D denses replay the per-sample kernel per
instance, and the pool and residual epilogues the graph optimizer fuses
in run after the kernel, on the same device.

Epilogue attribute contract on generalized ops (set by the passes):

  * ``quantized`` + ``requant_scale``/``clip_lo``/``clip_hi`` — fused
    quantized epilogue;
  * ``activation`` — "relu" | "gelu" | None (float path);
  * ``transpose_b`` — the 2-D weight operand arrives transposed (folded
    layout transpose); the executor reads it as a view;
  * ``pool`` — ``{"size", "stride", "conv_shape"}``: max-pool the conv
    output (applied after the elementwise epilogue, exactly like the
    unfused graph);
  * ``residual`` — one extra trailing input added to the epilogued output
    (fused skip connection; applied last).

Port of ``repro.core.lowering``: ``kernel_config_for`` and the kernel
executor (the reference's ``_make_pallas_executor``), as the one
accelerator executor.  Where the kernel runs follows the tensors, which
lie on the module's device; there is no counterpart of
``pallas_interpret_mode``.  The numpy emulation of the reference's default
gemmini route (``_make_gemmini_executor``) waits for its slice.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.accel import AcceleratorDescription
from repro_torch.core.executor import im2col, max_pool2d, result_dtype
from repro_torch.core.ir import Node
from repro_torch.core.mapping import MappingGenerator
from repro_torch.core.strategy import Strategy
from repro_torch.kernels import ops as kops
from repro_torch.kernels.gemm import GemmKernelConfig
from repro_torch.kernels.ref import torch_dtype


def make_accel_executor(
    desc: AcceleratorDescription,
    mapping_gen: MappingGenerator,
    node: Node,
    strategy: Strategy,
) -> Callable:
    attrs = node.attrs
    fused_epilogue = resolved_fused_epilogue(node, strategy)
    if fused_epilogue:
        missing = [
            k
            for k in ("requant_scale", "clip_lo", "clip_hi")
            if attrs.get(k) is None
        ]
        if missing:
            source = (
                "node attrs"
                if attrs.get("quantized")
                else f"core compute {strategy.compute.tag!r}"
            )
            raise ValueError(
                f"{node.name}: quantized {node.op} (flag from {source}) is "
                f"missing required epilogue attrs {missing}; legalization "
                f"sets them when fusing requantize/clip, hand-built "
                f"generalized ops must provide them"
            )
    return _make_kernel_executor(desc, mapping_gen, node, strategy, fused_epilogue)


def resolved_fused_epilogue(node: Node, strategy: Strategy) -> bool:
    """ONE resolved fused-epilogue flag: an explicit node attr wins
    (legalization sets quantized=False on float fused ops), otherwise the
    bound core compute decides.  The fused requantize/clip epilogue exists
    only on generalized (legalized) ops — a raw dense/conv in naive mode
    keeps its epilogue as separate graph nodes."""
    node_flag = node.attrs.get("quantized")
    quantized = bool(
        strategy.compute.quantized if node_flag is None else node_flag
    )
    return quantized and node.op.startswith("generalized")


def kernel_config_for(
    desc: AcceleratorDescription,
    mapping_gen: MappingGenerator,
    node: Node,
    strategy: Strategy,
) -> GemmKernelConfig:
    """Derive the schedule-determined kernel config for one accelerator
    step — the single derivation the kernel executor binds."""
    attrs = node.attrs
    fused_quant = resolved_fused_epilogue(node, strategy)
    int_acc = node.inputs[0].dtype.startswith(("int", "uint"))
    if fused_quant:
        epilogue = {
            "requant_scale": attrs["requant_scale"],
            "clip_lo": attrs["clip_lo"],
            "clip_hi": attrs["clip_hi"],
        }
    else:
        epilogue = {"activation": attrs.get("activation")}
    out_dtype = node.dtype
    return mapping_gen.to_kernel_config(
        strategy.schedule,
        acc_dtype="int32" if (fused_quant or int_acc) else "float32",
        out_dtype=out_dtype if out_dtype != "float64" else "float32",
        epilogue=epilogue,
        has_bias=len(node.inputs) > 2 and node.inputs[2] is not None,
    )


def _make_kernel_executor(
    desc: AcceleratorDescription,
    mapping_gen: MappingGenerator,
    node: Node,
    strategy: Strategy,
    fused_quant: bool,
) -> Callable:
    """Lower one accelerator step to the scheduled GEMM/qGEMM kernel.

    Integer inputs always accumulate in int32 (not just the fused path):
    int32 accumulation wraps mod 2^32 identically to the reference's
    int64-accumulate-then-cast, so unfused naive-mode int GEMMs stay
    bit-exact.
    """
    attrs = node.attrs
    is_conv = node.op.endswith("conv2d")
    is_bmm = not is_conv and len(node.inputs[1].shape) == 3
    transpose_b = bool(attrs.get("transpose_b")) and not is_conv
    stride = attrs.get("stride", 1)
    padding = attrs.get("padding", 0)
    pool = attrs.get("pool")
    out_t = torch_dtype(node.dtype)
    pre_shape = tuple(pool["conv_shape"]) if pool else tuple(node.shape)
    cfg = kernel_config_for(desc, mapping_gen, node, strategy)
    residual_t = None
    if attrs.get("residual") and len(node.inputs) > 3:
        residual_t = result_dtype(node.dtype, node.inputs[3].dtype)

    def run2d(x, w, bias):
        if fused_quant:
            return kops.qmatmul(x, w, bias, cfg)
        return kops.matmul(x, w, cfg, bias)

    def kernel_exec(x, w, bias=None, residual=None):
        if is_conv:
            kh, kw, ci, co = w.shape
            out = run2d(im2col(x, kh, kw, stride, padding), w.reshape(kh * kw * ci, co), bias)
        elif is_bmm:
            wb = w.transpose(-2, -1) if transpose_b else w
            out = torch.stack([run2d(x[i], wb[i], bias) for i in range(x.shape[0])])
        else:
            out = run2d(x, w.T if transpose_b else w, bias)
        out = out.reshape(pre_shape).to(out_t)
        if pool:
            out = max_pool2d(out, pool["size"], pool["stride"])
        if residual is not None:
            out = out.to(residual_t) + residual.to(residual_t)
        return out

    kernel_exec.kernel_config = cfg
    return kernel_exec
