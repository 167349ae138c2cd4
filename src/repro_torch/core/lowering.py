"""Backend lowering: (node, strategy) -> executable callable.

Two routes, as in the reference:

  * **kernel** (``use_pallas=True``, the port's default; ``tpu*``
    descriptions always): the schedule becomes the config of the
    scheduled GEMM kernel (``repro_torch.kernels``), quantized ops take the
    int8 kernel with fused requant+clip, convs run im2col first, batched
    3-D denses replay the per-sample kernel per instance;
  * **emulated** (``use_pallas=False``): the tensorized tiled loop nest
    over the description's registered compute intrinsic
    (``MappingGenerator.to_tiled_executor``), with the fused epilogue in
    float64 as the reference's emulation computes it, and plan-time
    specialization over constant operands (pre-padded weight panels, bias
    preloaded as the initial accumulator tile).

On both routes the pool and residual epilogues the graph optimizer fuses
in run after the GEMM, on the same device.

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

Port of ``repro.core.lowering``: ``kernel_config_for``, the kernel
executor (the reference's ``_make_pallas_executor``) and the emulated
executor ``_make_gemmini_executor``, whose tiles are torch tensors on the
module's device: no step of it copies to the host.  Where the kernel
runs follows the tensors; there is no counterpart of
``pallas_interpret_mode``.  The two routes can differ where the
requantize rounds: the kernel requantizes in float32, the emulated route
in float64 (an accumulator above 2^24, or a scale that is not
float32-exact).
"""

from __future__ import annotations

import threading
from typing import Callable

import numpy as np
import torch

from repro_torch.core.accel import AcceleratorDescription
from repro_torch.core.executor import gelu64, im2col, max_pool2d, result_dtype, to_numpy
from repro_torch.core.intrinsics import HardwareIntrinsicGenerator
from repro_torch.core.ir import Node
from repro_torch.core.mapping import MappingGenerator
from repro_torch.core.strategy import Strategy
from repro_torch.kernels import ops as kops
from repro_torch.kernels.gemm import GemmKernelConfig
from repro_torch.kernels.ref import torch_dtype

#: largest |value| of the integer dtypes whose products a float64 matmul
#: sums exactly (while K * the largest product stays below 2^53)
_F64_EXACT_MAX = {"int8": 2**7, "uint8": 2**8, "int16": 2**15, "uint16": 2**16}


def make_accel_executor(
    desc: AcceleratorDescription,
    mapping_gen: MappingGenerator,
    intrinsic_gen: HardwareIntrinsicGenerator,
    node: Node,
    strategy: Strategy,
    *,
    use_pallas: bool = True,
    device: torch.device | None = None,
) -> Callable:
    """Lower one accelerator step.  ``device`` is where the emulated
    route's build-time probe runs (the module's device; the CPU when
    None)."""
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
    if use_pallas or desc.name.startswith("tpu"):
        return _make_kernel_executor(desc, mapping_gen, node, strategy, fused_epilogue)
    return _make_gemmini_executor(
        desc, mapping_gen, intrinsic_gen, node, strategy, fused_epilogue,
        torch.device(device or "cpu"),
    )


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


def _output_stages(node: Node) -> tuple[Callable, Callable]:
    """What both routes do after the GEMM: ``finish`` reshapes to the
    (conv) output shape, casts to the node's dtype and applies the fused
    pool; ``add_residual`` adds the fused skip input last, in the dtype
    numpy's promotion gives."""
    pool = node.attrs.get("pool")
    out_t = torch_dtype(node.dtype)
    # the elementwise epilogue runs over the conv's own output; pooling
    # then reduces it to the node shape.
    pre_shape = tuple(pool["conv_shape"]) if pool else tuple(node.shape)
    residual_t = None
    if node.attrs.get("residual") and len(node.inputs) > 3:
        residual_t = result_dtype(node.dtype, node.inputs[3].dtype)

    def finish(out):
        out = out.reshape(pre_shape).to(out_t)
        if pool:
            out = max_pool2d(out, pool["size"], pool["stride"])
        return out

    def add_residual(out, residual):
        if residual is None:
            return out
        return out.to(residual_t) + residual.to(residual_t)

    return finish, add_residual


def _make_gemmini_executor(
    desc: AcceleratorDescription,
    mapping_gen: MappingGenerator,
    intrinsic_gen: HardwareIntrinsicGenerator,
    node: Node,
    strategy: Strategy,
    fused_epilogue: bool,
    device: torch.device,
) -> Callable:
    """Tensorized tiled executor + fused epilogue chain, on the operands'
    device."""
    attrs = node.attrs
    intr = desc.compute_intrinsic_for_tag(strategy.compute.tag)
    intrinsic_gen.tensorize_check(strategy.compute.tag, strategy.schedule)
    tiled = mapping_gen.to_tiled_executor(strategy.schedule, intr)
    is_conv = node.op.endswith("conv2d")
    # batched activation-activation matmul: both operands carry a leading
    # batch dim (attention scores/context).  The schedule covers the
    # per-sample GEMM; the executor replays it per batch instance.
    is_bmm = not is_conv and len(node.inputs[1].shape) == 3
    transpose_b = bool(attrs.get("transpose_b")) and not is_conv
    stride = attrs.get("stride", 1)
    padding = attrs.get("padding", 0)
    out_t = torch_dtype(node.dtype)
    activation = attrs.get("activation")
    _finish, add_residual = _output_stages(node)

    if fused_epilogue:
        requant_scale = float(attrs["requant_scale"])
        clip_lo, clip_hi = attrs["clip_lo"], attrs["clip_hi"]

        def _epilogue(acc):
            # float64, as the reference's np.rint(acc * scale): torch.round
            # is half-to-even too
            out = torch.round(acc.to(torch.float64) * requant_scale)
            return _finish(out.clamp(clip_lo, clip_hi))

    elif activation == "relu":

        def _epilogue(acc):
            return _finish(torch.clamp_min(acc, 0))

    elif activation == "gelu":

        def _epilogue(acc):
            return _finish(gelu64(acc))

    else:

        def _epilogue(acc):
            return _finish(acc)

    # batched-matmul fast path: integer accumulation is exact, so one
    # vectorized product over all instances is bit-identical to replaying
    # the tile loop per instance — verified once at build time by the
    # reference's random-operand probe against the tiled executor (a
    # custom intrinsic with non-multiply-add semantics, e.g. saturating,
    # fails the probe and keeps the faithful per-instance loop).  Torch has
    # no integer matmul on CUDA, so the vectorized product is a float64
    # matmul, exact only for narrow operands: wider ones keep the loop.
    bmm_fast = False
    if is_bmm and all(np.dtype(i.dtype).kind in "iu" for i in node.inputs[:2]):
        _b, _m, _c = node.inputs[0].shape
        _k = node.shape[-1]
        _rng = np.random.default_rng(0)
        _xs = _rng.integers(-128, 128, (_m, _c)).astype(node.inputs[0].dtype)
        _ws = _rng.integers(-128, 128, (_c, _k)).astype(node.inputs[1].dtype)
        try:
            probe = tiled(torch.from_numpy(_xs).to(device), torch.from_numpy(_ws).to(device))
            bmm_fast = np.array_equal(
                to_numpy(probe), _xs.astype(np.int64) @ _ws.astype(np.int64)
            )
        except Exception:
            bmm_fast = False
        lim = [_F64_EXACT_MAX.get(i.dtype) for i in node.inputs[:2]]
        bmm_fast = bmm_fast and None not in lim and _c * lim[0] * lim[1] < 2**53

    def gemmini_exec(x, w, bias=None, residual=None):
        if is_conv:
            kh, kw, ci, co = w.shape
            acc = tiled(im2col(x, kh, kw, stride, padding), w.reshape(kh * kw * ci, co))
        elif is_bmm:
            wb = w.transpose(-2, -1) if transpose_b else w
            if bmm_fast:
                acc = torch.matmul(x.to(torch.float64), wb.to(torch.float64)).to(torch.int64)
            else:
                acc = torch.stack([tiled(xs, ws) for xs, ws in zip(x, wb)])
        else:
            acc = tiled(x.reshape(-1, x.shape[-1]), w.T if transpose_b else w)
        if bias is not None:
            acc = acc + bias.to(torch.int64)
        return add_residual(_epilogue(acc), residual)

    def specialize_consts(consts: dict[int, torch.Tensor]):
        """Plan-time specialization over compile-time-constant inputs
        (weights, bias; device tensors): conv weights are flattened, folded
        layout transposes are materialized once, and the weight panel
        padded to the schedule's (pk, pn) once, instead of on every call.
        When the whole padded GEMM fits a single PE tile — the common case
        for serving-size layers — the intrinsic consumes the unpadded
        operands directly (tile limits are maxima), with the constant bias
        preloaded as the initial accumulator tile, exactly as a
        weight-stationary array preloads its accumulator.  Bit-identical
        to ``gemmini_exec`` (zero-padding contributes exact zeros to
        integer accumulation); the per-node interpreter cannot do any of
        this because it re-reads the graph each run."""
        if is_bmm or 1 not in consts:
            # batched-matmul weights are activations; nothing to pre-pad
            return None
        w = consts[1]
        if is_conv:
            kh, kw, ci, co = w.shape
            w2 = w.reshape(kh * kw * ci, co)
            conv_dims = (kh, kw)
        else:
            w2 = w.T.contiguous() if transpose_b else w
            conv_dims = None
        n_out = w2.shape[1]
        wp = tiled.pad_w(w2)
        run_prepadded = tiled.prepadded
        has_const_bias = 2 in consts
        bias_c = consts[2].to(torch.int64) if has_const_bias else None
        sched = strategy.schedule
        pe = sched.pe_tile()
        single_tile = all(sched.padded(j) == pe[j] for j in ("N", "C", "K"))
        intr_fn = intr.fn
        m_stat, k_stat = strategy.workload.N, strategy.workload.C
        x_dt = torch_dtype(node.inputs[0].dtype)
        acc_shape = (m_stat, n_out)

        # single-call fast path, verified once by a zero-input probe: the
        # intrinsic must pass the initial accumulator through unchanged
        # (the same contract the generic k-loop accumulation relies on) and
        # must not write into it.  The reference makes the shared init
        # read-only so that an in-place-accumulating intrinsic raises;
        # torch has no read-only tensors, so the probe reads the init's
        # version counter, which every in-place write bumps.  Anything
        # surprising falls back to the padded tile loop.
        fast_init = None
        has_bias_operand = len(node.inputs) > 2 and node.inputs[2] is not None
        if single_tile and (has_const_bias or not has_bias_operand):
            if has_const_bias:
                init = bias_c.expand(acc_shape)
            else:
                init = torch.zeros(acc_shape, dtype=torch.int64, device=w2.device)
            version = init._version
            try:
                probe = intr_fn(
                    torch.zeros((m_stat, k_stat), dtype=x_dt, device=w2.device), w2, init
                )
                if (
                    tuple(getattr(probe, "shape", ())) == acc_shape
                    and init._version == version
                    and bool((probe == init).all())
                    and (not has_const_bias or bool((init[0] == bias_c).all()))
                ):
                    fast_init = init
            except Exception:
                fast_init = None

        if fused_epilogue and out_t != torch.float64:
            # preallocated requantize scratch (shapes are static per node);
            # the arena value is always the fresh tensor the final cast
            # produces, so scratch reuse can never alias results.  The
            # scratch is THREAD-LOCAL: compiled modules are shared across
            # serving threads, and a process-wide buffer would let two
            # concurrent calls requantize into each other.
            scratch = threading.local()

            def _epilogue_planned(acc):
                if tuple(acc.shape) != acc_shape:
                    return _epilogue(acc)
                fbuf = getattr(scratch, "fbuf", None)
                if fbuf is None:
                    fbuf = scratch.fbuf = torch.empty(
                        acc_shape, dtype=torch.float64, device=acc.device
                    )
                fbuf.copy_(acc)
                fbuf.mul_(requant_scale)
                torch.round(fbuf, out=fbuf)
                fbuf.clamp_(clip_lo, clip_hi)
                return _finish(fbuf)

        else:
            _epilogue_planned = _epilogue

        def gemmini_exec_planned(x, w=None, bias=None, residual=None):
            if conv_dims is not None:
                x2 = im2col(x, *conv_dims, stride, padding)
            else:
                x2 = x.reshape(-1, x.shape[-1])
            if (
                fast_init is not None
                and tuple(x2.shape) == (m_stat, k_stat)
                and x2.dtype == x_dt
            ):
                out = _epilogue_planned(intr_fn(x2, w2, fast_init))
            else:
                acc = run_prepadded(x2, wp, n_out)
                if has_const_bias:
                    acc = acc + bias_c
                elif bias is not None:
                    acc = acc + bias.to(torch.int64)
                out = _epilogue_planned(acc)
            return add_residual(out, residual)

        return gemmini_exec_planned

    gemmini_exec.specialize_consts = specialize_consts
    return gemmini_exec


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
    cfg = kernel_config_for(desc, mapping_gen, node, strategy)
    finish, add_residual = _output_stages(node)

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
        return add_residual(finish(out), residual)

    kernel_exec.kernel_config = cfg
    return kernel_exec
