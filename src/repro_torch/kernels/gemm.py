"""The scheduled GEMM kernel — the Hopper lowering of the paper's mapping
generator output.

The extended-CoSA ``Schedule`` fixes the buffer tile shape (block_m/k/n)
and the dataflow.  On the card (``csrc/gemm.cu``) each output block of the
config is one CTA, the dataflow sets the raster order of the blocks (OS:
m outer, WS: n outer so a weight panel's blocks launch together), and the
reduction runs as a loop over block_k steps inside the CTA, with operand
chunks staged through a fixed shared-memory budget.  The int32 or f32
accumulator lives in registers — Gemmini's accumulator SRAM analogue —
and the epilogue (bias, then requantize + clip or an activation, then the
cast) runs before the one store, so no intermediate reaches device memory.

Kernel-naming convention: m, k, n are the GEMM dims (paper's N, C, K).

Port of ``repro.kernels.gemm``.  ``scheduled_gemm`` launches the CUDA
kernel for a CUDA tensor and raises if it cannot; for a CPU tensor it runs
the plain PyTorch version (``repro_torch.kernels.ref``); any other device
raises.  The kernel masks ragged edges itself, so operands need not be
multiples of the block shape.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from repro_torch.kernels import build, ref


@dataclass(frozen=True)
class GemmKernelConfig:
    """Everything the mapping generator derives from a Schedule."""

    block_m: int
    block_k: int
    block_n: int
    dataflow: str = "OS"  # OS: blocks m outer; WS: blocks n outer
    acc_dtype: str = "float32"
    out_dtype: str = "float32"
    # epilogue (quantized generalized op): requantize+clip, or activation
    requant_scale: float | None = None
    clip_lo: float | None = None
    clip_hi: float | None = None
    activation: str | None = None
    has_bias: bool = False

    def grid_for(self, m: int, k: int, n: int) -> tuple[int, int, int]:
        gm, gk, gn = m // self.block_m, k // self.block_k, n // self.block_n
        if self.dataflow == "WS":
            return (gn, gm, gk)
        return (gm, gn, gk)


#: kernel launches per instantiation of ``csrc/gemm.cu``, counted where the
#: kernel launches and nowhere else (the plain version never counts)
LAUNCHES: dict[str, int] = {"qgemm_requant": 0, "gemm_int32": 0, "gemm_float": 0}


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


_IN_TYPES = {torch.int8: 0, torch.float32: 1, torch.bfloat16: 2}
_OUT_TYPES = {torch.int8: 0, torch.int32: 1, torch.float32: 2, torch.bfloat16: 3}
_EPILOGUES = {None: 0, "relu": 1, "gelu": 2, "requant": 3}
#: (input, accumulator) -> output types and epilogues the kernel is built for
_SUPPORTED = {
    (torch.int8, torch.int32): (
        (torch.int8, torch.int32, torch.float32),
        (None, "relu", "requant"),
    ),
    (torch.float32, torch.float32): (
        (torch.float32, torch.bfloat16),
        (None, "relu", "gelu"),
    ),
    (torch.bfloat16, torch.float32): (
        (torch.float32, torch.bfloat16),
        (None, "relu", "gelu"),
    ),
}


def _epilogue(cfg: GemmKernelConfig) -> str | None:
    return "requant" if cfg.requant_scale is not None else cfg.activation


def variant(cfg: GemmKernelConfig) -> str:
    """Which instantiation of the kernel a config selects (the key of
    ``LAUNCHES``)."""
    if cfg.requant_scale is not None:
        return "qgemm_requant"
    if cfg.acc_dtype == "int32":
        return "gemm_int32"
    return "gemm_float"


def _check(x: torch.Tensor, w: torch.Tensor, cfg: GemmKernelConfig, bias) -> None:
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(
            f"scheduled_gemm needs x[m,k] @ w[k,n], got "
            f"{tuple(x.shape)} @ {tuple(w.shape)}"
        )
    if cfg.has_bias != (bias is not None):
        raise ValueError("cfg.has_bias does not match bias argument")
    if bias is not None and tuple(bias.shape) != (w.shape[1],):
        raise ValueError(f"bias shape {tuple(bias.shape)} != ({w.shape[1]},)")
    if x.dtype != w.dtype:
        raise ValueError(f"operand dtypes differ: {x.dtype} vs {w.dtype}")
    acc_t = ref.torch_dtype(cfg.acc_dtype)
    supported = _SUPPORTED.get((x.dtype, acc_t))
    if (
        supported is None
        or ref.torch_dtype(cfg.out_dtype) not in supported[0]
        or _epilogue(cfg) not in supported[1]
    ):
        raise ValueError(
            f"the scheduled GEMM kernel has no instantiation for {x.dtype} inputs, "
            f"{cfg.acc_dtype} accumulator, {cfg.out_dtype} output and epilogue "
            f"{_epilogue(cfg)!r}"
        )
    if cfg.requant_scale is not None and (cfg.clip_lo is None or cfg.clip_hi is None):
        raise ValueError("a requantizing config needs clip_lo and clip_hi")
    if min(cfg.block_m, cfg.block_k, cfg.block_n) < 1:
        raise ValueError(f"block shape must be positive: {cfg}")


def gemm_plain(
    x: torch.Tensor, w: torch.Tensor, cfg: GemmKernelConfig, bias=None
) -> torch.Tensor:
    """The plain PyTorch version of the kernel, on any device."""
    if cfg.requant_scale is not None:
        return ref.qgemm_ref(
            x,
            w,
            bias,
            requant_scale=cfg.requant_scale,
            clip_lo=cfg.clip_lo,
            clip_hi=cfg.clip_hi,
            out_dtype=cfg.out_dtype,
        )
    return ref.gemm_ref(
        x,
        w,
        bias,
        acc_dtype=cfg.acc_dtype,
        out_dtype=cfg.out_dtype,
        activation=cfg.activation,
    )


def _library() -> ctypes.CDLL:
    lib = build.load("gemm")
    if lib.repro_scheduled_gemm.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.repro_scheduled_gemm.argtypes = [
            p, p, p, p,  # x, w, bias, out
            i, i, i,  # m, k, n
            i, i, i,  # block_m, block_k, block_n
            i, i, i, i,  # weight_stationary, in_type, out_type, epilogue
            f, f, f,  # scale, clip_lo, clip_hi
            p,  # stream
        ]
        lib.repro_scheduled_gemm.restype = ctypes.c_int
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _launch(
    x: torch.Tensor, w: torch.Tensor, cfg: GemmKernelConfig, bias
) -> torch.Tensor:
    operands = {"x": x, "w": w} if bias is None else {"x": x, "w": w, "bias": bias}
    for name, t in operands.items():
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    acc_t = ref.torch_dtype(cfg.acc_dtype)
    if bias is not None and bias.dtype != acc_t:
        raise ValueError(f"bias must be {acc_t} (the accumulator type), got {bias.dtype}")
    m, k = x.shape
    n = w.shape[1]
    out_t = ref.torch_dtype(cfg.out_dtype)
    out = torch.empty((m, n), dtype=out_t, device=x.device)
    if m == 0 or n == 0:
        return out
    lib = _library()
    with torch.cuda.device(x.device):
        rc = lib.repro_scheduled_gemm(
            x.data_ptr(),
            w.data_ptr(),
            None if bias is None else bias.data_ptr(),
            out.data_ptr(),
            m,
            k,
            n,
            cfg.block_m,
            cfg.block_k,
            cfg.block_n,
            int(cfg.dataflow == "WS"),
            _IN_TYPES[x.dtype],
            _OUT_TYPES[out_t],
            _EPILOGUES[_epilogue(cfg)],
            0.0 if cfg.requant_scale is None else cfg.requant_scale,
            0.0 if cfg.clip_lo is None else cfg.clip_lo,
            0.0 if cfg.clip_hi is None else cfg.clip_hi,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if rc != 0:
        msg = lib.repro_cuda_error_string(rc).decode()
        raise RuntimeError(f"scheduled GEMM kernel launch failed: CUDA error {rc} ({msg})")
    LAUNCHES[variant(cfg)] += 1
    return out


def scheduled_gemm(
    x: torch.Tensor,
    w: torch.Tensor,
    cfg: GemmKernelConfig,
    bias: torch.Tensor | None = None,
) -> torch.Tensor:
    """Out[m, n] = epilogue(x[m, k] @ w[k, n] (+ bias[n])).

    Any m, k, n: the kernel masks the ragged edge of the block grid.  A
    CUDA tensor launches the kernel (or raises), a CPU tensor runs the
    plain version, any other device raises.  The bias, when given, is in
    the accumulator's dtype."""
    _check(x, w, cfg, bias)
    if x.device.type == "cuda":
        return _launch(x, w, cfg, bias)
    if x.device.type == "cpu":
        return gemm_plain(x, w, cfg, bias)
    raise ValueError(f"scheduled_gemm runs on cuda or cpu tensors, not {x.device}")
