"""Quantized GEMM: int8 x int8 -> int32 accumulator with a fused
requantize + clip epilogue.

This is the paper's quantized *generalized dense* operator on the card:
the whole QNN sequence (dense -> bias_add -> requantize -> clip) executes
as one kernel launch, with the int32 accumulator in registers (Gemmini's
accumulator SRAM analogue) and the epilogue applied before the one store
— no intermediate int32 tensor ever reaches device memory.

Port of ``repro.kernels.qgemm``.
"""

from __future__ import annotations

from dataclasses import replace

import torch

from repro_torch.kernels.gemm import GemmKernelConfig, scheduled_gemm


def scheduled_qgemm(
    x_q: torch.Tensor,
    w_q: torch.Tensor,
    bias: torch.Tensor | None,
    cfg: GemmKernelConfig,
) -> torch.Tensor:
    """int8[m,k] @ int8[k,n] (+ int32 bias) -> requantize -> clip -> int8."""
    if cfg.requant_scale is None:
        raise ValueError("quantized GEMM requires cfg.requant_scale")
    cfg = replace(
        cfg,
        acc_dtype="int32",
        out_dtype=cfg.out_dtype or "int8",
        clip_lo=cfg.clip_lo if cfg.clip_lo is not None else -128.0,
        clip_hi=cfg.clip_hi if cfg.clip_hi is not None else 127.0,
        activation=None,
        has_bias=bias is not None,
    )
    return scheduled_gemm(x_q, w_q, cfg, bias)
