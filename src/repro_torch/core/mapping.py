"""Mapping Generator (paper §3.3): Schedule -> executable kernel mapping.

In the paper, CoSA's YAML output (tile factors + per-level loop order) is
applied as TIR schedule primitives, then TIR stages are rewritten with the
hardware intrinsics produced by the Hardware Intrinsic Generator
(tensorization).  Here the same information lowers to the config of the
scheduled GEMM kernel (``repro_torch.kernels.gemm``):

  * buffer-level tile sizes  ->  the output block of one CTA and the
                                 block_k step of its reduction loop,
  * DRAM-level loop order    ->  the raster order of the blocks (OS: m
                                 outer / WS: n outer),
  * epilogue attrs           ->  fused requantize/clip or activation.

Port of ``repro.core.mapping``: ``to_kernel_config`` only (the tensorized
numpy executor ``to_tiled_executor`` waits for its slice).  The reference
raises the blocks to the TPU MXU's 8/128/128 floor outside interpret mode;
the CUDA kernel takes any block shape, so the port keeps the schedule's
exact buffer tiles on every device, as the reference's interpret mode
does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from repro_torch.core.accel import AcceleratorDescription
from repro_torch.core.schedule import Schedule
from repro_torch.kernels.gemm import GemmKernelConfig


@dataclass
class MappingGenerator:
    desc: AcceleratorDescription

    def to_kernel_config(
        self,
        schedule: Schedule,
        *,
        acc_dtype: str = "float32",
        out_dtype: str = "float32",
        epilogue: dict[str, Any] | None = None,
        has_bias: bool = False,
    ) -> GemmKernelConfig:
        buf = self.desc.arch.buffered_levels()
        level = buf[0] if buf else 0
        ep = epilogue or {}
        # paper dims N/C/K == kernel dims m/k/n
        return GemmKernelConfig(
            block_m=schedule.tile(level, "N"),
            block_k=schedule.tile(level, "C"),
            block_n=schedule.tile(level, "K"),
            dataflow=schedule.dataflow,
            acc_dtype=acc_dtype,
            out_dtype=out_dtype,
            requant_scale=ep.get("requant_scale"),
            clip_lo=ep.get("clip_lo"),
            clip_hi=ep.get("clip_hi"),
            activation=ep.get("activation"),
            has_bias=has_bias,
        )
