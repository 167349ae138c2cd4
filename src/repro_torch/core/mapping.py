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

For the emulated route (the reference's Gemmini case study) the same
Schedule drives a tiled executor that tensorizes with the registered
compute intrinsic, tile by tile (``to_tiled_executor``).

Port of ``repro.core.mapping``.  The reference raises the blocks to the
TPU MXU's 8/128/128 floor outside interpret mode; the CUDA kernel takes
any block shape, so the port keeps the schedule's exact buffer tiles on
every device, as the reference's interpret mode does.  The tiled
executor is the reference's loop nest on torch tensors: its padded
operands and accumulator lie on the operands' device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.core.accel import AcceleratorDescription, IntrinsicDef
from repro_torch.core.arch_spec import GEMM_DIMS
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

    # -- emulated route: Schedule -> tensorized tiled executor ---------------
    def to_tiled_executor(
        self, schedule: Schedule, intrinsic: IntrinsicDef
    ) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
        """Emit a loop-nest executor that applies the registered compute
        intrinsic per PE tile — the tensorization step, faithful to the
        generated loop structure (i0, then j0, then k0 over PE tiles, an
        int64 accumulator, one intrinsic call per tile)."""
        pe = schedule.pe_tile()
        tm, tk, tn = pe["N"], pe["C"], pe["K"]
        pm = schedule.padded("N")
        pk = schedule.padded("C")
        pn = schedule.padded("K")
        intr_fn = intrinsic.fn

        def pad_w(w: torch.Tensor) -> torch.Tensor:
            k, n = w.shape
            wp = w.new_zeros((pk, pn))
            wp[:k, :n] = w
            return wp

        def run_prepadded(x: torch.Tensor, wp: torch.Tensor, n: int) -> torch.Tensor:
            """Inner loop nest over an already-padded weight panel: the
            execution plan pre-pads constant weights once at plan-build time
            (stationary operands stay resident across calls)."""
            m, k = x.shape
            xp = x.new_zeros((pm, pk))
            xp[:m, :k] = x
            acc = torch.zeros((pm, pn), dtype=torch.int64, device=x.device)
            for i0 in range(0, pm, tm):
                for j0 in range(0, pn, tn):
                    tile_acc = torch.zeros((tm, tn), dtype=torch.int64, device=x.device)
                    for k0 in range(0, pk, tk):
                        tile_acc = intr_fn(
                            xp[i0 : i0 + tm, k0 : k0 + tk],
                            wp[k0 : k0 + tk, j0 : j0 + tn],
                            tile_acc,
                        )
                    acc[i0 : i0 + tm, j0 : j0 + tn] = tile_acc
            return acc[:m, :n]

        def run(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
            return run_prepadded(x, pad_w(w), w.shape[1])

        run.pad_w = pad_w
        run.prepadded = run_prepadded
        return run

    def describe(self, schedule: Schedule) -> str:
        """Human-readable mapping report (what CoSA's YAML + TIR transform
        sequence would contain)."""
        cfg_lines = [schedule.describe()]
        mem_intrs = [i.name for i in self.desc.memory_intrinsics()]
        cfg_lines.append(f"  memory intrinsics: {mem_intrs}")
        buf = self.desc.arch.buffered_levels()
        n_tiles = math.prod(schedule.trips(buf[0] if buf else 0, j) for j in GEMM_DIMS)
        cfg_lines.append(f"  outer tiles: {n_tiles}")
        return "\n".join(cfg_lines)
