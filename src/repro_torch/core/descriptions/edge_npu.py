"""EdgeNPU accelerator description — the registry's proof-of-abstraction.

A fictional-but-plausible edge-class NPU, deliberately unlike both in-tree
targets: an 8x8 *weight-stationary-only* int8 systolic array (Gemmini is
16x16 WS+OS, the TPU MXU is 128x128), a single **unified** 64 KiB SRAM
shared by all three operands behind a narrow 4 B/cycle DMA, a slow MCU-class
host (32 cycles/byte for unfolded preprocessing) and an expensive MMIO
doorbell per command (512 cycles) that makes fused loop issue essential.

Everything below goes through the *public* description API and registers
with the accelerator registry — no compiler internals are touched:

    import repro_torch
    module = repro_torch.compile(model, repro_torch.Target("edge_npu"))

Port of ``repro.core.descriptions.edge_npu``: plain Python and numpy,
copied with import changes only, except the compute intrinsic, which
takes and returns torch tensors (``repro_torch.core.intrinsics``).  On
the kernel route every step runs the scheduled GEMM kernel with this
description's 8-wide, weight-stationary block configs; the emulated
route (``Target(use_pallas=False)``) calls the intrinsic per 8x8x8 tile.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.accel import AcceleratorDescription
from repro_torch.core.arch_spec import (
    WEIGHT_STATIONARY,
    ArchSpec,
    HardwareConstraints,
    MemLevel,
)
from repro_torch.core.intrinsics import int32_tile_product
from repro_torch.core.registry import register_accelerator

DIM = 8  # PE array dimension
SRAM_BYTES = 64 * 1024  # unified operand SRAM


def make_edge_npu_arch() -> ArchSpec:
    """Architectural description (CoSA-format, paper §3.2b)."""
    return ArchSpec(
        name="edge_npu",
        levels=(
            # level 0: the 8x8 PE array.
            MemLevel("pe_array", size_bytes=0, holds=(), bytes_per_cycle=0.0),
            # level 1: one unified SRAM for In/W/Out — no separate
            # accumulator memory, so the uneven-mapping sweep matters even
            # more than on Gemmini's split scratchpad.
            MemLevel(
                "sram",
                size_bytes=SRAM_BYTES,
                holds=("In", "W", "Out"),
                bytes_per_cycle=4.0,
            ),
            # level 2: LPDDR behind a narrow SoC bus.
            MemLevel("dram", size_bytes=0, bytes_per_cycle=4.0),
        ),
        constraints=HardwareConstraints(
            pe_dim=DIM,
            spatial_levels=(0,),
            alignments={"N": DIM, "C": DIM, "K": DIM},
            memory_share_candidates=(
                (1 / 3, 1 / 3, 1 / 3),
                (1 / 4, 1 / 2, 1 / 4),
                (1 / 2, 1 / 4, 1 / 4),
                (1 / 4, 1 / 4, 1 / 2),
                (1 / 8, 5 / 8, 1 / 4),
            ),
            double_buffer_candidates=(True, False),
        ),
        dataflows=(WEIGHT_STATIONARY,),  # WS only: weights are preloaded
        macs_per_cycle=DIM * DIM,
        freq_hz=400e6,
        host_preproc_cycles_per_byte=32.0,  # MCU-class host, scalar loops
        host_epilogue_cycles_per_byte=4.0,
        instr_overhead_cycles=512.0,  # MMIO doorbell + completion IRQ
        # board-level SPI-class link between NPUs: narrow and high-latency
        link_bytes_per_cycle=4.0,
        link_hop_cycles=256.0,
    )


@register_accelerator("edge_npu", exist_ok=True)
def make_edge_npu_description() -> AcceleratorDescription:
    desc = AcceleratorDescription(name="edge_npu", arch=make_edge_npu_arch())

    # -- preprocessing (folded at compile time when constant) ---------------
    @desc.register_preprocessing("dense", operand="W", constant=True)
    def transpose_weights(w):
        # frameworks store (K, C); the NPU streams row-major (C, K) panels
        return np.ascontiguousarray(np.transpose(w))

    @desc.register_preprocessing("dense", operand="W", constant=True)
    def quantize_weights(w, scale=0.02):
        return np.clip(np.round(w / scale), -128, 127).astype(np.int8)

    @desc.register_preprocessing("conv2d", operand="In", constant=False)
    def im2col(x, kh=3, kw=3, stride=1):
        n, h, w_, c = x.shape
        oh = (h - kh) // stride + 1
        ow = (w_ - kw) // stride + 1
        cols = np.empty((n * oh * ow, kh * kw * c), dtype=x.dtype)
        idx = 0
        for b in range(n):
            for i in range(oh):
                for j in range(ow):
                    patch = x[b, i * stride : i * stride + kh, j * stride : j * stride + kw, :]
                    cols[idx] = patch.reshape(-1)
                    idx += 1
        return cols

    # -- core computes: int8-only (the array has no float datapath) ---------
    @desc.register_core_compute("edge_qgemm", op="dense", quantized=True)
    def qdense(x_q, w_q, bias, scale_in, scale_w, scale_out):
        acc = x_q.astype(np.int32) @ w_q.astype(np.int32)
        acc = acc + bias.astype(np.int32)
        requant = acc.astype(np.float64) * (scale_in * scale_w / scale_out)
        return np.clip(np.round(requant), -128, 127).astype(np.int8)

    @desc.register_core_compute("edge_qgemm_conv", op="conv2d", quantized=True)
    def qconv(cols_q, w_q, bias, scale_in, scale_w, scale_out):
        return qdense(cols_q, w_q, bias, scale_in, scale_w, scale_out)

    # -- hw intrinsics -------------------------------------------------------
    @desc.register_hw_intrinsic(
        "edge_npu.mma",
        kind="compute",
        tag="edge_qgemm",
        tile_limits={"N": DIM, "C": DIM, "K": DIM},
        dataflow="WS",
    )
    def mma(a_tile, b_tile, acc_tile):
        # weight panel preloaded; activations streamed through the array
        return acc_tile + int32_tile_product(a_tile, b_tile)

    @desc.register_hw_intrinsic(
        "edge_npu.mma_conv",
        kind="compute",
        tag="edge_qgemm_conv",
        tile_limits={"N": DIM, "C": DIM, "K": DIM},
        dataflow="WS",
    )
    def mma_conv(a_tile, b_tile, acc_tile):
        return mma(a_tile, b_tile, acc_tile)

    @desc.register_hw_intrinsic(
        "edge_npu.dma_in", kind="memory", operand="In", burst_bytes=64
    )
    def dma_in(dram_ref, sram_addr, rows, cols):
        return ("dma_in", sram_addr, rows, cols)

    @desc.register_hw_intrinsic(
        "edge_npu.dma_w", kind="memory", operand="W", burst_bytes=64
    )
    def dma_w(dram_ref, sram_addr, rows, cols):
        return ("dma_w", sram_addr, rows, cols)

    @desc.register_hw_intrinsic(
        "edge_npu.dma_out", kind="memory", operand="Out", burst_bytes=64
    )
    def dma_out(sram_addr, dram_ref, rows, cols):
        return ("dma_out", sram_addr, rows, cols)

    @desc.register_hw_intrinsic("edge_npu.cfg", kind="config")
    def cfg(requant_shift=0, relu=False):
        return ("cfg", requant_shift, relu)

    errs = desc.validate()
    assert not errs, errs
    return desc
