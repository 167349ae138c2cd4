"""Gemmini accelerator description — the paper's case study (§4, Fig. 3).

Default Gemmini config: 16x16 int8 PE array (weight- or output-stationary),
256 KiB scratchpad (inputs/weights), 64 KiB accumulator (32-bit partial
sums), RoCC command interface with fused ``LOOP_WS`` loop instructions and
``mvin/mvout`` DMA intrinsics.  Functional + architectural descriptions
together are ~200 LoC, which is exactly the paper's Table 1 claim — the
LoC benchmark counts this file.

Port of ``repro.core.descriptions.gemmini``: plain Python and numpy, copied with import changes
only, except the compute intrinsics, which follow the port's intrinsic
contract (``repro_torch.core.intrinsics``): torch tensors on the module's
device in, a torch tensor out, bit-equal to the reference's numpy
``acc_tile + a_tile.astype(np.int32) @ b_tile.astype(np.int32)``.  The
emulated route (``Target(use_pallas=False)``) calls them once per PE tile.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.accel import AcceleratorDescription
from repro_torch.core.arch_spec import (
    OUTPUT_STATIONARY,
    WEIGHT_STATIONARY,
    ArchSpec,
    HardwareConstraints,
    MemLevel,
)
from repro_torch.core.intrinsics import int32_tile_product

DIM = 16  # PE array dimension


def make_gemmini_arch() -> ArchSpec:
    """Architectural description (CoSA-format, paper §3.2b)."""
    return ArchSpec(
        name="gemmini",
        levels=(
            # level 0: the PE array itself (no buffering modeled here).
            MemLevel("pe_array", size_bytes=0, holds=(), bytes_per_cycle=0.0),
            # level 1: scratchpad for In/W + accumulator for Out.  Gemmini
            # splits them physically; we model one level whose shares are
            # swept (uneven mapping) with Out capped by the accumulator.
            MemLevel(
                "spad",
                size_bytes=256 * 1024 + 64 * 1024,
                holds=("In", "W", "Out"),
                bytes_per_cycle=16.0,
            ),
            # level 2: DRAM via the SoC bus.
            MemLevel("dram", size_bytes=0, bytes_per_cycle=16.0),
        ),
        constraints=HardwareConstraints(
            pe_dim=DIM,
            spatial_levels=(0,),
            alignments={"N": DIM, "C": DIM, "K": DIM},
            memory_share_candidates=(
                (1 / 3, 1 / 3, 1 / 3),
                (1 / 4, 1 / 2, 1 / 4),
                (3 / 8, 3 / 8, 1 / 4),
                (1 / 4, 1 / 4, 1 / 2),
                (1 / 2, 1 / 4, 1 / 4),
            ),
            double_buffer_candidates=(True, False),
        ),
        dataflows=(WEIGHT_STATIONARY, OUTPUT_STATIONARY),
        macs_per_cycle=DIM * DIM,
        freq_hz=1e9,
        host_preproc_cycles_per_byte=24.0,  # scalar host loop: ld/st + requant
        host_epilogue_cycles_per_byte=2.0,  # unfused requant/clip on int32 out
        instr_overhead_cycles=200.0,  # RoCC issue + fence round-trip
        # chip-to-chip over the SoC NoC: one int8 row per cycle, with a
        # DMA-descriptor setup per ring hop
        link_bytes_per_cycle=16.0,
        link_hop_cycles=64.0,
    )


def make_gemmini_description() -> AcceleratorDescription:
    desc = AcceleratorDescription(name="gemmini", arch=make_gemmini_arch())

    # -- preprocessing (Fig. 3a): folded at compile time when constant ------
    @desc.register_preprocessing("dense", operand="W", constant=True)
    def transpose_weights(w):
        # Gemmini expects row-major (C, K); frameworks store (K, C).
        return np.ascontiguousarray(np.transpose(w))

    @desc.register_preprocessing("dense", operand="W", constant=True)
    def quantize_weights(w, scale=0.02):
        return np.clip(np.round(w / scale), -128, 127).astype(np.int8)

    @desc.register_preprocessing("conv2d", operand="In", constant=False)
    def im2col(x, kh=3, kw=3, stride=1):
        # runs on the host when the input is not constant
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

    # -- core computes (Fig. 3b): quantized dense + conv-as-GEMM ------------
    @desc.register_core_compute("gemmini_qgemm", op="dense", quantized=True)
    def qdense(x_q, w_q, bias, scale_in, scale_w, scale_out):
        acc = x_q.astype(np.int32) @ w_q.astype(np.int32)
        acc = acc + bias.astype(np.int32)
        requant = acc.astype(np.float64) * (scale_in * scale_w / scale_out)
        return np.clip(np.round(requant), -128, 127).astype(np.int8)

    @desc.register_core_compute("gemmini_qgemm_conv", op="conv2d", quantized=True)
    def qconv(cols_q, w_q, bias, scale_in, scale_w, scale_out):
        return qdense(cols_q, w_q, bias, scale_in, scale_w, scale_out)

    # -- hw intrinsics (Fig. 3c/d) ------------------------------------------
    @desc.register_hw_intrinsic(
        "gemmini.matmul_ws",
        kind="compute",
        tag="gemmini_qgemm",
        tile_limits={"N": DIM, "C": DIM, "K": DIM},
        dataflow="WS",
    )
    def matmul_ws(a_tile, b_tile, acc_tile):
        # matmul.preload / matmul.compute.preloaded semantics
        return acc_tile + int32_tile_product(a_tile, b_tile)

    @desc.register_hw_intrinsic(
        "gemmini.matmul_os",
        kind="compute",
        tag="gemmini_qgemm_conv",
        tile_limits={"N": DIM, "C": DIM, "K": DIM},
        dataflow="OS",
    )
    def matmul_os(a_tile, b_tile, acc_tile):
        return acc_tile + int32_tile_product(a_tile, b_tile)

    @desc.register_hw_intrinsic(
        "gemmini.mvin", kind="memory", operand="In", stride_elems=DIM
    )
    def mvin(dram_ref, spad_addr, rows, cols):
        return ("mvin", spad_addr, rows, cols)

    @desc.register_hw_intrinsic(
        "gemmini.mvin_w", kind="memory", operand="W", stride_elems=DIM
    )
    def mvin_w(dram_ref, spad_addr, rows, cols):
        return ("mvin_w", spad_addr, rows, cols)

    @desc.register_hw_intrinsic(
        "gemmini.mvout", kind="memory", operand="Out", stride_elems=DIM
    )
    def mvout(spad_addr, dram_ref, rows, cols):
        return ("mvout", spad_addr, rows, cols)

    @desc.register_hw_intrinsic("gemmini.config_ex", kind="config")
    def config_ex(dataflow="WS", activation=None, shift=0):
        return ("config_ex", dataflow, activation, shift)

    errs = desc.validate()
    assert not errs, errs
    return desc
