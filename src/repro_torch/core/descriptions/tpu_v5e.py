"""TPU v5e accelerator description — the reference's production target.

The TPU is itself a GEMM-based accelerator in the paper's sense: a
systolic MXU, a software-visible vector memory (VMEM) standing in for the
scratchpad, HBM behind block copies, and a GEMM "compute instruction"
whose tiles must be hardware aligned.  This description drives the *same*
extended-CoSA scheduler as Gemmini.

Port of ``repro.core.descriptions.tpu_v5e``.  The module constants below
are the reference's TPU cost model, copied verbatim: they are inputs to
the modeled cycles, which must equal the reference's, and they say
nothing about the card the port runs on.  The functional part computes
in torch instead of ``jax.lax``: ``to_bf16`` casts to ``torch.bfloat16``,
``im2col_tpu`` is an unfold in ``lax.conv_general_dilated_patches``'s
patch order (NHWC rows, each row feature-major: channel, then kernel row,
then kernel column), and the computes and MXU intrinsics are torch
matmuls with the reference's accumulator dtypes.  All of these are host
or reference functions: on the card every offloaded step of a
``tpu_v5e`` plan runs the scheduled GEMM kernel (``kernels/csrc/gemm.cu``)
with the schedule's 128-aligned block configs.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.accel import AcceleratorDescription
from repro_torch.core.arch_spec import (
    OUTPUT_STATIONARY,
    WEIGHT_STATIONARY,
    ArchSpec,
    HardwareConstraints,
    MemLevel,
)

# The reference's TPU cost model (per chip), verbatim.
MXU_DIM = 128
LANE = 128  # last-dim tiling granularity
SUBLANE = 8  # second-to-last-dim granularity (f32; bf16 is 16)
VMEM_BYTES = 64 * 1024 * 1024
HBM_GBPS = 819e9
PEAK_BF16_FLOPS = 197e12
ICI_LINK_GBPS = 50e9


def make_tpu_v5e_arch(vmem_bytes: int = VMEM_BYTES) -> ArchSpec:
    n_mxu = 4
    freq = PEAK_BF16_FLOPS / (2.0 * MXU_DIM * MXU_DIM * n_mxu)
    macs_per_cycle = MXU_DIM * MXU_DIM * n_mxu
    return ArchSpec(
        name="tpu_v5e",
        levels=(
            MemLevel("mxu", size_bytes=0, holds=(), bytes_per_cycle=0.0),
            MemLevel(
                "vmem",
                size_bytes=vmem_bytes,
                holds=("In", "W", "Out"),
                bytes_per_cycle=HBM_GBPS / freq,  # HBM->VMEM bytes per cycle
            ),
            MemLevel("hbm", size_bytes=0, bytes_per_cycle=HBM_GBPS / freq),
        ),
        constraints=HardwareConstraints(
            pe_dim=MXU_DIM,
            spatial_levels=(0,),
            # N is the sublane dim of In/Out; C and K sit on lanes somewhere.
            alignments={"N": SUBLANE, "C": LANE, "K": LANE},
            memory_share_candidates=(
                (1 / 3, 1 / 3, 1 / 3),
                (1 / 4, 1 / 2, 1 / 4),
                (1 / 2, 1 / 4, 1 / 4),
                (1 / 4, 1 / 4, 1 / 2),
                (1 / 8, 5 / 8, 1 / 4),
                (3 / 8, 1 / 8, 1 / 2),
            ),
            double_buffer_candidates=(True, False),
        ),
        dataflows=(OUTPUT_STATIONARY, WEIGHT_STATIONARY),
        macs_per_cycle=macs_per_cycle,
        n_pe_units=n_mxu,
        freq_hz=freq,
        # host fallback for unfolded preprocessing, cheaper than a scalar
        # RISC-V host but still wasteful against folding
        host_preproc_cycles_per_byte=1.0,
        # per-kernel launch and prologue, amortized per grid step
        instr_overhead_cycles=10.0,
        # inter-chip ring link: wide and low-latency
        link_bytes_per_cycle=128.0,
        link_hop_cycles=32.0,
    )


def _tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))


def im2col_patches(x: torch.Tensor, kh: int = 3, kw: int = 3, stride: int = 1) -> torch.Tensor:
    """[N, H, W, C] -> [N * OH * OW, C * KH * KW] float32 patches, VALID
    padding, rows in NHWC order and each row feature-major (channel, then
    kernel row, then kernel column), as ``lax.conv_general_dilated_patches``
    orders them; ``F.unfold`` over NCHW gives that order."""
    x = _tensor(x)
    n = x.shape[0]
    cols = torch.nn.functional.unfold(
        x.to(torch.float32).permute(0, 3, 1, 2), kernel_size=(kh, kw), stride=stride
    )  # [N, C*KH*KW, OH*OW]
    return cols.transpose(1, 2).reshape(n * cols.shape[2], cols.shape[1])


def _matmul(a, b, acc_dtype: torch.dtype) -> torch.Tensor:
    """``a @ b`` summed in ``acc_dtype``, as ``preferred_element_type``
    asks (an int32 sum through int64, wrapped to int32)."""
    a, b = _tensor(a), _tensor(b)
    if acc_dtype == torch.int32:
        return (a.to(torch.int64) @ b.to(torch.int64)).to(torch.int32)
    return a.to(acc_dtype) @ b.to(acc_dtype)


def make_tpu_v5e_description(vmem_bytes: int = VMEM_BYTES) -> AcceleratorDescription:
    desc = AcceleratorDescription(name="tpu_v5e", arch=make_tpu_v5e_arch(vmem_bytes))

    # -- preprocessing: layout + (optional) quantization, folded when const --
    @desc.register_preprocessing("dense", operand="W", constant=True)
    def to_bf16(w):
        return _tensor(w).to(torch.bfloat16)

    @desc.register_preprocessing("dense", operand="W", constant=True, name="quantize_w_int8")
    def quantize_w_int8(w, scale=None):
        w = np.asarray(w)
        if scale is None:
            scale = max(float(np.max(np.abs(w))) / 127.0, 1e-8)
        return np.clip(np.round(w / scale), -128, 127).astype(np.int8)

    @desc.register_preprocessing("conv2d", operand="In", constant=False)
    def im2col_tpu(x, kh=3, kw=3, stride=1):
        return im2col_patches(x, kh, kw, stride)

    # -- core computes -------------------------------------------------------
    @desc.register_core_compute("tpu_gemm_bf16", op="dense")
    def dense_bf16(x, w, bias=None):
        acc = _matmul(_tensor(x).to(torch.bfloat16), _tensor(w).to(torch.bfloat16), torch.float32)
        if bias is not None:
            acc = acc + _tensor(bias)
        return acc

    @desc.register_core_compute("tpu_qgemm_int8", op="matmul", quantized=True)
    def qdense_int8(x_q, w_q, bias, scale_in, scale_w, scale_out):
        acc = _matmul(x_q, w_q, torch.int32)
        acc = acc + _tensor(bias).to(torch.int32)
        requant = acc.to(torch.float32) * (scale_in * scale_w / scale_out)
        return torch.clamp(torch.round(requant), -128, 127).to(torch.int8)

    @desc.register_core_compute("tpu_gemm_conv", op="conv2d")
    def conv_as_gemm(cols, w, bias=None):
        return dense_bf16(cols, w, bias)

    # -- hw intrinsics --------------------------------------------------------
    @desc.register_hw_intrinsic(
        "tpu.mxu_matmul",
        kind="compute",
        tag="tpu_gemm_bf16",
        tile_limits={"N": MXU_DIM, "C": MXU_DIM, "K": MXU_DIM},
        dataflow="OS",
    )
    def mxu_matmul(a_tile, b_tile, acc_tile):
        return _tensor(acc_tile) + _matmul(a_tile, b_tile, torch.float32)

    @desc.register_hw_intrinsic(
        "tpu.mxu_matmul_int8",
        kind="compute",
        tag="tpu_qgemm_int8",
        tile_limits={"N": MXU_DIM, "C": MXU_DIM, "K": MXU_DIM},
        dataflow="OS",
    )
    def mxu_matmul_int8(a_tile, b_tile, acc_tile):
        return _tensor(acc_tile) + _matmul(a_tile, b_tile, torch.int32)

    # conv reuses the bf16 MXU intrinsic after im2col.
    @desc.register_hw_intrinsic(
        "tpu.mxu_matmul_conv",
        kind="compute",
        tag="tpu_gemm_conv",
        tile_limits={"N": MXU_DIM, "C": MXU_DIM, "K": MXU_DIM},
        dataflow="OS",
    )
    def mxu_matmul_conv(a_tile, b_tile, acc_tile):
        return mxu_matmul(a_tile, b_tile, acc_tile)

    # Memory "intrinsics": not explicit instructions on a TPU — the
    # reference lowers them to kernel block specs; the port's kernel takes
    # the same blocks from the kernel config.
    @desc.register_hw_intrinsic(
        "tpu.vmem_load_in", kind="memory", operand="In", lowering="blockspec"
    )
    def vmem_load_in(block_shape, index_map):
        return ("blockspec", "In", block_shape, index_map)

    @desc.register_hw_intrinsic(
        "tpu.vmem_load_w", kind="memory", operand="W", lowering="blockspec"
    )
    def vmem_load_w(block_shape, index_map):
        return ("blockspec", "W", block_shape, index_map)

    @desc.register_hw_intrinsic(
        "tpu.vmem_store_out", kind="memory", operand="Out", lowering="blockspec"
    )
    def vmem_store_out(block_shape, index_map):
        return ("blockspec", "Out", block_shape, index_map)

    @desc.register_hw_intrinsic("tpu.dimension_semantics", kind="config")
    def dimension_semantics(arbitrary_dims=("C",)):
        # reduction grid dims must be 'arbitrary' for the reference's kernel
        return ("dimension_semantics", arbitrary_dims)

    errs = desc.validate()
    assert not errs, errs
    return desc
