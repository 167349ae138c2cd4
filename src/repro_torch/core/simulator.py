"""Analytical cycle model of a scratchpad GEMM accelerator.

Stand-in for the paper's cycle-accurate Verilator simulation of Gemmini
(§4): the scheduler's candidate schedules are ranked by modeled cycles
("evaluated on the hardware to determine the most efficient configuration"),
and the Table 2 reproduction runs all three backends through this model.

The model accounts for exactly the effects the paper discusses:
  * systolic compute with pipeline-fill per instruction,
  * per-instruction issue overhead — amortized by fused loop instructions
    (Gemmini's ``LOOP_WS``) for the C-toolchain/proposed paths, paid per
    tile by the naive path,
  * DMA traffic per the dataflow-aware reload model,
  * double buffering overlapping compute with DMA,
  * host-side preprocessing (transpose / quantization) when it is NOT
    constant-folded — the dominant cost of the naive UMA/BYOC backend.

Port of ``repro.core.simulator``: plain Python and numpy, copied with import changes
only unless noted here.
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.arch_spec import GEMM_DIMS, ArchSpec
from repro_torch.core.schedule import Schedule


@dataclass(frozen=True)
class SimReport:
    compute_cycles: float
    overhead_cycles: float
    dma_cycles: float
    preproc_cycles: float
    total_cycles: float
    utilization: float
    dram_traffic_bytes: int

    def __str__(self) -> str:
        return (
            f"total={self.total_cycles:,.0f}cyc (compute={self.compute_cycles:,.0f}, "
            f"overhead={self.overhead_cycles:,.0f}, dma={self.dma_cycles:,.0f}, "
            f"preproc={self.preproc_cycles:,.0f}) util={self.utilization:.2%} "
            f"traffic={self.dram_traffic_bytes:,}B"
        )


def simulate(
    schedule: Schedule,
    arch: ArchSpec,
    *,
    folded_preprocessing: bool = True,
    fused_loop_instructions: bool = True,
    host_epilogue: bool = False,
) -> SimReport:
    """Model one GEMM execution.  ``host_epilogue=True`` models the naive
    BYOC backend's unfused requantize/clip ops running on the host over the
    int32 accumulator output (TVM keeps them as separate Relay ops there)."""
    wl = schedule.workload

    # --- compute: each of the n_pe_units PE arrays performs (spatial
    # product) MACs per cycle; each instruction additionally pays a systolic
    # pipeline-fill latency.  Independent PE tiles are spread across units.
    spatial_product = 1
    for j in GEMM_DIMS:
        spatial_product *= schedule.spatial[0][j]
    padded_macs = 1
    for j in GEMM_DIMS:
        padded_macs *= schedule.padded(j)
    n_instr = schedule.num_instructions()
    fill = arch.pe_dim  # array depth: cycles to drain/fill the systolic pipe
    units = max(arch.n_pe_units, 1)
    compute_cycles = (
        padded_macs / max(spatial_product, 1) + n_instr * fill
    ) / units

    # --- instruction issue overhead: fused loop instructions issue one
    # descriptor per outer (buffer-level) tile; the naive path issues one
    # RoCC-style instruction per PE tile.
    buffered = arch.buffered_levels()
    outer_level = buffered[0] if buffered else 0
    n_outer = 1
    for j in GEMM_DIMS:
        n_outer *= schedule.trips(outer_level, j)
    issued = n_outer if fused_loop_instructions else n_instr
    overhead_cycles = issued * arch.instr_overhead_cycles

    # --- DMA: dataflow-aware DRAM traffic over the DRAM link bandwidth.
    traffic = schedule.total_dram_traffic(arch)
    bpc = arch.levels[-1].bytes_per_cycle or 16.0
    dma_cycles = traffic / bpc

    # --- host preprocessing when not constant-folded (naive backend):
    # weight layout transform + weight/activation quantization run on the
    # host CPU per inference (paper §4: "inefficient handling of
    # preprocessing operations, such as matrix transposition and
    # quantization, which, without proper constant folding, impose
    # substantial overhead").
    preproc_cycles = 0.0
    if not folded_preprocessing:
        preproc_bytes = wl.operand_bytes("W") + wl.operand_bytes("In")
        preproc_cycles = preproc_bytes * arch.host_preproc_cycles_per_byte
    if host_epilogue:
        # unfused requantize + clip over the int32 accumulator output
        preproc_cycles += wl.operand_bytes("Out") * arch.host_epilogue_cycles_per_byte

    busy = compute_cycles + overhead_cycles
    if schedule.double_buffer:
        # DMA overlapped with compute; pay one leading tile fill of the
        # outermost on-chip buffer.  An arch with no buffered level has no
        # tile to pre-fill (there is nothing to double-buffer *into*), so
        # the lead term is zero rather than a meaningless PE-level
        # (level-0) footprint.
        lead = (
            schedule.level_footprint(outer_level) / bpc if buffered else 0.0
        )
        core = max(busy, dma_cycles) + lead
    else:
        core = busy + dma_cycles

    total = core + preproc_cycles
    return SimReport(
        compute_cycles=compute_cycles,
        overhead_cycles=overhead_cycles,
        dma_cycles=dma_cycles,
        preproc_cycles=preproc_cycles,
        total_cycles=total,
        utilization=schedule.utilization() * spatial_product / (arch.pe_dim**2),
        dram_traffic_bytes=traffic,
    )
