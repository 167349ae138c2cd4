"""The paper's two evaluation baselines (Table 2), reimplemented.

1. **C-based toolchain** — Gemmini's hand-written ``tiled_matmul_auto``:
   weight-stationary, double-buffered, grows scratchpad tiles greedily in
   units of DIM with an even memory split, and issues fused loop
   instructions.  This is the "manually optimized" reference the proposed
   flow must match.

2. **Naive UMA/BYOC backend** — what you get from stock BYOC integration:
   no tensor scheduling (each compute instruction covers one minimal PE
   tile straight from DRAM), no double buffering, per-tile instruction
   issue, and — critically — *no constant folding of preprocessing*, so
   weight transposition/quantization run on the host every inference.

Port of ``repro.core.baselines``: plain Python and numpy, copied with import changes
only unless noted here.
"""

from __future__ import annotations

from repro_torch.core.arch_spec import (
    GEMM_DIMS,
    OPERAND_DIMS,
    OPERANDS,
    ArchSpec,
    GemmWorkload,
)
from repro_torch.core.cosa.factors import pad_to_alignment, prime_factors
from repro_torch.core.schedule import Schedule
from repro_torch.core.simulator import SimReport, simulate


def _pe_first_factors(workload, arch, padded):
    """Split each padded dim into (pe_factor, rest) with pe_factor <= DIM,
    preferring the largest PE tile (Gemmini mvin granularity)."""
    pe = {}
    rest = {}
    for j in GEMM_DIMS:
        fs = prime_factors(padded[j])
        t = 1
        leftovers = []
        for f in sorted(fs):
            if t * f <= arch.pe_dim:
                t *= f
            else:
                leftovers.append(f)
        pe[j] = t
        r = 1
        for f in leftovers:
            r *= f
        rest[j] = r
    return pe, rest


def c_toolchain_schedule(workload: GemmWorkload, arch: ArchSpec) -> Schedule:
    """Gemmini ``tiled_matmul_auto``-style heuristic schedule."""
    df = arch.dataflow("WS")
    c = arch.constraints
    padded = {
        j: pad_to_alignment(workload.dim(j), max(c.alignments.get(j, 1), 1))
        for j in GEMM_DIMS
    }
    pe, rest = _pe_first_factors(workload, arch, padded)

    num_levels = arch.num_levels
    temporal = [dict.fromkeys(GEMM_DIMS, 1) for _ in range(num_levels)]
    spatial = [dict.fromkeys(GEMM_DIMS, 1) for _ in range(num_levels)]

    # PE level: WS maps C x K spatially; N streams temporally.
    for j in GEMM_DIMS:
        if j in df.spatial_dims and 0 in c.spatial_levels:
            spatial[0][j] = pe[j]
        else:
            temporal[0][j] = pe[j]

    # Scratchpad level: grow tiles in DIM-units evenly (I/J/K round-robin),
    # double-buffered halves, even operand split — Gemmini's heuristic.
    shares = (1 / 3, 1 / 3, 1 / 3)
    share_map = dict(zip(OPERANDS, shares))
    buffered = arch.buffered_levels()

    def fits() -> bool:
        for i in buffered:
            lvl = arch.levels[i]
            for op in lvl.holds:
                foot = workload.elem_bytes(op)
                for j in OPERAND_DIMS[op]:
                    t = 1
                    for ii in range(i + 1):
                        t *= temporal[ii][j] * spatial[ii][j]
                    foot *= t
                if foot * 2 > lvl.size_bytes * share_map[op]:
                    return False
        return True

    level = buffered[0] if buffered else num_levels - 1
    remaining = {j: prime_factors(rest[j]) for j in GEMM_DIMS}
    remaining = {j: list(fs) for j, fs in remaining.items()}
    progress = True
    while progress:
        progress = False
        for j in GEMM_DIMS:  # round-robin growth, Gemmini-style
            for f in sorted(set(remaining[j])):
                temporal[level][j] *= f
                if fits():
                    remaining[j].remove(f)
                    progress = True
                    break
                temporal[level][j] //= f

    for j in GEMM_DIMS:
        for f in remaining[j]:
            temporal[num_levels - 1][j] *= f

    return Schedule(
        workload=workload,
        arch_name=arch.name,
        dataflow="WS",
        temporal=tuple(temporal),
        spatial=tuple(spatial),
        memory_shares=shares,
        double_buffer=True,
        loop_order=df.loop_order,
        padded_dims=padded,
    )


def naive_schedule(workload: GemmWorkload, arch: ArchSpec) -> Schedule:
    """Stock BYOC/UMA lowering: UMA's default TE schedule does block for the
    scratchpad (TVM's default tiling is not insane), but with an even
    operand split, no double buffering — and the backend issues one compute
    instruction per PE tile instead of a fused loop descriptor."""
    from repro_torch.core.cosa.heuristic import solve_heuristic

    df = arch.dataflow("WS")
    sched = solve_heuristic(
        workload, arch, df, (1 / 3, 1 / 3, 1 / 3), double_buffer=False
    )
    if sched is not None:
        return sched

    # degenerate fallback: one PE tile at a time straight from DRAM
    c = arch.constraints
    padded = {
        j: pad_to_alignment(workload.dim(j), max(c.alignments.get(j, 1), 1))
        for j in GEMM_DIMS
    }
    pe, rest = _pe_first_factors(workload, arch, padded)
    num_levels = arch.num_levels
    temporal = [dict.fromkeys(GEMM_DIMS, 1) for _ in range(num_levels)]
    spatial = [dict.fromkeys(GEMM_DIMS, 1) for _ in range(num_levels)]
    for j in GEMM_DIMS:
        if j in df.spatial_dims and 0 in c.spatial_levels:
            spatial[0][j] = pe[j]
        else:
            temporal[0][j] = pe[j]
        temporal[num_levels - 1][j] = rest[j]
    return Schedule(
        workload=workload,
        arch_name=arch.name,
        dataflow="WS",
        temporal=tuple(temporal),
        spatial=tuple(spatial),
        memory_shares=(1 / 3, 1 / 3, 1 / 3),
        double_buffer=False,
        loop_order=df.loop_order,
        padded_dims=padded,
    )


def simulate_c_toolchain(workload: GemmWorkload, arch: ArchSpec) -> SimReport:
    return simulate(
        c_toolchain_schedule(workload, arch),
        arch,
        folded_preprocessing=True,
        fused_loop_instructions=True,
    )


def simulate_naive_byoc(workload: GemmWorkload, arch: ArchSpec) -> SimReport:
    return simulate(
        naive_schedule(workload, arch),
        arch,
        folded_preprocessing=False,
        fused_loop_instructions=False,
        host_epilogue=True,
    )
