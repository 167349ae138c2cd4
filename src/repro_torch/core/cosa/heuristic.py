"""Greedy fallback solver for environments without a MIP solver.

Produces a valid (constraint-respecting) schedule with the same output
format as the MIP.  Strategy: fill the PE level to the instruction limit
(Eq. 1), then greedily grow buffer-level tiles in traffic-benefit order
under the uneven-mapping capacity shares, and push the remainder to DRAM.
Quality is below the MIP's but every invariant holds; tests cross-check
both solvers on the same workloads.

Port of ``repro.core.cosa.heuristic``: plain Python and numpy, copied with import changes
only unless noted here.
"""

from __future__ import annotations

from repro_torch.core.arch_spec import (
    GEMM_DIMS,
    OPERAND_DIMS,
    OPERANDS,
    ArchSpec,
    Dataflow,
    GemmWorkload,
)
from repro_torch.core.cosa.factors import pad_to_alignment, prime_factors
from repro_torch.core.schedule import Schedule


def solve_heuristic(
    workload: GemmWorkload,
    arch: ArchSpec,
    dataflow: Dataflow,
    memory_shares: tuple[float, float, float],
    double_buffer: bool,
) -> Schedule | None:
    c = arch.constraints
    padded = {
        j: pad_to_alignment(workload.dim(j), c.alignments.get(j, 1))
        for j in GEMM_DIMS
    }
    remaining = {j: list(prime_factors(padded[j]))[::-1] for j in GEMM_DIMS}

    num_levels = arch.num_levels
    temporal = [dict.fromkeys(GEMM_DIMS, 1) for _ in range(num_levels)]
    spatial = [dict.fromkeys(GEMM_DIMS, 1) for _ in range(num_levels)]
    shares = dict(zip(OPERANDS, memory_shares))
    mult = 2 if double_buffer else 1

    # --- PE level: spatial dims first (fill the array), then temporal. ----
    def pe_total(j: str) -> int:
        return temporal[0][j] * spatial[0][j]

    for j in dataflow.spatial_dims:
        for f in sorted(remaining[j]):
            if pe_total(j) * f <= arch.pe_dim and 0 in c.spatial_levels:
                spatial[0][j] *= f
                remaining[j].remove(f)
    for j in GEMM_DIMS:
        for f in sorted(remaining[j]):
            if pe_total(j) * f <= arch.pe_dim:
                temporal[0][j] *= f
                remaining[j].remove(f)

    # --- Buffer levels: grow tiles greedily under capacity shares. --------
    def tile(level: int, j: str) -> int:
        t = 1
        for i in range(level + 1):
            t *= temporal[i][j] * spatial[i][j]
        return t

    def fits(level: int) -> bool:
        lvl = arch.levels[level]
        for op in lvl.holds:
            foot = workload.elem_bytes(op)
            for j in OPERAND_DIMS[op]:
                foot *= tile(level, j)
            if foot * mult > lvl.size_bytes * shares[op]:
                return False
        return True

    for level in arch.buffered_levels():
        if not fits(level):
            return None  # PE tile alone exceeds a share: infeasible combo
        progress = True
        while progress:
            progress = False
            # Prefer growing dims that cut DRAM reloads (dims in some
            # operand's reload set), smallest factors first.
            order = sorted(
                GEMM_DIMS,
                key=lambda j: -sum(
                    j in dataflow.reload_dims(op) for op in OPERANDS
                ),
            )
            for j in order:
                for f in sorted(set(remaining[j])):
                    temporal[level][j] *= f
                    if fits(level):
                        remaining[j].remove(f)
                        progress = True
                        break
                    temporal[level][j] //= f

    # --- Remainder -> DRAM level (temporal). -------------------------------
    for j in GEMM_DIMS:
        for f in remaining[j]:
            temporal[num_levels - 1][j] *= f
        remaining[j] = []

    return Schedule(
        workload=workload,
        arch_name=arch.name,
        dataflow=dataflow.name,
        temporal=tuple(temporal),
        spatial=tuple(spatial),
        memory_shares=memory_shares,
        double_buffer=double_buffer,
        loop_order=dataflow.loop_order,
        padded_dims=padded,
    )
