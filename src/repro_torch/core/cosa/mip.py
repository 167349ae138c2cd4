"""The extended CoSA Mixed-Integer Program (paper §3.1, Eq. 1).

Faithful reimplementation of CoSA's scheduling MIP specialized to GEMM
accelerators, with the paper's extensions:

  * **Eq. (1)** — instruction-set loop-factor limits: at the PE-array level
    ``I`` the (spatial + temporal) loop bounds of each GEMM dim must not
    exceed the PE array dimension::

        sum_{n,k} log(pf_{J,n}) X[J,n,I,k] <= log(DIM)

  * **Fixed dataflows** — the dataflow restricts which dims may map
    spatially onto the PE array and fixes the DRAM-level loop order.

  * **Uneven mapping** — per-operand memory shares parameterize the
    capacity constraints instead of CoSA's fixed share array.

  * **Double buffering** — halves every operand's usable share.

Variables: X[j, n, i, k] in {0,1} — prime factor ``n`` of GEMM dim ``j``
assigned to level ``i`` as temporal (k=0) or spatial (k=1).  Each factor is
assigned exactly once; tile sizes are products of assigned factors, so all
capacity constraints are *exactly* linear in log space.

Objective (CoSA-style log-space proxies, traded off against each other):
  minimize   sum_op w_op * log(DRAM reloads of op)   (traffic term)
           - beta  * sum log(PE-level factors)        (utilization term)

The MIP is solved per (dataflow x memory-share x double-buffer) combination
by ``repro_torch.core.scheduler`` (Fig. 2b); candidates are then ranked on the
cycle model, mirroring the paper's "evaluated on the hardware" step.

Port of ``repro.core.cosa.mip``: plain Python over PuLP/CBC, copied with
import changes only.  Where ``pulp`` is not installed ``solve`` returns
None and the scheduler falls back to the greedy heuristic, as the
reference does.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

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

TEMPORAL, SPATIAL = 0, 1


@dataclass
class CosaMIP:
    """Builds and solves one instance of the extended-CoSA MIP."""

    workload: GemmWorkload
    arch: ArchSpec
    dataflow: Dataflow
    memory_shares: tuple[float, float, float]
    double_buffer: bool
    # objective weights: spatial placement at the PE level is what fills the
    # array, so it earns a much larger bonus than temporal placement there.
    beta_spatial: float = 0.60
    beta_temporal: float = 0.05

    def __post_init__(self):
        c = self.arch.constraints
        self.padded_dims = {
            j: pad_to_alignment(self.workload.dim(j), c.alignments.get(j, 1))
            for j in GEMM_DIMS
        }
        self.factors = {j: prime_factors(self.padded_dims[j]) for j in GEMM_DIMS}
        self.num_levels = self.arch.num_levels

    # ------------------------------------------------------------------
    def _usable_share_bytes(self, level_idx: int, op: str) -> float:
        lvl = self.arch.levels[level_idx]
        share = dict(zip(OPERANDS, self.memory_shares))[op]
        cap = lvl.size_bytes * share
        if self.double_buffer:
            cap /= 2.0  # paper: halve so each operand fits in half the memory
        return cap

    def _buffer_level_for(self, op: str) -> int:
        for i in self.arch.buffered_levels():
            if op in self.arch.levels[i].holds:
                return i
        return 0

    # ------------------------------------------------------------------
    def solve(self, time_limit_s: float = 10.0) -> Schedule | None:
        try:
            import pulp
        except ImportError:
            return None

        wl, arch, df = self.workload, self.arch, self.dataflow
        prob = pulp.LpProblem("cosa_gemm", pulp.LpMinimize)

        # X[j][n][i][k]
        X: dict[tuple[str, int, int, int], "pulp.LpVariable"] = {}
        for j in GEMM_DIMS:
            for n in range(len(self.factors[j])):
                for i in range(self.num_levels):
                    for k in (TEMPORAL, SPATIAL):
                        X[j, n, i, k] = pulp.LpVariable(
                            f"X_{j}_{n}_{i}_{k}", cat="Binary"
                        )

        logpf = {
            (j, n): math.log(self.factors[j][n])
            for j in GEMM_DIMS
            for n in range(len(self.factors[j]))
        }

        # (C1) each prime factor assigned exactly once.
        for j in GEMM_DIMS:
            for n in range(len(self.factors[j])):
                prob += (
                    pulp.lpSum(
                        X[j, n, i, k]
                        for i in range(self.num_levels)
                        for k in (TEMPORAL, SPATIAL)
                    )
                    == 1,
                    f"assign_{j}_{n}",
                )

        # (C2) spatial mapping only at spatial levels, and only for the
        # dataflow's PE-array dims (WS: CxK preloaded; OS: NxK pinned).
        for j in GEMM_DIMS:
            for n in range(len(self.factors[j])):
                for i in range(self.num_levels):
                    allowed = (
                        i in arch.constraints.spatial_levels
                        and j in df.spatial_dims
                    )
                    if not allowed:
                        prob += X[j, n, i, SPATIAL] == 0, f"nospat_{j}_{n}_{i}"

        # (C3) paper Eq. (1): PE-level loop bounds <= DIM per GEMM dim.
        log_dim = math.log(arch.pe_dim)
        for j in GEMM_DIMS:
            prob += (
                pulp.lpSum(
                    logpf[j, n] * X[j, n, 0, k]
                    for n in range(len(self.factors[j]))
                    for k in (TEMPORAL, SPATIAL)
                )
                <= log_dim + 1e-9,
                f"eq1_{j}",
            )

        # (C4) memory capacity with uneven shares (+ double-buffer halving).
        # log(tile footprint at level i) is linear in X over levels <= i.
        for i in arch.buffered_levels():
            lvl = arch.levels[i]
            for op in lvl.holds:
                cap = self._usable_share_bytes(i, op)
                elem = wl.elem_bytes(op)
                if cap < elem:
                    return None  # share can't hold even one element
                bound = math.log(cap / elem)
                prob += (
                    pulp.lpSum(
                        logpf[j, n] * X[j, n, ii, k]
                        for j in OPERAND_DIMS[op]
                        for n in range(len(self.factors[j]))
                        for ii in range(i + 1)
                        for k in (TEMPORAL, SPATIAL)
                    )
                    <= bound + 1e-9,
                    f"cap_{i}_{op}",
                )

        # (C5) optional per-level/dim temporal limits from the description.
        for (j, i), lim in arch.constraints.max_temporal_factors.items():
            prob += (
                pulp.lpSum(
                    logpf[j, n] * X[j, n, i, TEMPORAL]
                    for n in range(len(self.factors[j]))
                )
                <= math.log(lim) + 1e-9,
                f"maxt_{j}_{i}",
            )

        # Objective: traffic proxy + utilization bonus.
        total_bytes = sum(wl.operand_bytes(op) for op in OPERANDS)
        obj = []
        for op in OPERANDS:
            w_op = wl.operand_bytes(op) / total_bytes
            buf = self._buffer_level_for(op)
            for j in df.reload_dims(op):
                for n in range(len(self.factors[j])):
                    for i in range(buf + 1, self.num_levels):
                        for k in (TEMPORAL, SPATIAL):
                            obj.append(w_op * logpf[j, n] * X[j, n, i, k])
        # utilization: reward factors placed at the PE level — spatially
        # above all (that is what occupies the array), temporally second
        # (bigger instructions amortize issue overhead).
        for j in GEMM_DIMS:
            for n in range(len(self.factors[j])):
                obj.append(-self.beta_spatial * logpf[j, n] * X[j, n, 0, SPATIAL])
                obj.append(-self.beta_temporal * logpf[j, n] * X[j, n, 0, TEMPORAL])
        prob += pulp.lpSum(obj)

        solver = pulp.PULP_CBC_CMD(msg=0, timeLimit=time_limit_s)
        try:
            prob.solve(solver)
        except Exception:
            return None
        if pulp.LpStatus[prob.status] not in ("Optimal", "Not Solved", "Integer Feasible"):
            return None
        if prob.status != pulp.LpStatusOptimal:
            return None

        # Decode X -> factor tables.
        temporal = [dict.fromkeys(GEMM_DIMS, 1) for _ in range(self.num_levels)]
        spatial = [dict.fromkeys(GEMM_DIMS, 1) for _ in range(self.num_levels)]
        for (j, n, i, k), var in X.items():
            v = var.value()
            if v is not None and v > 0.5:
                if k == TEMPORAL:
                    temporal[i][j] *= self.factors[j][n]
                else:
                    spatial[i][j] *= self.factors[j][n]

        return Schedule(
            workload=wl,
            arch_name=arch.name,
            dataflow=df.name,
            temporal=tuple(temporal),
            spatial=tuple(spatial),
            memory_shares=self.memory_shares,
            double_buffer=self.double_buffer,
            loop_order=df.loop_order,
            padded_dims=self.padded_dims,
        )


def solve_mip(
    workload: GemmWorkload,
    arch: ArchSpec,
    dataflow: Dataflow,
    memory_shares: tuple[float, float, float],
    double_buffer: bool,
    time_limit_s: float = 10.0,
) -> Schedule | None:
    return CosaMIP(
        workload=workload,
        arch=arch,
        dataflow=dataflow,
        memory_shares=memory_shares,
        double_buffer=double_buffer,
    ).solve(time_limit_s=time_limit_s)
