"""Schedule: the output of the extended-CoSA scheduler (paper §3.1).

A Schedule fixes, for one GEMM workload on one accelerator:

  * per-level, per-dim *temporal* tile factors ``t[i][j]``,
  * per-level, per-dim *spatial* tile factors ``s[i][j]`` (PE level only
    for systolic targets),
  * the dataflow (loop order / stationary operand),
  * the per-operand memory shares actually used (uneven mapping),
  * whether double buffering is enabled.

CoSA emits this as a YAML file specifying "the tile factors and the
ordering of tensor dimensions for each memory level"; the mapping
generator consumes it (here: lowers it to Pallas grid/BlockSpecs, see
``repro.core.mapping``).

Port of ``repro.core.schedule``: plain Python and numpy, copied with import changes
only unless noted here.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

from repro_torch.core.arch_spec import (
    GEMM_DIMS,
    OPERAND_DIMS,
    OPERANDS,
    ArchSpec,
    GemmWorkload,
)


@dataclass(frozen=True)
class Schedule:
    workload: GemmWorkload
    arch_name: str
    dataflow: str
    # factors[i][j] for level i (0 = PE ... last = DRAM), dim j in GEMM_DIMS.
    temporal: tuple[dict[str, int], ...]
    spatial: tuple[dict[str, int], ...]
    memory_shares: tuple[float, float, float]  # (In, W, Out)
    double_buffer: bool
    # Loop order at the DRAM level, outer->inner (from the dataflow).
    loop_order: tuple[str, ...]
    # Dims were padded up to these bounds before factorization.
    padded_dims: dict[str, int] = field(default_factory=dict)

    # -- derived quantities --------------------------------------------------
    def padded(self, j: str) -> int:
        return self.padded_dims.get(j, self.workload.dim(j))

    def tile(self, level: int, j: str) -> int:
        """Tile size of dim j as seen *at* `level` (product of factors below
        and including `level`)."""
        t = 1
        for i in range(level + 1):
            t *= self.temporal[i][j] * self.spatial[i][j]
        return t

    def trips(self, level: int, j: str) -> int:
        """Number of iterations of dim j's loop *above* `level`."""
        return self.padded(j) // self.tile(level, j)

    def full_cover(self) -> bool:
        return all(
            self.tile(len(self.temporal) - 1, j) == self.padded(j) for j in GEMM_DIMS
        )

    def tile_bytes(self, level: int, op: str) -> int:
        """Footprint of operand `op`'s tile buffered at `level`."""
        n = math.prod(self.tile(level, j) for j in OPERAND_DIMS[op])
        return n * self.workload.elem_bytes(op)

    def level_footprint(self, level: int, holds: tuple[str, ...] = OPERANDS) -> int:
        mult = 2 if self.double_buffer else 1
        return mult * sum(self.tile_bytes(level, op) for op in holds)

    def operand_dram_traffic(self, arch: ArchSpec, op: str) -> int:
        """Bytes moved between DRAM and the outermost buffer for operand op.

        Dataflow-aware reload model (CoSA's traffic proxy): the operand is
        streamed once, and re-streamed once per trip of each non-indexing
        loop dim that has an indexing dim iterating inside it (otherwise the
        resident tile is reused — e.g. OS keeps Out across the innermost C
        loop, WS keeps W across the innermost N loop).
        """
        buf = self._buffer_level_for(arch, op)
        df = arch.dataflow(self.dataflow)
        reloads = math.prod(self.trips(buf, j) for j in df.reload_dims(op))
        base = math.prod(self.padded(j) for j in OPERAND_DIMS[op])
        base *= self.workload.elem_bytes(op)
        if op == "Out":
            # Output reloads > 1 mean partial-sum write-back + read traffic.
            return base * (2 * reloads - 1)
        return base * reloads

    def _buffer_level_for(self, arch: ArchSpec, op: str) -> int:
        for i in arch.buffered_levels():
            if op in arch.levels[i].holds:
                return i
        return 0

    def total_dram_traffic(self, arch: ArchSpec) -> int:
        return sum(self.operand_dram_traffic(arch, op) for op in OPERANDS)

    def pe_tile(self) -> dict[str, int]:
        """GEMM shape of one compute instruction (level-0 tile)."""
        return {j: self.tile(0, j) for j in GEMM_DIMS}

    def num_instructions(self) -> int:
        """Number of PE compute instructions issued for the whole GEMM."""
        return math.prod(self.trips(0, j) for j in GEMM_DIMS)

    def utilization(self) -> float:
        """Fraction of useful MACs: padding waste x PE occupancy."""
        useful = self.workload.macs
        padded = math.prod(self.padded(j) for j in GEMM_DIMS)
        return useful / padded

    # -- reporting (the CoSA-style YAML output consumed by the mapping
    #    generator, paper §3.3 "Mapping Generator") -------------------------
    def to_dict(self) -> dict:
        return {
            "workload": {
                "name": self.workload.name,
                "N": self.workload.N,
                "C": self.workload.C,
                "K": self.workload.K,
                "in_bytes": self.workload.in_bytes,
                "w_bytes": self.workload.w_bytes,
                "out_bytes": self.workload.out_bytes,
            },
            "arch": self.arch_name,
            "dataflow": self.dataflow,
            "loop_order": list(self.loop_order),
            "padded_dims": dict(self.padded_dims),
            "memory_shares": list(self.memory_shares),
            "double_buffer": self.double_buffer,
            "levels": [
                {
                    "level": i,
                    "temporal": dict(self.temporal[i]),
                    "spatial": dict(self.spatial[i]),
                }
                for i in range(len(self.temporal))
            ],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Schedule":
        """Inverse of ``to_dict`` — used by the persistent schedule cache."""
        w = d["workload"]
        workload = GemmWorkload(
            N=w["N"],
            C=w["C"],
            K=w["K"],
            in_bytes=w.get("in_bytes", 1),
            w_bytes=w.get("w_bytes", 1),
            out_bytes=w.get("out_bytes", 4),
            name=w.get("name", "gemm"),
        )
        return cls(
            workload=workload,
            arch_name=d["arch"],
            dataflow=d["dataflow"],
            temporal=tuple(
                {j: lvl["temporal"][j] for j in GEMM_DIMS} for lvl in d["levels"]
            ),
            spatial=tuple(
                {j: lvl["spatial"][j] for j in GEMM_DIMS} for lvl in d["levels"]
            ),
            memory_shares=tuple(d["memory_shares"]),
            double_buffer=d["double_buffer"],
            loop_order=tuple(d["loop_order"]),
            padded_dims=dict(d["padded_dims"]),
        )

    def to_yaml(self) -> str:
        import yaml

        return yaml.safe_dump(self.to_dict(), sort_keys=False)

    def describe(self) -> str:
        pe = self.pe_tile()
        lines = [
            f"Schedule[{self.workload.name}] {self.workload.N}x{self.workload.C}x"
            f"{self.workload.K} on {self.arch_name} ({self.dataflow}, "
            f"dbuf={self.double_buffer}, shares={self.memory_shares})",
            f"  PE tile: N={pe['N']} C={pe['C']} K={pe['K']}"
            f"  instructions={self.num_instructions()}",
        ]
        for i in range(1, len(self.temporal) - 1):
            tiles = {j: self.tile(i, j) for j in GEMM_DIMS}
            lines.append(
                f"  L{i} tile: {tiles}  footprint={self.level_footprint(i):,}B"
            )
        lines.append(f"  loop order (DRAM, outer->inner): {'>'.join(self.loop_order)}")
        return "\n".join(lines)


def validate_schedule(s: Schedule, arch: ArchSpec) -> list[str]:
    """Check every hardware constraint; returns a list of violations.

    These are the invariants the MIP encodes; used by tests (hypothesis
    properties) and as a safety net before lowering to a kernel.
    """
    errs: list[str] = []
    if len(s.temporal) != arch.num_levels or len(s.spatial) != arch.num_levels:
        errs.append("factor tables do not match the level count")
        return errs
    # Full coverage: product of factors == padded dim.
    for j in GEMM_DIMS:
        prod = 1
        for i in range(arch.num_levels):
            prod *= s.temporal[i][j] * s.spatial[i][j]
        if prod != s.padded(j):
            errs.append(f"dim {j}: factors product {prod} != padded {s.padded(j)}")
        if s.padded(j) < s.workload.dim(j):
            errs.append(f"dim {j}: padded below workload size")
    # Eq. (1): PE-level loop factors bounded by the PE array dimension.
    for j in GEMM_DIMS:
        pe = s.temporal[0][j] * s.spatial[0][j]
        if pe > arch.pe_dim:
            errs.append(f"Eq.(1) violated: dim {j} PE factor {pe} > {arch.pe_dim}")
    # Spatial factors only at spatial levels.
    for i in range(arch.num_levels):
        if i not in arch.constraints.spatial_levels:
            for j in GEMM_DIMS:
                if s.spatial[i][j] != 1:
                    errs.append(f"spatial factor at non-spatial level {i} dim {j}")
    # Memory capacity with uneven shares (+ double buffering halving).
    shares = dict(zip(OPERANDS, s.memory_shares))
    for i in arch.buffered_levels():
        lvl = arch.levels[i]
        for op in lvl.holds:
            cap = lvl.size_bytes * shares[op]
            used = s.tile_bytes(i, op) * (2 if s.double_buffer else 1)
            if used > cap + 1e-6:
                errs.append(
                    f"level {lvl.name} operand {op}: {used:,}B > share {cap:,.0f}B"
                )
    return errs
