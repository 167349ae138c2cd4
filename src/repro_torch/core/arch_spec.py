"""Architectural description of a GEMM-based accelerator (paper §3.2b).

This mirrors the CoSA-style YAML input: a memory hierarchy (topology of
compute and storage units) plus hardware constraints that restrict the set
of valid mappings (fixed dataflows, per-level loop-factor limits, memory
shares for uneven mapping, double-buffering support).

The same dataclasses describe both the paper's Gemmini case study and our
TPU-v5e target; they can be loaded from / dumped to YAML so user-facing
descriptions stay declarative, exactly as in the paper.

Port of ``repro.core.arch_spec``: plain Python and numpy, copied with import changes
only unless noted here.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Sequence

# GEMM dimension names, paper footnote 1: In[N, C] @ W[C, K] -> Out[N, K].
GEMM_DIMS = ("N", "C", "K")

# Operand -> the GEMM dims its footprint depends on.
OPERAND_DIMS = {
    "In": ("N", "C"),
    "W": ("C", "K"),
    "Out": ("N", "K"),
}
OPERANDS = tuple(OPERAND_DIMS)


@dataclass(frozen=True)
class MemLevel:
    """One storage level of the accelerator hierarchy.

    ``size_bytes`` of 0 means "unbounded" (DRAM/HBM).  ``holds`` lists the
    operands this level buffers (CoSA's memory-level *skipping*: e.g. the
    Gemmini accumulator holds only Out).
    """

    name: str
    size_bytes: int
    holds: tuple[str, ...] = OPERANDS
    bytes_per_cycle: float = 0.0  # DMA bandwidth from the level above.

    def __post_init__(self):
        for op in self.holds:
            if op not in OPERANDS:
                raise ValueError(f"unknown operand {op!r} in level {self.name!r}")


@dataclass(frozen=True)
class Dataflow:
    """A dataflow supported by the accelerator's instruction set (Fig. 2a).

    ``stationary`` names the operand pinned at the PE-array level.
    ``loop_order`` is the temporal loop order at the top (DRAM) level, outer
    to inner, over GEMM dims.  For output-stationary GEMM the reduction dim
    C is innermost so partial sums stay resident; weight-stationary keeps W
    resident across the N loop.  ``spatial_dims`` are the two GEMM dims laid
    out across the PE array (WS: weights C x K are preloaded; OS: outputs
    N x K are pinned).
    """

    name: str
    stationary: str
    loop_order: tuple[str, ...]
    spatial_dims: tuple[str, str]

    def __post_init__(self):
        if self.stationary not in OPERANDS:
            raise ValueError(f"bad stationary operand {self.stationary!r}")
        if sorted(self.loop_order) != sorted(GEMM_DIMS):
            raise ValueError(f"loop_order must be a permutation of {GEMM_DIMS}")

    def reload_dims(self, op: str) -> tuple[str, ...]:
        """Dims whose DRAM-level trips force re-fetching operand `op`.

        A non-indexing dim forces reloads iff some indexing dim of `op`
        iterates *inside* it (otherwise the resident tile is reused).
        """
        idx = OPERAND_DIMS[op]
        out = []
        for pos, j in enumerate(self.loop_order):
            if j in idx:
                continue
            if any(jj in idx for jj in self.loop_order[pos + 1 :]):
                out.append(j)
        return tuple(out)


OUTPUT_STATIONARY = Dataflow(
    "OS", stationary="Out", loop_order=("N", "K", "C"), spatial_dims=("N", "K")
)
WEIGHT_STATIONARY = Dataflow(
    "WS", stationary="W", loop_order=("K", "C", "N"), spatial_dims=("C", "K")
)


@dataclass(frozen=True)
class HardwareConstraints:
    """Constraints restricting valid mappings (paper §3.1 / Fig. 2a).

    * ``pe_dim`` — the PE array is pe_dim x pe_dim; the compute instruction
      performs GEMMs with every dim <= pe_dim (paper Eq. 1).
    * ``spatial_levels`` — levels (by index) at which spatial mapping is
      allowed; for a systolic array only the PE level is spatial.
    * ``alignments`` — per-GEMM-dim hardware alignment of tile sizes (TPU:
      lane = 128, sublane = 8); tiles are padded up to these.
    * ``memory_share_candidates`` — the uneven-mapping sweep: each entry is
      (share_In, share_W, share_Out) summing to <= 1, the fraction of each
      buffered level granted to that operand.
    * ``double_buffer_candidates`` — double-buffering settings to sweep;
      when True the scheduler halves every operand's usable share (paper
      §3.1: "we halve the maximum available memory for each operand").
    """

    pe_dim: int
    spatial_levels: tuple[int, ...] = (0,)
    alignments: dict[str, int] = field(default_factory=lambda: {"N": 1, "C": 1, "K": 1})
    max_temporal_factors: dict[tuple[str, int], int] = field(default_factory=dict)
    memory_share_candidates: tuple[tuple[float, float, float], ...] = (
        (1 / 3, 1 / 3, 1 / 3),
        (1 / 4, 1 / 2, 1 / 4),
        (1 / 2, 1 / 4, 1 / 4),
        (1 / 4, 1 / 4, 1 / 2),
        (1 / 8, 3 / 4, 1 / 8),
    )
    double_buffer_candidates: tuple[bool, ...] = (True, False)


@dataclass(frozen=True)
class ArchSpec:
    """Full architectural description (the CoSA-format YAML of §3.2).

    Levels are ordered innermost-first: level 0 is the PE array (compute),
    the last level is DRAM/HBM.  Intermediate levels are on-chip buffers.
    """

    name: str
    levels: tuple[MemLevel, ...]
    constraints: HardwareConstraints
    dataflows: tuple[Dataflow, ...] = (WEIGHT_STATIONARY, OUTPUT_STATIONARY)
    macs_per_cycle: float = 0.0  # peak MACs/cycle of the PE array
    n_pe_units: int = 1  # parallel PE arrays (TPU v5e: 4 MXUs)
    freq_hz: float = 1e9
    # Per-element cost (cycles) of host-side preprocessing when it is NOT
    # constant-folded (Table 2's naive-backend penalty).
    host_preproc_cycles_per_byte: float = 4.0
    # Per-byte cost of unfused requantize/clip epilogues on the host
    # (naive backend keeps them as separate graph ops).
    host_epilogue_cycles_per_byte: float = 2.0
    # Fixed issue overhead per compute instruction (cycles).  The fused
    # loop-instruction path (C toolchain / proposed) amortizes this; the
    # naive per-tile path pays it every tile.
    instr_overhead_cycles: float = 30.0
    # Inter-device interconnect (sharded ExecutionPlans): per-link payload
    # bandwidth and the fixed per-hop latency of one ring step.  A ring
    # collective over P devices moves (P-1) messages of B/P bytes per
    # device, so e.g. all_gather costs (P-1) * (B/P) / link_bytes_per_cycle
    # + (P-1) * link_hop_cycles (see ``repro.core.collective``).
    link_bytes_per_cycle: float = 16.0
    link_hop_cycles: float = 64.0

    def __post_init__(self):
        if len(self.levels) < 2:
            raise ValueError("need at least a compute level and DRAM")
        if self.levels[-1].size_bytes != 0:
            raise ValueError("outermost level (DRAM/HBM) must be unbounded (size 0)")

    # -- helpers used by the scheduler -------------------------------------
    @property
    def num_levels(self) -> int:
        return len(self.levels)

    @property
    def pe_dim(self) -> int:
        return self.constraints.pe_dim

    def buffered_levels(self) -> list[int]:
        """Indices of bounded on-chip buffer levels (exclude PE and DRAM)."""
        return [
            i
            for i, lvl in enumerate(self.levels)
            if 0 < i < self.num_levels - 1 and lvl.size_bytes > 0
        ]

    def dataflow(self, name: str) -> Dataflow:
        for df in self.dataflows:
            if df.name == name:
                return df
        raise KeyError(f"{self.name} does not support dataflow {name!r}")

    # -- (de)serialization: the user-facing YAML form ----------------------
    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "levels": [dataclasses.asdict(l) for l in self.levels],
            "constraints": {
                "pe_dim": self.constraints.pe_dim,
                "spatial_levels": list(self.constraints.spatial_levels),
                "alignments": dict(self.constraints.alignments),
                # tuple keys (dim, level) flattened for JSON/YAML
                "max_temporal_factors": sorted(
                    [j, i, lim]
                    for (j, i), lim in self.constraints.max_temporal_factors.items()
                ),
                "memory_share_candidates": [
                    list(s) for s in self.constraints.memory_share_candidates
                ],
                "double_buffer_candidates": list(
                    self.constraints.double_buffer_candidates
                ),
            },
            "dataflows": [dataclasses.asdict(d) for d in self.dataflows],
            "macs_per_cycle": self.macs_per_cycle,
            "n_pe_units": self.n_pe_units,
            "freq_hz": self.freq_hz,
            "host_preproc_cycles_per_byte": self.host_preproc_cycles_per_byte,
            "host_epilogue_cycles_per_byte": self.host_epilogue_cycles_per_byte,
            "instr_overhead_cycles": self.instr_overhead_cycles,
            "link_bytes_per_cycle": self.link_bytes_per_cycle,
            "link_hop_cycles": self.link_hop_cycles,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "ArchSpec":
        levels = tuple(
            MemLevel(
                name=l["name"],
                size_bytes=l["size_bytes"],
                holds=tuple(l.get("holds", OPERANDS)),
                bytes_per_cycle=l.get("bytes_per_cycle", 0.0),
            )
            for l in d["levels"]
        )
        c = d["constraints"]
        share_candidates = tuple(
            tuple(s) for s in c.get("memory_share_candidates", ())
        )
        kwargs = {}
        if share_candidates:
            kwargs["memory_share_candidates"] = share_candidates
        constraints = HardwareConstraints(
            pe_dim=c["pe_dim"],
            spatial_levels=tuple(c.get("spatial_levels", (0,))),
            alignments=dict(c.get("alignments", {"N": 1, "C": 1, "K": 1})),
            max_temporal_factors={
                (j, i): lim for j, i, lim in c.get("max_temporal_factors", ())
            },
            double_buffer_candidates=tuple(
                c.get("double_buffer_candidates", (True, False))
            ),
            **kwargs,
        )
        dataflows = tuple(
            Dataflow(
                x["name"],
                x["stationary"],
                tuple(x["loop_order"]),
                tuple(x["spatial_dims"]),
            )
            for x in d.get("dataflows", ())
        ) or (WEIGHT_STATIONARY, OUTPUT_STATIONARY)
        return cls(
            name=d["name"],
            levels=levels,
            constraints=constraints,
            dataflows=dataflows,
            macs_per_cycle=d.get("macs_per_cycle", 0.0),
            n_pe_units=d.get("n_pe_units", 1),
            freq_hz=d.get("freq_hz", 1e9),
            host_preproc_cycles_per_byte=d.get("host_preproc_cycles_per_byte", 4.0),
            host_epilogue_cycles_per_byte=d.get("host_epilogue_cycles_per_byte", 2.0),
            instr_overhead_cycles=d.get("instr_overhead_cycles", 30.0),
            link_bytes_per_cycle=d.get("link_bytes_per_cycle", 16.0),
            link_hop_cycles=d.get("link_hop_cycles", 64.0),
        )

    def to_yaml(self) -> str:
        import yaml

        return yaml.safe_dump(self.to_dict(), sort_keys=False)

    @classmethod
    def from_yaml(cls, text: str) -> "ArchSpec":
        import yaml

        return cls.from_dict(yaml.safe_load(text))


@dataclass(frozen=True)
class GemmWorkload:
    """One GEMM operator instance to be scheduled: Out[N,K] = In[N,C] @ W[C,K].

    ``batch`` multiplies N for batched GEMMs flattened into the N dim.
    dtype sizes are per-operand so quantized (int8 in / int32 acc) layers
    are first-class, as in the paper's quantized dense operator.
    """

    N: int
    C: int
    K: int
    in_bytes: int = 1
    w_bytes: int = 1
    out_bytes: int = 4  # accumulator width
    name: str = "gemm"

    def dim(self, j: str) -> int:
        return {"N": self.N, "C": self.C, "K": self.K}[j]

    @property
    def macs(self) -> int:
        return self.N * self.C * self.K

    def operand_bytes(self, op: str) -> int:
        n = math.prod(self.dim(j) for j in OPERAND_DIMS[op])
        return n * {"In": self.in_bytes, "W": self.w_bytes, "Out": self.out_bytes}[op]

    def elem_bytes(self, op: str) -> int:
        return {"In": self.in_bytes, "W": self.w_bytes, "Out": self.out_bytes}[op]

    def key(self) -> tuple:
        return (self.N, self.C, self.K, self.in_bytes, self.w_bytes, self.out_bytes)


def conv2d_as_gemm(
    batch: int,
    in_h: int,
    in_w: int,
    in_ch: int,
    out_ch: int,
    kh: int,
    kw: int,
    stride: int = 1,
    padding: int = 0,
    in_bytes: int = 1,
    w_bytes: int = 1,
    out_bytes: int = 4,
    name: str = "conv2d",
) -> GemmWorkload:
    """im2col lowering of a conv to the GEMM workload the scheduler handles.

    The paper's functional description registers im2col as *preprocessing*
    (§3.2); after it, conv is exactly a GEMM with
    N = batch * out_h * out_w, C = kh * kw * in_ch, K = out_ch.
    """
    out_h = (in_h + 2 * padding - kh) // stride + 1
    out_w = (in_w + 2 * padding - kw) // stride + 1
    return GemmWorkload(
        N=batch * out_h * out_w,
        C=kh * kw * in_ch,
        K=out_ch,
        in_bytes=in_bytes,
        w_bytes=w_bytes,
        out_bytes=out_bytes,
        name=name,
    )
