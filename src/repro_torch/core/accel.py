"""Accelerator functional description (paper §3.2, Fig. 3).

Users describe a GEMM-based accelerator with three registration decorators,
mirroring the paper's Python APIs:

  * ``@desc.register_preprocessing(op, operand=..., constant=True)`` —
    layout/quantization transforms an operand needs before the accelerator
    can consume it (transposition, flattening, im2col, weight quantization).
    Constant-related preprocessing is folded at compile time; the rest runs
    on the host (§3.2: "Constant-related preprocessing is folded at
    compile-time; others run on the host CPU").

  * ``@desc.register_core_compute(tag, op=...)`` — the tensor computation of
    a supported operator (dense / conv2d), written against plain jnp (our
    TE stand-in).  Linked to an accelerator interface via ``tag`` and
    consumed by the strategy generator.

  * ``@desc.register_hw_intrinsic(name, kind=...)`` — interface functions
    for offloading, categorized into compute / memory / config intrinsics
    (Fig. 3c/d).  Compute intrinsics carry the tile limits that the
    extended-CoSA MIP enforces via Eq. (1); memory intrinsics describe the
    DMA interface the mapping generator lowers to (explicit mvin/mvout for
    Gemmini, BlockSpec-driven copies for the TPU backend).

Together with the architectural ``ArchSpec`` this is the complete
user-provided model; everything else is generated by the configurators.

Port of ``repro.core.accel``: plain Python and numpy, copied with import changes
only unless noted here.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

from repro_torch.core.arch_spec import ArchSpec

SUPPORTED_OPS = ("dense", "conv2d", "matmul")
INTRINSIC_KINDS = ("compute", "memory", "config")


@dataclass
class PreprocessingDef:
    name: str
    op: str  # operator it applies to ("dense", "conv2d")
    operand: str  # which operand it transforms ("In", "W", "Out")
    constant: bool  # True => foldable at compile time when operand is const
    fn: Callable


@dataclass
class CoreComputeDef:
    tag: str  # links the compute to a hw intrinsic
    op: str  # operator implemented ("dense", "conv2d")
    fn: Callable  # jnp computation (TE stand-in)
    quantized: bool = False


@dataclass
class IntrinsicDef:
    name: str
    kind: str  # compute | memory | config
    tag: str | None = None  # compute intrinsics: tag matched by core computes
    operand: str | None = None  # memory intrinsics: operand moved
    tile_limits: dict[str, int] | None = None  # compute: max GEMM tile dims
    fn: Callable | None = None
    attrs: dict[str, Any] = field(default_factory=dict)


@dataclass
class AcceleratorDescription:
    """The complete user-facing accelerator model (functional + architectural)."""

    name: str
    arch: ArchSpec
    preprocessing: list[PreprocessingDef] = field(default_factory=list)
    core_computes: dict[str, CoreComputeDef] = field(default_factory=dict)
    intrinsics: dict[str, IntrinsicDef] = field(default_factory=dict)
    #: target-specific graph-rewrite rules (repro.core.rewrite.RewriteRule);
    #: the frontend pipeline runs them right after generic legalization
    rewrite_rules: list = field(default_factory=list)

    # -- registration decorators (paper Fig. 3) ----------------------------
    def register_preprocessing(
        self, op: str, *, operand: str, constant: bool = True, name: str | None = None
    ):
        if op not in SUPPORTED_OPS:
            raise ValueError(f"unsupported operator {op!r}")

        def deco(fn: Callable) -> Callable:
            self.preprocessing.append(
                PreprocessingDef(
                    name=name or fn.__name__,
                    op=op,
                    operand=operand,
                    constant=constant,
                    fn=fn,
                )
            )
            return fn

        return deco

    def register_core_compute(self, tag: str, *, op: str, quantized: bool = False):
        if op not in SUPPORTED_OPS:
            raise ValueError(f"unsupported operator {op!r}")

        def deco(fn: Callable) -> Callable:
            self.core_computes[tag] = CoreComputeDef(
                tag=tag, op=op, fn=fn, quantized=quantized
            )
            return fn

        return deco

    def register_hw_intrinsic(
        self,
        name: str,
        *,
        kind: str,
        tag: str | None = None,
        operand: str | None = None,
        tile_limits: dict[str, int] | None = None,
        **attrs,
    ):
        if kind not in INTRINSIC_KINDS:
            raise ValueError(f"intrinsic kind must be one of {INTRINSIC_KINDS}")

        def deco(fn: Callable) -> Callable:
            self.intrinsics[name] = IntrinsicDef(
                name=name,
                kind=kind,
                tag=tag,
                operand=operand,
                tile_limits=tile_limits,
                fn=fn,
                attrs=dict(attrs),
            )
            return fn

        return deco

    def register_rewrite(self, rule) -> None:
        """Contribute a prebuilt ``RewriteRule`` to this target's frontend
        pipeline (runs after the generic legalization rules)."""
        self.rewrite_rules.append(rule)

    def register_rewrite_pattern(self, name: str, pattern):
        """Decorator form: the decorated function is the rule's ``build``
        callback —

            @desc.register_rewrite_pattern("fuse-x", P("relu", P("dense", capture="d")))
            def build(match, graph):
                return Node(...)
        """
        from repro_torch.core.rewrite import RewriteRule

        def deco(build: Callable):
            r = RewriteRule(name=name, pattern=pattern, build=build)
            self.rewrite_rules.append(r)
            return r

        return deco

    # -- queries used by the configurators ---------------------------------
    def supported_ops(self) -> set[str]:
        return {cc.op for cc in self.core_computes.values()}

    def supports_dtype(self, op: str, dtype: str) -> bool:
        """Whether the datapath can execute ``op`` on ``dtype`` operands.

        Integer operands run exactly on either datapath (a float MAC
        accumulates int8 products exactly), but float operands on a
        quantized-only array (e.g. Gemmini's int8 PEs) would be truncated
        by the integer cast — those ops must stay on the host.
        """
        base = op.replace("generalized_", "")
        computes = [cc for cc in self.core_computes.values() if cc.op == base]
        if not computes:
            return False
        if dtype.startswith(("float", "bfloat")):
            return any(not cc.quantized for cc in computes)
        return True

    def compute_for_op(self, op: str) -> CoreComputeDef:
        for cc in self.core_computes.values():
            if cc.op == op:
                return cc
        raise KeyError(f"{self.name}: no core compute registered for op {op!r}")

    def compute_intrinsic_for_tag(self, tag: str) -> IntrinsicDef | None:
        for intr in self.intrinsics.values():
            if intr.kind == "compute" and intr.tag == tag:
                return intr
        return None

    def memory_intrinsics(self) -> list[IntrinsicDef]:
        return [i for i in self.intrinsics.values() if i.kind == "memory"]

    def preprocessing_for(self, op: str, operand: str) -> list[PreprocessingDef]:
        return [
            p for p in self.preprocessing if p.op == op and p.operand == operand
        ]

    def fingerprint(self) -> str:
        """Stable hash of everything a schedule depends on: the architectural
        description plus the scheduling-relevant parts of the functional one
        (compute tags, quantization, intrinsic tile limits).  Keys the
        persistent schedule cache — two descriptions with the same
        fingerprint produce identical schedules for the same workload.

        Recomputed on every call so description mutations are always
        reflected; hot paths (``CompilerBackend``) memoize it per backend,
        where the description is frozen by contract.
        """
        import hashlib
        import json

        payload = {
            "arch": self.arch.to_dict(),
            "core_computes": sorted(
                (cc.tag, cc.op, cc.quantized) for cc in self.core_computes.values()
            ),
            "intrinsics": sorted(
                (
                    i.name,
                    i.kind,
                    i.tag or "",
                    i.operand or "",
                    sorted((i.tile_limits or {}).items()),
                )
                for i in self.intrinsics.values()
            ),
        }
        blob = json.dumps(payload, sort_keys=True, default=str)
        return hashlib.sha256(blob.encode()).hexdigest()[:16]

    def validate(self) -> list[str]:
        """Consistency checks run by the configurators before generation."""
        errs = []
        for tag, cc in self.core_computes.items():
            intr = self.compute_intrinsic_for_tag(tag)
            if intr is None:
                errs.append(f"core compute {tag!r} has no compute intrinsic")
            elif intr.tile_limits:
                for j, lim in intr.tile_limits.items():
                    if lim > self.arch.pe_dim:
                        errs.append(
                            f"intrinsic {intr.name!r} tile limit {j}={lim} exceeds "
                            f"PE dim {self.arch.pe_dim}"
                        )
        if not any(i.kind == "memory" for i in self.intrinsics.values()):
            errs.append("no memory intrinsics registered")
        return errs
