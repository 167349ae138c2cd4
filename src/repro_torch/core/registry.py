"""Accelerator integration registry — the backend-generation machinery.

The paper's headline claim is that a new GEMM accelerator integrates into
the compiler "without requiring in-depth knowledge of the underlying
compiler".  This module is that claim made concrete, following the BYOC
registration pattern: accelerator descriptions register under a name, and
``build_integrated_backend()`` turns a description (or a registered name)
into a fully generated ``CompilerBackend``.  Users reach it through the
one front door, ``repro_torch.compile(model, repro_torch.Target(...))``.
``build_integrated_backend()`` additionally:

  * validates the description up front (required intrinsics, memory
    hierarchy sanity, dataflow coverage) and raises ``IntegrationError``
    with every problem listed, instead of failing mid-compile;
  * attaches a persistent schedule cache (see ``schedule_cache.py``) keyed
    by (workload, arch fingerprint, mode), so recompiling the same layer —
    even in a new process — performs zero extended-CoSA DSE sweeps;
  * optionally parallelizes the cold-cache DSE over mapping candidates
    (``parallel_dse=True``).

Out-of-tree accelerators use the same decorator as the in-tree ones:

    @repro_torch.register_accelerator("my_npu")
    def make_my_npu():
        return AcceleratorDescription(...)

Port of ``repro.core.registry``: ``REGISTRY`` holds ``edge_npu``,
``gemmini`` and ``tpu_v5e``, as the reference's does, and the deprecated
``integrate()`` wraps the same machinery for the legacy two-step flow.
``use_pallas`` defaults to True (the kernel route) where the reference's
defaults to False (its numpy emulation).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable

from repro_torch.core.accel import AcceleratorDescription
from repro_torch.core.arch_spec import GEMM_DIMS
from repro_torch.core.configurators import build_backend
from repro_torch.core.deprecation import warn_deprecated
from repro_torch.core.pipeline import CompilerBackend
from repro_torch.core.schedule_cache import ScheduleCache, default_cache_dir


class IntegrationError(ValueError):
    """A description failed validation; ``.problems`` lists every issue."""

    def __init__(self, name: str, problems: list[str]):
        self.problems = problems
        bullet = "\n  - ".join(problems)
        super().__init__(
            f"accelerator {name!r} failed integration validation:\n  - {bullet}"
        )


def validate_description(desc: AcceleratorDescription) -> list[str]:
    """Full pre-integration validation: the description's own consistency
    checks plus registry-level sanity (things that would otherwise surface
    as confusing mid-compile failures)."""
    errs = list(desc.validate())
    arch = desc.arch

    if not desc.core_computes:
        errs.append("no core computes registered (register_core_compute)")
    if not arch.buffered_levels():
        errs.append("memory hierarchy has no bounded on-chip buffer level")
    if arch.macs_per_cycle <= 0:
        errs.append("arch.macs_per_cycle must be positive")
    for j in arch.constraints.alignments:
        if j not in GEMM_DIMS:
            errs.append(f"alignment for unknown GEMM dim {j!r}")
    for intr in desc.intrinsics.values():
        if intr.kind == "compute" and not intr.tile_limits:
            errs.append(
                f"compute intrinsic {intr.name!r} has no tile_limits "
                f"(Eq. 1 needs the instruction's max GEMM tile)"
            )
    # (an arch without a 'WS' dataflow is still valid — it just cannot run
    # the c_toolchain/naive baseline modes; the pipeline reports that per
    # compile so OS-only accelerators keep working in 'proposed' mode.)
    # every buffered level must hold one pe_dim x pe_dim tile per operand it
    # buffers (1-byte elements — the most forgiving case); anything smaller
    # can never produce a feasible schedule and would otherwise surface as a
    # mid-compile "no feasible schedule" RuntimeError.
    for i in arch.buffered_levels():
        lvl = arch.levels[i]
        min_bytes = arch.pe_dim * arch.pe_dim * len(lvl.holds)
        if lvl.holds and lvl.size_bytes < min_bytes:
            errs.append(
                f"level {lvl.name!r} ({lvl.size_bytes}B) cannot hold one "
                f"{arch.pe_dim}x{arch.pe_dim} PE tile per buffered operand "
                f"{lvl.holds} (needs >= {min_bytes}B)"
            )
    return errs


@dataclass
class AcceleratorRegistry:
    """Name -> description-factory mapping (the BYOC-style target table)."""

    _factories: dict[str, Callable[[], AcceleratorDescription]] = field(
        default_factory=dict
    )

    def register(
        self,
        name: str,
        factory: Callable[[], AcceleratorDescription] | None = None,
        *,
        override: bool = False,
        exist_ok: bool = False,
    ):
        """Register a zero-arg description factory, directly or as a
        decorator: ``@registry.register("edge_npu")``.

        A duplicate name raises unless ``override=True`` (replace) or
        ``exist_ok=True`` (keep the existing entry — how the in-tree
        builtins register, so a user's earlier registration of the same
        name always wins).
        """

        def _do(fn: Callable[[], AcceleratorDescription]):
            if name in self._factories:
                if exist_ok and not override:
                    return fn
                if not override:
                    raise ValueError(f"accelerator {name!r} already registered")
            self._factories[name] = fn
            return fn

        return _do(factory) if factory is not None else _do

    def unregister(self, name: str) -> None:
        self._factories.pop(name, None)

    def names(self) -> list[str]:
        self._ensure_builtin()
        return sorted(self._factories)

    def __contains__(self, name: str) -> bool:
        self._ensure_builtin()
        return name in self._factories

    def get(self, name: str) -> AcceleratorDescription:
        """Instantiate a fresh description for ``name``."""
        self._ensure_builtin()
        try:
            factory = self._factories[name]
        except KeyError:
            known = ", ".join(sorted(self._factories)) or "<none>"
            raise KeyError(
                f"unknown accelerator {name!r}; registered: {known}"
            ) from None
        return factory()

    @staticmethod
    def _ensure_builtin() -> None:
        # the in-tree descriptions self-register on import; importing here
        # (not at module load) avoids a registry <-> descriptions cycle
        import repro_torch.core.descriptions  # noqa: F401


#: The process-global registry ``repro_torch.compile()`` resolves names against.
REGISTRY = AcceleratorRegistry()


def register_accelerator(
    name: str,
    factory: Callable[[], AcceleratorDescription] | None = None,
    *,
    override: bool = False,
    exist_ok: bool = False,
):
    """Register a description factory on the global registry (decorator)."""
    return REGISTRY.register(name, factory, override=override, exist_ok=exist_ok)


def build_integrated_backend(
    accelerator: AcceleratorDescription | str,
    *,
    use_mip: bool = True,
    use_pallas: bool = True,
    cache: bool = True,
    cache_dir: str | Path | None = None,
    parallel_dse: bool = False,
) -> CompilerBackend:
    """Resolve, validate, and generate a backend — the integration machinery
    behind ``repro_torch.compile()`` (and the deprecated ``integrate()``).

    Args:
      accelerator: an ``AcceleratorDescription`` or a registered name.
      use_mip: solve the extended-CoSA MIP (falls back to the greedy
        heuristic when no MIP solver is installed).
      use_pallas: True lowers every step to the scheduled GEMM kernel,
        False to the emulated tiled loop over the compute intrinsics.
      cache: attach the persistent schedule cache.  ``cache_dir`` defaults
        to ``$REPRO_TORCH_CACHE_DIR`` or ``~/.cache/repro_torch``.
      parallel_dse: evaluate cold-cache mapping candidates on a thread pool.

    Returns the generated ``CompilerBackend``.  Raises ``IntegrationError``
    when the description is invalid, ``KeyError`` for an unknown name.
    """
    desc = REGISTRY.get(accelerator) if isinstance(accelerator, str) else accelerator
    problems = validate_description(desc)
    if problems:
        raise IntegrationError(desc.name, problems)
    schedule_cache = (
        ScheduleCache(Path(cache_dir) if cache_dir is not None else default_cache_dir())
        if cache
        else None
    )
    return build_backend(
        desc,
        use_mip=use_mip,
        use_pallas=use_pallas,
        parallel_dse=parallel_dse,
        schedule_cache=schedule_cache,
    )


def integrate(
    accelerator: AcceleratorDescription | str,
    **kwargs,
) -> CompilerBackend:
    """Deprecated spelling of the one-call integration — the public entry
    point is now ``repro_torch.compile(model, target=repro_torch.Target(...))``,
    which resolves and caches the backend itself.  This wrapper keeps the
    old two-step flow working; it accepts the same keyword arguments as
    ``build_integrated_backend``."""
    warn_deprecated(
        "repro_torch.integrate()",
        "repro_torch.compile(model, target=repro_torch.Target(...))",
    )
    return build_integrated_backend(accelerator, **kwargs)
