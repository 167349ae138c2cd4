"""Backend Configurator (paper §3.3, Fig. 1).

``build_backend(desc)`` is the paper's automated flow: from a hardware
model (functional + architectural description) it generates a complete
compiler backend — strategy generation and the CoSA-driven mapping
generator — "with minimal manual effort, unlike existing methods that
branch out to custom backends."  The frontend half (legalization and
partitioning) is the per-mode pass list of ``passes.passes_for_mode``.

Port of ``repro.core.configurators``: ``build_backend`` only.  The
hardware-intrinsic generator (``repro.core.intrinsics``) belongs to the
reference's numpy emulation, which waits for its slice.  There is no
``use_pallas``: where the kernel runs follows the module's device.
"""

from __future__ import annotations

from repro_torch.core.accel import AcceleratorDescription
from repro_torch.core.mapping import MappingGenerator
from repro_torch.core.pipeline import CompilerBackend
from repro_torch.core.schedule_cache import ScheduleCache
from repro_torch.core.scheduler import ExtendedCosaScheduler
from repro_torch.core.strategy import StrategyGenerator


def build_backend(
    desc: AcceleratorDescription,
    *,
    use_mip: bool = True,
    parallel_dse: bool = False,
    schedule_cache: ScheduleCache | None = None,
) -> CompilerBackend:
    """Generate the backend components from a validated description
    (``registry.build_integrated_backend`` adds name resolution, the full
    validation and the persistent schedule cache)."""
    errs = desc.validate()
    if errs:
        raise ValueError(f"invalid accelerator description: {errs}")
    return CompilerBackend(
        desc=desc,
        scheduler=ExtendedCosaScheduler(desc.arch, use_mip=use_mip, parallel=parallel_dse),
        strategy_gen=StrategyGenerator(desc),
        mapping_gen=MappingGenerator(desc),
        schedule_cache=schedule_cache,
    )
