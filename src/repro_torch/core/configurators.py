"""Frontend / Backend Configurators (paper §3.3, Fig. 1).

``build_backend(desc)`` is the paper's automated flow: from a hardware
model (functional + architectural description) it generates a complete
compiler backend — graph partitioning + legalization setup (Frontend
Configurator), strategy generation, hardware-intrinsic generation, and
the CoSA-driven mapping generator (Backend Configurator) — "with minimal
manual effort, unlike existing methods that branch out to custom
backends."

Port of ``repro.core.configurators``.  ``use_pallas`` selects the route:
True (the port's default) lowers every step to the scheduled GEMM
kernel, False to the emulated tiled loop over the description's compute
intrinsics (the reference's default).
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.accel import AcceleratorDescription
from repro_torch.core.intrinsics import HardwareIntrinsicGenerator
from repro_torch.core.ir import Graph
from repro_torch.core.mapping import MappingGenerator
from repro_torch.core.passes import run_frontend
from repro_torch.core.pipeline import CompilerBackend
from repro_torch.core.schedule_cache import ScheduleCache
from repro_torch.core.scheduler import ExtendedCosaScheduler
from repro_torch.core.strategy import StrategyGenerator


@dataclass
class FrontendConfigurator:
    """Sets up graph partitioning and legalization passes using the
    predefined supported operators derived from the functional description."""

    desc: AcceleratorDescription

    def configure(self, graph: Graph, *, fold: bool = True, legalize: bool = True) -> Graph:
        return run_frontend(graph, self.desc, fold=fold, do_legalize=legalize)


@dataclass
class BackendConfigurator:
    """Generates the backend components from the accelerator description."""

    desc: AcceleratorDescription
    use_mip: bool = True
    parallel_dse: bool = False

    def configure(
        self,
        *,
        use_pallas: bool = True,
        schedule_cache: ScheduleCache | None = None,
    ) -> CompilerBackend:
        errs = self.desc.validate()
        if errs:
            raise ValueError(f"invalid accelerator description: {errs}")
        scheduler = ExtendedCosaScheduler(
            self.desc.arch, use_mip=self.use_mip, parallel=self.parallel_dse
        )
        return CompilerBackend(
            desc=self.desc,
            scheduler=scheduler,
            strategy_gen=StrategyGenerator(self.desc),
            intrinsic_gen=HardwareIntrinsicGenerator(self.desc),
            mapping_gen=MappingGenerator(self.desc),
            use_pallas=use_pallas,
            schedule_cache=schedule_cache,
        )


def build_backend(
    desc: AcceleratorDescription,
    *,
    use_mip: bool = True,
    use_pallas: bool = True,
    parallel_dse: bool = False,
    schedule_cache: ScheduleCache | None = None,
) -> CompilerBackend:
    """One-call backend generation from a description.

    ``registry.build_integrated_backend`` is the registry-aware wrapper
    around this: it adds name resolution, richer validation, and a
    persistent schedule cache by default.
    """
    return BackendConfigurator(desc, use_mip=use_mip, parallel_dse=parallel_dse).configure(
        use_pallas=use_pallas, schedule_cache=schedule_cache
    )
