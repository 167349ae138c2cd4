"""The paper's primary contribution: a compiler-integration framework for
GEMM-based DL accelerators — accelerator descriptions, extended-CoSA
scheduling, and the generated backend (configurators -> strategies ->
intrinsics -> mappings -> executables + cycle model).

``repro_torch.core.registry`` is the public integration surface: a named
accelerator registry plus ``build_integrated_backend()`` (and the
deprecated one-call ``integrate()``) that validates a description,
generates the backend, and attaches the persistent schedule cache.

Port of ``repro.core``, with the same exports.
"""

from repro_torch.core.accel import AcceleratorDescription
from repro_torch.core.arch_spec import ArchSpec, GemmWorkload, conv2d_as_gemm
from repro_torch.core.configurators import build_backend
from repro_torch.core.pass_manager import PassContext, PassManager, PipelineReport
from repro_torch.core.passes import frontend_passes, passes_for_mode
from repro_torch.core.executor import CompiledModule, ExecutionPlan
from repro_torch.core.rewrite import P, Match, OpPattern, RewriteRule, any_, apply_rules, rule
from repro_torch.core.deprecation import ReproDeprecationWarning
from repro_torch.core.registry import (
    REGISTRY,
    AcceleratorRegistry,
    IntegrationError,
    build_integrated_backend,
    integrate,
    register_accelerator,
    validate_description,
)
from repro_torch.core.schedule import Schedule, validate_schedule
from repro_torch.core.schedule_cache import ScheduleCache
from repro_torch.core.scheduler import ExtendedCosaScheduler
from repro_torch.core.simulator import simulate

__all__ = [
    "AcceleratorDescription",
    "AcceleratorRegistry",
    "ArchSpec",
    "CompiledModule",
    "ExecutionPlan",
    "ExtendedCosaScheduler",
    "GemmWorkload",
    "IntegrationError",
    "Match",
    "OpPattern",
    "P",
    "PassContext",
    "PassManager",
    "PipelineReport",
    "REGISTRY",
    "ReproDeprecationWarning",
    "RewriteRule",
    "Schedule",
    "ScheduleCache",
    "any_",
    "apply_rules",
    "build_backend",
    "build_integrated_backend",
    "conv2d_as_gemm",
    "frontend_passes",
    "integrate",
    "passes_for_mode",
    "register_accelerator",
    "rule",
    "simulate",
    "validate_description",
    "validate_schedule",
]
