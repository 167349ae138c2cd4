"""repro_torch — the PyTorch/CUDA port of ``repro`` for NVIDIA Hopper.

The paper's flow (accelerator description -> passes -> extended-CoSA
schedule per offloaded GEMM -> kernel config -> execution plan) with every
accelerator step on a hand-written CUDA kernel for sm_90a:

    import repro_torch

    module = repro_torch.compile(
        "toycar_mlp", repro_torch.Target("gemmini", mode="optimized")
    )
    outputs = module.run({"x": x})
    cycles = module.modeled_cycles()

Serving goes through batch buckets and a micro-batching queue:
``python -m repro_torch.launch.serve --zoo toycar_mlp --target
gemmini:optimized --batch 64``.  Schedules persist in a cross-process
cache (``~/.cache/repro_torch``), and ``repro_torch.save`` /
``repro_torch.load`` turn a compiled module into an AOT artifact that
boots with no DSE and no passes.

The target runs on the card by default; ``Target(..., device="cpu")``
runs the kernels' plain PyTorch versions instead.  The package imports
``torch`` and numpy, never ``jax`` and nothing of ``repro``, whose
modules it mirrors path for path.
"""

from repro_torch.api import (
    DEFAULT_BATCH_BUCKETS,
    CapabilityError,
    CompileOptions,
    Target,
    TargetError,
    backend_for,
    clear_backend_cache,
    compile,
    load,
    save,
)
from repro_torch.core.accel import AcceleratorDescription
from repro_torch.core.artifact import ArtifactError
from repro_torch.core.arch_spec import ArchSpec, GemmWorkload
from repro_torch.core.batching import BatchedModule
from repro_torch.core.executor import CompiledModule, FeedError
from repro_torch.core.pipeline import ScheduleError
from repro_torch.core.registry import (
    REGISTRY,
    AcceleratorRegistry,
    IntegrationError,
    build_integrated_backend,
    register_accelerator,
    validate_description,
)
from repro_torch.core.schedule_cache import ScheduleCache, default_cache_dir

__version__ = "0.1.0"

__all__ = [
    "AcceleratorDescription",
    "AcceleratorRegistry",
    "ArchSpec",
    "ArtifactError",
    "BatchedModule",
    "CapabilityError",
    "CompileOptions",
    "CompiledModule",
    "DEFAULT_BATCH_BUCKETS",
    "FeedError",
    "GemmWorkload",
    "IntegrationError",
    "REGISTRY",
    "ScheduleCache",
    "ScheduleError",
    "Target",
    "TargetError",
    "backend_for",
    "build_integrated_backend",
    "clear_backend_cache",
    "compile",
    "default_cache_dir",
    "load",
    "register_accelerator",
    "save",
    "validate_description",
    "__version__",
]
