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

The target runs on the card by default; ``Target(..., device="cpu")``
runs the kernels' plain PyTorch versions instead.  The package imports
``torch`` and numpy, never ``jax`` and nothing of ``repro``, whose
modules it mirrors path for path.
"""

from repro_torch.api import Target, TargetError, compile
from repro_torch.core.accel import AcceleratorDescription
from repro_torch.core.arch_spec import ArchSpec, GemmWorkload
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

__version__ = "0.1.0"

__all__ = [
    "AcceleratorDescription",
    "AcceleratorRegistry",
    "ArchSpec",
    "CompiledModule",
    "FeedError",
    "GemmWorkload",
    "IntegrationError",
    "REGISTRY",
    "ScheduleError",
    "Target",
    "TargetError",
    "build_integrated_backend",
    "compile",
    "register_accelerator",
    "validate_description",
    "__version__",
]
