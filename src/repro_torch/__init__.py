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

``compile`` also takes a plain PyTorch callable, traced with
``torch.export`` (``repro_torch.compile(fn, target, example_inputs={"x":
x}, params=params)``; zoo names go through the same tracer), and
``Target(devices=N)`` / ``Target(mesh=(d, m))`` compiles one plan per
shard of a mesh, every shard on the target's one device, behind a
``ShardedModule``.

Serving goes through batch buckets and a micro-batching queue:
``python -m repro_torch.launch.serve --zoo toycar_mlp --target
gemmini:optimized --batch 64``; the decode zoo (``attn_decode``) through
the continuous-batching engine (``repro_torch.serve.
ContinuousBatchingEngine``; ``--zoo attn_decode``).  ``repro_torch.verify``
statically checks a graph or a compiled module, and ``CompileOptions(
verify="each")`` gates every pass.  Schedules persist in a cross-process
cache (``~/.cache/repro_torch``), and ``repro_torch.save`` /
``repro_torch.load`` turn a compiled module into an AOT artifact that
boots with no DSE and no passes.

The target runs on the card by default; ``Target(..., device="cpu")``
runs the kernels' plain PyTorch versions instead.  ``Target(...,
use_pallas=False)`` takes the reference's emulated route: a tiled loop
that calls the description's registered compute intrinsic once per PE
tile, on the target's device.  The deprecated two-step flow
(``repro_torch.integrate`` + ``backend.compile``) still works and warns
``ReproDeprecationWarning``.  The package imports
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
from repro_torch.core.arch_spec import ArchSpec, GemmWorkload, conv2d_as_gemm
from repro_torch.core.batching import BatchedModule
from repro_torch.core.deprecation import ReproDeprecationWarning
from repro_torch.core.executor import CompiledModule, FeedError
from repro_torch.core.registry import (
    REGISTRY,
    AcceleratorRegistry,
    IntegrationError,
    build_integrated_backend,
    integrate,
    register_accelerator,
    validate_description,
)
from repro_torch.core.schedule_cache import ScheduleCache, default_cache_dir
from repro_torch.core.sharded import ShardedModule
from repro_torch.core.verify import Diagnostic, VerifyError, verify
from repro_torch.core.zoo import DECODE_ZOO, decode_model_names, get_decode_model
from repro_torch.frontend import UnsupportedExportError, trace_model

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
    "DECODE_ZOO",
    "DEFAULT_BATCH_BUCKETS",
    "Diagnostic",
    "FeedError",
    "GemmWorkload",
    "IntegrationError",
    "REGISTRY",
    "ReproDeprecationWarning",
    "ScheduleCache",
    "ShardedModule",
    "Target",
    "TargetError",
    "UnsupportedExportError",
    "VerifyError",
    "backend_for",
    "build_integrated_backend",
    "clear_backend_cache",
    "compile",
    "conv2d_as_gemm",
    "decode_model_names",
    "default_cache_dir",
    "get_decode_model",
    "integrate",
    "load",
    "register_accelerator",
    "save",
    "trace_model",
    "validate_description",
    "verify",
    "__version__",
]
