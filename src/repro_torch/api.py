"""The one front door: ``repro_torch.compile(model, target)``.

A ``Target`` names the accelerator, the optimization mode and the device
the compiled module runs on (validated up front, every problem listed);
``compile()`` accepts an ``ir.Graph`` or a model-zoo name —

    import repro_torch

    module = repro_torch.compile("toycar_mlp", repro_torch.Target("gemmini"))
    outputs = module.run({"x": x})        # numpy in, numpy out
    cycles = module.modeled_cycles()

    # serving: one execution plan per batch bucket behind one module
    served = repro_torch.compile(
        "toycar_mlp", repro_torch.Target.parse("gemmini:optimized", batch_size=16)
    )
    per_request = served.run_many([{"x": x0}, {"x": x1}])

The device defaults to the card (``"cuda"``): every accelerator step
launches the hand-written CUDA kernel there.  ``device="cpu"`` runs the
kernels' plain PyTorch versions on the CPU, which is how the tests ask
for it.  There is no automatic fallback: a CUDA target without a card
fails at compile time and names the missing device.

Port of ``repro.api``: ``Target`` (with ``batch_size``, ``parse`` and
``describe``), ``CompileOptions`` (``batch_buckets`` only),
``DEFAULT_BATCH_BUCKETS`` and ``compile`` for a graph or a zoo name, which
returns a ``BatchedModule`` when batch buckets resolve.  A zoo name's
bucket graphs are its golden graphs, ``build(batch=b)``: the port has no
traced frontend yet.  The reference's other target fields
(``use_pallas``, ``cache``, ``devices``, ``mesh``, ...) and compile
options, the traced-callable frontend, save/load and the backend memo
come with their slices.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core.accel import AcceleratorDescription
from repro_torch.core.batching import BatchedModule, io_specs_from_graph
from repro_torch.core.executor import CompiledModule
from repro_torch.core.ir import Graph
from repro_torch.core.pipeline import PUBLIC_MODES, resolve_mode
from repro_torch.core.registry import REGISTRY, build_integrated_backend
from repro_torch.core.zoo import get_model

#: serving bucket ladder used when only ``Target.batch_size`` is given:
#: the buckets are the ladder entries below it, plus the batch itself.
DEFAULT_BATCH_BUCKETS = (1, 4, 16)


class TargetError(ValueError):
    """A target failed validation; ``.problems`` lists every issue."""

    def __init__(self, spec: str, problems: list[str]):
        self.problems = problems
        bullet = "\n  - ".join(problems)
        super().__init__(f"invalid target {spec!r}:\n  - {bullet}")


@dataclass(frozen=True)
class Target:
    """Where and how to compile: accelerator + mode + scheduler options +
    the device the module runs on.

    ``accelerator`` is a registered name or an ``AcceleratorDescription``;
    ``mode`` is one of ``naive`` / ``baseline`` / ``optimized`` (the paper's
    evaluation matrix; the internal mode names are accepted as aliases);
    ``use_mip`` is the reference's switch for the extended-CoSA MIP, which
    is not ported: where ``pulp`` is absent, True schedules with the greedy
    heuristic as the reference does there, and where ``pulp`` is installed
    the compile refuses True; ``device`` is ``"cuda"`` (the default: the
    card) or ``"cpu"``; ``batch_size`` is the serving batch the deployment
    dispatches at: above 1, ``compile()`` returns a ``BatchedModule``
    bucketed at the ``DEFAULT_BATCH_BUCKETS`` entries below it plus the
    batch itself (``CompileOptions.batch_buckets`` overrides the set).
    Construction validates everything it can and raises ``TargetError``
    listing every problem at once.
    """

    accelerator: str | AcceleratorDescription
    mode: str = "optimized"
    use_mip: bool = True
    device: str = "cuda"
    batch_size: int = 1

    def __post_init__(self):
        problems = []
        if not isinstance(self.batch_size, int) or self.batch_size < 1:
            problems.append(
                f"batch_size must be a positive int, got {self.batch_size!r}"
            )
        try:
            resolve_mode(self.mode)
        except ValueError:
            problems.append(
                f"unknown mode {self.mode!r}; expected one of "
                f"{', '.join(PUBLIC_MODES)}"
            )
        if isinstance(self.accelerator, str):
            if self.accelerator not in REGISTRY:
                known = ", ".join(REGISTRY.names()) or "<none>"
                problems.append(
                    f"unknown accelerator {self.accelerator!r}; "
                    f"registered: {known}"
                )
        elif not isinstance(self.accelerator, AcceleratorDescription):
            problems.append(
                f"accelerator must be a registered name or an "
                f"AcceleratorDescription, got {type(self.accelerator).__name__}"
            )
        try:
            dev = torch.device(self.device)
        except (RuntimeError, TypeError):
            problems.append(f"device {self.device!r} is not a torch device")
        else:
            if dev.type not in ("cuda", "cpu"):
                problems.append(f"device must be 'cuda' or 'cpu', got {self.device!r}")
        if problems:
            raise TargetError(self.describe(), problems)

    @classmethod
    def parse(cls, spec: str, **overrides) -> "Target":
        """Parse ``"accelerator[:mode]"`` — the one-string form CLIs pass
        around, e.g. ``Target.parse("gemmini:optimized", device="cpu")``."""
        parts = spec.split(":")
        if len(parts) > 2 or not parts[0]:
            raise TargetError(
                spec, ["expected 'accelerator' or 'accelerator:mode'"]
            )
        if len(parts) == 2:
            if "mode" in overrides and overrides["mode"] != parts[1]:
                raise TargetError(
                    spec,
                    [
                        f"spec names mode {parts[1]!r} but mode="
                        f"{overrides['mode']!r} was also passed"
                    ],
                )
            overrides["mode"] = parts[1]
        return cls(parts[0], **overrides)

    def describe(self) -> str:
        name = (
            self.accelerator
            if isinstance(self.accelerator, str)
            else getattr(self.accelerator, "name", "<description>")
        )
        return f"{name}:{self.mode}@{self.device}"

    @property
    def internal_mode(self) -> str:
        return resolve_mode(self.mode)

    def torch_device(self) -> torch.device:
        """The device the module runs on; raises when it is a card that
        this process cannot reach."""
        dev = torch.device(self.device)
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    f"target {self.describe()!r} runs on the CUDA device "
                    f"{self.device!r}, but no CUDA device is available "
                    f"(torch.cuda.is_available() is False); pass "
                    f"device='cpu' to run the plain kernels on the CPU"
                )
            index = dev.index if dev.index is not None else torch.cuda.current_device()
            if index >= torch.cuda.device_count():
                raise RuntimeError(
                    f"target {self.describe()!r}: CUDA device {index} does not "
                    f"exist ({torch.cuda.device_count()} visible)"
                )
            dev = torch.device("cuda", index)
        return dev


@dataclass(frozen=True)
class CompileOptions:
    """Per-compile knobs orthogonal to the target."""

    #: serving batch buckets: compile one ExecutionPlan per bucket and
    #: return a BatchedModule whose run_many packs/pads per-sample feeds
    #: into the smallest fitting bucket.  Only zoo names can be rebuilt
    #: per bucket (a prebuilt ir.Graph is fixed-shape).  None (default) ->
    #: the classic single-shape module unless ``Target.batch_size > 1``
    #: supplies the default ladder.
    batch_buckets: tuple[int, ...] | None = None


def _resolve_buckets(target: Target, options: CompileOptions) -> tuple[int, ...] | None:
    """The bucket set to compile, or None for the classic unbatched path."""
    buckets = options.batch_buckets
    if buckets is None:
        if target.batch_size <= 1:
            return None
        buckets = tuple(
            b for b in DEFAULT_BATCH_BUCKETS if b < target.batch_size
        ) + (target.batch_size,)
    buckets = tuple(buckets)
    problems = [
        f"bucket {b!r} must be a positive int"
        for b in buckets
        if not isinstance(b, int) or b < 1
    ]
    if not buckets:
        problems.append("batch_buckets must name at least one bucket")
    if problems:
        raise ValueError(
            "invalid batch buckets:\n  - " + "\n  - ".join(problems)
        )
    return tuple(sorted(set(buckets)))


def compile(
    model, target: Target, *, options: CompileOptions | None = None
) -> CompiledModule | BatchedModule:
    """Compile a model for a target — the one entry point.

    Args:
      model: an ``ir.Graph`` (mutated by the pass pipeline: build a fresh
        one per compile) or a zoo model name (``repro_torch.core.zoo``).
      target: a ``Target``.
      options: ``CompileOptions``.

    Returns a ``CompiledModule``: ``run(feeds)`` / ``run_many(feeds_list)``
    execute it on ``target.device``, ``modeled_cycles()`` reads the cycle
    model.  With ``Target(batch_size=...)`` > 1 or ``CompileOptions(
    batch_buckets=...)``, returns a ``BatchedModule`` instead: one
    ExecutionPlan per batch bucket, plus the unpadded per-sample plan for
    single requests (see ``repro_torch.core.batching``).
    """
    if not isinstance(target, Target):
        raise TypeError(f"target must be a Target, got {type(target).__name__}")
    if not isinstance(model, (Graph, str)):
        raise TypeError(
            f"model must be an ir.Graph or a zoo model name; got {type(model).__name__}"
        )
    # the device, the buckets and the model are checked before any
    # integration work
    device = target.torch_device()
    buckets = _resolve_buckets(target, options or CompileOptions())
    if buckets is not None and isinstance(model, Graph):
        raise ValueError(
            "batch buckets need a model that can be rebuilt per bucket "
            "(a zoo name); a prebuilt ir.Graph is fixed-shape — compile "
            "the model by its zoo name instead, or compile the graph "
            "without batch_buckets"
        )
    zoo_model = get_model(model) if isinstance(model, str) else None
    backend = build_integrated_backend(target.accelerator, use_mip=target.use_mip)

    def compile_graph(graph: Graph) -> CompiledModule:
        return backend.compile_graph(graph, target.internal_mode, device=device)

    if zoo_model is None:
        return compile_graph(model)
    if buckets is None:
        return compile_graph(zoo_model.build())
    # each bucket compiles the golden graph at that batch; the per-sample
    # graph compiles into the UNPADDED single-request plan, which run_many
    # takes for size-1 chunks instead of pack/pad-to-bucket/unpack
    sample = zoo_model.build()
    inputs, outputs = io_specs_from_graph(sample)
    return BatchedModule(
        modules={b: compile_graph(zoo_model.build(batch=b)) for b in buckets},
        inputs=inputs,
        outputs=outputs,
        sample_module=compile_graph(sample),
    )
