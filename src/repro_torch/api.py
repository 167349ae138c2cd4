"""The one front door: ``repro_torch.compile(model, target)``.

A ``Target`` names the accelerator, the optimization mode and the device
the compiled module runs on (validated up front, every problem listed);
``compile()`` accepts an ``ir.Graph`` or a model-zoo name —

    import repro_torch

    module = repro_torch.compile("toycar_mlp", repro_torch.Target("gemmini"))
    outputs = module.run({"x": x})        # numpy in, numpy out
    cycles = module.modeled_cycles()

The device defaults to the card (``"cuda"``): every accelerator step
launches the hand-written CUDA kernel there.  ``device="cpu"`` runs the
kernels' plain PyTorch versions on the CPU, which is how the tests ask
for it.  There is no automatic fallback: a CUDA target without a card
fails at compile time and names the missing device.

Port of ``repro.api``: ``Target`` and ``compile`` for a graph or a zoo
name.  The reference's other target fields (``use_pallas``, ``cache``,
``batch_size``, ``devices``, ``mesh``, ...) and ``CompileOptions``, the
traced-callable frontend, save/load and the backend memo come with their
slices.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core.accel import AcceleratorDescription
from repro_torch.core.executor import CompiledModule
from repro_torch.core.ir import Graph
from repro_torch.core.pipeline import PUBLIC_MODES, resolve_mode
from repro_torch.core.registry import REGISTRY, build_integrated_backend


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
    card) or ``"cpu"``.
    Construction validates everything it can and raises ``TargetError``
    listing every problem at once.
    """

    accelerator: str | AcceleratorDescription
    mode: str = "optimized"
    use_mip: bool = True
    device: str = "cuda"

    def __post_init__(self):
        problems = []
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


def _graph_for(model) -> Graph:
    if isinstance(model, Graph):
        return model
    if isinstance(model, str):
        from repro_torch.core.zoo import get_model

        return get_model(model).build()
    raise TypeError(
        f"model must be an ir.Graph or a zoo model name; got {type(model).__name__}"
    )


def compile(model, target: Target) -> CompiledModule:
    """Compile a model for a target — the one entry point.

    Args:
      model: an ``ir.Graph`` (mutated by the pass pipeline: build a fresh
        one per compile) or a zoo model name (``repro_torch.core.zoo``).
      target: a ``Target``.

    Returns a ``CompiledModule``: ``run(feeds)`` / ``run_many(feeds_list)``
    execute it on ``target.device``, ``modeled_cycles()`` reads the cycle
    model.
    """
    if not isinstance(target, Target):
        raise TypeError(f"target must be a Target, got {type(target).__name__}")
    # the device and the model are checked before any integration work
    device = target.torch_device()
    graph = _graph_for(model)
    backend = build_integrated_backend(target.accelerator, use_mip=target.use_mip)
    return backend.compile_graph(graph, target.internal_mode, device=device)
