"""The one front door: ``repro_torch.compile(model, target)``.

A ``Target`` names the accelerator, the optimization mode and the device
the compiled module runs on (validated up front, every problem listed);
``CompileOptions`` carries per-compile knobs; ``compile()`` accepts an
``ir.Graph`` or a model-zoo name —

    import repro_torch

    module = repro_torch.compile("toycar_mlp", repro_torch.Target("gemmini"))
    outputs = module.run({"x": x})        # numpy in, numpy out
    cycles = module.modeled_cycles()

    # serving: one execution plan per batch bucket behind one module
    served = repro_torch.compile(
        "toycar_mlp", repro_torch.Target.parse("gemmini:optimized", batch_size=16)
    )
    per_request = served.run_many([{"x": x0}, {"x": x1}])

    # AOT: save once, boot replicas with zero DSE and zero passes
    repro_torch.save(served, "toycar.art")
    replica = repro_torch.load("toycar.art", device="cuda")

The device defaults to the card (``"cuda"``): every accelerator step
launches the hand-written CUDA kernel there.  ``device="cpu"`` runs the
kernels' plain PyTorch versions on the CPU, which is how the tests ask
for it.  There is no automatic fallback: a CUDA target without a card
fails at compile time and names the missing device.

Schedules persist across processes in the schedule cache
(``Target(cache=True)``, the default; ``$REPRO_TORCH_CACHE_DIR`` or
``~/.cache/repro_torch``), and one generated backend per target is
memoized in-process (``backend_for``), so repeated compiles repeat no
DSE sweep.  ``CompileOptions(measure_top_k=K)`` re-ranks each node's K
best modeled schedules by timing the kernel on the target's device.

Port of ``repro.api``: ``Target`` (without ``use_pallas``, ``devices`` and
``mesh``: the route follows the device, and sharded plans wait for their
slice), ``CompileOptions``, the backend memo, ``compile`` for a graph or
a zoo name, ``save`` and ``load``.  A zoo name's bucket graphs are its
golden graphs, ``build(batch=b)``: the port has no traced frontend yet.
The ``verify`` gate waits for the port of ``repro.core.verify``.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass
from pathlib import Path

import torch

from repro_torch.core.accel import AcceleratorDescription
from repro_torch.core.batching import BatchedModule, io_specs_from_graph
from repro_torch.core.executor import CompiledModule
from repro_torch.core.ir import Graph
from repro_torch.core.pass_manager import PassContext
from repro_torch.core import pipeline
from repro_torch.core.pipeline import PUBLIC_MODES, CompilerBackend, resolve_mode
from repro_torch.core.registry import REGISTRY, build_integrated_backend
from repro_torch.core.scheduler import mip_installable
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


class CapabilityError(ValueError):
    """``allow_host_fallback=False`` and the target cannot run every core
    op; ``.problems`` lists each op left on the host."""

    def __init__(self, name: str, problems: list[str]):
        self.problems = problems
        bullet = "\n  - ".join(problems)
        super().__init__(
            f"accelerator {name!r} cannot offload the whole model "
            f"(allow_host_fallback=False):\n  - {bullet}"
        )


def torch_device(device: str | torch.device, subject: str) -> torch.device:
    """``device`` as a torch device this process can run on; raises, naming
    ``subject``, when it is a card that this process cannot reach."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{subject} runs on the CUDA device {str(device)!r}, but no "
                f"CUDA device is available (torch.cuda.is_available() is "
                f"False); pass device='cpu' to run the plain kernels on the CPU"
            )
        index = dev.index if dev.index is not None else torch.cuda.current_device()
        if index >= torch.cuda.device_count():
            raise RuntimeError(
                f"{subject}: CUDA device {index} does not exist "
                f"({torch.cuda.device_count()} visible)"
            )
        dev = torch.device("cuda", index)
    return dev


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
    the compile refuses True; ``cache`` attaches the persistent schedule
    cache at ``cache_dir`` (default ``$REPRO_TORCH_CACHE_DIR`` or
    ``~/.cache/repro_torch``); ``parallel_dse`` sweeps cold-cache
    candidates on a thread pool; ``device`` is ``"cuda"`` (the default:
    the card) or ``"cpu"``; ``batch_size`` is the serving batch the
    deployment dispatches at: above 1, ``compile()`` returns a
    ``BatchedModule`` bucketed at the ``DEFAULT_BATCH_BUCKETS`` entries
    below it plus the batch itself (``CompileOptions.batch_buckets``
    overrides the set).  Construction validates everything it can and
    raises ``TargetError`` listing every problem at once.
    """

    accelerator: str | AcceleratorDescription
    mode: str = "optimized"
    use_mip: bool = True
    cache: bool = True
    cache_dir: str | Path | None = None
    parallel_dse: bool = False
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
        if self.cache_dir is not None and not self.cache:
            problems.append("cache_dir given but cache=False")
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
        return torch_device(self.device, f"target {self.describe()!r}")


@dataclass(frozen=True)
class CompileOptions:
    """Per-compile knobs orthogonal to the target."""

    #: explicit pass list overriding the per-mode pipeline (experiments)
    passes: list | None = None
    #: trace/dump instrumentation context for the pass manager
    pass_context: PassContext | None = None
    #: False -> raise CapabilityError if any dense/conv stays on the host
    allow_host_fallback: bool = True
    #: True -> build a fresh backend instead of reusing the per-target one
    #: (benchmarking cold integration, isolating solver-call counters)
    fresh_backend: bool = False
    #: serving batch buckets: compile one ExecutionPlan per bucket and
    #: return a BatchedModule whose run_many packs/pads per-sample feeds
    #: into the smallest fitting bucket.  Only zoo names can be rebuilt
    #: per bucket (a prebuilt ir.Graph is fixed-shape).  None (default) ->
    #: the classic single-shape module unless ``Target.batch_size > 1``
    #: supplies the default ladder.
    batch_buckets: tuple[int, ...] | None = None
    #: measured DSE: time the K best modeled schedule candidates per node
    #: on the lowered executor — the kernel on the target's device — and
    #: pick the fastest (on a card its device time, on the CPU wall-clock:
    #: see ``core.measure``).  Measurements persist in the schedule cache
    #: and the artifact store under keys naming K and the device, so warm
    #: recompiles do zero sweeps AND zero re-measurement.  None (default)
    #: keeps the pure cycle-model argmin.
    measure_top_k: int | None = None
    #: transparent AOT write-through: probe a content-addressed
    #: ``ArtifactStore`` rooted here before compiling (keyed by source
    #: graph fingerprint, arch fingerprint, mode, route, bucket, measured
    #: K and device, schema version) and persist the compiled module after.  A hit
    #: restores the full module — plan, schedules, pass report, constants
    #: — with zero DSE sweeps, zero measurements, and zero rewrite fires.
    #: Ignored when ``passes`` overrides the per-mode pipeline (custom
    #: pipelines are not part of the key).  See also ``save`` / ``load``.
    artifact_dir: str | Path | None = None
    #: the reference's static-verification gate; only None and 'off' are
    #: accepted until ``repro.core.verify`` is ported
    verify: str | None = None

    def __post_init__(self):
        k = self.measure_top_k
        if k is not None and (not isinstance(k, int) or k < 1):
            raise ValueError(
                f"measure_top_k must be a positive int or None, got {k!r}"
            )
        if self.verify not in (None, "each", "final", "off"):
            raise ValueError(
                f"verify must be 'each', 'final', 'off', or None, got "
                f"{self.verify!r}"
            )
        if self.verify in ("each", "final"):
            raise NotImplementedError(
                f"verify={self.verify!r}: the static-verification gate "
                f"(repro.core.verify) is not ported to repro_torch yet; "
                f"pass verify=None or 'off'"
            )


# one backend per (accelerator fingerprint, backend options): repeated
# compiles share the scheduler's in-memory memo on top of the persistent
# schedule cache, so sweeping modes/models never repeats a DSE sweep.
# Bounded locked LRU (move-to-end on hit, evict the least recently used)
# so long-lived serving processes sweeping many descriptions or throwaway
# cache dirs cannot grow memory monotonically, and hot targets are never
# the ones evicted.  Concurrent compile() callers are safe: lookups,
# insertion, and eviction all happen under the lock, and two threads
# racing to build the same backend converge on whichever one published
# first (so they share its scheduler memo).  The device is not part of
# the key: a backend compiles for any device, and measured cache entries
# name theirs.
_BACKENDS: OrderedDict[tuple, CompilerBackend] = OrderedDict()
_BACKENDS_MAX = 16
_BACKENDS_LOCK = threading.Lock()


def clear_backend_cache() -> None:
    """Drop every memoized backend (fresh schedulers on the next compile)."""
    with _BACKENDS_LOCK:
        _BACKENDS.clear()


def backend_for(target: Target, *, fresh: bool = False) -> CompilerBackend:
    """Resolve (and memoize) the generated backend for a target.  The mode
    and the device are compile-time properties, so all modes and devices
    of one accelerator share a backend.  Raises ``IntegrationError`` for
    an invalid description."""
    desc = (
        REGISTRY.get(target.accelerator)
        if isinstance(target.accelerator, str)
        else target.accelerator
    )
    key = (
        desc.fingerprint(),
        target.use_mip,
        # where pulp is installed use_mip=True is refused at backend build
        # (core/scheduler.py); a backend built without it must not answer
        mip_installable(),
        target.cache,
        str(target.cache_dir),
        target.parallel_dse,
    )
    if not fresh:
        with _BACKENDS_LOCK:
            cached = _BACKENDS.get(key)
            if cached is not None:
                _BACKENDS.move_to_end(key)
                return cached
    backend = build_integrated_backend(
        desc,
        use_mip=target.use_mip,
        cache=target.cache,
        cache_dir=target.cache_dir,
        parallel_dse=target.parallel_dse,
    )
    if not fresh:
        with _BACKENDS_LOCK:
            winner = _BACKENDS.get(key)
            if winner is not None:
                # lost a build race: share the published backend (and its
                # scheduler memo) instead of forking the cache
                _BACKENDS.move_to_end(key)
                return winner
            while len(_BACKENDS) >= _BACKENDS_MAX:
                _BACKENDS.popitem(last=False)
            _BACKENDS[key] = backend
    return backend


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


def _check_offload(module: CompiledModule) -> None:
    desc = module.desc
    left_on_host = [
        f"{n.name}: {n.op} {list(n.shape)} ({n.dtype})"
        for n in module.graph.toposort()
        if n.target != "accel"
        and n.op.replace("generalized_", "") in ("dense", "conv2d", "matmul")
    ]
    if left_on_host:
        left_on_host.append(
            f"(supported core ops: {', '.join(sorted(desc.supported_ops()))})"
        )
        raise CapabilityError(desc.name, left_on_host)


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
    options = options or CompileOptions()
    # the device, the buckets and the model are checked before any
    # integration work or cache-dir side effect
    device = target.torch_device()
    buckets = _resolve_buckets(target, options)
    if buckets is not None and isinstance(model, Graph):
        raise ValueError(
            "batch buckets need a model that can be rebuilt per bucket "
            "(a zoo name); a prebuilt ir.Graph is fixed-shape — compile "
            "the model by its zoo name instead, or compile the graph "
            "without batch_buckets"
        )
    zoo_model = get_model(model) if isinstance(model, str) else None
    backend = backend_for(target, fresh=options.fresh_backend)
    store = None
    if options.artifact_dir is not None and options.passes is None:
        from repro_torch.core.artifact import ArtifactStore

        store = ArtifactStore(Path(options.artifact_dir))

    def compile_graph(graph: Graph, bucket: int | None = None) -> CompiledModule:
        key = src_fp = None
        if store is not None:
            # key by the PRE-pipeline graph (what the caller hands us); the
            # passes mutate it in place during compile
            from repro_torch.core.artifact import graph_fingerprint

            src_fp = graph_fingerprint(graph)
            key = store.key_for(
                source_fingerprint=src_fp,
                arch_fingerprint=backend.desc.fingerprint(),
                mode=target.internal_mode,
                use_pallas=True,  # the kernel route, as the manifests say
                bucket=bucket,
                measure_top_k=options.measure_top_k,
                measure_device=options.measure_top_k and pipeline.device_tag(device),
            )
            cached = store.get(key, device=device, desc=backend.desc)
            if cached is not None:
                if not options.allow_host_fallback:
                    _check_offload(cached)
                return cached
        module = backend.compile_graph(
            graph,
            target.internal_mode,
            device=device,
            passes=options.passes,
            pass_context=options.pass_context,
            measure_top_k=options.measure_top_k,
        )
        if not options.allow_host_fallback:
            _check_offload(module)
        if store is not None:
            store.put(key, module, source_fingerprint=src_fp)
        return module

    if zoo_model is None:
        return compile_graph(model)
    if buckets is None:
        return compile_graph(zoo_model.build())
    # each bucket compiles the golden graph at that batch; the per-sample
    # graph compiles into the UNPADDED single-request plan, which run_many
    # takes for size-1 chunks instead of pack/pad-to-bucket/unpack
    sample = zoo_model.build()
    inputs, outputs = io_specs_from_graph(sample)
    sample_module = compile_graph(sample)
    return BatchedModule(
        modules={b: compile_graph(zoo_model.build(batch=b), bucket=b) for b in buckets},
        inputs=inputs,
        outputs=outputs,
        sample_module=sample_module,
    )


def save(module, path) -> Path:
    """Serialize a compiled module (or bucketed ``BatchedModule``) into an
    AOT artifact directory at ``path``.

    The artifact holds everything ``compile()`` produced — the optimized
    graph, per-node schedules (measured-DSE winners included), the
    pass-pipeline report, constant panels/weights, kernel configs, and the
    ExecutionPlan skeleton — versioned and content-verified, written
    atomically, in the reference's manifest schema.  ``load(path)``
    restores it with zero DSE sweeps, zero measurements, and zero
    rewrite-rule fires.  See ``repro_torch.core.artifact`` for the layout."""
    from repro_torch.core.artifact import save_any

    return save_any(module, path)


def load(path, device: str = "cuda"):
    """Restore a compiled module from an AOT artifact written by ``save``
    (or by ``CompileOptions(artifact_dir=...)`` write-through, or by the
    reference's ``repro.save``), to run on ``device``: an artifact does not
    depend on the device, so the caller names it (``"cuda"``, the default,
    or ``"cpu"``).

    Raises ``ArtifactError`` naming the mismatch if the artifact is torn
    or was built for a different schema version, architecture, or graph.
    The accelerator the artifact targets must be registered in this
    process (built-ins always are)."""
    from repro_torch.core.artifact import load_any

    return load_any(path, device=torch_device(device, f"artifact {str(path)!r}"))
