"""The one front door: ``repro_torch.compile(model, target)``.

A ``Target`` names the accelerator, the optimization mode and the device
the compiled module runs on (validated up front, every problem listed);
``CompileOptions`` carries per-compile knobs; ``compile()`` accepts an
``ir.Graph``, a model-zoo name, or a plain PyTorch callable —

    import repro_torch

    module = repro_torch.compile("toycar_mlp", repro_torch.Target("gemmini"))
    outputs = module.run({"x": x})        # numpy in, numpy out
    cycles = module.modeled_cycles()

    # a plain torch callable + example inputs (traced with torch.export)
    module = repro_torch.compile(
        fn, repro_torch.Target("gemmini"), example_inputs={"x": x}, params=params
    )

    # one plan per shard of a (data, model) mesh, every shard on the card
    sharded = repro_torch.compile(
        "toycar_mlp", repro_torch.Target("gemmini", mesh=(1, 4))
    )

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

Port of ``repro.api``: ``Target`` (its ``use_pallas`` defaults to True,
the kernel route, where the reference's defaults to False, its numpy
emulation; ``Target(..., use_pallas=False)`` runs the emulated route over
the description's compute intrinsics, on the target's device too),
``CompileOptions``, the backend memo, ``compile``
for a graph, a zoo name (the decode zoo's names included: their
decode-step form) or a callable, sharded compiles (``Target(devices=,
mesh=)``), ``save`` and ``load``, and the ``verify`` gate.  A zoo name
compiles its traced form (``trace(batch=b)``), as the reference's does; a
callable is traced per bucket with batch-widened example inputs.  The
shards of a sharded module are plans on the target's one device (see
``repro_torch.core.sharded``), not one card each.  ``compile`` takes a
``Target`` only, not the reference's ``"accelerator:mode"`` string
(``Target.parse`` reads that).
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass, replace
from pathlib import Path

import torch

from repro_torch.core.accel import AcceleratorDescription
from repro_torch.core.batching import BatchedModule, io_specs_from_graph
from repro_torch.core.collective import ShardSpec
from repro_torch.core.executor import CompiledModule
from repro_torch.core.ir import Graph, clone_graph
from repro_torch.core.pass_manager import PassContext
from repro_torch.core import pipeline
from repro_torch.core.pipeline import PUBLIC_MODES, CompilerBackend, resolve_mode
from repro_torch.core.registry import REGISTRY, build_integrated_backend
from repro_torch.core.sharded import ShardedModule
from repro_torch.core.verify import VerifyError, resolve_verify, verify_collectives
from repro_torch.core.zoo import DECODE_ZOO, get_decode_model, get_model
from repro_torch.frontend import trace_batched, trace_model

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
    ``use_mip`` solves the extended-CoSA MIP where ``pulp`` is installed
    (the greedy heuristic answers elsewhere, as in the reference);
    ``use_pallas`` selects the route: True (the default) runs every
    accelerator step on the scheduled GEMM kernel, False on the emulated
    tiled loop that calls the description's compute intrinsic once per PE
    tile (``tpu*`` descriptions take the kernel either way); ``cache``
    attaches the persistent schedule
    cache at ``cache_dir`` (default ``$REPRO_TORCH_CACHE_DIR`` or
    ``~/.cache/repro_torch``); ``parallel_dse`` sweeps cold-cache
    candidates on a thread pool; ``device`` is ``"cuda"`` (the default:
    the card) or ``"cpu"``; ``batch_size`` is the serving batch the
    deployment dispatches at: above 1, ``compile()`` returns a
    ``BatchedModule`` bucketed at the ``DEFAULT_BATCH_BUCKETS`` entries
    below it plus the batch itself (``CompileOptions.batch_buckets``
    overrides the set).  ``devices > 1`` compiles ONE graph into one
    ExecutionPlan per shard of a ``(data, model)`` mesh and ``compile()``
    returns a ``ShardedModule`` (or a ``BatchedModule`` of them); every
    shard runs on ``device``.  The factorization defaults to the
    elastic-mesh rule (``repro_torch.launch.mesh.mesh_factorization``);
    ``mesh`` pins it, and giving only ``mesh`` derives ``devices`` from its
    product.  Construction validates everything it can and raises
    ``TargetError`` listing every problem at once.
    """

    accelerator: str | AcceleratorDescription
    mode: str = "optimized"
    use_mip: bool = True
    use_pallas: bool = True
    cache: bool = True
    cache_dir: str | Path | None = None
    parallel_dse: bool = False
    device: str = "cuda"
    batch_size: int = 1
    devices: int = 1
    mesh: tuple[int, int] | None = None

    def __post_init__(self):
        problems = []
        if not isinstance(self.batch_size, int) or self.batch_size < 1:
            problems.append(
                f"batch_size must be a positive int, got {self.batch_size!r}"
            )
        if not isinstance(self.devices, int) or self.devices < 1:
            problems.append(
                f"devices must be a positive int, got {self.devices!r}"
            )
        elif self.mesh is not None:
            mesh = tuple(self.mesh) if isinstance(self.mesh, list) else self.mesh
            if (
                not isinstance(mesh, tuple)
                or len(mesh) != 2
                or not all(isinstance(a, int) and a >= 1 for a in mesh)
            ):
                problems.append(
                    f"mesh must be a (data, model) pair of positive ints, "
                    f"got {self.mesh!r}"
                )
            else:
                object.__setattr__(self, "mesh", mesh)
                if self.devices == 1:
                    object.__setattr__(self, "devices", mesh[0] * mesh[1])
                elif mesh[0] * mesh[1] != self.devices:
                    problems.append(
                        f"mesh {mesh} factorizes {mesh[0] * mesh[1]} devices "
                        f"but devices={self.devices} was also passed"
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
        base = f"{name}:{self.mode}@{self.device}"
        if not self.use_pallas:
            base += "/emulated"
        if isinstance(self.devices, int) and self.devices > 1:
            try:
                dp, mp = self.resolved_mesh
                base += f"@{self.devices}dev(data={dp},model={mp})"
            except Exception:  # an invalid mesh mid-TargetError formatting
                base += f"@{self.devices}dev"
        return base

    @property
    def resolved_mesh(self) -> tuple[int, int]:
        """The ``(data, model)`` mesh this target compiles for: the
        explicit ``mesh`` if given, else the elastic factorization of
        ``devices`` (largest power-of-two model axis, rest data)."""
        if self.mesh is not None:
            return self.mesh
        if self.devices == 1:
            return (1, 1)
        from repro_torch.launch.mesh import mesh_factorization

        return mesh_factorization(self.devices)

    @property
    def internal_mode(self) -> str:
        return resolve_mode(self.mode)

    def with_mode(self, mode: str) -> "Target":
        return replace(self, mode=mode)

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
    #: into the smallest fitting bucket.  Only zoo names and traced
    #: callables can be rebuilt per bucket (a prebuilt ir.Graph is
    #: fixed-shape).  None (default) ->
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
    #: static-verification gate (``repro_torch.core.verify``): 'each'
    #: re-verifies the graph after every pass, 'final' once after the
    #: pipeline, 'off' never; both gated modes also check the built plan.
    #: None (default) reads ``REPRO_VERIFY``.  Sharded compiles
    #: additionally check cross-shard collective-sequence consistency
    #: (the static deadlock detector).
    verify: str | None = None

    def __post_init__(self):
        k = self.measure_top_k
        if k is not None and (not isinstance(k, int) or k < 1):
            raise ValueError(
                f"measure_top_k must be a positive int or None, got {k!r}"
            )
        if self.verify is not None:
            from repro_torch.core.verify import resolve_verify

            resolve_verify(self.verify)


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


def _intrinsic_key(target: Target, desc: AcceleratorDescription) -> tuple:
    """What the emulated route's backend memo must also tell apart: the
    fingerprint keys schedules, which do not depend on what the compute
    intrinsics compute, but the emulated route calls them.  A registered
    factory defines its intrinsics, so their code names them; a
    description object is told apart by its intrinsic functions."""
    fns = [(i.name, i.fn) for i in desc.intrinsics.values() if i.kind == "compute"]
    if isinstance(target.accelerator, str):
        return tuple((name, getattr(fn, "__code__", fn)) for name, fn in fns)
    return tuple(fns)


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
        target.use_pallas,
        target.cache,
        str(target.cache_dir),
        target.parallel_dse,
        None if target.use_pallas else _intrinsic_key(target, desc),
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
        use_pallas=target.use_pallas,
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


def _check_zoo_args(example_inputs, params) -> None:
    if example_inputs is not None or params is not None:
        raise ValueError(
            "zoo models carry their own inputs and parameters; "
            "drop example_inputs/params"
        )


def _check_callable_args(model, example_inputs) -> None:
    if not callable(model):
        raise TypeError(
            f"model must be an ir.Graph, a zoo model name, or a torch "
            f"callable; got {type(model).__name__}"
        )
    if not isinstance(example_inputs, dict) or not example_inputs:
        raise ValueError(
            "compiling a traced callable needs example_inputs: a dict "
            "mapping input names to example arrays, e.g. "
            "repro_torch.compile(fn, target, example_inputs={'x': x})"
        )


def _graph_for(model, example_inputs, params) -> Graph:
    if isinstance(model, Graph):
        if example_inputs is not None or params is not None:
            raise ValueError(
                "example_inputs/params only apply to traced callables, "
                "not prebuilt ir.Graph models"
            )
        return model
    if isinstance(model, str):
        _check_zoo_args(example_inputs, params)
        if model in DECODE_ZOO:
            # the decode-step form; prefill compiles via
            # get_decode_model(name).trace(seq=P) passed as a Graph
            return get_decode_model(model).trace()
        return get_model(model).trace()
    _check_callable_args(model, example_inputs)
    return trace_model(model, example_inputs, params)


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


def _batched_graph_builder(model, example_inputs, params):
    """A ``build(batch) -> Graph`` callback for models that can be rebuilt
    per bucket: zoo names and callables are exported once with a symbolic
    batch dim and imported per bucket (``frontend.trace_batched``).
    Prebuilt graphs are fixed-shape.  Returns the per-sample graph too,
    whose IO specs the buckets share."""
    if isinstance(model, str):
        if model in DECODE_ZOO:
            raise ValueError(
                "stateful decode models do not use batch buckets: the "
                "decode batch is the engine's static slot count — compile "
                "get_decode_model(name).trace(batch=B) directly, or serve "
                "via repro_torch.serve.ContinuousBatchingEngine"
            )
        _check_zoo_args(example_inputs, params)
        return get_model(model).trace_batched()
    if isinstance(model, Graph):
        raise ValueError(
            "batch buckets need a model that can be rebuilt per bucket "
            "(a zoo name or a traced callable); a prebuilt ir.Graph is "
            "fixed-shape — trace the model instead, or compile the graph "
            "without batch_buckets"
        )
    _check_callable_args(model, example_inputs)
    return trace_batched(model, example_inputs, params)


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
    model,
    target: Target,
    *,
    example_inputs: dict | None = None,
    params=None,
    options: CompileOptions | None = None,
):
    """Compile a model for a target — the one entry point.

    Args:
      model: an ``ir.Graph`` (mutated by the pass pipeline: build a fresh
        one per compile), a zoo model name (``repro_torch.core.zoo``; a
        decode-zoo name compiles its decode step, ``trace()``: prefill and
        batched steps compile as ``get_decode_model(name).trace(seq=P)`` /
        ``trace(batch=B)`` graphs), or a plain PyTorch callable (traced
        with ``torch.export`` by ``repro_torch.frontend``).
      target: a ``Target``.
      example_inputs: for callables — dict of input name -> example array
        or tensor (shape and dtype only; values are not used).
      params: for callables — optional tree of weight arrays or tensors,
        imported as graph constants (keeps weight preprocessing foldable).
      options: ``CompileOptions``.

    Returns a ``CompiledModule``: ``run(feeds)`` / ``run_many(feeds_list)``
    execute it on ``target.device``, ``modeled_cycles()`` reads the cycle
    model.  With ``Target(batch_size=...)`` > 1 or ``CompileOptions(
    batch_buckets=...)``, returns a ``BatchedModule`` instead: one
    ExecutionPlan per batch bucket, plus the unpadded per-sample plan for
    single requests (see ``repro_torch.core.batching``).  With
    ``Target(devices=N)`` > 1, a ``ShardedModule`` (or a ``BatchedModule``
    of them, one per bucket).
    """
    if not isinstance(target, Target):
        raise TypeError(f"target must be a Target, got {type(target).__name__}")
    options = options or CompileOptions()
    # the device, the buckets and the model are checked (and the model's
    # graphs traced) before any integration work or cache-dir side effect
    device = target.torch_device()
    buckets = _resolve_buckets(target, options)
    if buckets is None:
        graph = _graph_for(model, example_inputs, params)
    else:
        reference, build = _batched_graph_builder(model, example_inputs, params)
    dp, mp = target.resolved_mesh
    if target.devices > 1 and options.passes is not None:
        raise ValueError(
            "devices > 1 inserts the shard-partitioning pass into the "
            "per-mode pipeline; a custom CompileOptions.passes list cannot "
            "be sharded"
        )
    backend = backend_for(target, fresh=options.fresh_backend)
    store = None
    if (
        options.artifact_dir is not None
        and options.passes is None
        and target.devices == 1  # the store key carries no mesh coordinate
    ):
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
                use_pallas=backend.use_pallas,
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
            verify=options.verify,
        )
        if not options.allow_host_fallback:
            _check_offload(module)
        if store is not None:
            store.put(key, module, source_fingerprint=src_fp)
        return module

    def compile_sharded(base_graph: Graph, dp_eff: int, signature) -> ShardedModule:
        """Compile one graph into its per-shard ExecutionPlan set: every
        mesh coordinate gets its own CLONE of the source graph (the pass
        pipeline mutates in place, and each shard's shard pass rewrites
        different slices) compiled with that coordinate's ShardSpec, for
        the target's one device."""
        shards = {}
        for d in range(dp_eff):
            for m in range(mp):
                module = backend.compile_graph(
                    clone_graph(base_graph),
                    target.internal_mode,
                    device=device,
                    pass_context=options.pass_context,
                    measure_top_k=options.measure_top_k,
                    shard=ShardSpec(data=dp_eff, model=mp, data_rank=d, model_rank=m),
                    verify=options.verify,
                )
                if not options.allow_host_fallback:
                    _check_offload(module)
                shards[(d, m)] = module
        if resolve_verify(options.verify) != "off":
            # the per-shard gate proved each plan sound in isolation; the
            # cross-shard property — a consistent collective sequence on
            # every shard — is what rules out a rendezvous deadlock
            diags = verify_collectives(shards)
            if diags:
                raise VerifyError(
                    f"sharded compile of {base_graph.name!r} "
                    f"(mesh data={dp_eff}, model={mp})",
                    diags,
                )
        return ShardedModule(shards=shards, mesh=(dp_eff, mp), signature=signature)

    if buckets is None:
        if target.devices == 1:
            return compile_graph(graph)
        if dp > 1:
            raise ValueError(
                f"target mesh (data={dp}, model={mp}) is data-parallel, "
                f"which splits along the batch dim and therefore needs "
                f"batch buckets (Target(batch_size=...) or CompileOptions("
                f"batch_buckets=...)); use mesh=(1, {target.devices}) for "
                f"pure tensor parallelism on an unbatched compile"
            )
        signature = tuple((n.name, tuple(n.shape), n.dtype) for n in graph.inputs())
        return compile_sharded(graph, 1, signature)

    inputs, outputs = io_specs_from_graph(reference)
    if target.devices == 1:
        # the per-sample graph compiles into the UNPADDED single-request
        # plan, which run_many takes for size-1 chunks instead of
        # pack/pad-to-bucket/unpack
        sample_module = compile_graph(reference)
        return BatchedModule(
            modules={b: compile_graph(build(b), bucket=b) for b in buckets},
            inputs=inputs,
            outputs=outputs,
            sample_module=sample_module,
        )
    modules = {}
    for b in buckets:
        # a bucket only splits data-parallel when the mesh divides it
        # evenly; otherwise that bucket runs tensor-parallel-only
        dp_eff = dp if dp > 1 and b % dp == 0 else 1
        signature = tuple((s.name, s.batched_shape(b), s.dtype) for s in inputs)
        modules[b] = compile_sharded(build(b // dp_eff), dp_eff, signature)
    return BatchedModule(modules=modules, inputs=inputs, outputs=outputs)


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
    or was built for a different schema version, architecture, or graph,
    and ``VerifyError`` if the restored graph or plan fails static
    verification.  The accelerator the artifact targets must be registered
    in this process (built-ins always are)."""
    from repro_torch.core.artifact import load_any

    return load_any(path, device=torch_device(device, f"artifact {str(path)!r}"))
