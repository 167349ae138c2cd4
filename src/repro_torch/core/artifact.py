"""Content-addressed AOT compile artifacts: ``repro_torch.save`` /
``repro_torch.load``.

Everything after ``repro_torch.compile()`` becomes a durable, versioned artifact
so a serving replica cold-starts in milliseconds with **zero DSE sweeps,
zero measurements, and zero rewrite-rule fires**.  Layout (one directory
per artifact, written with the same atomic tmp + ``os.replace`` + sha256
discipline as ``checkpoint/store.py``)::

    <artifact>/
        manifest.json   # schema version, arch + graph fingerprints, the
                        # post-pipeline graph, per-node schedules, the
                        # pass-pipeline report, the plan skeleton, kernel
                        # configs, sha256 of arrays.npz
        arrays.npz      # constant panels / weights (const_<node_index>)
    # batched artifacts add one bucket_<b>/ sub-artifact per batch bucket

What is (and is not) serialized: the *post-pipeline* graph, each
accelerator node's resolved :class:`ScheduleResult` (measured-DSE winners
included), and the ExecutionPlan skeleton.  Executors and plan closures
are NOT pickled — ``load`` re-derives them deterministically from the
stored schedules (``CompilerBackend.executor_for`` + ``build_plan``),
then verifies the rebuilt plan against the stored skeleton.  Rebuilding
from schedules touches neither the scheduler, the stopwatch, nor the pass
manager, which is what makes the zero-work cold-start guarantee a
structural property rather than a cache hit.

Artifacts are keyed (``ArtifactStore``) and invalidated (``load``) by
content: (source-graph fingerprint, architecture fingerprint, mode,
pallas, batch bucket, measured-DSE K, schema version).  Graph
fingerprints deliberately exclude auto-generated node names — ``Node``
names come from a process-global counter, so two processes tracing the
same model disagree on them — keeping only user-stable input names.

Port of ``repro.core.artifact``: the module and batched parts, with the
reference's manifest schema (``SCHEMA_VERSION`` 1, the same keys), so an
artifact saved by either package loads in the other.  An artifact does
not depend on the device: ``load_module(path, device=...)`` names where
the restored module runs.  Two manifest keys describe the port's route:

  * ``use_pallas`` is always True: every accelerator step of the port runs
    the scheduled GEMM kernel, which is the reference's Pallas route (its
    ``use_pallas=True``); a reference artifact saved with False (the numpy
    emulation) restores onto the kernel too, bit-equal on the zoo;
  * ``kernel_configs`` holds the port's configs (``GemmKernelConfig``
    fields, the schedule's exact tiles); load re-derives configs from the
    schedules in both packages and never reads them.

Sharded artifacts (``save_sharded``/``load_sharded``) and a graph's
``cache_spec`` wait for the sharded and decode slices: a manifest that
holds either is refused with an ``ArtifactError`` naming the slice.  The
reference's static verification of a restored module (``repro.core.
verify``) waits for its slice too; the checks here are the schema, the
npz hash, the graph and architecture fingerprints, the schedules and the
rebuilt plan's skeleton.
"""

from __future__ import annotations

import dataclasses
import hashlib
import io
import json
import os
import shutil
import tempfile
import warnings
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from repro_torch.core.batching import BatchedModule, _IOSpec
from repro_torch.core.configurators import build_backend
from repro_torch.core.executor import CompiledModule, CompiledOp
from repro_torch.core.ir import Graph, Node
from repro_torch.core.lowering import kernel_config_for
from repro_torch.core.pass_manager import PassStats, PipelineReport
from repro_torch.core.registry import REGISTRY
from repro_torch.core.schedule_cache import result_from_dict, result_to_dict

#: bump on any incompatible change to the manifest or npz layout; load
#: rejects other versions with a clear error instead of misreading them.
SCHEMA_VERSION = 1

_MANIFEST = "manifest.json"
_ARRAYS = "arrays.npz"


class ArtifactError(RuntimeError):
    """A compile artifact is missing, torn, or was built for a different
    graph / architecture / schema version."""


# ---------------------------------------------------------------------------
# attr (de)serialization — JSON with explicit tuple markers, so attrs like
# transpose perms and reshape shapes round-trip as the exact tuples the
# host-op closures and rewrite rules were compiled against.
# ---------------------------------------------------------------------------


def _encode_attr(v):
    if v is None or isinstance(v, (bool, str)):
        return v
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, np.floating):
        return float(v)
    if isinstance(v, (int, float)):
        return v
    if isinstance(v, tuple):
        return {"__tuple__": [_encode_attr(x) for x in v]}
    if isinstance(v, list):
        return [_encode_attr(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _encode_attr(x) for k, x in v.items()}
    raise ArtifactError(
        f"cannot serialize attr value of type {type(v).__name__}: {v!r}"
    )


def _decode_attr(v):
    if isinstance(v, dict):
        if set(v) == {"__tuple__"}:
            return tuple(_decode_attr(x) for x in v["__tuple__"])
        return {k: _decode_attr(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_decode_attr(x) for x in v]
    return v


# ---------------------------------------------------------------------------
# graph (de)serialization + fingerprints
# ---------------------------------------------------------------------------


def graph_to_dict(graph: Graph) -> tuple[dict, dict[str, np.ndarray]]:
    """Serialize a graph: toposort-order node records with index-based
    input references, plus the const payloads as an arrays dict."""
    order = graph.toposort()
    idx = {n: i for i, n in enumerate(order)}
    nodes = []
    arrays: dict[str, np.ndarray] = {}
    for i, n in enumerate(order):
        nodes.append(
            {
                "op": n.op,
                "inputs": [None if x is None else idx[x] for x in n.inputs],
                "attrs": _encode_attr(n.attrs),
                "shape": list(n.shape),
                "dtype": n.dtype,
                "name": n.name,
                "target": n.target,
            }
        )
        if n.op == "const":
            arrays[f"const_{i}"] = np.ascontiguousarray(n.value)
    d = {
        "name": graph.name,
        "nodes": nodes,
        "outputs": [idx[o] for o in graph.outputs],
    }
    return d, arrays


def graph_from_dict(d: dict, arrays) -> Graph:
    if d.get("cache_spec"):
        raise ArtifactError(
            "the artifact's graph carries a KV-cache contract (cache_spec), "
            "which waits for the port's decode slice"
        )
    nodes: list[Node] = []
    for i, nd in enumerate(d["nodes"]):
        nodes.append(
            Node(
                op=nd["op"],
                inputs=[None if j is None else nodes[j] for j in nd["inputs"]],
                attrs=_decode_attr(nd["attrs"]),
                shape=tuple(nd["shape"]),
                dtype=nd["dtype"],
                name=nd["name"],
                target=nd["target"],
                value=arrays[f"const_{i}"] if nd["op"] == "const" else None,
            )
        )
    return Graph(outputs=[nodes[j] for j in d["outputs"]], name=d["name"])


def graph_fingerprint(graph: Graph) -> str:
    """Structural sha256 of a graph: ops, edges, attrs, shapes/dtypes,
    targets, and const *bytes*.  Auto-generated node names are excluded
    (they come from a process-global counter and differ across processes
    for identical models); only input names — the user-stable feed keys —
    participate.  Equal to the reference's fingerprint of the same graph."""
    order = graph.toposort()
    idx = {n: i for i, n in enumerate(order)}
    h = hashlib.sha256()
    for n in order:
        rec = {
            "op": n.op,
            "inputs": [None if x is None else idx[x] for x in n.inputs],
            "attrs": _encode_attr(n.attrs),
            "shape": list(n.shape),
            "dtype": n.dtype,
            "target": n.target,
        }
        if n.op == "input":
            rec["name"] = n.name
        h.update(json.dumps(rec, sort_keys=True).encode())
        if n.op == "const" and n.value is not None:
            v = np.ascontiguousarray(n.value)
            h.update(f"{v.dtype}{v.shape}".encode())
            h.update(v.tobytes())
    h.update(json.dumps([idx[o] for o in graph.outputs]).encode())
    return h.hexdigest()


# ---------------------------------------------------------------------------
# single-module artifacts
# ---------------------------------------------------------------------------


def _plan_skeleton(plan) -> dict:
    return {
        "n_slots": plan.n_slots,
        "input_slots": [[name, slot] for name, slot in plan.input_slots],
        "const_slots": [slot for slot, _ in plan.const_slots],
        "steps": [
            [s.slot, list(s.arg_slots), s.op, s.name, s.lane]
            for s in plan.steps
        ],
        "output_slots": list(plan.output_slots),
    }


def _report_to_dict(report: PipelineReport | None) -> dict | None:
    if report is None:
        return None
    return {
        "graph_name": report.graph_name,
        "mode": report.mode,
        "passes": [dataclasses.asdict(p) for p in report.passes],
    }


def _report_from_dict(d: dict | None) -> PipelineReport | None:
    if d is None:
        return None
    return PipelineReport(
        graph_name=d["graph_name"],
        mode=d["mode"],
        passes=[PassStats(**p) for p in d["passes"]],
    )


def _atomic_write_dir(path: Path, write_contents) -> None:
    """Populate ``path`` atomically: ``write_contents(tmp_dir)`` fills a
    unique sibling tmp dir, which is then renamed over ``path``.  A crash
    mid-write leaves only a tmp dir; concurrent writers race benignly
    (content-addressed artifacts are identical, last rename wins)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix=path.name + ".tmp.", dir=path.parent))
    try:
        write_contents(tmp)
        if path.exists():
            shutil.rmtree(path)
        os.replace(tmp, path)
    except OSError:
        # lost a replace race against a concurrent writer of the same
        # artifact: their (identical) content stands
        if path.is_dir() and (path / _MANIFEST).exists():
            shutil.rmtree(tmp, ignore_errors=True)
            return
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def save_module(
    module: CompiledModule, path: str | Path, *, source_fingerprint: str | None = None
) -> Path:
    """Serialize one compiled module into an artifact directory at ``path``
    (written atomically).  ``source_fingerprint`` optionally records the
    *pre-pipeline* graph fingerprint the module was compiled from (the
    ``ArtifactStore`` keys by it)."""
    if not isinstance(module, CompiledModule):
        raise ArtifactError(
            "save_module() takes a CompiledModule; use repro_torch.save() for "
            "batched modules"
        )
    plan = module.finalize()
    graph_d, arrays = graph_to_dict(module.graph)
    order = module.graph.toposort()
    idx = {n: i for i, n in enumerate(order)}
    schedules = {}
    kernel_configs = {}
    backend = module.backend
    for n, op in module.ops.items():
        sd = result_to_dict(op.strategy.schedule_result)
        # the ranked candidate list only feeds measured DSE, which never
        # runs at load time — drop it to keep artifacts lean
        sd.pop("top", None)
        schedules[str(idx[n])] = sd
        if backend is not None:
            cfg = kernel_config_for(module.desc, backend.mapping_gen, n, op.strategy)
            kernel_configs[str(idx[n])] = _encode_attr(dataclasses.asdict(cfg))
    use_mip = bool(getattr(getattr(backend, "scheduler", None), "use_mip", True))
    manifest = {
        "schema_version": SCHEMA_VERSION,
        "kind": "module",
        "accelerator": module.desc.name,
        "arch_fingerprint": module.desc.fingerprint(),
        "mode": module.mode,
        # the port's route is the reference's kernel route (module docstring)
        "use_pallas": True,
        "use_mip": use_mip,
        "graph_fingerprint": graph_fingerprint(module.graph),
        "source_fingerprint": source_fingerprint,
        "graph": graph_d,
        "schedules": schedules,
        "pass_report": _report_to_dict(module.pass_report),
        "plan": _plan_skeleton(plan),
        "kernel_configs": kernel_configs,
        "stage_assignment": list(plan.stage_assignment()),
    }

    def write(tmp: Path) -> None:
        buf = io.BytesIO()
        np.savez_compressed(buf, **arrays)
        data = buf.getvalue()
        (tmp / _ARRAYS).write_bytes(data)
        manifest["npz_sha256"] = hashlib.sha256(data).hexdigest()
        (tmp / _MANIFEST).write_text(json.dumps(manifest))

    path = Path(path)
    _atomic_write_dir(path, write)
    return path


def _read_manifest(path: Path) -> dict:
    f = path / _MANIFEST
    if not f.exists():
        raise ArtifactError(f"no compile artifact at {path} (missing {_MANIFEST})")
    try:
        man = json.loads(f.read_text())
    except (OSError, ValueError) as e:
        raise ArtifactError(f"unreadable artifact manifest at {f}: {e}") from e
    version = man.get("schema_version")
    if version != SCHEMA_VERSION:
        raise ArtifactError(
            f"artifact at {path} has schema version {version!r}, this build "
            f"reads version {SCHEMA_VERSION}; recompile and re-save it"
        )
    if man.get("kind") == "sharded":
        raise ArtifactError(
            f"artifact at {path} is a sharded module (kind 'sharded'); sharded "
            f"plans wait for the port's sharded slice"
        )
    return man


def _read_arrays(path: Path, manifest: dict) -> dict[str, np.ndarray]:
    f = path / _ARRAYS
    try:
        data = f.read_bytes()
    except OSError as e:
        raise ArtifactError(f"unreadable artifact arrays at {f}: {e}") from e
    digest = hashlib.sha256(data).hexdigest()
    if digest != manifest.get("npz_sha256"):
        raise ArtifactError(
            f"artifact at {path} failed content verification "
            f"({_ARRAYS} sha256 mismatch — torn or tampered write)"
        )
    with np.load(io.BytesIO(data)) as npz:
        return {k: npz[k] for k in npz.files}


def _resolve_desc(manifest: dict, desc, path: Path):
    name = manifest["accelerator"]
    if desc is None:
        if name not in REGISTRY:
            known = ", ".join(REGISTRY.names()) or "<none>"
            raise ArtifactError(
                f"artifact at {path} targets accelerator {name!r}, which is "
                f"not registered in this process (registered: {known}); "
                f"register it with repro_torch.register_accelerator first or "
                f"pass desc="
            )
        desc = REGISTRY.get(name)
    fp = desc.fingerprint()
    if fp != manifest["arch_fingerprint"]:
        raise ArtifactError(
            f"artifact at {path} was compiled for {name!r} with architecture "
            f"fingerprint {manifest['arch_fingerprint']}, but the current "
            f"description fingerprints as {fp}; the accelerator description "
            f"changed — recompile and re-save"
        )
    return desc


def load_module(path: str | Path, *, device: torch.device, desc=None) -> CompiledModule:
    """Restore a compiled module from an artifact directory, to run on
    ``device``.

    Validation is strict and every failure is an :class:`ArtifactError`
    naming the mismatch: schema version, npz content hash, architecture
    fingerprint, stored-graph fingerprint, and the rebuilt-plan skeleton.
    Restoration performs zero DSE sweeps, zero measurements, and zero
    pass-pipeline rewrites: executors are re-derived from the persisted
    schedules and the plan is rebuilt deterministically."""
    path = Path(path)
    manifest = _read_manifest(path)
    if manifest.get("kind") != "module":
        raise ArtifactError(
            f"artifact at {path} is kind {manifest.get('kind')!r}, expected "
            f"'module' (batched artifacts load via repro_torch.load())"
        )
    arrays = _read_arrays(path, manifest)
    graph = graph_from_dict(manifest["graph"], arrays)
    fp = graph_fingerprint(graph)
    if fp != manifest["graph_fingerprint"]:
        raise ArtifactError(
            f"artifact at {path} failed graph verification (stored graph "
            f"fingerprints as {fp}, manifest says "
            f"{manifest['graph_fingerprint']})"
        )
    desc = _resolve_desc(manifest, desc, path)
    # a fresh, clean-counter backend: nothing below touches the scheduler,
    # the stopwatch, or the pass manager — the zero-work cold start is
    # checkable on its counters (n_solver_calls == 0, n_measurements == 0)
    backend = build_backend(desc, use_mip=manifest.get("use_mip", True))
    module = CompiledModule(
        graph=graph,
        desc=desc,
        mode=manifest["mode"],
        device=torch.device(device),
        pass_report=_report_from_dict(manifest.get("pass_report")),
        backend=backend,
    )
    order = graph.toposort()
    for key, sd in manifest["schedules"].items():
        n = order[int(key)]
        sr = result_from_dict(sd)
        strat = backend.strategy_gen.generate(n, sr)
        module.ops[n] = CompiledOp(
            node=n, strategy=strat, executor=backend.executor_for(n, strat)
        )
    missing = [n.name for n in order if n.target == "accel" and n not in module.ops]
    if missing:
        raise ArtifactError(
            f"artifact at {path} has no schedule for accelerator node(s) "
            f"{missing} — torn or schema-drifted manifest"
        )
    plan = module.finalize()
    if _plan_skeleton(plan) != manifest["plan"]:
        raise ArtifactError(
            f"artifact at {path} failed plan verification: the plan rebuilt "
            f"from the stored graph/schedules does not match the stored "
            f"skeleton (compiler drift across versions?)"
        )
    return module


# ---------------------------------------------------------------------------
# batched artifacts (one sub-artifact per bucket)
# ---------------------------------------------------------------------------


def save_batched(
    module: BatchedModule,
    path: str | Path,
    *,
    source_fingerprints: dict[int, str] | None = None,
) -> Path:
    """Serialize a bucketed BatchedModule: a batched manifest (IO specs +
    bucket list) plus one full module artifact per bucket."""
    manifest = {
        "schema_version": SCHEMA_VERSION,
        "kind": "batched",
        "buckets": list(module.bucket_sizes()),
        "inputs": [dataclasses.asdict(s) for s in module.inputs],
        "outputs": [dataclasses.asdict(s) for s in module.outputs],
        "has_sample": module.sample_module is not None,
    }
    fps = source_fingerprints or {}

    def write(tmp: Path) -> None:
        (tmp / _MANIFEST).write_text(json.dumps(_encode_attr(manifest)))
        for b in module.bucket_sizes():
            save_module(module.bucket_module(b), tmp / f"bucket_{b}", source_fingerprint=fps.get(b))
        if module.sample_module is not None:
            save_module(module.sample_module, tmp / "sample")

    path = Path(path)
    _atomic_write_dir(path, write)
    return path


def load_batched(path: str | Path, *, device: torch.device, desc=None) -> BatchedModule:
    path = Path(path)
    manifest = _read_manifest(path)
    if manifest.get("kind") != "batched":
        raise ArtifactError(
            f"artifact at {path} is kind {manifest.get('kind')!r}, expected "
            f"'batched'"
        )

    def spec(d) -> _IOSpec:
        d = _decode_attr(d)
        return _IOSpec(
            name=d["name"],
            shape=tuple(d["shape"]),
            dtype=d["dtype"],
            stacked=d["stacked"],
        )

    modules = {
        b: load_module(path / f"bucket_{b}", device=device, desc=desc)
        for b in manifest["buckets"]
    }
    sample = None
    if manifest.get("has_sample"):
        sample = load_module(path / "sample", device=device, desc=desc)
    return BatchedModule(
        modules=modules,
        inputs=tuple(spec(d) for d in manifest["inputs"]),
        outputs=tuple(spec(d) for d in manifest["outputs"]),
        sample_module=sample,
    )


def save_any(module, path: str | Path) -> Path:
    """``repro_torch.save``: dispatch on module kind."""
    if isinstance(module, BatchedModule):
        return save_batched(module, path)
    if isinstance(module, CompiledModule):
        return save_module(module, path)
    raise ArtifactError(
        f"repro_torch.save() takes a CompiledModule or BatchedModule, got "
        f"{type(module).__name__}"
    )


def load_any(path: str | Path, *, device: torch.device, desc=None):
    """``repro_torch.load``: dispatch on the artifact's recorded kind."""
    path = Path(path)
    if _read_manifest(path).get("kind") == "batched":
        return load_batched(path, device=device, desc=desc)
    return load_module(path, device=device, desc=desc)


# ---------------------------------------------------------------------------
# the content-addressed store (compile write-through)
# ---------------------------------------------------------------------------


@dataclass
class ArtifactStore:
    """Content-addressed artifact cache backing ``CompileOptions(
    artifact_dir=...)``: ``compile()`` probes it before compiling and
    writes through after.  Keys cover everything that determines the
    compiled output; a corrupt or stale entry is a *miss* (with a
    warning), never an error — the explicit ``repro_torch.load()`` surface
    is the strict one."""

    root: Path
    hits: int = 0
    misses: int = 0
    puts: int = 0
    _skip_put: set = field(default_factory=set, repr=False)

    def __post_init__(self):
        self.root = Path(self.root)

    @staticmethod
    def key_for(
        *,
        source_fingerprint: str,
        arch_fingerprint: str,
        mode: str,
        use_pallas: bool,
        bucket: int | None,
        measure_top_k: int | None,
        measure_device: str | None = None,
    ) -> str:
        """The reference's key material.  A measured compile
        (``measure_top_k`` set) also names ``measure_device``, the
        ``pipeline.device_tag`` of the device that timed its candidates, as
        the schedule cache's measured keys do: a module whose winners were
        timed on the CPU never answers for the card.  Unmeasured keys equal
        the reference's."""
        measure = f"measure{measure_top_k}"
        if measure_top_k is not None:
            measure += f"@{measure_device}"
        material = "|".join(
            [
                f"schema{SCHEMA_VERSION}",
                source_fingerprint,
                arch_fingerprint,
                mode,
                f"pallas{int(bool(use_pallas))}",
                f"bucket{bucket}",
                measure,
            ]
        )
        return hashlib.sha256(material.encode()).hexdigest()

    def path_for(self, key: str) -> Path:
        return self.root / key[:2] / key

    def get(self, key: str, *, device: torch.device, desc=None):
        p = self.path_for(key)
        if not (p / _MANIFEST).exists():
            self.misses += 1
            return None
        try:
            module = load_module(p, device=device, desc=desc)
        except ArtifactError as e:
            warnings.warn(
                f"ignoring unusable compile artifact at {p}: {e}",
                RuntimeWarning,
                stacklevel=2,
            )
            self.misses += 1
            return None
        self.hits += 1
        return module

    def put(self, key: str, module: CompiledModule, *, source_fingerprint: str) -> Path | None:
        if key in self._skip_put:
            return None
        try:
            path = save_module(module, self.path_for(key), source_fingerprint=source_fingerprint)
        except (OSError, ArtifactError) as e:
            # an unwritable artifact dir must never fail a compile
            warnings.warn(
                f"compile artifacts are not persistable under {self.root} "
                f"({e}); continuing without write-through",
                RuntimeWarning,
                stacklevel=2,
            )
            self._skip_put.add(key)
            return None
        self.puts += 1
        return path
