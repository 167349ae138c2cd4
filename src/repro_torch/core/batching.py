"""Batch-aware serving modules: bucketed ExecutionPlans + padded dispatch.

The compile-time side of the serving story: ``repro_torch.compile(...,
options=CompileOptions(batch_buckets=(1, 4, 16)))`` builds one compiled
module (one ExecutionPlan, one schedule set) per batch *bucket* and wraps
them in a :class:`BatchedModule`.  At run time, ``run_many`` packs
per-sample feeds along the batch dimension, pads the tail chunk up to the
smallest fitting bucket, executes ONE planned run per chunk, and unpacks
only the real rows — so a 16-request burst is one GEMM sweep with batch
folded into M, not 16 Python-level plan walks.

Padding semantics: pad rows are zeros and are sliced away before results
are returned.  Every op the planner batches is row-independent along the
batch dimension (weight-GEMM rows, per-sample im2col, per-instance batched
matmuls, elementwise epilogues, last-axis softmax), so a padded execution
is bit-exact with the per-sample execution of the real rows.

Batch-dim convention (mirrors ``ZooModel.batched_input_shape``): an input
whose per-sample shape has a leading unit dim is *widened* in place
(``(1, d) -> (b, d)``, packed with ``concatenate``); any other per-sample
shape gets a new leading batch dim (``(s, d) -> (b, s, d)``, packed with
``stack``).  Outputs follow the same rule.

``BatchedModule`` is stateless on top of its per-bucket modules, which are
themselves thread-safe (every run builds its own arena), so one instance
can serve a whole thread pool.  Packing and unpacking are numpy on the
host; each chunk crosses to the modules' device once, inside ``run``.

Port of ``repro.core.batching``, whole.  ``device`` is the port's own: the
device the bucket modules run on.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

import torch

from repro_torch.core.executor import CompiledModule, FeedError


def is_stacked(shape: tuple[int, ...]) -> bool:
    """THE batch-dim convention, in one place: a per-sample shape with a
    leading unit dim is *widened* in place at batch b (``(1, d) -> (b,
    d)``, packed with concatenate); any other shape gains a new leading
    batch dim (``(s, d) -> (b, s, d)``, packed with stack)."""
    return not (shape and shape[0] == 1)


def batched_shape(shape: tuple[int, ...], batch: int) -> tuple[int, ...]:
    """The batched form of a per-sample shape under ``is_stacked``."""
    return (batch, *shape) if is_stacked(shape) else (batch, *shape[1:])


def pick_bucket(buckets: tuple[int, ...], n: int) -> int:
    """The smallest bucket that fits ``n`` samples, else the largest
    (callers then split ``n`` across multiple chunks).  ``buckets`` must be
    sorted ascending."""
    for b in buckets:
        if b >= n:
            return b
    return buckets[-1]


def plan_chunks(buckets: tuple[int, ...], n: int) -> list[int]:
    """Split ``n`` requests into chunk sizes, each executed in the bucket
    ``pick_bucket`` assigns it.  Full largest-bucket chunks come first; a
    sub-largest tail is *filled* with the largest bucket that fits before
    padding, and only pads when the padded bucket wastes less than 2x the
    remaining work (23 requests over (1, 4, 16) -> [16, 4, 3(->4)], never
    7 padded to 16).  ``buckets`` must be sorted ascending."""
    chunks: list[int] = []
    remaining = n
    largest = buckets[-1]
    while remaining > 0:
        if remaining >= largest:
            chunks.append(largest)
            remaining -= largest
            continue
        pad = pick_bucket(buckets, remaining)  # smallest bucket that fits
        fill = max((b for b in buckets if b <= remaining), default=None)
        if fill is None or pad < 2 * remaining:
            chunks.append(remaining)  # executes padded up to ``pad``
            remaining = 0
        else:
            chunks.append(fill)
            remaining -= fill
    return chunks


@dataclass(frozen=True)
class _IOSpec:
    """Per-sample shape/dtype of one input or output plus its batching
    style (``stacked=True`` -> new leading dim, else widen the unit dim)."""

    name: str
    shape: tuple[int, ...]
    dtype: str
    stacked: bool

    def batched_shape(self, batch: int) -> tuple[int, ...]:
        return batched_shape(self.shape, batch)


@dataclass
class BatchedModule:
    """Bucketed compiled modules behind one per-sample ``run``/``run_many``
    surface.  Build via ``repro_torch.compile(..., CompileOptions(
    batch_buckets=...))`` — the constructor checks every bucket module against the
    per-sample signature."""

    #: bucket size -> compiled module for that batch (plan + schedules)
    modules: dict[int, CompiledModule]
    #: per-sample input signature (order = graph input order)
    inputs: tuple[_IOSpec, ...]
    #: per-sample output signature
    outputs: tuple[_IOSpec, ...]
    #: the UNPADDED per-sample plan: single-request chunks dispatch here
    #: directly (no pack/pad/unpack), which is what keeps batched serving
    #: from regressing the latency of batch-of-1 traffic
    sample_module: CompiledModule | None = None
    _buckets: tuple[int, ...] = field(init=False, repr=False)
    _feed_names: frozenset = field(init=False, repr=False)

    def __post_init__(self):
        if not self.modules:
            raise ValueError("BatchedModule needs at least one bucket")
        self._buckets = tuple(sorted(self.modules))
        self._feed_names = frozenset(spec.name for spec in self.inputs)
        for b in self._buckets:
            if b < 1:
                raise ValueError(f"batch bucket {b} must be >= 1")
            sig = dict(
                (name, (shape, dtype))
                for name, shape, dtype in self.modules[b].input_signature()
            )
            for spec in self.inputs:
                got = sig.get(spec.name)
                want = (spec.batched_shape(b), spec.dtype)
                if got != want:
                    raise ValueError(
                        f"bucket {b} module input {spec.name!r} is {got}, "
                        f"expected {want} for per-sample shape {spec.shape}"
                    )
        if self.sample_module is not None:
            sig = dict(
                (name, (tuple(shape), dtype))
                for name, shape, dtype in self.sample_module.input_signature()
            )
            for spec in self.inputs:
                got = sig.get(spec.name)
                if got != (spec.shape, spec.dtype):
                    raise ValueError(
                        f"sample module input {spec.name!r} is {got}, "
                        f"expected per-sample {(spec.shape, spec.dtype)}"
                    )

    # -- introspection -------------------------------------------------------
    def bucket_sizes(self) -> tuple[int, ...]:
        return self._buckets

    def bucket_module(self, bucket: int) -> CompiledModule:
        return self.modules[bucket]

    @property
    def device(self) -> torch.device:
        """The device every bucket module runs on."""
        return self.modules[self._buckets[0]].device

    def input_signature(self) -> tuple[tuple[str, tuple[int, ...], str], ...]:
        """Per-sample (name, shape, dtype) — what each feeds dict in
        ``run_many(feeds_list)`` must contain."""
        return tuple((s.name, s.shape, s.dtype) for s in self.inputs)

    def modeled_cycles(self, bucket: int | None = None) -> dict[str, float]:
        """Cycle model of one bucket's plan (default: the largest bucket).
        Divide by the bucket size for the amortized per-request cost."""
        bucket = self._buckets[-1] if bucket is None else bucket
        return self.modules[bucket].modeled_cycles()

    # -- feed validation -----------------------------------------------------
    def _check_sample_feeds(self, feeds: dict[str, np.ndarray]) -> None:
        problems = []
        if feeds.keys() != self._feed_names:
            for name in sorted(self._feed_names - feeds.keys()):
                problems.append(f"missing feed for input {name!r}")
            for name in sorted(feeds.keys() - self._feed_names):
                problems.append(f"unknown feed {name!r}")
        for spec in self.inputs:
            if spec.name not in feeds:
                continue
            value = np.asarray(feeds[spec.name])
            if value.shape != spec.shape or str(value.dtype) != spec.dtype:
                problems.append(
                    f"feed {spec.name!r} is {value.dtype}{list(value.shape)}, "
                    f"expected per-sample {spec.dtype}{list(spec.shape)}"
                )
        if not problems:
            return
        sig = ", ".join(
            f"{s.name}: {s.dtype}{list(s.shape)}" for s in self.inputs
        )
        bullet = "\n  - ".join(problems)
        raise FeedError(
            f"feeds do not match the module's per-sample inputs:\n"
            f"  - {bullet}\nexpected per-sample inputs: {sig or '<none>'}"
        )

    # -- execution -----------------------------------------------------------
    def _pack(
        self, chunk: list[dict[str, np.ndarray]], bucket: int
    ) -> dict[str, np.ndarray]:
        packed: dict[str, np.ndarray] = {}
        for spec in self.inputs:
            parts = [np.asarray(f[spec.name]) for f in chunk]
            arr = np.stack(parts) if spec.stacked else np.concatenate(parts)
            if len(chunk) < bucket:
                pad = np.zeros(
                    (bucket - len(chunk), *arr.shape[1:]), dtype=arr.dtype
                )
                arr = np.concatenate([arr, pad])
            packed[spec.name] = arr
        return packed

    def _unpack(self, outs: list[np.ndarray], n: int) -> list[list[np.ndarray]]:
        return [
            [
                out[i] if spec.stacked else out[i : i + 1]
                for spec, out in zip(self.outputs, outs)
            ]
            for i in range(n)
        ]

    def run(self, feeds: dict[str, np.ndarray]) -> list[np.ndarray]:
        """Execute ONE per-sample request (padded up to the smallest
        bucket)."""
        return self.run_many([feeds])[0]

    def run_many(
        self, feeds_list: list[dict[str, np.ndarray]]
    ) -> list[list[np.ndarray]]:
        """Serve a list of per-sample feeds: greedy chunks of the largest
        bucket, the tail filled with smaller buckets and padded only up to
        the smallest fitting one (``plan_chunks``), one planned execution
        per chunk.  Returns per-sample outputs in request order.
        Thread-safe (the bucket modules build one arena per call)."""
        for feeds in feeds_list:
            self._check_sample_feeds(feeds)
        results: list[list[np.ndarray]] = []
        i = 0
        for size in plan_chunks(self._buckets, len(feeds_list)):
            if size == 1 and self.sample_module is not None:
                # single-request chunk: the unpadded per-sample plan is
                # strictly cheaper than pack -> pad-to-bucket -> unpack
                # (and bit-exact with it — padded rows are sliced away)
                results.append(self.sample_module.run(feeds_list[i]))
                i += 1
                continue
            bucket = pick_bucket(self._buckets, size)
            chunk = feeds_list[i : i + size]
            outs = self.modules[bucket].run(self._pack(chunk, bucket))
            results.extend(self._unpack(outs, len(chunk)))
            i += size
        return results


def io_specs_from_graph(graph) -> tuple[tuple[_IOSpec, ...], tuple[_IOSpec, ...]]:
    """Derive per-sample input/output specs from the *per-sample* reference
    graph (batch-dim convention in the module docstring)."""
    ins = tuple(
        _IOSpec(n.name, tuple(n.shape), n.dtype, stacked=is_stacked(n.shape))
        for n in graph.inputs()
    )
    outs = tuple(
        _IOSpec(f"out{i}", tuple(o.shape), o.dtype, stacked=is_stacked(o.shape))
        for i, o in enumerate(graph.outputs)
    )
    return ins, outs
