"""The mesh-aware executor: one ``CompiledModule`` per mesh coordinate
behind a single ``run``/``run_many`` surface.

``Target(devices=N)`` compiles one graph into a per-shard ExecutionPlan
set (see ``passes.make_shard_pass``); a :class:`ShardedModule` holds those
plans keyed by ``(data_rank, model_rank)`` and dispatches every call
across one thread per shard.  Collectives inside the plans rendezvous
through a per-call :class:`~repro_torch.core.collective.CollectiveSession`
(barrier + a combine on the device), so all shards must run concurrently —
the module spawns fresh threads per call (the caller's thread runs shard
``(0, 0)``) rather than sharing a bounded pool, which could deadlock two
concurrent calls each holding half their shards.

Because every shard's plan all_gathers each split value immediately, the
outputs of shard ``(0, 0)`` are the full (replicated) outputs — bit-exact
with the ``devices=1`` plan.

Data parallelism: each shard's plan was compiled at ``batch/data`` rows
and ends with a batch-axis all_gather per output, so ``run`` slices the
incoming feeds along the batch dim (axis 0, the bucket-level convention)
per data rank and every shard still returns full-batch outputs.

Port of ``repro.core.sharded``.  The mesh is one of shards, not of cards:
every shard's plan runs on the one device of the target
(``ShardedModule.device``), its kernels launched from its own thread onto
the caller's current stream of that device, and the collectives combine
there, on that stream too: one stream orders every shard's work and every
combine, so no event is needed between them.  Only shard ``(0, 0)``'s
outputs are copied back to the host; the other shards' plans run to their
end on the device and return nothing to numpy.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.collective import (
    CollectiveError,
    CollectiveSession,
    session_scope,
)
from repro_torch.core.executor import CompiledModule, FeedError, to_numpy


@dataclass
class ShardedModule:
    """Per-shard compiled modules for one ``(data, model)`` mesh.

    Duck-types the ``CompiledModule`` execution surface (``run`` /
    ``run_many`` / ``input_signature`` / ``modeled_cycles`` / ``device``),
    so it drops into ``BatchedModule`` buckets and the serving
    ``MicroBatcher`` unchanged.
    """

    #: (data_rank, model_rank) -> that shard's compiled plan
    shards: dict[tuple[int, int], CompiledModule]
    #: mesh factorization (data, model); ``data * model == len(shards)``
    mesh: tuple[int, int]
    #: the FULL (unsharded) input signature this module accepts — with
    #: data parallelism the per-shard plans expect ``batch/data`` rows,
    #: which ``run`` slices out of these full feeds
    signature: tuple[tuple[str, tuple[int, ...], str], ...]

    _feed_names: frozenset = field(init=False, repr=False)

    def __post_init__(self):
        dp, mp = self.mesh
        want = {(d, m) for d in range(dp) for m in range(mp)}
        if set(self.shards) != want:
            raise ValueError(
                f"shards {sorted(self.shards)} do not cover mesh {self.mesh}"
            )
        devices = {s.device for s in self.shards.values()}
        if len(devices) != 1:
            raise ValueError(f"shards of one module run on one device, got {sorted(map(str, devices))}")
        self._feed_names = frozenset(name for name, _, _ in self.signature)

    # -- introspection -------------------------------------------------------
    @property
    def devices(self) -> int:
        return self.mesh[0] * self.mesh[1]

    @property
    def device(self) -> torch.device:
        """The device every shard's plan runs on."""
        return self.shards[(0, 0)].device

    @property
    def desc(self):
        return self.shards[(0, 0)].desc

    @property
    def mode(self) -> str:
        return self.shards[(0, 0)].mode

    def shard_module(self, data_rank: int = 0, model_rank: int = 0) -> CompiledModule:
        return self.shards[(data_rank, model_rank)]

    def collective_sequences(self) -> dict[tuple[int, int], list[dict]]:
        """Per-shard ordered collective descriptors (group, op, rank,
        parts, axis, dtype, contribution shape) in plan-step order — the
        input of ``repro_torch.core.verify.verify_collectives``, which
        proves the mesh cannot deadlock at a rendezvous."""
        from repro_torch.core.verify import collective_sequence

        return {
            key: collective_sequence(shard.graph)
            for key, shard in sorted(self.shards.items())
        }

    def input_signature(self) -> tuple[tuple[str, tuple[int, ...], str], ...]:
        return self.signature

    def modeled_cycles(self) -> dict[str, float]:
        """The mesh-critical-path cost: shards run concurrently, so the
        modeled latency is the SLOWEST shard's total (its own accel/host
        work plus the collectives it participates in)."""
        worst = max(
            (s.modeled_cycles() for s in self.shards.values()),
            key=lambda c: c["total"],
        )
        return worst

    # -- feed validation -----------------------------------------------------
    def _check_feeds(self, feeds: dict[str, np.ndarray]) -> None:
        problems = []
        if feeds.keys() != self._feed_names:
            for name in sorted(self._feed_names - feeds.keys()):
                problems.append(f"missing feed for input {name!r}")
            for name in sorted(feeds.keys() - self._feed_names):
                problems.append(f"unknown feed {name!r}")
        for name, shape, dtype in self.signature:
            if name not in feeds:
                continue
            value = np.asarray(feeds[name])
            if value.shape != shape or str(value.dtype) != dtype:
                problems.append(
                    f"feed {name!r} is {value.dtype}{list(value.shape)}, "
                    f"expected {dtype}{list(shape)}"
                )
        if problems:
            sig = ", ".join(
                f"{name}: {dtype}{list(shape)}"
                for name, shape, dtype in self.signature
            )
            bullet = "\n  - ".join(problems)
            raise FeedError(
                f"feeds do not match the sharded module's inputs:\n"
                f"  - {bullet}\nexpected inputs: {sig or '<none>'}"
            )

    def _shard_feeds(self, feeds: dict[str, np.ndarray], data_rank: int) -> dict:
        dp = self.mesh[0]
        if dp == 1:
            return feeds
        out = {}
        for name, value in feeds.items():
            value = np.asarray(value)
            size = value.shape[0] // dp
            out[name] = value[data_rank * size : (data_rank + 1) * size]
        return out

    # -- execution -----------------------------------------------------------
    def _execute(self, key: tuple[int, int], feeds: dict[str, np.ndarray]) -> list[torch.Tensor]:
        """One shard's plan over its feeds; its outputs stay on the device."""
        shard = self.shards[key]
        shard._check_feeds(feeds)
        plan = shard.finalize()
        return plan.execute(feeds, plan.new_arena())

    def run(self, feeds: dict[str, np.ndarray]) -> list[np.ndarray]:
        """One mesh-wide execution: every shard's plan runs on its own
        thread inside a shared CollectiveSession; shard ``(0, 0)``'s
        outputs (full, replicated) are returned."""
        self._check_feeds(feeds)
        if self.devices == 1:
            return self.shards[(0, 0)].run(feeds)
        session = CollectiveSession()
        # a fresh thread starts on the device's default stream: every
        # shard, and the combine its thread may run, joins the caller's
        stream = torch.cuda.current_stream(self.device) if self.device.type == "cuda" else None
        by_rank = {
            d: self._shard_feeds(feeds, d) for d in range(self.mesh[0])
        }
        failures: list[BaseException] = []

        def run_shard(key: tuple[int, int]) -> list[torch.Tensor]:
            with session_scope(session), torch.cuda.stream(stream):
                return self._execute(key, by_rank[key[0]])

        def worker(key: tuple[int, int]) -> None:
            try:
                run_shard(key)
            except CollectiveError:
                pass  # unwound by a peer's abort; the origin owns the error
            except BaseException as e:  # noqa: BLE001 — re-raised in caller
                failures.append(e)
                session.abort(e)

        threads = [
            threading.Thread(
                target=worker,
                args=(key,),
                name=f"repro-shard-d{key[0]}m{key[1]}",
                daemon=True,
            )
            for key in self.shards
            if key != (0, 0)
        ]
        for t in threads:
            t.start()
        try:
            outs = run_shard((0, 0))
        except BaseException as e:  # noqa: BLE001
            session.abort(e)
            for t in threads:
                t.join()
            # a peer's failure is the root cause when this shard only saw
            # the aborted collective
            if failures and isinstance(e, CollectiveError):
                raise failures[0] from e
            raise
        for t in threads:
            t.join()
        if failures:
            raise failures[0]
        return [to_numpy(t) for t in outs]

    def run_many(
        self, feeds_list: list[dict[str, np.ndarray]]
    ) -> list[list[np.ndarray]]:
        return [self.run(feeds) for feeds in feeds_list]
