"""Collective runtime + interconnect cost model for sharded ExecutionPlans.

``Target(devices=N)`` compiles one graph into one plan per mesh coordinate
(see ``repro_torch.core.sharded``).  The shard partitioning pass
(``passes.make_shard_pass``) inserts collective IR ops — ``all_gather`` /
``all_reduce`` / ``reduce_scatter`` — wherever a tensor-parallel split must
re-materialize the full value.  At run time every shard executes its plan
on its own thread and the collectives rendezvous through a
:class:`CollectiveSession`: the last participant to arrive combines the
contributions and every waiter wakes with the result (barrier + reduction,
the software stand-in for a ring collective).

The *modeled* cost charges the classic ring formulas, parameterized on the
``ArchSpec`` interconnect fields so accelerators differ:

    ring step  = (B / P) bytes over one link  +  one fixed hop latency
    all_gather / reduce_scatter = (P-1) ring steps
    all_reduce = reduce_scatter + all_gather = 2 * (P-1) ring steps

where ``B`` is the FULL (gathered/reduced) payload in bytes and ``P`` the
participant count.

Port of ``repro.core.collective``.  The combine runs on the device of the
contributions, with torch: an ``all_gather`` is one ``torch.cat``, an
integer sum accumulates in int64 in rank order and casts back, a float
sum adds in rank order — the reference's numpy combine, value for value,
and never a copy to the host.  Every shard of a ``ShardedModule`` runs on
the module's one device, so the contributions already share it.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.core.arch_spec import ArchSpec
from repro_torch.kernels.ref import torch_dtype


@dataclass(frozen=True)
class ShardSpec:
    """One shard's coordinate in a ``(data, model)`` mesh.

    ``data``/``model`` are the mesh axis sizes; ``data_rank``/``model_rank``
    this shard's coordinates.  ``devices == data * model``.  The shard pass
    reads the *model* axis for tensor-parallel splits; the api layer
    implements the *data* axis by rebuilding each batch bucket at
    ``bucket/data`` rows and gathering outputs along the batch dim.
    """

    data: int = 1
    model: int = 1
    data_rank: int = 0
    model_rank: int = 0

    def __post_init__(self):
        if self.data < 1 or self.model < 1:
            raise ValueError(f"mesh axes must be >= 1, got {self!r}")
        if not (0 <= self.data_rank < self.data):
            raise ValueError(f"data_rank out of range: {self!r}")
        if not (0 <= self.model_rank < self.model):
            raise ValueError(f"model_rank out of range: {self!r}")

    @property
    def devices(self) -> int:
        return self.data * self.model


# ---------------------------------------------------------------------------
# Modeled interconnect cost (ring collectives).
# ---------------------------------------------------------------------------


def collective_cycles(op: str, nbytes: int, parts: int, arch: ArchSpec) -> float:
    """Modeled cycles of one collective over ``parts`` devices moving a
    FULL payload of ``nbytes`` (the gathered/reduced tensor size).

    Ring schedule: each of the ``parts - 1`` steps ships ``nbytes/parts``
    over one link and pays one fixed hop latency.  ``all_reduce`` is
    reduce-scatter followed by all-gather (2x).  One device is free.
    """
    if parts <= 1:
        return 0.0
    steps = parts - 1
    per_step = (nbytes / parts) / arch.link_bytes_per_cycle + arch.link_hop_cycles
    if op == "all_reduce":
        return 2.0 * steps * per_step
    if op in ("all_gather", "reduce_scatter"):
        return steps * per_step
    raise ValueError(f"unknown collective op {op!r}")


# ---------------------------------------------------------------------------
# Runtime rendezvous.
# ---------------------------------------------------------------------------


class CollectiveError(RuntimeError):
    """A peer shard failed while this shard was parked in a collective."""


class CollectiveSession:
    """One ``ShardedModule`` call's rendezvous state.

    ``exchange(group, rank, parts, value, combine)`` blocks until every
    participant of ``group`` has arrived (each call site uses a distinct
    group id, and every ``ShardedModule.run`` opens a fresh session, so
    the same static op rendezvouses freshly on every plan execution), then returns
    ``combine([v_0, ..., v_{parts-1}])`` — computed once, by the last
    arrival, so the reduction order is deterministic (rank order) and every
    shard observes the identical tensor.

    ``abort(exc)`` unwinds every parked and future participant with a
    :class:`CollectiveError` naming the originating failure — a crashed
    shard can never deadlock its peers.
    """

    def __init__(self):
        self._cond = threading.Condition()
        self._pending: dict[str, dict] = {}
        self._failure: BaseException | None = None

    def abort(self, exc: BaseException) -> None:
        with self._cond:
            if self._failure is None:
                self._failure = exc
            self._cond.notify_all()

    def exchange(
        self,
        group: str,
        rank: int,
        parts: int,
        value: torch.Tensor,
        combine: Callable[[list[torch.Tensor]], torch.Tensor],
    ) -> torch.Tensor:
        if parts <= 1:
            return combine([value])
        with self._cond:
            if self._failure is not None:
                raise CollectiveError(
                    f"peer shard failed before collective {group!r}"
                ) from self._failure
            st = self._pending.get(group)
            if st is None:
                st = self._pending[group] = {
                    "vals": [None] * parts,
                    "n": 0,
                    "out": None,
                }
            if st["vals"][rank] is not None:
                raise CollectiveError(
                    f"duplicate rank {rank} in collective {group!r}"
                )
            st["vals"][rank] = value
            st["n"] += 1
            if st["n"] == parts:
                # last arrival combines (deterministic rank order) and
                # publishes; the group entry is dropped so the id can be
                # reused by the next call through this session
                st["out"] = combine(st["vals"])
                del self._pending[group]
                self._cond.notify_all()
                return st["out"]
            while st["out"] is None and self._failure is None:
                self._cond.wait()
            if st["out"] is None:
                raise CollectiveError(
                    f"peer shard failed during collective {group!r}"
                ) from self._failure
            return st["out"]


# thread-local current session: plan steps are baked closures, so the
# executing session rides on the thread rather than the call signature.
_tls = threading.local()


class session_scope:
    """Bind ``session`` as the current collective session of this thread
    for the duration of a ``with``."""

    def __init__(self, session: CollectiveSession):
        self._session = session

    def __enter__(self):
        self._prev = getattr(_tls, "session", None)
        _tls.session = self._session
        return self._session

    def __exit__(self, *exc):
        _tls.session = self._prev
        return False


def current_session() -> CollectiveSession | None:
    return getattr(_tls, "session", None)


def _combine_for(op: str, axis: int, dtype: str):
    """The combine of one collective, on the contributions' device."""
    out_dtype = torch_dtype(dtype)
    if op == "all_gather":
        return lambda vals: torch.cat(vals, dim=axis)
    if op in ("all_reduce", "reduce_scatter"):
        # integer payloads accumulate wide then cast back — matches the
        # accelerator's int64 accumulation semantics bit-for-bit; float
        # payloads sum in rank order (deterministic).
        if dtype.startswith(("int", "uint")):
            def _sum_int(vals):
                acc = vals[0].to(torch.int64)
                for v in vals[1:]:
                    acc = acc + v.to(torch.int64)
                return acc.to(out_dtype)

            return _sum_int

        def _sum(vals):
            acc = vals[0]
            for v in vals[1:]:
                acc = acc + v
            return acc.to(out_dtype)

        return _sum
    raise ValueError(f"unknown collective op {op!r}")


def collective_fn(
    op: str, group: str, rank: int, parts: int, axis: int, dtype: str
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Build the plan-step closure of one collective node.  With ``parts
    == 1`` the single-participant semantics apply (gather/reduce of one
    contribution is the identity), so a ``devices=1`` plan never needs a
    session."""
    combine = _combine_for(op, axis, dtype)

    def post(full: torch.Tensor) -> torch.Tensor:
        # reduce_scatter: everyone receives the full reduction from the
        # rendezvous, then keeps only its own slice
        if op != "reduce_scatter":
            return full
        size = full.shape[axis] // parts
        return full.narrow(axis, rank * size, size)

    if parts <= 1:
        return lambda x: combine([x])

    def run(x: torch.Tensor) -> torch.Tensor:
        session = current_session()
        if session is None:
            raise CollectiveError(
                f"collective {group!r} executed outside a ShardedModule "
                f"session (plan compiled for {parts} shards)"
            )
        return post(session.exchange(group, rank, parts, x, combine))

    return run
