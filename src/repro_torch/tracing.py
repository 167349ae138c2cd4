"""In-process spans and counters on the LM serving path.

``span(name, **attrs)`` marks a stretch of host time, ``count(name, n)``
adds to a counter, and ``recording()`` turns both on for its block and
yields the ``Recording`` they fill.  A span keeps its name, its start and
end on ``time.time_ns()`` (the clock ``torch.profiler`` puts device
events on, so a span can be laid over a device trace as it is), its own
id, the id of the span open around it on the same thread, the thread's
native id and its attrs.  Spans and counters stay in memory; the caller
reads the ``Recording`` in the same process.

Off is the default.  Then ``span`` reads one module global and returns a
shared context manager that does nothing: no clock read, no allocation.
A caller whose count costs arithmetic asks ``active()`` first and
computes it only when a recording is on.  Nothing here touches the
device, on or off: no synchronise, no readback, no CUDA event.

The port's own module, with no counterpart in the reference.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import NamedTuple


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: int | None  # the span open around it on its thread, if any
    thread: int  # threading.get_native_id() of the thread that ran it
    attrs: dict


@dataclass
class Recording:
    """What ``span`` and ``count`` recorded while this recording was on."""

    spans: list[Span] = field(default_factory=list)
    counters: dict[str, int] = field(default_factory=dict)
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n


#: the recording that is on, or None
_ACTIVE: Recording | None = None
_ids = itertools.count()
_local = threading.local()


def _thread() -> tuple[list[int], int]:
    """This thread's stack of open span ids and its native id."""
    state = getattr(_local, "state", None)
    if state is None:
        state = _local.state = ([], threading.get_native_id())
    return state


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Open:
    __slots__ = ("rec", "name", "attrs", "id", "parent", "start", "stack", "thread")

    def __init__(self, rec: Recording, name: str, attrs: dict):
        self.rec, self.name, self.attrs = rec, name, attrs

    def __enter__(self):
        stack, self.thread = _thread()
        self.stack = stack
        self.parent = stack[-1] if stack else None
        self.id = next(_ids)
        stack.append(self.id)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        self.stack.pop()
        self.rec.spans.append(Span(self.name, self.start, end, self.id, self.parent, self.thread, self.attrs))
        return False


def span(name: str, **attrs):
    """A context manager that records ``name`` over its block while a
    recording is on, and does nothing otherwise."""
    rec = _ACTIVE
    if rec is None:
        return _OFF
    return _Open(rec, name, attrs)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` while a recording is on."""
    rec = _ACTIVE
    if rec is not None:
        rec.count(name, n)


def active() -> Recording | None:
    """The recording that is on, or None."""
    return _ACTIVE


@contextlib.contextmanager
def recording():
    """Record spans and counters for the block; yields the ``Recording``.
    The recording that was on before, if any, is on again after."""
    global _ACTIVE
    rec, prev = Recording(), _ACTIVE
    _ACTIVE = rec
    try:
        yield rec
    finally:
        _ACTIVE = prev
