"""Reduction of a ``torch.profiler`` trace to intervals and sums.

The benchmark traces the card with ``torch.profiler`` with CUDA activity
alone: recording every CPU-side op as well doubles the host's time per
op, and the decode step is host-bound.  The harness's own spans (engine
call, prefill, decode step) are taken on the host's ``time.time_ns()``,
the clock the profiler puts the kernels on.  ``device_events`` turns
the trace into plain intervals, so the arithmetic below runs on
synthetic events in the CPU tests; nothing of the full trace is kept.
"""

from __future__ import annotations

import bisect
import re
from dataclasses import dataclass

#: the harness's host spans, innermost first when they nest
SPANS = ("prefill", "decode_step", "engine")
#: the device work that is not in any engine call
OUTSIDE = "harness"


@dataclass(frozen=True)
class Interval:
    name: str
    start_ns: int
    end_ns: int

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


def device_events(prof) -> list[Interval]:
    """The device operations of a finished profile: every CUDA-side event
    that is not a user annotation (kernels, copies, fills)."""
    out = []
    for ev in prof.profiler.kineto_results.events():
        if not str(ev.device_type()).endswith("CUDA"):
            continue
        if hasattr(ev, "is_user_annotation") and ev.is_user_annotation():
            continue
        start = ev.start_ns()
        out.append(Interval(ev.name(), start, start + ev.duration_ns()))
    return out


def union_s(intervals: list[Interval], lo: int, hi: int) -> float:
    """Seconds of [lo, hi) covered by at least one interval."""
    total, cur_lo, cur_hi = 0, None, None
    for iv in sorted(intervals, key=lambda i: i.start_ns):
        s, e = max(iv.start_ns, lo), min(iv.end_ns, hi)
        if e <= s:
            continue
        if cur_hi is None or s > cur_hi:
            if cur_hi is not None:
                total += cur_hi - cur_lo
            cur_lo, cur_hi = s, e
        else:
            cur_hi = max(cur_hi, e)
    if cur_hi is not None:
        total += cur_hi - cur_lo
    return total / 1e9


def gaps(intervals: list[Interval], lo: int, hi: int) -> list[tuple[int, int]]:
    """The stretches of [lo, hi) in which no interval runs."""
    out, t = [], lo
    for iv in sorted(intervals, key=lambda i: i.start_ns):
        if iv.start_ns > t:
            out.append((t, min(iv.start_ns, hi)))
        t = max(t, iv.end_ns)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(s, e) for s, e in out if e > s]


def label_at(spans: list[Interval], t: int) -> str:
    """The innermost harness span open at host time ``t``."""
    open_ = {s.name for s in spans if s.start_ns <= t < s.end_ns}
    return next((name for name in SPANS if name in open_), OUTSIDE)


def idle_by_span(device: list[Interval], spans: list[Interval], lo: int, hi: int) -> dict[str, float]:
    """Idle seconds of the device in [lo, hi), each gap split at the span
    boundaries and charged to the span open on the host meanwhile."""
    cuts = sorted({lo, hi, *(t for s in spans for t in (s.start_ns, s.end_ns) if lo < t < hi)})
    labels = [label_at(spans, c) for c in cuts]
    out: dict[str, float] = {}
    for s, e in gaps(device, lo, hi):
        i = bisect.bisect_right(cuts, s) - 1
        a = s
        while a < e:
            b = min(e, cuts[i + 1]) if i + 1 < len(cuts) else e
            out[labels[i]] = out.get(labels[i], 0.0) + (b - a) / 1e9
            a, i = b, i + 1
    return out


def short_name(kernel: str) -> str:
    """A kernel's name without its return type, anonymous namespaces and
    parameter list."""
    name = re.sub(r"^void\s+", "", kernel).replace("(anonymous namespace)::", "")
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            return name[:i]
    return name


def by_name(device: list[Interval], lo: int, hi: int) -> dict[str, float]:
    """Device seconds in [lo, hi) summed by short kernel name."""
    out: dict[str, float] = {}
    for iv in device:
        s, e = max(iv.start_ns, lo), min(iv.end_ns, hi)
        if e > s:
            key = short_name(iv.name)
            out[key] = out.get(key, 0.0) + (e - s) / 1e9
    return out


def top(sums: dict[str, float], n: int = 10) -> list[list]:
    return [[k, v] for k, v in sorted(sums.items(), key=lambda kv: -kv[1])[:n]]
