"""The program's own spans and counters (``repro_torch.tracing``) laid
over a traced run of one cell.

    python3 bench/spans.py --workload <cell> --seed <n> [--rounds 1]

Run from the root of a checkout on a card.  It runs the cell as
``run.py --trace 1`` does (``harness.run``: set-up, two timed waves,
then two waves under ``torch.profiler``), with the program's recorder
on in those two waves, and prints one JSON line: device time and idle
gaps charged to the program span open on the host (``breakdown``), the
counters of the profiled waves, and ``readings``.  With ``--rounds n``
it makes n rounds of two such runs more, each with the recorder on in
one profiled wave and off in the other (the two pad to the same
length in every cell), and adds the recorder's cost: the profiled waves' seconds and
device idle shares each way, each pair's on less off, and the same cost
bounded by arithmetic (spans and counter updates of a profiled wave,
each times the host ns it adds, on less off in a tight loop).

Under CUDA activity the trace holds the host side of each launch
(``cudaLaunchKernel``, ``cuLaunchKernelEx``, ``cudaMemcpyAsync`` ...),
which shares its device operation's correlation id: ``launch_times``
gives each device operation the host time it was launched at, so its
device time can be charged to the program span open then
(``device_by_span``).  The launch events agree with the host's clock;
the device timestamps need not.  On an H100 the device clock has been
seen to drift from the host's by 1 % of the time elapsed in a trace, so
that operations started up to 2.7 ms before their own launch event
(0.25 s traces at the smoke size, about one in three).  ``align`` maps
the device operations onto the host clock by the launches before
anything lays them over host spans.
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import json
import statistics
import sys
import threading
import time
from collections import Counter

import devtrace
import run as bench_run
from devtrace import Interval

#: ``device_by_span``'s key for device operations with no launch event
UNLAUNCHED = "no_launch"
#: the steepest edge of ``align``'s envelope taken for the clock's drift
#: (the drift seen is 1 %); a steeper one at an end is a queue
MAX_DRIFT = 0.05


def _is_device_op(ev) -> bool:
    """What ``devtrace.device_events`` keeps: a device event that is not a
    user annotation."""
    if not str(ev.device_type()).endswith("CUDA"):
        return False
    return not (hasattr(ev, "is_user_annotation") and ev.is_user_annotation())


def launch_times(prof) -> list[int | None]:
    """The host time (ns) at which each of ``devtrace.device_events(prof)``'s
    operations was launched, in the same order: the start of the earliest
    host-side CUDA API call (a name starting ``cu``: ``cudaLaunchKernel``,
    ``cuLaunchKernelEx`` ...) that shares the operation's correlation id, or
    None where there is none."""
    events = list(prof.profiler.kineto_results.events())
    launched: dict[int, int] = {}
    for ev in events:
        if not str(ev.device_type()).endswith("CUDA") and ev.name().startswith("cu"):
            c, t = ev.correlation_id(), ev.start_ns()
            if c and (c not in launched or t < launched[c]):
                launched[c] = t
    return [launched.get(ev.correlation_id()) for ev in events if _is_device_op(ev)]


def align(device: list[Interval], launches: list) -> list[Interval]:
    """``device`` on the host clock.  The launch-to-start lags of the
    operations with a launch time, against their launch time, have a
    lower envelope (their lower convex hull): the device clock's offset
    from the host's plus the latency of a launch onto an idle device.
    Each operation's times less the envelope at its own start (read back
    onto the host clock through the envelope once) is where it ran, less
    that latency: no operation then starts before its launch, to within
    the drift's second order (the drift rate squared times a queue's
    wait: 200 ns at 1 % and 2 ms).  A device clock that runs at another
    rate than the host's is corrected as far as the device went idle
    often enough to draw the envelope."""
    points = sorted((t, iv.start_ns - t) for iv, t in zip(device, launches, strict=True) if t is not None)
    hull: list[tuple[int, int]] = []
    for p in points:
        while len(hull) >= 2 and _turn(hull[-2], hull[-1], p) <= 0:
            hull.pop()
        if hull and hull[-1][0] == p[0]:
            continue  # the same launch time: the lower lag came first
        hull.append(p)
    # the hull's ends are the first and last launch, onto an idle device or not
    while len(hull) > 1 and _steep(hull[-2], hull[-1]):
        hull.pop()
    while len(hull) > 1 and _steep(hull[0], hull[1]):
        hull.pop(0)
    if not hull:
        return list(device)
    times = [t for t, _ in hull]

    def lag(t: int) -> int:
        if len(hull) == 1:
            return hull[0][1]
        i = min(max(bisect.bisect_right(times, t), 1), len(hull) - 1)  # beyond the ends: the end edges
        (t0, l0), (t1, l1) = hull[i - 1], hull[i]
        return l0 + (l1 - l0) * (t - t0) // (t1 - t0)

    out = []
    for iv in device:
        d = lag(iv.start_ns - lag(iv.start_ns))
        out.append(Interval(iv.name, iv.start_ns - d, iv.end_ns - d))
    return out


def _steep(a, b) -> bool:
    return abs(b[1] - a[1]) > MAX_DRIFT * abs(b[0] - a[0])


def _turn(a, b, c) -> int:
    """Positive where a -> b -> c turns counter-clockwise."""
    return (b[0] - a[0]) * (c[1] - a[1]) - (b[1] - a[1]) * (c[0] - a[0])


def timeline(spans) -> tuple[list[int], list]:
    """The innermost of properly nested ``spans`` (anything with ``name``,
    ``start_ns``, ``end_ns``) as a step function: from ``cuts[i]`` until
    ``cuts[i + 1]`` the innermost open span is ``labels[i]`` (None where
    none is open)."""
    cuts: list[int] = []
    labels: list = []

    def at(t, label):
        if cuts and cuts[-1] == t:
            labels[-1] = label
        else:
            cuts.append(t)
            labels.append(label)

    def close():
        end = stack.pop().end_ns
        at(end, stack[-1].name if stack else None)

    stack: list = []
    for s in sorted(spans, key=lambda s: (s.start_ns, -s.end_ns)):
        while stack and stack[-1].end_ns <= s.start_ns:
            close()
        stack.append(s)
        at(s.start_ns, s.name)
    while stack:
        close()
    return cuts, labels


def harness_timeline(spans: list[Interval]) -> tuple[list[int], list]:
    """``devtrace.label_at`` of the harness's spans as a step function
    (see ``timeline``)."""
    cuts = sorted({t for s in spans for t in (s.start_ns, s.end_ns)})
    return cuts, [devtrace.label_at(spans, c) for c in cuts]


def open_at(line: tuple[list[int], list], t: int):
    """The label of a ``timeline`` at ``t``, or None before its first cut."""
    cuts, labels = line
    i = bisect.bisect_right(cuts, t) - 1
    return labels[i] if i >= 0 else None


def span_label(harness: tuple[list[int], list], program: tuple[list[int], list], t: int) -> str:
    """``<harness span>/<innermost program span>`` open at host time ``t``;
    the harness span's name alone (``devtrace.OUTSIDE`` outside every
    harness span) where no program span is open."""
    h = open_at(harness, t) or devtrace.OUTSIDE
    p = open_at(program, t)
    return f"{h}/{p}" if p else h


def idle_by_span(device: list[Interval], spans: list[Interval], program, lo: int, hi: int) -> dict[str, float]:
    """``devtrace.idle_by_span`` with each label refined to
    ``<harness span>/<innermost program span>`` (``program``: the
    program's spans on the engine's thread); the sums by harness prefix
    are ``devtrace.idle_by_span``'s."""
    harness, line = harness_timeline(spans), timeline(program)
    cuts = sorted({lo, hi, *(t for t in (*harness[0], *line[0]) if lo < t < hi)})
    labels = [span_label(harness, line, c) for c in cuts]
    out: dict[str, float] = {}
    for s, e in devtrace.gaps(device, lo, hi):
        i = bisect.bisect_right(cuts, s) - 1
        a = s
        while a < e:
            b = min(e, cuts[i + 1]) if i + 1 < len(cuts) else e
            out[labels[i]] = out.get(labels[i], 0.0) + (b - a) / 1e9
            a, i = b, i + 1
    return out


def device_by_span(device: list[Interval], launches: list, spans: list[Interval], program, lo: int,
                   hi: int) -> dict[str, float]:
    """Device seconds in [lo, hi) summed by the span open on the host when
    each operation was launched (``launches``, parallel to ``device``):
    ``<harness span>/<innermost program span>`` as ``idle_by_span`` labels
    its gaps, ``UNLAUNCHED`` for an operation with no launch time."""
    harness, line = harness_timeline(spans), timeline(program)
    out: dict[str, float] = {}
    for iv, t in zip(device, launches, strict=True):
        s, e = max(iv.start_ns, lo), min(iv.end_ns, hi)
        if e > s:
            key = UNLAUNCHED if t is None else span_label(harness, line, t)
            out[key] = out.get(key, 0.0) + (e - s) / 1e9
    return out


def named_under(program, name: str, ancestor: str) -> list:
    """The spans called ``name`` with a span called ``ancestor`` among
    their parents (by ``id`` / ``parent``), sorted by start."""
    by_id = {s.id: s for s in program}

    def under(s):
        while s.parent is not None and s.parent in by_id:
            s = by_id[s.parent]
            if s.name == ancestor:
                return True
        return False

    return sorted((s for s in program if s.name == name and under(s)), key=lambda s: s.start_ns)


def launched_in(device: list[Interval], launches: list, spans: list) -> tuple[int, float]:
    """(operations, device seconds) of the device operations launched
    inside any of ``spans`` (disjoint, sorted by start)."""
    starts = [s.start_ns for s in spans]
    n, total = 0, 0
    for iv, t in zip(device, launches, strict=True):
        if t is None:
            continue
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t < spans[i].end_ns:
            n += 1
            total += iv.end_ns - iv.start_ns
    return n, total / 1e9


def idle_in(device: list[Interval], spans: list) -> float:
    """Seconds inside ``spans`` (disjoint, sorted by start) in which no
    device operation runs."""
    if not spans:
        return 0.0
    starts = [s.start_ns for s in spans]
    total = 0
    for a, b in devtrace.gaps(device, spans[0].start_ns, max(s.end_ns for s in spans)):
        i = max(bisect.bisect_right(starts, a) - 1, 0)
        while i < len(spans) and spans[i].start_ns < b:
            total += max(0, min(b, spans[i].end_ns) - max(a, spans[i].start_ns))
            i += 1
    return total / 1e9


def launched_ms_per_call(obs: dict, name: str, call: str) -> float | None:
    """Device ms of the operations launched inside the program's ``name``
    spans under a ``call`` span, per ``call`` span; None where there are
    none."""
    program = obs["program"]
    calls = sum(s.name == call for s in program)
    spans = named_under(program, name, call)
    if not calls or not spans or not obs["device"]:
        return None
    return 1e3 * launched_in(obs["device"], obs["launches"], spans)[1] / calls


def readings(obs: dict) -> dict:
    """What the program's spans and counters say of the profiled waves;
    a reading with nothing to read is None.

    - ``attn_prefill_ms``, ``scan_prefill_ms``: device ms launched inside
      ``attn.core`` / ``mamba.scan`` under ``lm.prefill``, per prefill;
    - ``decode_idle_ms``: device idle ms inside ``lm.decode_step``, per step;
    - ``decode_ops_per_step``: device operations launched inside
      ``lm.decode_step``, per step;
    - ``routed_flop_share``: % of the weight products' operations counted
      under ``gemm.routed_flops`` against ``gemm.unrouted_flops``."""
    steps = sorted((s for s in obs["program"] if s.name == "lm.decode_step"), key=lambda s: s.start_ns)
    device = obs["device"]
    c = obs["counters"]
    routed, unrouted = c.get("gemm.routed_flops", 0), c.get("gemm.unrouted_flops", 0)
    return {
        "attn_prefill_ms": launched_ms_per_call(obs, "attn.core", "lm.prefill"),
        "scan_prefill_ms": launched_ms_per_call(obs, "mamba.scan", "lm.prefill"),
        "decode_idle_ms": 1e3 * idle_in(device, steps) / len(steps) if steps and device else None,
        "decode_ops_per_step": (launched_in(device, obs["launches"], steps)[0] / len(steps)
                                if steps and device else None),
        "routed_flop_share": 100.0 * routed / (routed + unrouted) if routed + unrouted else None,
    }


@contextlib.contextmanager
def recording_in(on: tuple[bool, ...]):
    """While the block runs, the program's recorder is on inside the
    harness's ``engine`` span of the i-th profiled wave (the waves whose
    spans the harness keeps) where ``on[i]``.  Yields a list that gains,
    for each profiled wave, (its ``Recording`` or None, a ``Counter`` of
    the counter updates by name; the wrapper that counts them runs in the
    recording's time, about 0.1 us an update)."""
    import harness
    from repro_torch import tracing

    made: list = []
    base = harness.Probes.span

    @contextlib.contextmanager
    def span(self, name):
        if name != "engine" or self.spans is None:
            with base(self, name):
                yield
            return
        updates: Counter = Counter()
        with base(self, name), tracing.recording() if on[len(made)] else contextlib.nullcontext() as rec:
            if rec is not None:
                update = rec.count

                def counted(name, n=1):
                    updates[name] += 1
                    update(name, n)

                rec.count = counted
            made.append((rec, updates))
            yield

    harness.Probes.span = span
    try:
        yield made
    finally:
        harness.Probes.span = base


def traced(cell, seed: int, device, on: tuple[bool, ...] = (True, True), log=sys.stderr) -> dict:
    """One run of ``cell`` as ``run.py --trace 1`` makes it, with the
    program's recorder on in its profiled waves where ``on`` says;
    returns what the profiled waves show: the device operations on the
    host clock with their launch times, the harness's and the program's
    spans (of the engine's thread), the counters and their updates, and
    each profiled wave's seconds and host window."""
    import harness

    with recording_in(on) as made:
        out = harness.run(cell, seed, 0.0, True, device, time.perf_counter(), log)
    prof, spans = out["trace"]["profiler"], out["trace"]["spans"]
    raw, launches = devtrace.device_events(prof), launch_times(prof)
    aligned = align(raw, launches)
    engine = sorted((s for s in spans if s.name == "engine"), key=lambda s: s.start_ns)
    recs = [rec for rec, _ in made if rec is not None]
    counters: Counter = Counter()
    updates: Counter = Counter()
    for rec, u in made:
        counters.update(rec.counters if rec else {})
        updates.update(u)
    return {
        "device": aligned, "launches": launches, "spans": spans,
        "window_ns": (engine[0].start_ns, engine[-1].end_ns),
        "waves_ns": [(s.start_ns, s.end_ns) for s in engine],
        "program": [s for rec in recs for s in rec.spans if s.thread == threading.get_native_id()],
        "counters": dict(counters), "updates": dict(updates),
        "clock_shift_ns": [a.start_ns - r.start_ns for a, r in zip(aligned, raw)] or [0],
        "wave_s": [w.end - w.start for w in out["waves"] if w.index in harness.PROFILED_WAVES],
    }


def idle_share(device: list[Interval], lo: int, hi: int) -> float:
    """% of [lo, hi) in which the device runs nothing."""
    return 100.0 * (1.0 - devtrace.union_s(device, lo, hi) / ((hi - lo) / 1e9))


def report(obs: dict) -> dict:
    """The breakdown by program span, the counters and the readings of one
    ``traced`` run."""
    lo, hi = obs["window_ns"]
    charged = device_by_span(obs["device"], obs["launches"], obs["spans"], obs["program"], lo, hi)
    total = sum(charged.values())
    shift = obs["clock_shift_ns"]
    return {
        "breakdown": {
            "device_by_span": devtrace.top(charged),
            "idle_gaps": devtrace.top(idle_by_span(obs["device"], obs["spans"], obs["program"], lo, hi)),
        },
        "launched_share": 100.0 * (1.0 - charged.get(UNLAUNCHED, 0.0) / total) if total else None,
        "clock_shift_us": [min(shift) / 1e3, max(shift) / 1e3],
        "spans": len(obs["program"]),
        "counters": obs["counters"],
        "readings": readings(obs),
        "idle_share": idle_share(obs["device"], *obs["window_ns"]),
    }


def unit_ns(n: int = 200_000) -> dict:
    """Host ns that recording adds to one span and to one counter update
    (as ``dense`` counts a product's operations): each timed over ``n``
    calls on and off, on less off."""
    import torch

    from repro_torch import tracing
    from repro_torch.models import layers

    x, w = torch.empty(8, 16), torch.empty(16, 32)

    def loop(what):
        t0 = time.perf_counter_ns()
        if what == "span":
            for _ in range(n):
                with tracing.span("layer.attn"):
                    pass
        else:
            for _ in range(n):
                layers._count_flops("gemm.routed_flops", x, w)
        return (time.perf_counter_ns() - t0) / n

    out = {}
    for what in ("span", "count"):
        off = loop(what)
        with tracing.recording():
            on = loop(what)
        out[what] = on - off
    return out


def measure(cell, seed: int, rounds: int, device) -> dict:
    """``report`` of one traced run of ``cell``, then ``rounds`` rounds of
    two runs with the recorder on in one profiled wave and off in the
    other (on, off, then off, on; the two pad to the same length)
    and the recorder's cost: the profiled waves' seconds and idle shares
    each way, each pair's on less off over off, measured, and the cost
    bounded by arithmetic (``unit_ns``)."""
    import torch

    dev = torch.device(device)
    obs = traced(cell, seed, dev)
    out = {"workload": cell.name, "seed": seed,
           "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type, **report(obs)}
    if not rounds:
        return out
    waves: dict[str, list] = {"off": [], "on": []}
    idle: dict[str, list] = {"off": [], "on": []}
    pairs = []
    for _ in range(rounds):
        for on in ((True, False), (False, True)):
            o = traced(cell, seed, dev, on)
            side = {}
            for rec, s, (lo, hi) in zip(on, o["wave_s"], o["waves_ns"], strict=True):
                key = "on" if rec else "off"
                waves[key].append(s)
                idle[key].append(idle_share(o["device"], lo, hi))
                side[key] = s
            pairs.append(100.0 * (side["on"] - side["off"]) / side["off"])
    med = {key: statistics.median(v) for key, v in waves.items()}
    unit = unit_ns()
    per_wave = len(obs["wave_s"])
    estimate_s = (len(obs["program"]) * unit["span"] + sum(obs["updates"].values()) * unit["count"]) / per_wave / 1e9
    out["cost"] = {
        "wave_s": waves, "idle_share": idle, "pair_share": pairs, "median_wave_s": med,
        "median_idle_share": {key: statistics.median(v) for key, v in idle.items()},
        "measured_share": statistics.median(pairs),
        "spans_per_wave": len(obs["program"]) / per_wave,
        "counter_updates_per_wave": {k: v / per_wave for k, v in obs["updates"].items()},
        "unit_ns": unit, "estimated_s": estimate_s, "estimated_share": 100.0 * estimate_s / med["off"],
    }
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rounds", type=int, default=0)
    args = ap.parse_args(argv)
    bench_run.prepare()

    import torch

    import harness

    if not torch.cuda.is_available():
        print("bench: spans.py traces a CUDA card; this machine has none", file=sys.stderr)
        return 2
    bench = json.loads((bench_run.ROOT / "BENCHMARK.json").read_text())
    cell = harness.Cell.load(bench, args.workload)
    print(json.dumps(measure(cell, args.seed, args.rounds, "cuda")))
    return 0


if __name__ == "__main__":
    sys.exit(main())
