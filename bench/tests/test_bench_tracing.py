"""The program's spans laid over the device trace (``spans.py``): launch
times from the trace's correlation ids, device time and idle gaps
charged to the span open at launch, and the readings of the program's
spans and counters, on synthetic events and observations; a traced run
at the smoke size on the CPU; on a card (``-m cuda``) the same run,
where the two clocks have to agree."""

from collections import namedtuple

import pytest
import torch

import devtrace
import harness
import spans
from devtrace import Interval
from helpers import smoke_cell

MS = 1_000_000
#: a program span as ``repro_torch.tracing.Span`` has it (the fields read here)
P = namedtuple("P", "name start_ns end_ns id parent")


class Event:
    def __init__(self, name, device, start, dur=0, corr=0, annotation=False):
        self._v = (name, device, start, dur, corr, annotation)

    def name(self):
        return self._v[0]

    def device_type(self):
        return f"DeviceType.{self._v[1]}"

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def is_user_annotation(self):
        return self._v[5]


class Prof:
    def __init__(self, events):
        results = type("Results", (), {"events": lambda self: list(events)})()
        self.profiler = type("Profiler", (), {"kineto_results": results})()


def test_launch_times_follow_the_correlation_ids():
    prof = Prof([
        Event("Activity Buffer Request", "CPU", 90, 5, corr=5),  # shares the id, is no launch
        Event("cudaLaunchKernel", "CPU", 100, 8, corr=5),
        Event("void gemm_kernel<1>(int)", "CUDA", 200, 50, corr=5),
        Event("cuLaunchKernelEx", "CPU", 260, 4, corr=6),
        Event("nvjet_tst_256x8", "CUDA", 270, 30, corr=6),
        Event("cudaMemcpyAsync", "CPU", 300, 4, corr=7),
        Event("Memcpy DtoH (Device -> Pageable)", "CUDA", 310, 10, corr=7),
        Event("a user annotation", "CUDA", 320, 10, corr=7, annotation=True),
        Event("void fill_kernel(int)", "CUDA", 400, 10, corr=9),  # no launch recorded
    ])
    device = devtrace.device_events(prof)
    assert [iv.name[:8] for iv in device] == ["void gem", "nvjet_ts", "Memcpy D", "void fil"]
    assert spans.launch_times(prof) == [100, 260, 300, None]


def test_timeline_is_the_innermost_open_span():
    line = spans.timeline([P("a", 0, 10, 0, None), P("b", 2, 5, 1, 0), P("c", 5, 7, 2, 0), P("d", 12, 14, 3, None)])
    got = [spans.open_at(line, t) for t in (-1, 0, 1, 2, 4, 5, 6, 7, 9, 10, 11, 12, 13, 14)]
    assert got == [None, "a", "a", "b", "b", "c", "c", "a", "a", None, None, "d", "d", None]


def program_obs():
    """Two engine calls traced: the first a prefill [0, 9) ms with one
    attention layer and one Mamba scan, the second two decode steps."""
    harness_spans = [Interval("engine", 0, 10 * MS), Interval("prefill", 0, 9 * MS),
             Interval("engine", 11 * MS, 20 * MS), Interval("decode_step", 12 * MS, 16 * MS),
             Interval("decode_step", 16 * MS, 20 * MS)]
    program = [
        P("engine.wave", 0, 10 * MS, 0, None), P("lm.prefill", 0, 9 * MS, 1, 0),
        P("layer.attn", 1 * MS, 5 * MS, 2, 1), P("attn.core", 2 * MS, 4 * MS, 3, 2),
        P("layer.mamba", 5 * MS, 8 * MS, 4, 1), P("mamba.scan", 5 * MS, 7 * MS, 5, 4),
        P("engine.wave", 11 * MS, 20 * MS, 6, None), P("engine.readback", 11 * MS, 12 * MS, 7, 6),
        P("lm.decode_step", 12 * MS, 16 * MS, 8, 6), P("layer.attn", 13 * MS, 15 * MS, 9, 8),
        P("attn.core", 13 * MS, 14 * MS, 10, 9), P("lm.decode_step", 16 * MS, 20 * MS, 11, 6),
        P("attn.core", 17 * MS, 18 * MS, 12, 11),
    ]
    # (launched at, runs over) in ms
    ops = [(0.5, (0.6, 1.0)), (2.5, (2.6, 3.6)), (3.0, (3.6, 4.4)), (5.5, (5.6, 6.6)), (6.0, (6.6, 8.0)),
           (13.5, (13.6, 14.0)), (14.5, (14.6, 15.0)), (17.5, (17.6, 18.0)), (None, (18.5, 19.0))]
    device = [Interval(f"k{i}", int(a * MS), int(b * MS)) for i, (_, (a, b)) in enumerate(ops)]
    launches = [None if t is None else int(t * MS) for t, _ in ops]
    return {"device": device, "launches": launches, "spans": harness_spans, "program": program, "window_ns": (0, 20 * MS),
            "counters": {"gemm.routed_flops": 3 * 10**9, "gemm.unrouted_flops": 10**9}}


def test_device_time_is_charged_to_the_span_open_at_launch():
    obs = program_obs()
    lo, hi = obs["window_ns"]
    got = spans.device_by_span(obs["device"], obs["launches"], obs["spans"], obs["program"], lo, hi)
    assert got == pytest.approx({
        "prefill/lm.prefill": 0.0004, "prefill/attn.core": 0.0018, "prefill/mamba.scan": 0.0024,
        "decode_step/attn.core": 0.0008, "decode_step/layer.attn": 0.0004, spans.UNLAUNCHED: 0.0005})
    assert sum(got.values()) == pytest.approx(sum(iv.seconds for iv in obs["device"]))
    # without program spans the harness's own names remain
    plain = spans.device_by_span(obs["device"], obs["launches"], obs["spans"], [], lo, hi)
    assert set(plain) == {"prefill", "decode_step", spans.UNLAUNCHED}


def test_idle_gaps_name_program_spans_and_keep_the_harness_sums():
    obs = program_obs()
    lo, hi = obs["window_ns"]
    plain = devtrace.idle_by_span(obs["device"], obs["spans"], lo, hi)
    fine = spans.idle_by_span(obs["device"], obs["spans"], obs["program"], lo, hi)
    by_prefix: dict = {}
    for label, s in fine.items():
        by_prefix[label.split("/")[0]] = by_prefix.get(label.split("/")[0], 0.0) + s
    assert by_prefix == pytest.approx(plain)
    assert fine == pytest.approx({
        "prefill/lm.prefill": 0.0016, "prefill/layer.attn": 0.0016, "prefill/attn.core": 0.0006,
        "prefill/mamba.scan": 0.0006, "engine/engine.wave": 0.001, "harness": 0.001,
        "engine/engine.readback": 0.001, "decode_step/lm.decode_step": 0.0045,
        "decode_step/attn.core": 0.0012, "decode_step/layer.attn": 0.0006})


def test_readings_of_the_program_spans_and_counters():
    obs = program_obs()
    got = spans.readings(obs)
    # attn.core under lm.prefill: k1 and k2 (1.0 + 0.8 ms), one prefill call
    assert got["attn_prefill_ms"] == pytest.approx(1.8)
    assert got["scan_prefill_ms"] == pytest.approx(2.4)
    # decode steps [12, 16) and [16, 20): busy 0.4 + 0.4 and 0.4 (+ the unlaunched 0.5)
    assert got["decode_idle_ms"] == pytest.approx((4 - 0.8 + 4 - 0.9) / 2)
    assert got["decode_ops_per_step"] == pytest.approx(1.5)
    assert got["routed_flop_share"] == pytest.approx(75.0)
    # no recording, or a trace without a device: nothing to read
    assert set(spans.readings({**obs, "program": [], "counters": {}}).values()) == {None}
    assert set(spans.readings({**obs, "device": [], "launches": []}).values()) == {None, 75.0}
    no_mamba = {**obs, "program": [s for s in obs["program"] if not s.name.startswith(("mamba", "layer.mamba"))]}
    assert spans.readings(no_mamba)["scan_prefill_ms"] is None


def check_shared_clock(obs):
    """Each operation launched inside a program span starts, on the device
    clock as ``spans.align`` puts it onto the host's, after that span
    started on the host; returns how many were checked."""
    lo, hi = obs["window_ns"]
    line = spans.timeline(obs["program"])
    by_name: dict = {}
    for s in obs["program"]:
        by_name.setdefault(s.name, []).append(s)
    checked, early = 0, []
    for iv, t in zip(obs["device"], obs["launches"], strict=True):
        if t is None or not lo <= t < hi:
            continue
        name = spans.open_at(line, t)
        if name is None:
            continue
        span = max((s for s in by_name[name] if s.start_ns <= t < s.end_ns), key=lambda s: s.start_ns)
        if iv.start_ns < span.start_ns:
            early.append((iv.name[:60], name, iv.start_ns - span.start_ns, iv.start_ns - t))
        checked += 1
    shift = obs["clock_shift_ns"]
    assert not early, f"{len(early)} of {checked} (clock moved {min(shift)}..{max(shift)} ns): {early[:10]}"
    return checked


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["codeqwen-completion", "jamba-summarize"])
def test_program_spans_share_the_device_traces_clock(name):
    """A traced run at the smoke size on the card: the shared clock holds
    (``check_shared_clock``), and almost all the window's device time
    has a launch time."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    cell = smoke_cell(name, "bfloat16")
    obs = spans.traced(cell, 2**31 + 19, torch.device("cuda"))
    assert obs["program"] and obs["counters"]["engine.decode_steps"] == 2 * cell.traffic.new_tokens
    assert check_shared_clock(obs) > 100
    lo, hi = obs["window_ns"]
    charged = spans.device_by_span(obs["device"], obs["launches"], obs["spans"], obs["program"], lo, hi)
    assert charged.get(spans.UNLAUNCHED, 0.0) <= 0.01 * sum(charged.values())


@pytest.mark.parametrize("rate_ppm", [0, -10_000, 2_000])
def test_align_puts_a_drifting_device_clock_onto_the_launches(rate_ppm):
    """Operations launched every 100 us, each starting 5 us after its
    launch on an idle device and 2 ms after it behind a queue (every
    third), one with no launch event; the device clock read off by an
    offset and a rate.  Aligned, every operation is where it ran, less
    the 5 us floor of the lags, to within the drift's second order
    (rate x rate x 2 ms = 200 ns at 1 %)."""
    us = 1_000
    t0 = 10**12
    launches = [t0 + 100 * us * i for i in range(300)]
    true = [Interval(f"k{i}", t + (2_000 if i % 3 == 2 else 5) * us, t + (2_000 if i % 3 == 2 else 5) * us + 40 * us)
            for i, t in enumerate(launches)]

    def read(t):  # the device clock
        return t - 300 * us + (t - t0) * rate_ppm // 10**6

    device = [Interval(iv.name, read(iv.start_ns), read(iv.start_ns) + 40 * us) for iv in true]
    launches[150] = None
    got = spans.align(device, launches)
    for a, want in zip(got, true, strict=True):
        assert abs(a.start_ns - (want.start_ns - 5 * us)) <= 500 and a.end_ns - a.start_ns == 40 * us
    assert all(a.start_ns >= t - 500 for a, t in zip(got, launches) if t is not None)
    assert spans.align([], []) == [] and spans.align(device[:1], [None]) == device[:1]


@pytest.mark.parametrize("name", ["codeqwen-completion", "jamba-summarize"])
def test_a_traced_run_records_the_profiled_waves_only(name):
    """On the CPU (no device operations): the recorder is on in the
    profiled waves of a traced run that ``on`` names and off in the
    rest, and the harness's span is its own again after the run."""
    cell = smoke_cell(name, "float32")
    cpu = torch.device("cpu")
    obs = spans.traced(cell, 2**31 + 23, cpu)
    assert obs["counters"]["engine.decode_steps"] == 2 * cell.traffic.new_tokens
    assert sum(s.name == "engine.wave" for s in obs["program"]) == 2
    assert obs["device"] == [] and len(obs["wave_s"]) == len(obs["waves_ns"]) == 2
    assert obs["updates"]["engine.decode_steps"] == 2 * cell.traffic.new_tokens
    assert harness.Probes.span.__qualname__ == "Probes.span"
    got = spans.report(obs)
    assert got["spans"] == len(obs["program"]) and got["launched_share"] is None
    assert got["readings"]["routed_flop_share"] > 0
    one = spans.traced(cell, 2**31 + 23, cpu, (False, True))
    (lo, hi) = one["waves_ns"][1]
    assert one["counters"]["engine.decode_steps"] == cell.traffic.new_tokens
    assert all(lo <= s.start_ns <= s.end_ns <= hi for s in one["program"])
    off = spans.traced(cell, 2**31 + 23, cpu, (False, False))
    assert off["program"] == [] and off["counters"] == {}


def test_measure_pairs_each_wave_on_with_its_twin_off():
    cell = smoke_cell("jamba-summarize", "float32")
    got = spans.measure(cell, 2**31 + 29, 1, "cpu")
    cost = got["cost"]
    assert len(cost["pair_share"]) == len(cost["wave_s"]["on"]) == len(cost["wave_s"]["off"]) == 2
    assert cost["spans_per_wave"] == got["spans"] / 2 > 0 and cost["estimated_share"] > 0
    assert set(cost["unit_ns"]) == {"span", "count"} and got["device"] == "cpu"
