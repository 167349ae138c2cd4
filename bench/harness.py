"""One run of one cell: set-up, the measured window, the readings.

The window drives the port's LM serving path as a user would: every
wave is one ``repro_torch.serve.ServingEngine.generate`` call of the
cell's ``batch`` prompts, inside
``repro_torch.kernels.policy.scheduled_kernels(build_backend(
make_gemmini_description()))``, so every product of at least 8 rows runs
on the scheduled GEMM kernel with the schedule CoSA chose for its shape.

Harness-side wrappers sit at four boundaries of the program, replacing
module attributes for the run (``Probes``): ``lm.prefill`` and
``lm.decode_step`` as the engine calls them (their logits kept for the
correctness check; with ``--trace 1`` also their shapes and times),
``moe.route`` (the experts chosen, for the check), and
``ops.scheduled_gemm``, the call into the kernel layer (the shapes of
the products launched in the warm-up wave and in a traced wave).

Set-up warms every shape the window can meet: one wave at the longest
prompt length (the kernels' build, the largest buffers), then CoSA's
schedule of each of that wave's prefill products at every other length
a wave can pad to (``schedule_lengths``), so nothing is built or
scheduled inside the window.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import sys
import time
import warnings
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

import devtrace
from traffic import Traffic

BENCH = Path(__file__).resolve().parent
#: served tokens the correctness check compares, at least (whole waves)
CHECK_TOKENS = 256
#: ``--trace 1``: waves (after the first) timed with a synchronise at
#: both ends of each model call, then waves traced with the profiler
TIMED_WAVES = (1, 2)
PROFILED_WAVES = (3, 4)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _module_name(kind: str, name: str) -> str:
    return f"bench_{kind}_" + "".join(c if c.isalnum() else "_" for c in name)


@dataclass
class Cell:
    """Everything one cell reads, found by its names."""

    name: str
    spec: dict  # the configuration file
    cfg: object  # the port's ModelConfig
    config: object  # configs/<config>.py
    reference: object  # reference/<config>.py
    traffic: Traffic
    limits: dict
    end_to_end: list
    per_layer: list

    @classmethod
    def load(cls, bench: dict, name: str) -> "Cell":
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise SystemExit(f"bench: no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
        w = cells[name]
        conf = next(c for c in bench["configs"] if c["name"] == w["config"])
        root = BENCH.parent
        spec = json.loads((root / conf["file"]).read_text())
        config = load_module(BENCH / "configs" / f"{w['config']}.py", _module_name("config", w["config"]))
        reference = load_module(BENCH / "reference" / f"{w['config']}.py", _module_name("reference", w["config"]))

        def mine(m):
            return name in m.get("workloads", [name])

        return cls(
            name=name,
            spec=spec,
            cfg=config.model_config(spec),
            config=config,
            reference=reference,
            traffic=Traffic.load(BENCH / "workloads" / f"{w['traffic']}.json"),
            limits=json.loads((BENCH / "limits" / f"{name}.json").read_text()),
            end_to_end=[m for m in bench["end_to_end"] if mine(m)],
            per_layer=[m for m in bench["per_layer"] if mine(m)],
        )


@dataclass(eq=False)
class Wave:
    index: int
    prompts: list
    outputs: list
    start: float
    end: float
    logits: list = field(default_factory=list)
    routes: list = field(default_factory=list)  # expert ids of each MoE call, in call order


class Probes:
    """The harness's wrappers at the program's boundaries."""

    def __init__(self, device: torch.device):
        self.device = device
        self.logits: list | None = None  # where the engine's logits go
        self.routes: list | None = None  # where the MoE layers' expert choices go
        self.timed = False  # synchronise and time each model call
        self.spans: list | None = None  # host spans (name, start, end) in time.time_ns()
        self.gemms: list | None = None  # (m, k, n, in, out, bias) of each launch
        self.prefill_shapes: list = []
        self.seconds: dict[str, list] = {"prefill": [], "decode_step": []}

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _model_call(self, name: str, fn):
        def call(*args, **kwargs):
            with self.span(name):
                if self.timed:
                    if name == "prefill":
                        self.prefill_shapes.append(tuple(args[2].shape))
                    self._sync()
                    t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                if self.timed:
                    self._sync()
                    self.seconds[name].append(time.perf_counter() - t0)
            if self.logits is not None:
                self.logits.append(out[0])
            return out

        return call

    @contextlib.contextmanager
    def span(self, name: str):
        if self.spans is None:
            yield
            return
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.spans.append(devtrace.Interval(name, t0, time.time_ns()))

    def _gemm_call(self, fn):
        def call(x, w, cfg, bias=None):
            if self.gemms is not None:
                self.gemms.append((x.shape[0], x.shape[1], w.shape[1], _dt(x.dtype), cfg.out_dtype,
                                   None if bias is None else _dt(bias.dtype)))
            return fn(x, w, cfg, bias)

        return call

    def _route_call(self, fn):
        def call(params, cfg, xt):
            out = fn(params, cfg, xt)
            if self.routes is not None:
                self.routes.append(out[1])
            return out

        return call

    @contextlib.contextmanager
    def installed(self):
        from repro_torch.kernels import ops
        from repro_torch.models import lm, moe

        saved = [(lm, "prefill", lm.prefill), (lm, "decode_step", lm.decode_step),
                 (ops, "scheduled_gemm", ops.scheduled_gemm), (moe, "route", moe.route)]
        lm.prefill = self._model_call("prefill", lm.prefill)
        lm.decode_step = self._model_call("decode_step", lm.decode_step)
        ops.scheduled_gemm = self._gemm_call(ops.scheduled_gemm)
        moe.route = self._route_call(moe.route)
        try:
            yield self
        finally:
            for mod, attr, fn in saved:
                setattr(mod, attr, fn)


def _dt(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def schedule_lengths(policy, gemms: list, t: Traffic) -> int:
    """Schedule, through the policy, each prefill product of the warm-up
    wave (m = batch x the longest length) at every length a wave can pad
    to; returns the number of shapes."""
    warm = t.batch * t.max_len
    shapes = {(k, n, dt, bias) for m, k, n, dt, _, bias in gemms if m == warm}
    for s in t.padded_lengths():
        for k, n, dt, bias in shapes:
            policy.config_for(t.batch * s, k, n, getattr(torch, dt), has_bias=bias is not None)
    return len(shapes) * len(t.padded_lengths())


def check_waves(t: Traffic) -> int:
    """Whole waves whose served tokens reach ``CHECK_TOKENS``."""
    return max(1, math.ceil(CHECK_TOKENS / (t.batch * t.new_tokens)))


def run(cell: Cell, seed: int, seconds: float, trace: bool, device, t_start: float, log=sys.stderr,
        min_waves: int = 1) -> dict:
    """Set up, warm, then serve waves until ``seconds`` have passed and at
    least ``min_waves`` waves (with ``trace``, the traced ones too) are
    done.  Returns the run's record: its waves, the sample of them kept
    for the check (with their logits), timings and the trace."""
    from repro_torch.core.configurators import build_backend
    from repro_torch.core.deprecation import ReproDeprecationWarning
    from repro_torch.core.descriptions import make_gemmini_description
    from repro_torch.kernels import gemm
    from repro_torch.kernels.policy import scheduled_kernels
    from repro_torch.serve import ServeConfig, ServingEngine

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    t, cfg = cell.traffic, cell.cfg
    weights = cell.config.make_weights(seed, cfg, dev)
    policy = scheduled_kernels(build_backend(make_gemmini_description()))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", ReproDeprecationWarning)
        engine = ServingEngine(cfg, weights, ServeConfig(
            batch=t.batch, max_len=t.max_len + t.new_tokens, max_new_tokens=t.new_tokens))
    probes = Probes(dev)
    keep = check_waves(t)
    if trace:
        min_waves = max(min_waves, max(PROFILED_WAVES) + 1)
    pick = np.random.default_rng([seed, 1])  # the sample of waves checked
    kept: list[Wave] = []
    waves: list[Wave] = []
    trace_out = {}

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    with policy as pol, probes.installed():
        probes.gemms = []
        engine.generate(t.wave(seed, -1, cfg.vocab))  # builds the kernels, warms the largest shape
        sync()
        shapes = schedule_lengths(pol, probes.gemms, t)
        probes.gemms = None
        gemm.reset_launches()
        t_window = time.perf_counter()
        setup_s = t_window - t_start
        print(f"bench: {cell.name} set up in {setup_s:.3f} s ({shapes} product shapes scheduled)", file=log)
        i = 0
        profiler = None
        while True:
            if time.perf_counter() - t_window >= seconds and i >= min_waves:
                break
            prompts = t.wave(seed, i, cfg.vocab)
            probes.logits, probes.routes = [], []
            probes.timed = trace and i in TIMED_WAVES
            if trace and i == PROFILED_WAVES[0]:
                probes.spans, probes.gemms = [], []
                activity = torch.profiler.ProfilerActivity.CUDA if cuda else torch.profiler.ProfilerActivity.CPU
                profiler = torch.profiler.profile(activities=[activity])
                profiler.start()
            t0 = time.perf_counter()
            with probes.span("engine"):
                reqs = engine.generate(prompts)
                sync()
            t1 = time.perf_counter()
            served = {r.rid: list(r.output) for r in reqs}
            wave = Wave(i, prompts, [served.get(j) for j in range(len(prompts))], t0, t1, probes.logits,
                        probes.routes)
            waves.append(wave)
            if trace and i == PROFILED_WAVES[-1]:
                profiler.stop()
                trace_out = {"profiler": profiler, "gemms": probes.gemms, "spans": probes.spans}
                probes.gemms = probes.spans = None
            # reservoir sampling: ``keep`` waves uniformly from those served
            if len(kept) < keep:
                kept.append(wave)
            else:
                j = int(pick.integers(0, i + 1))
                if j < keep:
                    kept[j].logits = kept[j].routes = []
                    kept[j] = wave
                else:
                    wave.logits = wave.routes = []
            i += 1
        probes.logits = probes.routes = None
    launches = {k: v / len(waves) for k, v in gemm.DESIGN_LAUNCHES.items()}
    print(f"bench: scheduled GEMM launches per wave by design {launches} over {len(waves)} waves; wave "
          f"seconds {[round(w.end - w.start, 3) for w in waves]}", file=log)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    del engine
    if cuda:
        torch.cuda.empty_cache()
    return {
        "weights": weights, "setup_s": setup_s, "t_window": t_window, "waves": waves, "kept": kept,
        "memory_peak_bytes": peak, "prefill_shapes": probes.prefill_shapes, "seconds": probes.seconds,
        "trace": trace_out,
    }


def observations(cell: Cell, out: dict) -> dict:
    """What the metric readers read, from a run's record."""
    t, waves = cell.traffic, out["waves"]
    requests = [(len(p), len(o), w.end - w.start) for w in waves for p, o in zip(w.prompts, w.outputs)
                if o is not None]
    timed = [w for w in waves if w.index in TIMED_WAVES] if out["prefill_shapes"] else []

    def flops(ws):
        return sum(cell.config.request_flops(cell.cfg, len(p), len(o))
                   for w in ws for p, o in zip(w.prompts, w.outputs) if o)

    obs = {
        "setup_s": out["setup_s"],
        "window_s": waves[-1].end - out["t_window"],
        "requests": requests,
        "prefill_shapes": out["prefill_shapes"],
        "timed_prompt_tokens": sum(len(p) for w in timed for p in w.prompts),
        "model_call_s": out["seconds"],
        "timed_flops": flops(timed),
        "timed_s": sum(w.end - w.start for w in timed),
    }
    tr = out["trace"]
    if tr:
        device, spans = devtrace.device_events(tr["profiler"]), tr["spans"]
        engine = [s for s in spans if s.name == "engine"]
        lo, hi = min(s.start_ns for s in engine), max(s.end_ns for s in engine)
        obs.update(
            device=device, spans=spans, window_ns=(lo, hi), trace_window_s=(hi - lo) / 1e9,
            busy_s=devtrace.union_s(device, lo, hi), gemms=tr["gemms"],
        )
    return obs


def read_metrics(entries: list, obs: dict) -> dict:
    """Each metric's reader (``metrics/<name>.py``) on the observations; a
    reader that finds nothing returns None and its metric is left out."""
    out = {}
    for m in entries:
        value = load_module(BENCH / "metrics" / f"{m['name']}.py", _module_name("metric", m["name"])).read(obs)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def execute(cell: Cell, seed: int, seconds: float, trace: bool, device, t_start: float, log=sys.stderr) -> dict:
    """One run: the result line's object (``checks`` last), less the check
    for modules that the caller makes."""
    import correct

    dev = torch.device(device)
    out = run(cell, seed, seconds, trace, dev, t_start, log)
    t = cell.traffic
    obs = observations(cell, out)
    failed = sum(o is None or len(o) != t.new_tokens or not all(0 <= x < cell.cfg.vocab for x in o)
                 for w in out["waves"] for o in w.outputs)
    result = {
        "correct": False,
        "attempted": sum(len(w.prompts) for w in out["waves"]),
        "failed": failed,
        "metrics": read_metrics(cell.per_layer if trace else cell.end_to_end, obs),
        "device": {
            "platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type,
            "count": 1,
            "memory_peak_bytes": out["memory_peak_bytes"],
        },
    }
    if trace and "device" in obs:
        lo, hi = obs["window_ns"]
        result["device"].update(busy_s=obs["busy_s"], window_s=obs["trace_window_s"])
        result["breakdown"] = {
            "device_ops": devtrace.top(devtrace.by_name(obs["device"], lo, hi)),
            "idle_gaps": devtrace.top(devtrace.idle_by_span(obs["device"], obs["spans"], lo, hi)),
        }
        first = min((d.start_ns for d in obs["device"]), default=lo)
        plain = [w.end - w.start for w in out["waves"] if w.index not in (0, *TIMED_WAVES, *PROFILED_WAVES)]
        print(f"bench: traced {len(obs['device'])} device operations over {obs['trace_window_s']:.3f} s; the "
              f"first starts {(first - lo) / 1e6:.3f} ms after the first traced engine call; a traced wave took "
              f"{obs['trace_window_s'] / len(PROFILED_WAVES):.3f} s, an untraced one "
              f"{sum(plain) / len(plain) if plain else float('nan'):.3f} s", file=log)
        out["trace"].clear()
    t0 = time.perf_counter()
    numbers = correct.check(cell, out["weights"], out["kept"], dev)
    ok, checks = correct.judge(numbers, cell.limits)
    print(f"bench: {cell.name} checked {len(out['kept'])} waves against the reference in "
          f"{time.perf_counter() - t0:.3f} s", file=log)
    result["correct"] = ok and failed == 0
    result["checks"] = checks
    return result
