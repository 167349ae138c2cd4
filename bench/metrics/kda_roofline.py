"""KDA's recurrence kernel's share of its roofline over the traced waves
of ``kimi-linear-longdoc``: the least time of its launches
(``kda_bound.kda_least_s``), summed, over the device time of the kernels
named ``kda_*kernel*`` in the trace (all of them: the profiler runs over
the traced waves alone).

The observations hold no KDA shape, so the shapes are rebuilt: the batch
from the timed waves' prefill shapes, each traced wave's padded length
from its requests (its longest prompt; the engine pads to it) and its
decode steps from its requests' served tokens (one step a token, T = 1
each), and the heads, the head width and the number of KDA layers from
the cell's configuration file.  The prefills' launches are the longest
(milliseconds against microseconds for a step's), one per KDA layer and
traced wave.  The trace can lose a few of its 600,000-odd device records
(2 of the 2,600 KDA launches were missing from one traced run on an
H100), so each step launch counts as it is found, up to 1 % of them
missing;
nothing is read where a prefill launch is missing, the prefills' and the
steps' launches do not part by a factor of ten in time, or more launches
are found than the waves make."""

import json
import re
from pathlib import Path

import devtrace
import harness
import kda_bound

CELL = "kimi-linear-longdoc"
KERNEL = re.compile(r"^kda_\w*kernel")


def shapes(root: Path = harness.BENCH.parent) -> tuple[int, int, int]:
    """(heads, head width, KDA layers) of the cell's configuration."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    config = next(w["config"] for w in bench["workloads"] if w["name"] == CELL)
    spec = json.loads((root / next(c["file"] for c in bench["configs"] if c["name"] == config)).read_text())
    lac = spec["linear_attn_config"]
    return lac["num_heads"], lac["head_dim"], len(lac["kda_layers"])


def traced_waves(obs, batch: int) -> list[tuple[int, int]] | None:
    """(padded length, decode steps) of each traced wave, from the requests
    in wave order (``batch`` a wave), or None if a wave lost a request."""
    reqs = obs["requests"]
    first, last = min(harness.PROFILED_WAVES), max(harness.PROFILED_WAVES)
    if len(reqs) < (last + 1) * batch or len(reqs) % batch:
        return None
    waves = [reqs[w * batch : (w + 1) * batch] for w in range(first, last + 1)]
    return [(max(p for p, _, _ in wave), max(o for _, o, _ in wave)) for wave in waves]


def least_s(obs, heads: int, width: int, layers: int, launches: list) -> float | None:
    """The least time of ``launches`` (the traced waves' KDA launches,
    found in the trace), or None where the observations cannot give it or
    the launches are not the waves' (the module's note)."""
    if not obs.get("prefill_shapes"):
        return None
    batch = obs["prefill_shapes"][0][0]
    waves = traced_waves(obs, batch)
    if waves is None:
        return None
    n_prefill = layers * len(waves)
    steps = layers * sum(n for _, n in waves)
    by_time = sorted(launches, key=lambda iv: iv.seconds, reverse=True)
    prefill, rest = by_time[:n_prefill], by_time[n_prefill:]
    if (len(prefill) < n_prefill or not steps * 0.99 <= len(rest) <= steps
            or (rest and prefill[-1].seconds < 10 * rest[0].seconds)):
        return None
    one_step = kda_bound.kda_least_s(batch, 1, heads, width, width)
    return sum(layers * kda_bound.kda_least_s(batch, s, heads, width, width) for s, _ in waves) + len(rest) * one_step


def read(obs, config=None):
    if not obs.get("device"):
        return None
    launches = [iv for iv in obs["device"] if KERNEL.match(devtrace.short_name(iv.name))]
    device_s = sum(iv.seconds for iv in launches)
    found = least_s(obs, *(config or shapes()), launches)
    if device_s <= 0 or found is None:
        return None
    return 100.0 * found / device_s
