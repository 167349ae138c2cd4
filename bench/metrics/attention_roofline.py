"""The fused prefill attention's share of its roofline over the traced
waves of ``deepseek-longdoc``: the least time of its launches
(``attention_bound.attention_least_s``), summed, over the device time of
the kernels named ``prefill_attention_kernel`` in the trace.

The observations hold no attention shape, so the shapes are rebuilt:
the batch from the timed waves' prefill shapes, each traced wave's
padded length from its requests (its longest prompt; the engine pads to
it), and the heads, the head dims and the number of attention layers
from the cell's configuration file.  Nothing is read where the launches
counted in the trace are not one per attention layer and traced
prefill."""

import json
import re
from pathlib import Path

import attention_bound
import devtrace
import harness

CELL = "deepseek-longdoc"
KERNEL = re.compile(r"^prefill_attention_kernel\b")


def shapes(root: Path = harness.BENCH.parent) -> tuple[int, int, int, int]:
    """(heads, q/k head dim, v head dim, attention layers) of the cell's
    configuration."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    config = next(w["config"] for w in bench["workloads"] if w["name"] == CELL)
    spec = json.loads((root / next(c["file"] for c in bench["configs"] if c["name"] == config)).read_text())
    dqk = spec["qk_nope_head_dim"] + spec["qk_rope_head_dim"]
    return spec["num_attention_heads"], dqk, spec["v_head_dim"], spec["num_hidden_layers"]


def traced_lengths(obs, batch: int) -> list[int] | None:
    """The padded length of each traced wave, from the requests in wave
    order (``batch`` a wave), or None if a wave lost a request."""
    reqs = obs["requests"]
    first, last = min(harness.PROFILED_WAVES), max(harness.PROFILED_WAVES)
    if len(reqs) < (last + 1) * batch or len(reqs) % batch:
        return None
    return [max(p for p, _, _ in reqs[w * batch : (w + 1) * batch]) for w in range(first, last + 1)]


def least_s(obs, heads: int, dqk: int, dv: int, layers: int) -> tuple[float, int] | None:
    """(the least time of the traced prefills' attention launches, their
    number), or None where the observations cannot give them."""
    if not obs.get("prefill_shapes"):
        return None
    batch = obs["prefill_shapes"][0][0]
    lengths = traced_lengths(obs, batch)
    if lengths is None:
        return None
    total = sum(layers * attention_bound.attention_least_s(batch, heads, s, dqk, dv) for s in lengths)
    return total, layers * len(lengths)


def read(obs, config=None):
    if not obs.get("device"):
        return None
    lo, hi = obs["window_ns"]
    launches = [iv for iv in obs["device"]
                if lo <= iv.start_ns < hi and KERNEL.match(devtrace.short_name(iv.name))]
    device_s = sum(iv.seconds for iv in launches)
    found = least_s(obs, *(config or shapes()))
    if device_s <= 0 or found is None or found[1] != len(launches):
        return None
    return 100.0 * found[0] / device_s
