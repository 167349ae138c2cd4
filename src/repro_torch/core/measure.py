"""Measurement of lowered executors (measured DSE).

The cycle model ranks the extended-CoSA sweep, but a model is only as
honest as its calibration — AutoTVM closes the same loop with on-device
timing, and MATCH validates its cost model the same way (PAPERS.md).
``CompileOptions(measure_top_k=K)`` re-ranks the K best modeled
candidates by the measured latency of the *actual lowered executor* — on
the card, one launch of the scheduled GEMM kernel per GEMM instance — and
persists the winner plus the raw timings in the schedule cache, so warm
boots re-measure nothing.

Timing protocol (the reference's): deterministic synthetic operands,
``warmup`` untimed calls, then the best of ``repeats`` timed calls of the
executor — best-of is the standard noise floor estimator for short
kernels (min is robust to scheduler preemption; mean is not).

What one number is.  On the CPU, wall-clock seconds of one call
(``perf_counter`` around it), as in the reference.  On a CUDA device, the
device time of the work one call issues — the kernel, plus any copy the
executor makes on the card — and not the host's: each timed call is
queued behind a device-side wait (``torch.cuda._sleep``) long enough for
the host to issue the whole call meanwhile, and two CUDA events around
the call bracket only what the card runs.  A launch's host time (the
wrapper's checks and launch, 0.04-0.18 ms on the H100) is several times a
small kernel's and varies by tens of microseconds, so a wall clock would
rank host noise; a winner is persisted in the schedule cache and in
artifacts, so it must be the card's.  If the wait runs out before the
call is issued, the next repeat waits twice as long.

Port of ``repro.core.measure``; ``synthetic_args`` is a copy (numpy, the
same seed and ranges), and the caller moves its arrays to the device.
"""

from __future__ import annotations

import time
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.core.ir import Node


def synthetic_args(node: Node, seed: int = 0) -> list:
    """Deterministic synthetic operands matching ``node.inputs``
    shapes/dtypes (integer operands stay small so quantized accumulators
    match real activation magnitudes)."""
    rng = np.random.default_rng(seed)
    args = []
    for inp in node.inputs:
        if inp is None:
            args.append(None)
            continue
        dt = np.dtype(inp.dtype)
        if np.issubdtype(dt, np.integer):
            args.append(rng.integers(-100, 100, size=inp.shape).astype(dt))
        else:
            args.append(rng.standard_normal(inp.shape).astype(dt))
    return args


def _cuda_device(args: Sequence) -> torch.device | None:
    for a in args:
        if isinstance(a, torch.Tensor) and a.device.type == "cuda":
            return a.device
    return None


#: device clock cycles of the wait queued ahead of each timed call on a
#: card (about 1 ms at an H100's clock, several times a call's host time)
HOLD_CYCLES = 2_000_000


def time_executor(
    executor: Callable,
    args: Sequence,
    *,
    warmup: int = 1,
    repeats: int = 3,
) -> float:
    """Best-of-``repeats`` seconds of one executor call: wall-clock on the
    CPU, the device time of its work when ``args`` lie on a CUDA device."""
    dev = _cuda_device(args)
    for _ in range(warmup):
        executor(*args)
    if dev is not None:
        return _device_seconds(executor, args, dev, repeats)
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        executor(*args)
        best = min(best, time.perf_counter() - t0)
    return best


def _device_seconds(executor: Callable, args: Sequence, dev: torch.device, repeats: int) -> float:
    hold, best = HOLD_CYCLES, float("inf")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev)
        for _ in range(repeats):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize(dev)
            torch.cuda._sleep(hold)  # holds the stream while the call is issued
            start.record(stream)
            executor(*args)
            end.record(stream)
            if start.query():  # the wait ran out before the call was issued
                hold *= 2
            end.synchronize()
            best = min(best, start.elapsed_time(end) * 1e-3)
    return best
