"""The scheduled GEMM kernels' share of their roofline over the traced
waves: the least time of the products launched (``hopper.gemm_least_s``
of each (m, k, n, dtypes) recorded at ``ops.scheduled_gemm``) over the
device time of the kernels named ``wgmma_gemm_kernel`` and
``scheduled_gemm_kernel`` in the trace."""

import re

import devtrace
import hopper

KERNELS = re.compile(r"^(wgmma_gemm_kernel|scheduled_gemm_kernel)\b")


def read(obs):
    if not obs.get("gemms") or not obs.get("device"):
        return None
    lo, hi = obs["window_ns"]
    device_s = sum(s for name, s in devtrace.by_name(obs["device"], lo, hi).items() if KERNELS.match(name))
    if device_s <= 0:
        return None
    least = sum(hopper.gemm_least_s(*g) for g in obs["gemms"])
    return 100.0 * least / device_s
