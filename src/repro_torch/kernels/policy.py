"""Scheduled-kernel policy: routes model GEMMs through the paper's backend.

This is how the compiler-integration contribution becomes *first-class* in
the LM substrate: when a policy is active, every
``repro_torch.models.layers.dense`` call with at least ``min_m`` rows
consults the extended-CoSA scheduler (via the generated backend) for its
(m, k, n, dtype) workload and executes through the scheduled GEMM kernel
(``repro_torch.kernels.ops.matmul``); otherwise it runs the plain
``x @ w`` — exactly the paper's host-fallback semantics.

Schedules are cached by workload key inside the scheduler, so each shape
is scheduled once per backend; the policy keeps the kernel config of each
(m, k, n, dtype, bias) it has seen, as the reference resolves each shape
once, when it traces.

Port of ``repro.kernels.policy``.  ``ScheduledKernelPolicy`` has no
``interpret`` field: the port's ``GemmKernelConfig`` has none, since where
the kernel runs follows the tensors' device (the CUDA kernel on a card,
its plain version on the CPU).  Under ``repro_torch.tracing.recording``
the policy counts its CoSA solves (``policy.solves``), each inside a
``policy.solve`` span.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field

from repro_torch import tracing
from repro_torch.core.arch_spec import GemmWorkload
from repro_torch.kernels.gemm import GemmKernelConfig
from repro_torch.kernels.ref import dtype_name, torch_dtype

_lock = threading.Lock()
_POLICY: "ScheduledKernelPolicy | None" = None


@dataclass
class ScheduledKernelPolicy:
    backend: object  # repro_torch.core.pipeline.CompilerBackend
    min_m: int = 8  # skip degenerate GEMMs (decode gemv runs unrouted)
    _configs: dict = field(default_factory=dict, repr=False)

    def config_for(
        self, m: int, k: int, n: int, dtype, *, has_bias: bool
    ) -> GemmKernelConfig | None:
        """The kernel config for an (m, k, n) product in ``dtype`` (f32
        accumulator, output in ``dtype``), or None when the product stays
        unrouted: fewer than ``min_m`` rows, or no feasible schedule."""
        if m < self.min_m:
            return None
        key = (m, k, n, dtype, has_bias)
        if key not in self._configs:
            self._configs[key] = self._derive(m, k, n, dtype, has_bias)
        return self._configs[key]

    def _derive(self, m: int, k: int, n: int, dtype, has_bias: bool) -> GemmKernelConfig | None:
        dt = torch_dtype(dtype)
        elem = dt.itemsize
        wl = GemmWorkload(
            N=m, C=k, K=n, in_bytes=elem, w_bytes=elem, out_bytes=4, name="lm_gemm"
        )
        tracing.count("policy.solves")
        try:
            with tracing.span("policy.solve", m=m, k=k, n=n):
                result = self.backend.scheduler.schedule(wl)
        except RuntimeError:
            return None
        return self.backend.mapping_gen.to_kernel_config(
            result.best,
            acc_dtype="float32",
            out_dtype=dtype_name(dt),
            has_bias=has_bias,
        )


def set_policy(policy: ScheduledKernelPolicy | None) -> None:
    global _POLICY
    with _lock:
        _POLICY = policy


def get_policy() -> ScheduledKernelPolicy | None:
    return _POLICY


class scheduled_kernels:
    """Context manager: ``with scheduled_kernels(backend): lm.prefill(...)``."""

    def __init__(self, backend):
        self._policy = ScheduledKernelPolicy(backend=backend)

    def __enter__(self):
        set_policy(self._policy)
        return self._policy

    def __exit__(self, *exc):
        set_policy(None)
        return False
