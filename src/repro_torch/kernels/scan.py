"""Mamba's selective scan: a fused CUDA kernel (``csrc/selective_scan.cu``)
beside its plain PyTorch version.

``selective_scan(u, dt, a_log, d, b, c, h0)`` is what the Mamba block
calls once a layer call (``models/ssm.py:mamba_block``, inside the
``mamba.scan`` span), over the whole sequence, prefill and decode step
alike: with delta = softplus(dt) and A = -exp(a_log),

    h_s = exp(delta_s A) h_{s-1} + delta_s u_s B_s,    y_s = h_s C_s + D u_s

for u, dt [B, S, d_in] (dt is dt_proj's output, its bias added, before
softplus), a_log [d_in, n], d [d_in], b, c [B, S, n] and h0 [B, d_in, n]
(None: zeros).  It returns y [B, S, d_in] in u's dtype (rounded once from
f32) and the final h [B, d_in, n] f32; everything in between is f32.  As
every kernel wrapper of the port, it checks the tensors on every device
(``scan_refusal``: dtypes, shapes, contiguity) and raises on what it does
not take; then a CUDA tensor launches the kernel, or raises with
``kernel_refusal``'s reason (d_state other than 8 or 16, a tensor that
requires grad, another device), and a CPU tensor (or the dry run's meta
tensor) runs the plain version; nothing falls back.  ``tracing.count``
records ``mamba.kernel_calls`` or ``mamba.plain_calls``, one per call, by
the design that ran; ``LAUNCHES["selective_scan"]`` counts the kernel's
launches.

The kernel replaces no TPU kernel: the reference's scan,
``repro/models/ssm.py:_scan_chunk``, is ``jax.lax.associative_scan`` and
reaches no ``pl.pallas_call``.  It is bound by the exps of exp(delta A),
one per state, position and channel (the source's note): one thread per
(batch row, channel) with its states in registers, u and dt loaded ahead,
B and C staged in shared memory; no [B, S, d_in, n] tensor is made.

``selective_scan_plain`` is the plain version: the port of the
reference's chunk loop, each chunk's dA and dBu [B, c, d_in, n] scanned
by ``_scan_chunk``, a log-step (Hillis–Steele) scan with the reference's
combine ``(a1·a2, a2·b1 + b2)``: ⌈log₂ c⌉ rounds of whole-tensor products
(7 at chunk 128) instead of one host step per position.  The two scans
associate the products differently, so they agree to float rounding, not
bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch import tracing
from repro_torch.kernels import build

#: the state sizes (d_state) the kernel is built for
STATE_SIZES = (8, 16)
#: the dtypes of u, dt, b and c the kernel takes, by its codes
#: (csrc/selective_scan.cu)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _scan_chunk(h0: torch.Tensor, d_a: torch.Tensor, d_bu: torch.Tensor):
    """Inclusive scan of h_t = dA_t h_{t-1} + dBu_t over the chunk axis
    (dim 1), log-step: at offset o each position combines with the one o
    before it, ``(a1·a2, a2·b1 + b2)`` with 1 the earlier.
    h0 [B,d_in,n]; dA/dBu [B,c,d_in,n] -> (h over the chunk, final h)."""
    a, b = d_a, d_bu
    c = a.shape[1]
    off = 1
    while off < c:
        a, b = (
            torch.cat([a[:, :off], a[:, :-off] * a[:, off:]], dim=1),
            torch.cat([b[:, :off], a[:, off:] * b[:, :-off] + b[:, off:]], dim=1),
        )
        off *= 2
    h = a * h0[:, None] + b
    return h, h[:, -1]


def selective_scan_plain(u, dt, a_log, d, b, c, h0=None, *, chunk: int = 128):
    """The scan in plain PyTorch, ``chunk`` positions at a time (the last
    chunk may be shorter): (y [B, S, d_in] in u's dtype, final h [B, d_in,
    n] f32).  Takes any layout and DTensors (a sharded block's scan)."""
    bsz, s, d_in = u.shape
    if h0 is None:
        h0 = torch.zeros((bsz, d_in, a_log.shape[-1]), dtype=torch.float32, device=u.device)
    h = h0
    a = -torch.exp(a_log)  # [d_in, n]
    ys = []
    for c0 in range(0, s, chunk):
        delta = torch.nn.functional.softplus(dt[:, c0 : c0 + chunk].to(torch.float32))  # [B,c,d_in]
        u_c = u[:, c0 : c0 + chunk].to(torch.float32)
        d_a = torch.exp(delta[..., None] * a[None, None])
        d_bu = (delta * u_c)[..., None] * b[:, c0 : c0 + chunk].to(torch.float32)[:, :, None, :]
        h_seq, h = _scan_chunk(h, d_a, d_bu)
        y_c = torch.einsum("bcdn,bcn->bcd", h_seq, c[:, c0 : c0 + chunk].to(torch.float32))
        ys.append(y_c + d[None, None] * u_c)
    return torch.cat(ys, dim=1).to(u.dtype), h


def scan_refusal(u, dt, a_log, d, b, c, h0) -> str | None:
    """Why the wrapper does not take these tensors on any device, or None:
    u, dt [B, S, d_in] and b, c [B, S, n] of one dtype, bf16 or f32;
    a_log [d_in, n], d [d_in] and h0 [B, d_in, n] (or None) f32; all
    contiguous."""
    named = {"u": u, "dt": dt, "a_log": a_log, "d": d, "b": b, "c": c}
    if h0 is not None:
        named["h0"] = h0
    if u.dtype not in DTYPE_CODES:
        return f"u is {u.dtype}: the scan takes {', '.join(map(str, DTYPE_CODES))}"
    for name in ("dt", "b", "c"):
        if named[name].dtype != u.dtype:
            return f"{name} is {named[name].dtype}, u {u.dtype}: u, dt, b and c share one dtype"
    for name in ("a_log", "d", "h0"):
        if name in named and named[name].dtype != torch.float32:
            return f"{name} is {named[name].dtype}: a_log, d and h0 are float32"
    if u.dim() != 3:
        return f"u is {tuple(u.shape)}, not [B, S, d_in]"
    bsz, s, d_in = u.shape
    if a_log.dim() != 2 or a_log.shape[0] != d_in:
        return f"a_log is {tuple(a_log.shape)}, not [d_in {d_in}, n]"
    n = a_log.shape[1]
    want = {"dt": (bsz, s, d_in), "d": (d_in,), "b": (bsz, s, n), "c": (bsz, s, n), "h0": (bsz, d_in, n)}
    for name, shape in want.items():
        if name in named and tuple(named[name].shape) != shape:
            return f"{name} is {tuple(named[name].shape)}, not {shape}"
    for name, t in named.items():
        if not t.is_contiguous():
            return f"{name} is not contiguous"
    return None


def kernel_refusal(u, dt, a_log, d, b, c, h0) -> str | None:
    """Why the kernel does not take tensors that ``scan_refusal`` takes,
    or None if it does: d_state in ``STATE_SIZES``, a batch the grid
    holds, none requiring grad (the kernel has no backward), all on u's
    CUDA device."""
    tensors = [t for t in (u, dt, a_log, d, b, c, h0) if t is not None]
    if a_log.shape[1] not in STATE_SIZES:
        return f"d_state {a_log.shape[1]}: the kernel is built for {STATE_SIZES}"
    if u.shape[0] > 65535:
        return f"batch {u.shape[0]}: the grid holds at most 65535 rows"
    if any(t.requires_grad for t in tensors):
        return "a tensor requires grad: the kernel has no backward"
    if u.device.type != "cuda":
        return f"on {u.device}: the kernel runs on CUDA tensors"
    if any(t.device != u.device for t in tensors):
        return f"devices differ: {[str(t.device) for t in tensors]}"
    return None


#: the kernel's launches (``build.LaunchCounts``)
LAUNCHES = build.LaunchCounts("selective_scan")

_P, _I = ctypes.c_void_p, ctypes.c_int
#: the argument types of csrc/selective_scan.cu's entry point
_ARGS = [
    _P, _P, _P, _P, _P, _P, _P,  # u, dt, a_log, d, b, c, h0 (null: zeros)
    _P, _P,  # y, h_out
    _I, _I, _I, _I, _I,  # batch, s_len, d_in, d_state, dtype code
    _P,  # stream
]


def _launch(u, dt, a_log, d, b, c, h0):
    bsz, s, d_in = u.shape
    n = a_log.shape[1]
    y = torch.empty_like(u)
    h = torch.empty((bsz, d_in, n), dtype=torch.float32, device=u.device)
    lib = build.load("gemm")
    with torch.cuda.device(u.device):
        rc = build.bind(lib.repro_selective_scan, _ARGS)(
            *(t.data_ptr() for t in (u, dt, a_log, d, b, c)),
            None if h0 is None else h0.data_ptr(),
            y.data_ptr(),
            h.data_ptr(),
            bsz,
            s,
            d_in,
            n,
            DTYPE_CODES[u.dtype],
            torch.cuda.current_stream(u.device).cuda_stream,
        )
    build.check(lib, rc, "selective scan kernel")
    LAUNCHES.record("selective_scan")
    return y, h


def selective_scan(u, dt, a_log, d, b, c, h0=None, *, chunk: int = 128):
    """The selective scan of u, dt [B, S, d_in], a_log [d_in, n], d [d_in],
    b, c [B, S, n] from h0 [B, d_in, n] (None: zeros) -> (y [B, S, d_in]
    in u's dtype, final h [B, d_in, n] f32): on CUDA the kernel, or
    ValueError where ``kernel_refusal`` refuses the tensors; on any other
    device (the CPU, the dry run's meta tensors) ``selective_scan_plain``
    at ``chunk``.  ValueError on every device where ``scan_refusal``
    refuses them."""
    refusal = scan_refusal(u, dt, a_log, d, b, c, h0)
    if refusal is not None:
        raise ValueError(f"selective scan: {refusal}")
    if u.device.type != "cuda":
        tracing.count("mamba.plain_calls")
        return selective_scan_plain(u, dt, a_log, d, b, c, h0, chunk=chunk)
    refusal = kernel_refusal(u, dt, a_log, d, b, c, h0)
    if refusal is not None:
        raise ValueError(f"selective scan kernel: {refusal}")
    tracing.count("mamba.kernel_calls")
    return _launch(u, dt, a_log, d, b, c, h0)
