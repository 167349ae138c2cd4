"""KDA's gated delta-rule recurrence: a CUDA kernel
(``csrc/kda_recurrent.cu``) beside its plain PyTorch version.

``kda_recurrent(q, k, v, g, beta, h0, state=)`` is what a KDA layer calls
once a layer call (``models/kda.py:kda_block``, inside the ``kda.core``
span), prefill and decode step alike: per batch row, head and position t,
with S a [K, V] float32 state (keys x values),

    S <- Diag(exp g_t) S
    S <- S + beta_t k_t (v_t - S^T k_t)^T
    o_t = S^T q_t

for q, k [B, T, H, K] and v [B, T, H, V] (bf16 on the kernel; q already
scaled, q and k L2-normed), g [B, T, H, K] f32 (the log-decay of each key
channel, at most 0), beta [B, T, H] f32 and h0 [B, H, K, V] f32 (None:
zeros).  It returns o [B, T, H, V] in v's dtype (rounded once from f32)
and the final S [B, H, K, V] f32, written into ``state`` where one is
given (it may be h0 itself: the recurrence then runs in place, as the
decode step's does over the cache), else into a new tensor.  As every
kernel wrapper of the port, it checks the tensors on every device
(``recurrent_refusal``: dtypes, shapes, contiguity) and raises on what it
does not take; then a CUDA tensor launches the kernel, or raises with
``kernel_refusal``'s reason, and a CPU tensor (or the dry run's meta
tensor) runs the plain version; nothing falls back.  ``tracing.count``
records ``kda.kernel_calls`` or ``kda.plain_calls``, one per call, by the
design that ran; ``LAUNCHES["kda_recurrent"]`` counts the kernel's
launches.

The kernel replaces no TPU kernel: the reference has no linear-attention
block.  It is the recurrence of FLA's ``fused_recurrent_kda``: the value
columns of S evolve independently given k, g and beta, so one CTA takes a
(batch row, head, slice of 32 value columns), its slice of S in
registers, and walks time in order (the source's note).  It reads no
[T, K, V] tensor and writes none.

``kda_recurrent_plain`` is the plain version: the same recurrence one
position at a time in float32 (T steps of whole-tensor operations over
[B, H, K, V]), differentiable, for the CPU, the tests and training.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch import tracing
from repro_torch.kernels import build

#: the key and value widths (K = V) the kernel is built for
HEAD_DIMS = (128,)


def kda_recurrent_plain(q, k, v, g, beta, h0=None, *, state=None):
    """The recurrence in plain PyTorch, one position at a time, in float32:
    (o [B, T, H, V] in v's dtype, final S [B, H, K, V] f32; written into
    ``state`` where given)."""
    f32 = torch.float32
    bsz, t_len, h, dk = q.shape
    dv = v.shape[-1]
    s = torch.zeros((bsz, h, dk, dv), dtype=f32, device=q.device) if h0 is None else h0.to(f32)
    outs = []
    for t in range(t_len):
        s = s * torch.exp(g[:, t].to(f32))[..., None]
        kt = k[:, t].to(f32)
        u = v[:, t].to(f32) - torch.einsum("bhkv,bhk->bhv", s, kt)
        s = s + beta[:, t].to(f32)[:, :, None, None] * kt[..., None] * u[:, :, None, :]
        outs.append(torch.einsum("bhkv,bhk->bhv", s, q[:, t].to(f32)))
    o = torch.stack(outs, dim=1) if outs else torch.zeros((bsz, 0, h, dv), dtype=f32, device=q.device)
    if state is not None:
        state.copy_(s)
        s = state
    return o.to(v.dtype), s


def recurrent_refusal(q, k, v, g, beta, h0, state) -> str | None:
    """Why the wrapper does not take these tensors on any device, or None:
    q, k [B, T, H, K] and v [B, T, H, V] of one dtype, bf16 or f32; g [B,
    T, H, K], beta [B, T, H], h0 and state [B, H, K, V] (or None) f32; all
    contiguous."""
    named = {"q": q, "k": k, "v": v, "g": g, "beta": beta, "h0": h0, "state": state}
    named = {n: t for n, t in named.items() if t is not None}
    if q.dtype not in (torch.bfloat16, torch.float32):
        return f"q is {q.dtype}: the recurrence takes bfloat16 or float32 q, k and v"
    for name in ("k", "v"):
        if named[name].dtype != q.dtype:
            return f"{name} is {named[name].dtype}, q {q.dtype}: q, k and v share one dtype"
    for name in ("g", "beta", "h0", "state"):
        if name in named and named[name].dtype != torch.float32:
            return f"{name} is {named[name].dtype}: g, beta and the states are float32"
    if q.dim() != 4 or v.dim() != 4:
        return f"q is {tuple(q.shape)}, v {tuple(v.shape)}: not [B, T, H, D]"
    bsz, t_len, h, dk = q.shape
    dv = v.shape[-1]
    want = {"k": (bsz, t_len, h, dk), "v": (bsz, t_len, h, dv), "g": (bsz, t_len, h, dk), "beta": (bsz, t_len, h),
            "h0": (bsz, h, dk, dv), "state": (bsz, h, dk, dv)}
    for name, shape in want.items():
        if name in named and tuple(named[name].shape) != shape:
            return f"{name} is {tuple(named[name].shape)}, not {shape}"
    for name, t in named.items():
        if not t.is_contiguous():
            return f"{name} is not contiguous"
    return None


def kernel_refusal(q, k, v, g, beta, h0, state) -> str | None:
    """Why the kernel does not take tensors that ``recurrent_refusal``
    takes, or None if it does: bf16 q, k and v, K = V in ``HEAD_DIMS``, a
    grid the card holds, 16-byte aligned bases, none requiring grad (the
    kernel has no backward), all on q's CUDA device."""
    tensors = [t for t in (q, k, v, g, beta, h0, state) if t is not None]
    if q.dtype != torch.bfloat16:
        return f"q, k and v are {q.dtype}: the kernel reads bfloat16"
    dk, dv = q.shape[-1], v.shape[-1]
    if dk != dv or dk not in HEAD_DIMS:
        return f"(K, V) = ({dk}, {dv}): the kernel is built for K = V in {HEAD_DIMS}"
    bsz, _, h, _ = q.shape
    if bsz > 65535 or h > 65535:
        return f"batch {bsz}, heads {h}: the grid holds at most 65535 of each"
    if any(t.requires_grad for t in tensors):
        return "a tensor requires grad: the kernel has no backward"
    if q.device.type != "cuda":
        return f"on {q.device}: the kernel runs on CUDA tensors"
    if any(t.device != q.device for t in tensors):
        return f"devices differ: {[str(t.device) for t in tensors]}"
    if any(t.data_ptr() % 16 for t in tensors):
        return "a base is not 16-byte aligned"
    return None


#: the kernel's launches (``build.LaunchCounts``)
LAUNCHES = build.LaunchCounts("kda_recurrent")

_P, _I = ctypes.c_void_p, ctypes.c_int
#: the argument types of csrc/kda_recurrent.cu's entry point
_ARGS = [
    _P, _P, _P, _P, _P, _P,  # q, k, v, g, beta, h0 (null: zeros)
    _P, _P,  # o, state
    _I, _I, _I, _I,  # batch, t_len, heads, head dim
    _P,  # stream
]


def _launch(q, k, v, g, beta, h0, state):
    bsz, t_len, h, dk = q.shape
    o = torch.empty_like(v)
    if state is None:
        state = torch.empty((bsz, h, dk, dk), dtype=torch.float32, device=q.device)
    lib = build.load("gemm")
    with torch.cuda.device(q.device):
        rc = build.bind(lib.repro_kda_recurrent, _ARGS)(
            *(t.data_ptr() for t in (q, k, v, g, beta)),
            None if h0 is None else h0.data_ptr(),
            o.data_ptr(),
            state.data_ptr(),
            bsz,
            t_len,
            h,
            dk,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    build.check(lib, rc, "KDA recurrent kernel")
    LAUNCHES.record("kda_recurrent")
    return o, state


def kda_recurrent(q, k, v, g, beta, h0=None, *, state=None):
    """The KDA recurrence of q, k [B, T, H, K], v [B, T, H, V], g [B, T, H,
    K], beta [B, T, H] from h0 [B, H, K, V] (None: zeros) -> (o [B, T, H,
    V] in v's dtype, final S [B, H, K, V] f32, written into ``state``
    where given; ``state`` may be ``h0``): on CUDA the kernel, or
    ValueError where ``kernel_refusal`` refuses the tensors; on any other
    device (the CPU, the dry run's meta tensors) ``kda_recurrent_plain``.
    ValueError on every device where ``recurrent_refusal`` refuses them."""
    refusal = recurrent_refusal(q, k, v, g, beta, h0, state)
    if refusal is not None:
        raise ValueError(f"KDA recurrence: {refusal}")
    if q.device.type != "cuda":
        tracing.count("kda.plain_calls")
        return kda_recurrent_plain(q, k, v, g, beta, h0, state=state)
    refusal = kernel_refusal(q, k, v, g, beta, h0, state)
    if refusal is not None:
        raise ValueError(f"KDA recurrent kernel: {refusal}")
    tracing.count("kda.kernel_calls")
    return _launch(q, k, v, g, beta, h0, state)
