"""MLA's absorbed decode attention over the latent cache: a Hopper kernel
(``csrc/mla_decode.cu``) beside its plain PyTorch version.

``mla_decode(q_lat, q_rope, latent, k_rope, length, scale=)`` is what the
decode step calls (``models/attention.py:mla_decode_attention``, inside
the ``attn.core`` span) for a cache the kernel takes: for q_lat [B, H, 1,
r] (q's nope part through the absorbed k_up) and q_rope [B, H, 1, dr],
over the cache's latent [B, S_max, r] and k_rope [B, S_max, dr] up to
``length`` positions,

    ctx[b, h] = sum_{s < length} softmax_s(scale (q_lat . latent_s + q_rope . k_rope_s)) latent_s

[B, H, 1, r] in f32.  ``length`` is a device int64 tensor of one element
(``lm.decode_step``'s position + 1), so one captured CUDA graph serves
every step of a cache.  As every kernel wrapper of the port, a CUDA tensor
launches the kernel or raises with ``kernel_refusal``'s reason, and a CPU
tensor (or the dry run's meta tensor) runs the plain version; nothing
falls back.  The kernel takes bf16 q_lat and q_rope and a bf16 cache at
(r, dr) in ``LATENT_DIMS``, any batch, heads and S_max, read in place; its
logits are bf16 products summed in f32, its softmax f32, the weights
rounded to bf16 for the value product.  ``cache_refusal`` is the part of
the rule that the cache decides (``models/attention.py:
mla_decode_kernel_refusal`` asks it).  ``tracing.count`` records
``mla.kernel_calls`` or ``mla.plain_calls``, one per call, by the design
that ran; ``LAUNCHES`` counts the split kernel and its combine, one each
a call.

The kernel replaces no TPU kernel: the reference's absorbed decode,
``repro/models/attention.py:mla_decode_attention``, is plain ``jnp`` and
reaches no ``pl.pallas_call``.  It streams the bf16 latent once per step
and stops at ``length``: at deepseek-longdoc's layer (B 4, H 128, S_max
16,448) 75.8 MB, 22.6 µs at 3.35 TB/s, and 18.3 GFLOP, 18.5 µs at the
bf16 peak.  The design (the source's note): one CTA per (64-head block,
split of the positions, batch row), a fixed number of splits sized from
S_max and the SM count (``splits``), each taking an equal share of the
tiles below the device length; wgmma over TMA-fed tiles in which one
latent tile is both K and V; a combine over the splits' partial sums.

``mla_decode_plain`` is the plain version: the f32 arithmetic the decode
step ran before the kernel, over every position under a mask, its softmax
combined across a process group where the cache's positions are split
over one (``models/attention.py:mla_decode_attention``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch import tracing
from repro_torch.kernels import build
from repro_torch.kernels.attention import NEG_INF, tma_strides

#: the (latent width r, rope dims dr) the kernel is built for: DeepSeek-V2's
LATENT_DIMS = ((512, 64),)
#: query heads a CTA takes, and positions a latent tile holds
HEAD_BLOCK = 64
TILE = 64


def mla_decode_plain(q_lat, q_rope, latent, k_rope, length, *, scale: float, positions=None, group=None):
    """The softmax-weighted latent [B, H, 1, r] in f32, everything in f32:
    the logits of q_lat [B, H, 1, r] and q_rope [B, H, 1, dr] over the
    cache positions ``positions`` held here (None: all of ``latent``'s
    [B, S, r] and ``k_rope``'s [B, S, dr]), those at or past ``length``
    (an int or a tensor) masked; with ``group`` (a (mesh, dim) pair) each
    rank of it holds a slice of the positions, and the softmax combines
    across the group."""
    f32 = torch.float32
    latent, q_lat = latent.to(f32).contiguous(), q_lat.to(f32).contiguous()
    logits = torch.einsum("bhqr,bsr->bhqs", q_lat, latent)
    logits = logits + torch.einsum("bhqd,bsd->bhqs", q_rope.to(f32).contiguous(), k_rope.to(f32).contiguous())
    logits = logits * scale
    if positions is None:
        positions = torch.arange(latent.shape[1], device=q_lat.device)
    mask = positions[None, None, None, :] < length
    logits = torch.where(mask, logits, NEG_INF)
    # one arithmetic with and without a group (flash-decoding's: the row
    # max, the unnormalised weights, their sum, and the weighted latent
    # divided last), so a one-rank group gives the ungrouped bits
    from torch.distributed import _functional_collectives as funcol

    m = logits.amax(-1, keepdim=True)
    if group is not None:
        m = funcol.all_reduce(m, "max", group)
    p = torch.exp(logits - m)
    den = p.sum(-1, keepdim=True)
    ctx_lat = torch.einsum("bhqs,bsr->bhqr", p, latent)
    if group is not None:
        den = funcol.all_reduce(den, "sum", group)
        ctx_lat = funcol.all_reduce(ctx_lat, "sum", group)
    return ctx_lat / den


def cache_refusal(latent: torch.Tensor, rope_dim: int) -> str | None:
    """Why the kernel does not take a latent cache [B, S, r] with rope
    dims ``rope_dim``, or None if it does: bf16, (r, dr) in
    ``LATENT_DIMS``, on a CUDA device."""
    if latent.dtype != torch.bfloat16:
        return f"a {latent.dtype} cache: the kernel is built for bfloat16"
    dims = (latent.shape[-1], rope_dim)
    if dims not in LATENT_DIMS:
        return f"(r, dr) = {dims}: the kernel is built for {LATENT_DIMS}"
    if latent.device.type != "cuda":
        return f"on {latent.device}: the kernel runs on CUDA tensors"
    return None


def kernel_refusal(q_lat, q_rope, latent, k_rope, length) -> str | None:
    """Why the kernel does not take these tensors, or None if it does:
    ``cache_refusal``'s rule; q_lat [B, H, 1, r], q_rope [B, H, 1, dr],
    latent [B, S, r] and k_rope [B, S, dr], all bf16, none requiring
    grad; the cache readable in place (``tma_strides``); ``length`` an
    int64 tensor of one element; all on one CUDA device."""
    refusal = cache_refusal(latent, k_rope.shape[-1])
    if refusal is not None:
        return refusal
    if not isinstance(length, torch.Tensor) or length.dtype != torch.int64 or length.numel() != 1:
        return "the length is not an int64 tensor of one element"
    tensors = (q_lat, q_rope, latent, k_rope, length)
    if any(t.requires_grad for t in tensors):
        return "a tensor requires grad: the kernel has no backward"
    if any(t.dtype != torch.bfloat16 for t in tensors[:4]):
        return f"dtypes {[t.dtype for t in tensors[:4]]}: q_lat, q_rope, latent and k_rope are bfloat16"
    if q_lat.dim() != 4 or q_rope.dim() != 4 or latent.dim() != 3 or k_rope.dim() != 3:
        return "q_lat, q_rope are not [B, H, 1, d] or latent, k_rope not [B, S, d]"
    (b, h, one, r), (bq, hq, oneq, dr) = q_lat.shape, q_rope.shape
    if not (one == oneq == 1 and (b, h) == (bq, hq) and (b, r) == (latent.shape[0], latent.shape[2])
            and (b, latent.shape[1], dr) == tuple(k_rope.shape)):
        return (f"shapes differ: q_lat {tuple(q_lat.shape)}, q_rope {tuple(q_rope.shape)}, latent "
                f"{tuple(latent.shape)}, k_rope {tuple(k_rope.shape)}")
    if latent.shape[1] == 0 or b * h == 0:
        return "empty"
    if tma_strides(latent) is None or tma_strides(k_rope) is None:
        return "the cache is not laid out for TMA (a contiguous dim, 16-byte aligned rows)"
    if any(t.device != latent.device for t in tensors):
        return f"devices differ: {[str(t.device) for t in tensors]}"
    return None


@functools.cache
def splits(batch: int, heads: int, s_max: int, device_index: int) -> int:
    """The splits of the positions: as many as fill the card's SMs once
    with one CTA per (64-head block, split, batch row), and at most one a
    tile of S_max; fixed by the shapes, so a captured graph holds one
    grid, while the tiles each split takes follow the device length."""
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    ctas = batch * -(-heads // HEAD_BLOCK)
    return max(1, min(sms // ctas, -(-s_max // TILE)))


#: the split kernel's and the combine's launches (``build.LaunchCounts``)
LAUNCHES = build.LaunchCounts("mla_decode", "mla_decode_combine")

_P, _I = ctypes.c_void_p, ctypes.c_int
_STRIDES = ctypes.POINTER(ctypes.c_longlong)
#: the argument types of csrc/mla_decode.cu's entry point
_ARGS = [
    _P, _P, _P, _P, _P,  # q_lat, q_rope, latent, k_rope, length
    _P, _P, _P,  # part, lse, out
    _I, _I, _I, _I,  # batch, heads, s_max, n_split
    _STRIDES, _STRIDES, _STRIDES, _STRIDES,  # q_lat, q_rope, latent, k_rope (batch, row)
    ctypes.c_float,  # scale
    _P,  # stream
]


def _launch(q_lat, q_rope, latent, k_rope, length, scale: float) -> torch.Tensor:
    """The kernel on admitted tensors.  q_lat and q_rope that TMA cannot
    read in place are copied contiguous first."""
    b, h, _, r = q_lat.shape
    s_max = latent.shape[1]
    qs = []
    for t in (q_lat[:, :, 0], q_rope[:, :, 0]):
        if tma_strides(t) is None:
            t = t.contiguous()
        qs.append(t)
    dev = latent.device
    n_split = splits(b, h, s_max, dev.index if dev.index is not None else torch.cuda.current_device())
    part = torch.empty((b, h, n_split, r), dtype=torch.float32, device=dev)
    lse = torch.empty((b, h, n_split), dtype=torch.float32, device=dev)
    out = torch.empty((b, h, 1, r), dtype=torch.float32, device=dev)
    arrays = [(ctypes.c_longlong * 2)(*tma_strides(t)) for t in (*qs, latent, k_rope)]
    lib = build.load("gemm")
    with torch.cuda.device(dev):
        rc = build.bind(lib.repro_mla_decode, _ARGS)(
            *(t.data_ptr() for t in (*qs, latent, k_rope, length, part, lse, out)),
            b,
            h,
            s_max,
            n_split,
            *arrays,
            scale,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    build.check(lib, rc, "MLA decode kernel")
    LAUNCHES.record("mla_decode", (LAUNCHES, "mla_decode_combine"))
    return out


def mla_decode(q_lat, q_rope, latent, k_rope, length, *, scale: float) -> torch.Tensor:
    """The softmax-weighted latent [B, H, 1, r] f32 of q_lat [B, H, 1, r]
    and q_rope [B, H, 1, dr] over the first ``length`` positions of the
    latent [B, S, r] and k_rope [B, S, dr] caches, the logits times
    ``scale``: on CUDA the kernel, or ValueError where ``kernel_refusal``
    refuses the tensors; on any other device (the CPU, the dry run's meta
    tensors) ``mla_decode_plain``."""
    if latent.device.type != "cuda":
        tracing.count("mla.plain_calls")
        return mla_decode_plain(q_lat, q_rope, latent, k_rope, length, scale=scale)
    refusal = kernel_refusal(q_lat, q_rope, latent, k_rope, length)
    if refusal is not None:
        raise ValueError(f"MLA decode kernel: {refusal}")
    tracing.count("mla.kernel_calls")
    return _launch(q_lat, q_rope, latent, k_rope, length, scale)
