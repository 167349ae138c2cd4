"""The LM prefill's causal GQA attention: a fused Hopper kernel
(``csrc/attention_wgmma.cu``) beside its plain PyTorch version.

``prefill_attention(q, k, v, window=, scale=)`` is what the serving
prefill calls (``models/attention.py:prefill_core``, inside the
``attn.core`` span) for a configuration the kernel takes: causal,
optionally sliding-window attention of q [B, H, S, D] over k [B, Hkv,
S, D], v [B, Hkv, S, Dv], each KV head serving its H / Hkv consecutive
query heads, the logits times ``scale`` (the configuration's:
``models/attention.py:softmax_scale``).  As every kernel wrapper of the
port, a CUDA tensor launches the kernel or raises with
``attention_refusal``'s reason, and a CPU tensor (or the dry run's meta
tensor) runs the plain version, ``blockwise_attention``; nothing falls
back.  The kernel takes bf16 from position 0 (q, k and v of one
length), head dims (D, Dv) of (64, 64), (128, 128) or MLA's expanded
(192, 128), H a multiple of Hkv, any window, and no tensor that
requires grad.  ``shape_refusal`` is the part of the rule that a
configuration's shapes decide: where it refuses (f32, other MLA sizes,
head dim 256) the prefill calls the plain version itself.  ``tracing.count`` records ``attn.kernel_calls``
or ``attn.plain_calls``, one per call, by the design that ran;
``LAUNCHES["prefill_attention"]`` counts the kernel's launches.

The kernel replaces no TPU kernel: the reference's prefill attention,
``repro/models/attention.py:blockwise_attention``, is plain ``jnp`` and
reaches no ``pl.pallas_call``.  It is bound by operations once the
[S, S] logits stay on chip (a causal layer at B 8, H 32, S 4096, D 128:
1.10 TFLOP, 1.11 ms at 989 TFLOP/s, against 603 MB, 0.18 ms at 3.35
TB/s); its exps on the multi-function unit cost half its products'
time.  The design (the source's note): one CTA per 128-row q tile, head
and batch row, the CTAs of one KV head adjacent; a producer warp
streaming K and V tiles of 128 keys with TMA through a two-stage ring,
read from the KV head in place; two consumer warpgroups running
``wgmma`` for S = Q K^T and O += P V with the online softmax in f32
registers; KV tiles wholly masked never visited.  Its logits stay in
f32 where the plain version rounds them to bf16.

``blockwise_attention`` is the plain version (``models.attention``
exports it too): the port of the reference's, a loop over (q-chunk,
kv-chunk) pairs of the largest divisor of S up to the chunk size, every
pair computed.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch import tracing
from repro_torch.kernels import build

NEG_INF = -1e30

#: the (q and k, v) head dims the kernel is built for: GQA's equal dims,
#: and MLA's expanded prefill at DeepSeek-V2's sizes (nope 128 + rope 64)
HEAD_DIMS = ((64, 64), (128, 128), (192, 128))


def _pick_chunk(s: int, target: int) -> int:
    """Largest divisor of s that is <= target."""
    c = min(target, s)
    while s % c:
        c -= 1
    return c


def _repeat_kv(k: torch.Tensor, v: torch.Tensor, h: int):
    hkv = k.shape[1]
    if hkv == h:
        return k, v
    rep = h // hkv
    return k.repeat_interleave(rep, dim=1), v.repeat_interleave(rep, dim=1)


def blockwise_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    chunk_q: int = 512,
    chunk_kv: int = 512,
    base_q_pos: int = 0,
    scale: float | None = None,
) -> torch.Tensor:
    """Online-softmax attention over [B,H,S,D] q and [B,Hkv,Skv,D] k/v
    (v's head dim may differ), the logits times ``scale`` (None: 1 /
    sqrt(D)).

    The baseline computes every (q-chunk, kv-chunk) pair (masked);
    ``causal_block_skip_attention`` truncates the KV range per q-chunk
    instead.
    """
    b, h, sq, d = q.shape
    dv = v.shape[-1]
    skv = k.shape[2]
    k, v = _repeat_kv(k, v, h)
    chunk_q = _pick_chunk(sq, chunk_q)
    chunk_kv = _pick_chunk(skv, chunk_kv)
    nq, nk = sq // chunk_q, skv // chunk_kv
    if scale is None:
        scale = 1.0 / (d**0.5)
    dev = q.device

    q = q.reshape(b, h, nq, chunk_q, d)
    k = k.reshape(b, h, nk, chunk_kv, d)
    v = v.reshape(b, h, nk, chunk_kv, dv)
    q_pos_base = torch.arange(chunk_q, device=dev)
    k_pos_base = torch.arange(chunk_kv, device=dev)

    outs = []
    for qi in range(nq):
        q_blk = q[:, :, qi]
        q_pos = base_q_pos + qi * chunk_q + q_pos_base  # [cq]
        m_c = torch.full((b, h, chunk_q), NEG_INF, dtype=torch.float32, device=dev)
        l_c = torch.zeros((b, h, chunk_q), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, h, chunk_q, dv), dtype=torch.float32, device=dev)
        for ki in range(nk):
            k_blk, v_blk = k[:, :, ki], v[:, :, ki]
            k_pos = ki * chunk_kv + k_pos_base  # [ck]
            logits = torch.einsum("bhqd,bhkd->bhqk", q_blk, k_blk).to(torch.float32) * scale
            mask = torch.ones((chunk_q, chunk_kv), dtype=torch.bool, device=dev)
            if causal:
                mask &= k_pos[None, :] <= q_pos[:, None]
            if window:
                mask &= k_pos[None, :] > q_pos[:, None] - window
            logits = torch.where(mask[None, None], logits, NEG_INF)

            m_new = torch.maximum(m_c, logits.amax(-1))
            p = torch.exp(logits - m_new[..., None])
            alpha = torch.exp(m_c - m_new)
            l_c = l_c * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhqk,bhkd->bhqd", p.to(v_blk.dtype), v_blk
            ).to(torch.float32)
            m_c = m_new
        outs.append((acc / torch.clamp_min(l_c, 1e-30)[..., None]).to(q.dtype))
    out = torch.stack(outs, dim=2)  # [B,H,nq,cq,Dv]
    return out.reshape(b, h, sq, dv)


def shape_refusal(q_shape, k_shape, v_shape, dtype: torch.dtype) -> str | None:
    """Why the kernel does not take causal attention of these shapes and
    dtype, or None if it does: bf16, q [B, H, S, D], k [B, Hkv, S, D] and
    v [B, Hkv, S, Dv] with one S (a prefill from position 0), (D, Dv) in
    ``HEAD_DIMS``, H a multiple of Hkv."""
    if dtype != torch.bfloat16:
        return f"{dtype}: the kernel is built for bfloat16"
    if not (len(q_shape) == len(k_shape) == len(v_shape) == 4):
        return "q, k and v are not [B, H, S, D]"
    (b, h, s, d), (bk, hkv, sk, dk), (bv, hv, sv, dv) = q_shape, k_shape, v_shape
    if not (b == bk == bv and hkv == hv):
        return f"batch or KV heads differ: q {tuple(q_shape)}, k {tuple(k_shape)}, v {tuple(v_shape)}"
    if not s == sk == sv:
        return f"q, k and v lengths differ ({s}, {sk}, {sv}): the kernel prefills from position 0"
    if d != dk:
        return f"head dims differ (q {d}, k {dk})"
    if (d, dv) not in HEAD_DIMS:
        dims = f"head dim {d}" if d == dv else f"head dims differ (q and k {d}, v {dv})"
        return f"{dims}: the kernel is built for (q and k, v) in {HEAD_DIMS}"
    if hkv == 0 or h % hkv:
        return f"{h} query heads over {hkv} KV heads"
    if b * s == 0:
        return "empty"
    return None


def attention_refusal(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str | None:
    """Why the kernel does not take these tensors, or None if it does:
    none requiring grad, one dtype, ``shape_refusal``'s rule, and CUDA
    tensors on one device (a DTensor's shards arrive as local tensors,
    ``models.attention.on_local_heads``)."""
    tensors = (q, k, v)
    if any(t.requires_grad for t in tensors):
        return "a tensor requires grad: the kernel has no backward"
    if len({t.dtype for t in tensors}) > 1:
        return f"dtypes differ: {[t.dtype for t in tensors]}"
    refusal = shape_refusal(q.shape, k.shape, v.shape, q.dtype)
    if refusal is not None:
        return refusal
    if q.device.type != "cuda":
        return f"on {q.device}: the kernel runs on CUDA tensors"
    if any(t.device != q.device for t in tensors):
        return f"devices differ: {[str(t.device) for t in tensors]}"
    return None


def tma_strides(t: torch.Tensor) -> tuple[int, ...] | None:
    """The element strides of a bf16 tensor's leading dims ([B, H, S, D]:
    batch, head, position; MLA's [B, S, D]: batch, position) as the
    kernels' tensor maps take them, or None if TMA cannot read it in
    place: the last dim contiguous, the base 16-byte aligned, the other
    strides multiples of 16 bytes (a dim of one element takes any such
    stride)."""
    if t.stride(-1) != 1 or t.data_ptr() % 16:
        return None
    packed = [math.prod(t.shape[i + 1 :]) for i in range(t.dim() - 1)]
    strides = tuple(p if n == 1 else st for n, st, p in zip(t.shape[:-1], t.stride()[:-1], packed, strict=True))
    return strides if all(st > 0 and st % 8 == 0 for st in strides) else None


#: the kernel's launches (``build.LaunchCounts``)
LAUNCHES = build.LaunchCounts("prefill_attention")

_P, _I = ctypes.c_void_p, ctypes.c_int
_STRIDES = ctypes.POINTER(ctypes.c_longlong)
#: the argument types of csrc/attention_wgmma.cu's entry point
_ARGS = [
    _P, _P, _P, _P,  # q, k, v, out
    _I, _I, _I, _I, _I, _I,  # batch, heads, kv_heads, s_len, dim, v_dim
    _STRIDES, _STRIDES, _STRIDES, _STRIDES,  # q, k, v, out (batch, head, position)
    _I, ctypes.c_float,  # window, scale
    _P,  # stream
]


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int, scale: float) -> torch.Tensor:
    """The kernel on admitted tensors.  Operands that TMA cannot read in
    place are copied contiguous first.  The result is [B, H, S, Dv] laid
    out as [B, S, H, Dv], so merging the heads for the output projection
    is a view."""
    b, h, s, d = q.shape
    dv = v.shape[-1]
    operands = []
    for t in (q, k, v):
        if tma_strides(t) is None:
            t = t.contiguous()
        operands.append(t)
    out = torch.empty((b, s, h, dv), dtype=q.dtype, device=q.device).permute(0, 2, 1, 3)
    arrays = [(ctypes.c_longlong * 3)(*tma_strides(t)) for t in (*operands, out)]
    lib = build.load("gemm")
    with torch.cuda.device(q.device):
        rc = build.bind(lib.repro_prefill_attention, _ARGS)(
            *(t.data_ptr() for t in operands),
            out.data_ptr(),
            b,
            h,
            k.shape[1],
            s,
            d,
            dv,
            *arrays,
            window,
            scale,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    build.check(lib, rc, "prefill attention kernel")
    LAUNCHES.record("prefill_attention")
    return out


def prefill_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    window: int = 0,
    chunk_q: int = 512,
    chunk_kv: int = 512,
    scale: float | None = None,
) -> torch.Tensor:
    """Causal attention of q [B, H, S, D] over k [B, Hkv, S, D], v [B,
    Hkv, S, Dv] from position 0 (``window`` > 0: each position sees its
    last ``window``), the logits times ``scale`` (None: 1 / sqrt(D)),
    [B, H, S, Dv] in q's dtype: on CUDA the kernel, or ValueError where
    ``attention_refusal`` refuses the tensors; on any other device (the
    CPU, the dry run's meta tensors) ``blockwise_attention`` at the given
    chunks."""
    if q.device.type != "cuda":
        tracing.count("attn.plain_calls")
        opts = {} if scale is None else {"scale": scale}
        return blockwise_attention(q, k, v, causal=True, window=window, chunk_q=chunk_q, chunk_kv=chunk_kv, **opts)
    refusal = attention_refusal(q, k, v)
    if refusal is not None:
        raise ValueError(f"prefill attention kernel: {refusal}")
    tracing.count("attn.kernel_calls")
    return _launch(q, k, v, window, 1.0 / (q.shape[-1] ** 0.5) if scale is None else scale)
