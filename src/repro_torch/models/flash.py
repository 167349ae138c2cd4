"""Memory-efficient (flash-style) attention with a custom backward.

The forward keeps one (q-chunk, kv-chunk) probability block at a time with
an online-softmax accumulator and saves only (out, row-max, row-sum) per
position — O(S·D); the backward recomputes each (q-chunk, kv-chunk)
probability block from them, as FlashAttention does, instead of keeping
every block for autograd.  GQA is handled natively: q is grouped as
[B, Hkv, G, S, D] (query head h = kv head h // G, as ``jnp.repeat`` /
``repeat_interleave`` orders them) and contracted against ungrouped K/V,
so no repeated-KV materialization.

Port of ``repro.models.flash`` as plain torch: the reference's
online-softmax forward and its ``custom_vjp`` backward (``_flash_bwd``),
step for step, so the numerics follow it (not
``scaled_dot_product_attention``).  ``flash_attention`` is a
``torch.autograd.Function`` whose backward is the reference's: ``delta``
per q-chunk, p recomputed per (q-chunk, kv-chunk) from the saved row max
and row sum, f32 accumulators, the same KV range under ``skip``, and the
gradients cast back to the inputs' dtypes.  The reference's
``REPRO_FLASH_UNROLL`` measures XLA's cost analysis and has no meaning
here, so each KV loop is a Python loop over the chunks in range.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def _mask(qpos: torch.Tensor, kpos: torch.Tensor, causal: bool, window: int) -> torch.Tensor:
    m = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool, device=qpos.device)
    if causal:
        m &= kpos[None, :] <= qpos[:, None]
    if window:
        m &= kpos[None, :] > qpos[:, None] - window
    return m


def _div_chunk(s: int, target: int) -> int:
    c = min(target, s)
    while s % c:
        c -= 1
    return c


def _kv_range(qi, cq, ck, nk, causal, window, base_q_pos, skip):
    """Static KV-chunk range for q-chunk qi (the block-skip optimization).

    With skip=False (baseline) every KV chunk is visited (masked), matching
    a naive dense schedule; skip=True prunes causally-dead and
    out-of-window chunks."""
    if not skip:
        return 0, nk
    hi = nk
    lo = 0
    if causal:
        hi = min(nk, (base_q_pos + (qi + 1) * cq - 1) // ck + 1)
    if window:
        lo = max(0, (base_q_pos + qi * cq - window) // ck)
    return lo, max(hi, lo + 1)


def _flash_fwd_impl(q, k, v, causal, window, chunk_q, chunk_kv, base_q_pos, skip):
    """q [B, Hkv, G, Sq, D], k [B, Hkv, Skv, D], v [B, Hkv, Skv, Dv] ->
    (out [B, Hkv, G, Sq, Dv] in q's dtype, (row max, row sum) in f32)."""
    b, hk, g, sq, d = q.shape
    skv, dv = k.shape[2], v.shape[-1]
    cq = _div_chunk(sq, chunk_q)
    ck = _div_chunk(skv, chunk_kv)
    nq, nk = sq // cq, skv // ck
    scale = 1.0 / (d**0.5)
    dev = q.device

    q_r = q.reshape(b, hk, g, nq, cq, d)
    k_r = k.reshape(b, hk, nk, ck, d)
    v_r = v.reshape(b, hk, nk, ck, dv)

    outs, ms, ls = [], [], []
    for qi in range(nq):
        q_blk = q_r[:, :, :, qi]
        qpos = base_q_pos + qi * cq + torch.arange(cq, device=dev)
        m_c = torch.full((b, hk, g, cq), NEG_INF, dtype=torch.float32, device=dev)
        l_c = torch.zeros((b, hk, g, cq), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, hk, g, cq, dv), dtype=torch.float32, device=dev)

        lo, hi = _kv_range(qi, cq, ck, nk, causal, window, base_q_pos, skip)
        for ki in range(lo, hi):
            k_blk = k_r[:, :, ki]
            v_blk = v_r[:, :, ki]
            kpos = ki * ck + torch.arange(ck, device=dev)
            logits = torch.einsum("bhgqd,bhkd->bhgqk", q_blk, k_blk).to(torch.float32) * scale
            msk = _mask(qpos, kpos, causal, window)
            logits = torch.where(msk[None, None, None], logits, NEG_INF)
            m_new = torch.maximum(m_c, logits.amax(-1))
            p = torch.exp(logits - m_new[..., None])
            alpha = torch.exp(m_c - m_new)
            l_c = l_c * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhgqk,bhkd->bhgqd", p.to(v_blk.dtype), v_blk
            ).to(torch.float32)
            m_c = m_new
        outs.append((acc / torch.clamp_min(l_c, 1e-30)[..., None]).to(q.dtype))
        ms.append(m_c)
        ls.append(l_c)

    out = torch.stack(outs, dim=3).reshape(b, hk, g, sq, dv)
    m_all = torch.stack(ms, dim=3).reshape(b, hk, g, sq)
    l_all = torch.stack(ls, dim=3).reshape(b, hk, g, sq)
    return out, (m_all, l_all)


def _flash_bwd(causal, window, chunk_q, chunk_kv, base_q_pos, skip, res, g_out):
    """(dq, dk, dv) from the saved (q, k, v, out, row max, row sum) and
    the output's gradient, each in its input's dtype."""
    q, k, v, out, m_all, l_all = res
    b, hk, grp, sq, d = q.shape
    skv, dv = k.shape[2], v.shape[-1]
    cq = _div_chunk(sq, chunk_q)
    ck = _div_chunk(skv, chunk_kv)
    nq, nk = sq // cq, skv // ck
    scale = 1.0 / (d**0.5)
    dev = q.device
    f32 = torch.float32

    q_r = q.reshape(b, hk, grp, nq, cq, d)
    o_r = out.reshape(b, hk, grp, nq, cq, dv)
    go_r = g_out.reshape(b, hk, grp, nq, cq, dv)
    m_r = m_all.reshape(b, hk, grp, nq, cq)
    l_r = l_all.reshape(b, hk, grp, nq, cq)
    k_r = k.reshape(b, hk, nk, ck, d)
    v_r = v.reshape(b, hk, nk, ck, dv)

    dq = torch.zeros((b, hk, grp, nq, cq, d), dtype=f32, device=dev)
    dk = torch.zeros((b, hk, nk, ck, d), dtype=f32, device=dev)
    dv_ = torch.zeros((b, hk, nk, ck, dv), dtype=f32, device=dev)

    for qi in range(nq):
        q_blk = q_r[:, :, :, qi]
        go_blk = go_r[:, :, :, qi].to(f32)
        o_blk = o_r[:, :, :, qi].to(f32)
        m_blk = m_r[:, :, :, qi]
        l_blk = torch.clamp_min(l_r[:, :, :, qi], 1e-30)
        delta = (go_blk * o_blk).sum(-1)  # [b,hk,g,cq]
        qpos = base_q_pos + qi * cq + torch.arange(cq, device=dev)
        lo, hi = _kv_range(qi, cq, ck, nk, causal, window, base_q_pos, skip)
        dq_acc = torch.zeros((b, hk, grp, cq, d), dtype=f32, device=dev)
        for ki in range(lo, hi):
            k_blk = k_r[:, :, ki]
            v_blk = v_r[:, :, ki]
            kpos = ki * ck + torch.arange(ck, device=dev)
            logits = torch.einsum("bhgqd,bhkd->bhgqk", q_blk, k_blk).to(f32) * scale
            msk = _mask(qpos, kpos, causal, window)
            logits = torch.where(msk[None, None, None], logits, NEG_INF)
            p = torch.exp(logits - m_blk[..., None]) / l_blk[..., None]
            dvk = torch.einsum("bhgqk,bhgqd->bhkd", p, go_blk)
            dp = torch.einsum("bhgqd,bhkd->bhgqk", go_blk, v_blk.to(f32))
            ds = p * (dp - delta[..., None]) * scale
            dq_acc = dq_acc + torch.einsum("bhgqk,bhkd->bhgqd", ds, k_blk.to(f32))
            dk[:, :, ki] += torch.einsum("bhgqk,bhgqd->bhkd", ds, q_blk.to(f32))
            dv_[:, :, ki] += dvk
        dq[:, :, :, qi] = dq_acc

    return (
        dq.reshape(q.shape).to(q.dtype),
        dk.reshape(k.shape).to(k.dtype),
        dv_.reshape(v.shape).to(v.dtype),
    )


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, chunk_q, chunk_kv, base_q_pos, skip):
        out, (m_all, l_all) = _flash_fwd_impl(
            q, k, v, causal, window, chunk_q, chunk_kv, base_q_pos, skip
        )
        ctx.save_for_backward(q, k, v, out, m_all, l_all)
        ctx.statics = (causal, window, chunk_q, chunk_kv, base_q_pos, skip)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_out):
        dq, dk, dv = _flash_bwd(*ctx.statics, ctx.saved_tensors, g_out)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention(
    q: torch.Tensor,  # [B, Hkv, G, S, D]
    k: torch.Tensor,  # [B, Hkv, S, D]
    v: torch.Tensor,  # [B, Hkv, S, Dv]
    causal: bool = True,
    window: int = 0,
    chunk_q: int = 512,
    chunk_kv: int = 512,
    base_q_pos: int = 0,
    skip: bool = False,  # skip fully-masked KV chunks
) -> torch.Tensor:
    """Flash attention [B, Hkv, G, S, Dv] whose backward recomputes the
    probability blocks (O(S·D) saved for autograd)."""
    return _FlashAttention.apply(q, k, v, causal, window, chunk_q, chunk_kv, base_q_pos, skip)


def gqa_flash_attention(
    q: torch.Tensor,  # [B, H, S, D]
    k: torch.Tensor,  # [B, Hkv, S, D]
    v: torch.Tensor,  # [B, Hkv, S, Dv]
    *,
    causal: bool = True,
    window: int = 0,
    chunk_q: int = 512,
    chunk_kv: int = 512,
    skip: bool = False,
) -> torch.Tensor:
    """[B,H,S,D] wrapper: groups query heads over the KV heads."""
    b, h, s, d = q.shape
    hkv = k.shape[1]
    g = h // hkv
    qg = q.reshape(b, hkv, g, s, d)
    out = flash_attention(qg, k, v, causal, window, chunk_q, chunk_kv, 0, skip)
    return out.reshape(b, h, s, out.shape[-1])
