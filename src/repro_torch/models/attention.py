"""Attention: GQA/MQA with RoPE, sliding windows, a memory-bounded
blockwise (flash-style) implementation for prefill, and a decode step.

The blockwise implementation chunks both query and key/value axes with an
online-softmax accumulator, so peak memory is O(chunk_q x chunk_kv) per
head instead of O(S^2).  Fully-masked KV chunks are still *computed* in
the baseline; ``causal_block_skip_attention`` skips them.

Port of ``repro.models.attention`` without MLA: ``mla_decode_attention``
and the ``kv_lora_rank`` branches raise ``NotImplementedError`` (ROADMAP
Queue A item 5).  Head order follows the reference: ``jnp.repeat`` of
the KV heads is ``repeat_interleave`` (each KV head serves its
consecutive query heads).  The reference's ``constrain`` calls are the
identity without a sharding policy and are left out.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.ref import torch_dtype
from repro_torch.models import layers as L
from repro_torch.models.cache import MLA_NOT_PORTED
from repro_torch.models.config import ModelConfig
from repro_torch.models.flash import gqa_flash_attention

NEG_INF = -1e30


def init_attention(gen, cfg: ModelConfig, dtype=torch.float32, *, lead=()):
    if cfg.kv_lora_rank:
        raise NotImplementedError(MLA_NOT_PORTED)
    d, h, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    return {
        "q": L.init_dense(gen, d, h * dh, bias=cfg.qkv_bias, dtype=dtype, lead=lead),
        "k": L.init_dense(gen, d, hkv * dh, bias=cfg.qkv_bias, dtype=dtype, lead=lead),
        "v": L.init_dense(gen, d, hkv * dh, bias=cfg.qkv_bias, dtype=dtype, lead=lead),
        "o": L.init_dense(gen, h * dh, d, dtype=dtype, lead=lead),
    }


def _split_heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    b, s, _ = x.shape
    return x.reshape(b, s, n_heads, -1).permute(0, 2, 1, 3)  # [B,H,S,D]


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, s, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b, s, h * d)


def _rope_broadcast(t: torch.Tensor) -> torch.Tensor:
    """[B, S, D/2] -> [B, 1, S, D/2]; [S, D/2] -> [1, 1, S, D/2]."""
    return t[:, None] if t.dim() == 3 else t[None, None]


def qkv_project(params, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor):
    """Returns q [B,H,S,D], k [B,Hkv,S,D], v [B,Hkv,S,D] with RoPE applied,
    plus the MLA cache payload, always (None, None) here."""
    if cfg.kv_lora_rank:
        raise NotImplementedError(MLA_NOT_PORTED)
    dh = cfg.head_dim_
    compute = torch_dtype(cfg.compute_dtype)
    q = _split_heads(L.dense(params["q"], x, compute_dtype=compute), cfg.n_heads)
    k = _split_heads(L.dense(params["k"], x, compute_dtype=compute), cfg.n_kv_heads)
    v = _split_heads(L.dense(params["v"], x, compute_dtype=compute), cfg.n_kv_heads)
    cos, sin = L.rope_tables(positions, dh, cfg.rope_theta)  # [B?,S,D/2]
    cos, sin = _rope_broadcast(cos), _rope_broadcast(sin)
    q = L.apply_rope(q, cos, sin)
    k = L.apply_rope(k, cos, sin)
    return q, k, v, (None, None)


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
) -> torch.Tensor:
    """Online-softmax attention over [B,H,S,D] q and [B,Hkv,Skv,D] k/v.

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


def causal_block_skip_attention(q, k, v, *, window: int = 0, chunk_q=512, chunk_kv=512):
    """Per-q-chunk KV truncation (true skip).

    For q-chunk qi only KV chunks [lo, hi] are touched: hi from causality,
    lo from the sliding window.
    """
    b, h, sq, d = q.shape
    skv = k.shape[2]
    k, v = _repeat_kv(k, v, h)
    chunk_q = _pick_chunk(sq, chunk_q)
    chunk_kv = _pick_chunk(skv, chunk_kv)
    nq = sq // chunk_q
    outs = []
    for qi in range(nq):
        q_blk = q[:, :, qi * chunk_q : (qi + 1) * chunk_q]
        hi = (qi + 1) * chunk_q  # causal upper bound (exclusive)
        lo = 0
        if window:
            lo = max(0, (qi * chunk_q - window) // chunk_kv * chunk_kv)
        out = blockwise_attention(
            q_blk,
            k[:, :, lo:hi],
            v[:, :, lo:hi],
            causal=True,
            window=window,
            chunk_q=chunk_q,
            chunk_kv=min(chunk_kv, hi - lo),
            base_q_pos=qi * chunk_q - lo,
        )
        outs.append(out)
    return torch.cat(outs, dim=2)


def decode_attention(
    q: torch.Tensor,  # [B,H,1,D]
    k_cache: torch.Tensor,  # [B,Hkv,S,D]
    v_cache: torch.Tensor,  # [B,Hkv,S,D]
    cur_len: int,  # tokens valid in the cache
    *,
    window: int = 0,
) -> torch.Tensor:
    """One-token attention over the cache: logits in f32, the weights cast
    to the cache's dtype for the value product, the result in q's dtype."""
    b, h, _, d = q.shape
    s = k_cache.shape[2]
    k_cache, v_cache = _repeat_kv(k_cache, v_cache, h)
    scale = 1.0 / (d**0.5)
    logits = torch.einsum(
        "bhqd,bhkd->bhqk", q.to(torch.float32), k_cache.to(torch.float32)
    ) * scale
    pos = torch.arange(s, device=q.device)
    mask = pos[None, None, None, :] < cur_len
    if window:
        mask &= pos[None, None, None, :] >= cur_len - window
    logits = torch.where(mask, logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(v_cache.dtype), v_cache).to(q.dtype)


def mla_decode_attention(*args, **kwargs):
    """Matrix-absorbed MLA decode: waits for the MLA slice."""
    raise NotImplementedError(MLA_NOT_PORTED)


def attention_block(
    params,
    cfg: ModelConfig,
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    block_skip: bool = False,
) -> torch.Tensor:
    """Full train/prefill attention sub-block (no residual/norm), through
    the flash forward; ``block_skip`` prunes causally-dead KV chunks."""
    q, k, v, _ = qkv_project(params, cfg, x, positions)
    window = cfg.window if cfg.attn_kind == "swa" else 0
    out = gqa_flash_attention(
        q,
        k,
        v,
        causal=True,
        window=window,
        chunk_q=cfg.attn_chunk,
        chunk_kv=cfg.attn_chunk,
        skip=block_skip,
    )
    return L.dense(params["o"], _merge_heads(out), compute_dtype=torch_dtype(cfg.compute_dtype))
