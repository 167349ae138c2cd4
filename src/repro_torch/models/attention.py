"""Attention: GQA/MQA with RoPE, sliding windows, MLA compressed KV, a
memory-bounded blockwise (flash-style) implementation for prefill, and a
decode step.

The blockwise implementation chunks both query and key/value axes with an
online-softmax accumulator, so peak memory is O(chunk_q x chunk_kv) per
head instead of O(S^2).  Fully-masked KV chunks are still *computed* in
the baseline; ``causal_block_skip_attention`` skips them.

Port of ``repro.models.attention``, MLA included.  Head order follows
the reference: ``jnp.repeat`` of the KV heads is ``repeat_interleave``
(each KV head serves its consecutive query heads).  The reference's
``constrain`` calls lay out q, k, v and the output on DTensors (batch on
data, heads on model); the attention itself then runs on each shard's
own heads under ``local_map`` (``on_local_heads``), and a decode over a
cache whose positions are sharded combines its shards' softmax partials
(``_sharded_decode``).  MLA's four projections (q, kv_down, k_up, v_up) go through
``layers.dense`` and so through the scheduled kernel; its absorbed
decode contracts the up-projection weights directly, as the reference's
einsums do.
"""

from __future__ import annotations

import functools

import torch
from torch.distributed.tensor import DTensor, Shard

from repro_torch.kernels.ref import torch_dtype
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.flash import gqa_flash_attention
from repro_torch.parallel.policy import constrain, gather_fsdp, heads_axis, run_local

NEG_INF = -1e30


def init_attention(gen, cfg: ModelConfig, dtype=torch.float32, *, lead=()):
    d, h, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    if cfg.kv_lora_rank:
        r, dr = cfg.kv_lora_rank, cfg.qk_rope_dim
        return {
            # q: per-head nope + rope parts
            "q": L.init_dense(gen, d, h * (dh + dr), bias=cfg.qkv_bias, dtype=dtype, lead=lead),
            # kv_down: latent (r) + shared k_rope (dr)
            "kv_down": L.init_dense(gen, d, r + dr, dtype=dtype, lead=lead),
            "k_up": L.init_dense(gen, r, h * dh, dtype=dtype, lead=lead),
            "v_up": L.init_dense(gen, r, h * dh, dtype=dtype, lead=lead),
            "o": L.init_dense(gen, h * dh, d, dtype=dtype, lead=lead),
        }
    return {
        "q": L.init_dense(gen, d, h * dh, bias=cfg.qkv_bias, dtype=dtype, lead=lead),
        "k": L.init_dense(gen, d, hkv * dh, bias=cfg.qkv_bias, dtype=dtype, lead=lead),
        "v": L.init_dense(gen, d, hkv * dh, bias=cfg.qkv_bias, dtype=dtype, lead=lead),
        "o": L.init_dense(gen, h * dh, d, dtype=dtype, lead=lead),
    }


def _split_heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    b, s, _ = x.shape
    x = constrain(x, "dp", None, heads_axis(n_heads))  # whole heads per shard
    return x.reshape(b, s, n_heads, -1).permute(0, 2, 1, 3)  # [B,H,S,D]


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, s, d = x.shape
    # whole heads per shard, in the backward too
    return constrain(x.permute(0, 2, 1, 3).reshape(b, s, h * d), "dp", None, heads_axis(h))


def _rope_broadcast(t: torch.Tensor) -> torch.Tensor:
    """[B, S, D/2] -> [B, 1, S, D/2]; [S, D/2] -> [1, 1, S, D/2]."""
    return t[:, None] if t.dim() == 3 else t[None, None]


def qkv_project(params, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor):
    """Returns q [B,H,S,Dq], k [B,Hkv,S,Dq], v [B,Hkv,S,Dv] with RoPE
    applied, plus the MLA cache payload (latent, k_rope) or (None, None).

    MLA (decoupled RoPE): q/k = [nope part | rope(rope part)]; the rope
    part of k is one shared head derived from x beside the latent, so the
    latent stays position-free and decode can absorb the up-projections
    (DeepSeek-V2 §2.1)."""
    dh = cfg.head_dim_
    compute = torch_dtype(cfg.compute_dtype)
    if cfg.kv_lora_rank:
        r, dr = cfg.kv_lora_rank, cfg.qk_rope_dim
        q_all = _split_heads(L.dense(params["q"], x, compute_dtype=compute), cfg.n_heads)
        q_nope, q_rope = q_all[..., :dh], q_all[..., dh:]
        down = L.dense(params["kv_down"], x, compute_dtype=compute)  # [B,S,r+dr]
        latent, k_rope = down[..., :r], down[..., r:]
        cos, sin = L.rope_tables(positions, dr, cfg.rope_theta)
        cos, sin = _rope_broadcast(cos), _rope_broadcast(sin)
        q_rope = L.apply_rope(q_rope, cos, sin)
        k_rope_r = L.apply_rope(k_rope[:, None], cos, sin)  # [B,1,S,dr]
        k_nope = _split_heads(L.dense(params["k_up"], latent, compute_dtype=compute), cfg.n_heads)
        v = _split_heads(L.dense(params["v_up"], latent, compute_dtype=compute), cfg.n_heads)
        q = torch.cat([q_nope, q_rope], dim=-1)
        k = torch.cat([k_nope, k_rope_r.expand(*k_nope.shape[:-1], dr)], dim=-1)
        q, k, v = (constrain(t, "dp", "tp", None, None) for t in (q, k, v))
        return q, k, v, (latent, k_rope_r[:, 0])
    q = _split_heads(L.dense(params["q"], x, compute_dtype=compute), cfg.n_heads)
    k = _split_heads(L.dense(params["k"], x, compute_dtype=compute), cfg.n_kv_heads)
    v = _split_heads(L.dense(params["v"], x, compute_dtype=compute), cfg.n_kv_heads)
    cos, sin = L.rope_tables(positions, dh, cfg.rope_theta)  # [B?,S,D/2]
    cos, sin = _rope_broadcast(cos), _rope_broadcast(sin)
    q = L.apply_rope(q, cos, sin)
    k = L.apply_rope(k, cos, sin)
    # anchor head-parallel attention: batch on data, heads on model (MQA/GQA
    # kv heads that don't divide the axis stay replicated via the policy)
    q, k, v = (constrain(t, "dp", "tp", None, None) for t in (q, k, v))
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


def on_local_heads(fn, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``fn(q, k, v)`` -> [B, H, S, Dv], an attention over whole heads.
    On DTensors laid out by ``qkv_project`` (batch on data, heads on
    model) it runs under ``local_map`` on each shard's own batch rows and
    heads, so its chunk loop never meets a collective; KV heads that the
    model axis does not divide are repeated to the query heads first, so
    each shard holds the KV heads of its own query heads.  Plain tensors
    go straight to ``fn``."""
    h = q.shape[1]
    if isinstance(q, DTensor) and k.shape[1] != h and heads_axis(k.shape[1]) is None and heads_axis(h) is not None:
        k, v = _repeat_kv(k, v, h)
        k, v = (constrain(t, "dp", "tp", None, None) for t in (k, v))
    return run_local(fn, q, k, v)


def decode_attention(
    q: torch.Tensor,  # [B,H,1,D]
    k_cache: torch.Tensor,  # [B,Hkv,S,D]
    v_cache: torch.Tensor,  # [B,Hkv,S,D]
    cur_len: int,  # tokens valid in the cache
    *,
    window: int = 0,
) -> torch.Tensor:
    """One-token attention over the cache: logits in f32, the weights cast
    to the cache's dtype for the value product, the result in q's dtype.
    On DTensor caches see ``_sharded_decode``."""
    if isinstance(k_cache, DTensor):
        return _sharded_decode(q, k_cache, v_cache, cur_len, window=window)
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


def _seq_split(cache: torch.Tensor, seq_dim: int):
    """(mesh, the model mesh dim index or None): the index when the
    cache's sequence dim is sharded over the model axis
    (sequence-parallel decode), else None."""
    mesh = cache.device_mesh
    names = mesh.mesh_dim_names
    tp = names.index("model") if "model" in names else None
    if tp is not None and cache.placements[tp] == Shard(seq_dim):
        return mesh, tp
    return mesh, None


def _softmax_attend(logits: torch.Tensor, values: torch.Tensor, group):
    """softmax(logits) @ values over the last logits dim, where each rank
    of ``group`` (a (mesh, dim) pair, or None for one rank) holds a slice
    of the positions: row maxes, row sums and the weighted values are
    all-reduced over the group (flash-decoding's combine)."""
    if group is None:
        return torch.softmax(logits, dim=-1), None
    from torch.distributed import _functional_collectives as funcol

    m = funcol.all_reduce(logits.amax(-1, keepdim=True), "max", group)
    p = torch.exp(logits - m)
    den = funcol.all_reduce(p.sum(-1, keepdim=True), "sum", group)
    return p, den


def _local_positions(mesh, tp, s_local: int, device) -> torch.Tensor:
    """The cache positions this rank holds: its slice of the model axis's
    sequence shards (all of them without one)."""
    off = mesh.get_local_rank(tp) * s_local if tp is not None else 0
    return off + torch.arange(s_local, device=device)


def _sharded_decode(q, k_cache, v_cache, cur_len: int, *, window: int = 0):
    """``decode_attention`` over DTensor caches.  Each shard attends its
    own batch rows under ``local_map``: KV heads over the model axis (the
    query heads with them), or, when the cache's sequence dim is sharded
    there (sequence-parallel decode), every head over its own slice of
    positions, combined across the model axis as flash-decoding does."""
    mesh, tp = _seq_split(k_cache, 2)
    if tp is None and heads_axis(k_cache.shape[1]) is not None:
        return run_local(
            functools.partial(decode_attention, cur_len=cur_len, window=window), q, k_cache, v_cache
        )
    q = constrain(q, "dp", None, None, None)  # every head beside the cache slice
    group = (mesh, tp) if tp is not None else None

    def local(q, k_cache, v_cache):
        h, d = q.shape[1], q.shape[-1]
        k_cache, v_cache = _repeat_kv(k_cache, v_cache, h)
        scale = 1.0 / (d**0.5)
        logits = torch.einsum(
            "bhqd,bhkd->bhqk", q.to(torch.float32), k_cache.to(torch.float32)
        ) * scale
        pos = _local_positions(mesh, tp, k_cache.shape[2], q.device)
        mask = pos[None, None, None, :] < cur_len
        if window:
            mask &= pos[None, None, None, :] >= cur_len - window
        logits = torch.where(mask, logits, NEG_INF)
        p, den = _softmax_attend(logits, v_cache, group)
        out = torch.einsum("bhqk,bhkd->bhqd", p.to(v_cache.dtype), v_cache)
        if den is not None:
            from torch.distributed import _functional_collectives as funcol

            out = funcol.all_reduce(out.to(torch.float32), "sum", group) / den
        return out.to(q.dtype)

    out = run_local(local, q, k_cache, v_cache)
    return constrain(out, "dp", "tp", None, None)


def mla_decode_attention(
    params,
    cfg: ModelConfig,
    q_nope: torch.Tensor,  # [B,H,1,dh]
    q_rope: torch.Tensor,  # [B,H,1,dr] (already rotated)
    latent_cache: torch.Tensor,  # [B,S,r]
    k_rope_cache: torch.Tensor,  # [B,S,dr] (already rotated)
    cur_len: int,
) -> torch.Tensor:
    """Matrix-absorbed MLA decode: attention runs in latent space.

    score_s = (W_uk^T q)^T . latent_s + q_rope . k_rope_s
    out     = W_uv^T-projection of (sum_s p_s latent_s)

    Per-token cost is O(S.r) instead of O(S.H.dh) with re-expansion; all
    of it in f32, the result in q's dtype."""
    b, h, _, dh = q_nope.shape
    r, dr = cfg.kv_lora_rank, cfg.qk_rope_dim
    f32 = torch.float32
    w_ku = gather_fsdp(params["k_up"]["w"]).reshape(r, h, dh).to(f32)
    w_vu = gather_fsdp(params["v_up"]["w"]).reshape(r, h, dh).to(f32)
    scale = 1.0 / ((dh + dr) ** 0.5)
    latent = latent_cache.to(f32)

    q_lat = torch.einsum("bhqd,rhd->bhqr", q_nope.to(f32), w_ku)
    if isinstance(latent, DTensor):
        # every head beside each shard's slice of the sequence-parallel latent
        q_lat = constrain(q_lat, "dp", None, None, None)
        q_rope = constrain(q_rope, "dp", None, None, None)
        ctx_lat = run_local(
            functools.partial(_mla_context, scale=scale, cur_len=cur_len, split=_seq_split(latent, 1)),
            q_lat,
            q_rope,
            latent,
            k_rope_cache,
        )
        ctx_lat = constrain(ctx_lat, "dp", "tp", None, None)
    else:
        ctx_lat = _mla_context(q_lat, q_rope, latent, k_rope_cache, scale=scale, cur_len=cur_len)
    out = torch.einsum("bhqr,rhd->bhqd", ctx_lat, w_vu)
    return out.to(q_nope.dtype)


def _mla_context(q_lat, q_rope, latent, k_rope_cache, *, scale: float, cur_len: int, split=None):
    """The softmax-weighted latent [B, H, 1, r] of the absorbed MLA
    decode, in f32; with ``split`` (``_seq_split`` of a sequence-parallel
    latent) over this rank's slice of the positions, combined across the
    model axis."""
    f32 = torch.float32
    mesh, tp = split if split is not None else (None, None)
    latent = latent.to(f32)
    logits = torch.einsum("bhqr,bsr->bhqs", q_lat, latent)
    logits = logits + torch.einsum("bhqd,bsd->bhqs", q_rope.to(f32), k_rope_cache.to(f32))
    logits = logits * scale
    pos = _local_positions(mesh, tp, latent.shape[1], q_lat.device)
    mask = pos[None, None, None, :] < cur_len
    logits = torch.where(mask, logits, NEG_INF)
    group = (mesh, tp) if tp is not None else None
    p, den = _softmax_attend(logits, latent, group)
    ctx_lat = torch.einsum("bhqs,bsr->bhqr", p, latent)
    if den is not None:
        from torch.distributed import _functional_collectives as funcol

        ctx_lat = funcol.all_reduce(ctx_lat, "sum", group) / den
    return ctx_lat


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
    out = on_local_heads(
        functools.partial(
            gqa_flash_attention,
            causal=True,
            window=window,
            chunk_q=cfg.attn_chunk,
            chunk_kv=cfg.attn_chunk,
            skip=block_skip,
        ),
        q,
        k,
        v,
    )
    out = constrain(out, "dp", "tp", None, None)
    return L.dense(params["o"], _merge_heads(out), compute_dtype=torch_dtype(cfg.compute_dtype))
