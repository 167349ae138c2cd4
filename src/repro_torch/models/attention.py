"""Attention: GQA/MQA with RoPE, sliding windows, MLA compressed KV, a
memory-bounded blockwise (flash-style) implementation for prefill, and a
decode step.

The blockwise implementation (``repro_torch.kernels.attention``, the
plain version of the prefill's fused kernel, imported here) chunks both
query and key/value axes with an online-softmax accumulator, so peak
memory is O(chunk_q x chunk_kv) per head instead of O(S^2).
Fully-masked KV chunks are still *computed* in the baseline;
``causal_block_skip_attention`` skips them.  ``prefill_core`` is the
serving prefill's choice between that kernel and the blockwise loop.

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
einsums do, and attends the latent cache through ``kernels.mla`` where
``mla_decode_kernel_refusal`` takes the cache (the kernel, up to a
length read on the device), else through the plain f32 arithmetic.
"""

from __future__ import annotations

import functools

import torch
from torch.distributed.tensor import DTensor, Shard

from repro_torch import tracing
from repro_torch.kernels import attention as KA
from repro_torch.kernels import mla as KM
from repro_torch.kernels.attention import NEG_INF, _pick_chunk, _repeat_kv, blockwise_attention
from repro_torch.kernels.ref import torch_dtype
from repro_torch.models import layers as L
from repro_torch.models.config import MLAConfig, ModelConfig
from repro_torch.models.flash import gqa_flash_attention
from repro_torch.parallel.policy import constrain, gather_fsdp, heads_axis, run_local


def init_attention(gen, cfg: ModelConfig, dtype=torch.float32, *, lead=()):
    d, h, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    if cfg.kv_lora_rank:
        r, dr = cfg.kv_lora_rank, cfg.qk_rope_dim
        published = isinstance(cfg, MLAConfig)
        qr = cfg.q_lora_rank if published else 0
        p = {}
        if qr:  # q-LoRA: q_a, RMSNorm, q_b
            p["q_a"] = L.init_dense(gen, d, qr, dtype=dtype, lead=lead)
            p["q_norm"] = L.init_rmsnorm(qr, dtype, device=gen.device, lead=lead)
            p["q_b"] = L.init_dense(gen, qr, h * (dh + dr), dtype=dtype, lead=lead)
        else:  # q: per-head nope + rope parts
            p["q"] = L.init_dense(gen, d, h * (dh + dr), bias=cfg.qkv_bias, dtype=dtype, lead=lead)
        # kv_down: latent (r) + shared k_rope (dr)
        p["kv_down"] = L.init_dense(gen, d, r + dr, dtype=dtype, lead=lead)
        if published:
            p["kv_norm"] = L.init_rmsnorm(r, dtype, device=gen.device, lead=lead)
        p["k_up"] = L.init_dense(gen, r, h * dh, dtype=dtype, lead=lead)
        p["v_up"] = L.init_dense(gen, r, h * dh, dtype=dtype, lead=lead)
        p["o"] = L.init_dense(gen, h * dh, d, dtype=dtype, lead=lead)
        return p
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


def softmax_scale(cfg: ModelConfig) -> float:
    """The attention's softmax scale: 1 / sqrt(q's head dim) (MLA: the
    nope and rope parts together), times YaRN's mscale(factor,
    ``mscale_all_dim``) squared where ``cfg`` scales RoPE so."""
    d = cfg.head_dim_ + (cfg.qk_rope_dim if cfg.kv_lora_rank else 0)
    scale = 1.0 / (d**0.5)
    yarn = cfg.rope_scaling if isinstance(cfg, MLAConfig) else None
    if yarn is not None and yarn.mscale_all_dim:
        m = L.yarn_mscale(yarn.factor, yarn.mscale_all_dim)
        scale *= m * m
    return scale


def mla_project(params, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor):
    """MLA's projections below the up-projections: q [B, H, S, dh + dr]
    (the nope part, then the rope part rotated; batch on data, heads on
    model), the latent [B, S, r] (normed where the configuration is the
    published one) and k_rope [B, S, dr] rotated (unrotated where the
    configuration has no positional encoding: Kimi-Linear's NoPE MLA).
    The spans ``mla.q`` (q-LoRA or the direct q, and its RoPE) and
    ``mla.kv_down`` (the latent and k_rope, the norm and RoPE)."""
    dh, r, dr = cfg.head_dim_, cfg.kv_lora_rank, cfg.qk_rope_dim
    compute = torch_dtype(cfg.compute_dtype)
    yarn = cfg.rope_scaling if isinstance(cfg, MLAConfig) else None
    rotate = None  # NoPE (``MLAConfig.rope`` false): the rope dims stay, unrotated
    if not isinstance(cfg, MLAConfig) or cfg.rope:
        cos, sin = L.rope_tables(positions, dr, cfg.rope_theta, yarn)
        cos, sin = _rope_broadcast(cos), _rope_broadcast(sin)

        def rotate(t):
            return L.apply_rope(t, cos, sin)

    with tracing.span("mla.q"):
        if "q_a" in params:
            c = L.rmsnorm(params["q_norm"], L.dense(params["q_a"], x, compute_dtype=compute), cfg.norm_eps)
            q_all = L.dense(params["q_b"], c, compute_dtype=compute)
        else:
            q_all = L.dense(params["q"], x, compute_dtype=compute)
        q_all = _split_heads(q_all, cfg.n_heads)
        q = q_all if rotate is None else torch.cat([q_all[..., :dh], rotate(q_all[..., dh:])], dim=-1)
        q = constrain(q, "dp", "tp", None, None)
    with tracing.span("mla.kv_down"):
        down = L.dense(params["kv_down"], x, compute_dtype=compute)  # [B,S,r+dr]
        latent, k_rope = down[..., :r], down[..., r:]
        if "kv_norm" in params:
            latent = L.rmsnorm(params["kv_norm"], latent, cfg.norm_eps)
        if rotate is not None:
            k_rope = rotate(k_rope[:, None])[:, 0]  # one head shared by all
    return q, latent, k_rope


def qkv_project(params, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor):
    """Returns q [B,H,S,Dq], k [B,Hkv,S,Dq], v [B,Hkv,S,Dv] with RoPE
    applied, plus the MLA cache payload (latent, k_rope) or (None, None).

    MLA (decoupled RoPE): q/k = [nope part | rope(rope part)]; the rope
    part of k is one shared head derived from x beside the latent, so the
    latent stays position-free and decode can absorb the up-projections
    (DeepSeek-V2 §2.1).  Its up-projections run in the span ``mla.up``;
    the decode step never calls this (``mla_project`` and
    ``mla_decode_attention``)."""
    dh = cfg.head_dim_
    compute = torch_dtype(cfg.compute_dtype)
    if cfg.kv_lora_rank:
        dr = cfg.qk_rope_dim
        q, latent, k_rope = mla_project(params, cfg, x, positions)
        with tracing.span("mla.up"):
            k_nope = _split_heads(L.dense(params["k_up"], latent, compute_dtype=compute), cfg.n_heads)
            v = _split_heads(L.dense(params["v_up"], latent, compute_dtype=compute), cfg.n_heads)
            k = torch.cat([k_nope, k_rope[:, None].expand(*k_nope.shape[:-1], dr)], dim=-1)
        k, v = (constrain(t, "dp", "tp", None, None) for t in (k, v))
        return q, k, v, (latent, k_rope)
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


def prefill_kernel_refusal(cfg: ModelConfig) -> str | None:
    """Why the prefill attention kernel does not take ``cfg``'s attention
    layers, or None if it does: ``kernels.attention.shape_refusal`` of the
    q, k and v that ``qkv_project`` gives in the compute dtype (MLA: every
    head's k carries the rope part beside its own, v does not, so q and k
    have 192 dims where v has 128 at DeepSeek-V2's sizes).  The length
    and batch are any: the rule asks only that q, k and v share them."""
    h, dh = cfg.n_heads, cfg.head_dim_
    dq = dh + (cfg.qk_rope_dim if cfg.kv_lora_rank else 0)
    hkv = h if cfg.kv_lora_rank else cfg.n_kv_heads
    return KA.shape_refusal((1, h, 1, dq), (1, hkv, 1, dq), (1, hkv, 1, dh), torch_dtype(cfg.compute_dtype))


def prefill_core(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The prefill's causal attention of ``qkv_project``'s q, k, v under
    ``cfg`` (its window, chunk and ``softmax_scale``), [B, H, S, Dv]; call
    it under ``on_local_heads``.  Where ``prefill_kernel_refusal`` takes
    the configuration, ``kernels.attention.prefill_attention`` (the kernel
    on the card, the plain version elsewhere, each counted there); else
    (f32, MLA at other sizes, head dim 256) ``blockwise_attention`` on any
    device, counted as ``attn.plain_calls``."""
    window = cfg.window if cfg.attn_kind == "swa" else 0
    opts = {"window": window, "chunk_q": cfg.attn_chunk, "chunk_kv": cfg.attn_chunk, "scale": softmax_scale(cfg)}
    if prefill_kernel_refusal(cfg) is None:
        return KA.prefill_attention(q, k, v, **opts)
    tracing.count("attn.plain_calls")
    return blockwise_attention(q, k, v, causal=True, **opts)


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
    pos = torch.arange(k_cache.shape[2], device=q.device)
    return _decode_core(q, k_cache, v_cache, cur_len, window, pos, None)


def _decode_core(q, k_cache, v_cache, cur_len: int, window: int, pos: torch.Tensor, group) -> torch.Tensor:
    """``decode_attention``'s arithmetic over the cache positions ``pos``
    held here; with ``group`` (a (mesh, dim) pair) each rank of it holds a
    slice of the positions, and the softmax combines across the group."""
    h, d = q.shape[1], q.shape[-1]
    k_cache, v_cache = _repeat_kv(k_cache, v_cache, h)
    scale = 1.0 / (d**0.5)
    logits = torch.einsum(
        "bhqd,bhkd->bhqk", q.to(torch.float32), k_cache.to(torch.float32)
    ) * scale
    mask = pos[None, None, None, :] < cur_len
    if window:
        mask &= pos[None, None, None, :] >= cur_len - window
    logits = torch.where(mask, logits, NEG_INF)
    if group is None:
        p = torch.softmax(logits, dim=-1)
        return torch.einsum("bhqk,bhkd->bhqd", p.to(v_cache.dtype), v_cache).to(q.dtype)
    # flash-decoding's combine: row maxes and sums all-reduced over the
    # group, then the weighted values
    from torch.distributed import _functional_collectives as funcol

    m = funcol.all_reduce(logits.amax(-1, keepdim=True), "max", group)
    p = torch.exp(logits - m)
    den = funcol.all_reduce(p.sum(-1, keepdim=True), "sum", group)
    out = torch.einsum("bhqk,bhkd->bhqd", p.to(v_cache.dtype), v_cache)
    return (funcol.all_reduce(out.to(torch.float32), "sum", group) / den).to(q.dtype)


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
        pos = _local_positions(mesh, tp, k_cache.shape[2], q.device)
        return _decode_core(q, k_cache, v_cache, cur_len, window, pos, group)

    out = run_local(local, q, k_cache, v_cache)
    return constrain(out, "dp", "tp", None, None)


def mla_decode_kernel_refusal(cfg: ModelConfig, latent: torch.Tensor) -> str | None:
    """Why the MLA decode kernel does not take ``cfg``'s decode over the
    latent cache ``latent``, or None if it does: a plain (not DTensor)
    tensor, compute in bf16 (the kernel rounds q_lat to it), and
    ``kernels.mla.cache_refusal``'s rule (a bf16 CUDA cache at the (r,
    dr) the kernel is built for).  The length and batch are any."""
    if isinstance(latent, DTensor):
        return "a DTensor latent: each shard attends its own slice, combined across the mesh"
    compute = torch_dtype(cfg.compute_dtype)
    if compute != torch.bfloat16:
        return f"compute in {compute}: the kernel rounds q to bfloat16"
    return KM.cache_refusal(latent, cfg.qk_rope_dim)


def mla_decode_attention(
    params,
    cfg: ModelConfig,
    q_nope: torch.Tensor,  # [B,H,1,dh]
    q_rope: torch.Tensor,  # [B,H,1,dr] (already rotated)
    latent_cache: torch.Tensor,  # [B,S,r]
    k_rope_cache: torch.Tensor,  # [B,S,dr] (already rotated)
    cur_len,  # positions to attend: an int, or a device tensor of one element
) -> torch.Tensor:
    """Matrix-absorbed MLA decode: attention runs in latent space.

    score_s = (W_uk^T q)^T . latent_s + q_rope . k_rope_s
    out     = W_uv^T-projection of (sum_s p_s latent_s)

    Per-token cost is O(S.r) instead of O(S.H.dh) with re-expansion; the
    absorbing products in f32, the result in q's dtype; the scale is
    ``softmax_scale``'s.  Where ``mla_decode_kernel_refusal`` takes the
    cache, the attention is ``kernels.mla.mla_decode`` on q_lat rounded to
    bf16, over the cache in place up to ``cur_len`` (read on the device);
    else the plain f32 arithmetic over every position under a mask
    (``kernels.mla.mla_decode_plain``; a sequence-parallel DTensor latent
    on each shard's slice, combined across the model axis), counted as
    ``mla.plain_calls``.  Every product takes contiguous operands, so that
    a DTensor run (its redistributions lay local tensors out
    contiguously) and a plain run hand their products one layout."""
    b, h, _, dh = q_nope.shape
    r = cfg.kv_lora_rank
    f32 = torch.float32
    w_ku = gather_fsdp(params["k_up"]["w"]).reshape(r, h, dh).to(f32)
    w_vu = gather_fsdp(params["v_up"]["w"]).reshape(r, h, dh).to(f32)
    scale = softmax_scale(cfg)
    q_lat = torch.einsum("bhqd,rhd->bhqr", q_nope.to(f32).contiguous(), w_ku.contiguous())
    if mla_decode_kernel_refusal(cfg, latent_cache) is None:
        if not isinstance(cur_len, torch.Tensor):
            cur_len = torch.full((1,), cur_len, dtype=torch.int64, device=latent_cache.device)
        ctx_lat = KM.mla_decode(q_lat.to(torch.bfloat16), q_rope, latent_cache, k_rope_cache, cur_len, scale=scale)
    else:
        tracing.count("mla.plain_calls")
        latent = latent_cache.to(f32)
        if isinstance(latent, DTensor):
            # every head beside each shard's slice of the sequence-parallel
            # latent, combined across the model axis
            mesh, tp = _seq_split(latent, 1)
            group = (mesh, tp) if tp is not None else None
            q_lat = constrain(q_lat, "dp", None, None, None)
            q_rope = constrain(q_rope, "dp", None, None, None)

            def local(q_lat, q_rope, latent, k_rope):
                pos = _local_positions(mesh, tp, latent.shape[1], q_lat.device)
                return KM.mla_decode_plain(q_lat, q_rope, latent, k_rope, cur_len, scale=scale, positions=pos,
                                           group=group)

            ctx_lat = run_local(local, q_lat, q_rope, latent, k_rope_cache)
            ctx_lat = constrain(ctx_lat, "dp", "tp", None, None)
        else:
            ctx_lat = KM.mla_decode_plain(q_lat, q_rope, latent, k_rope_cache, cur_len, scale=scale)
    out = torch.einsum("bhqr,rhd->bhqd", ctx_lat.contiguous(), w_vu.contiguous())
    return out.to(q_nope.dtype)


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
    scale = softmax_scale(cfg)
    if scale != 1.0 / (q.shape[-1] ** 0.5):  # YaRN: the flash form scales by 1 / sqrt(D) itself
        q = q * (scale * q.shape[-1] ** 0.5)
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
