"""Mixture-of-Experts FFN with GShard-style capacity dispatch.

Tokens are routed to their top-k experts (softmax scores; a
``GroupedMoEConfig`` may take DeepSeek-V2's group-limited choice, or
Kimi-Linear's sigmoid scores with a correction bias: ``route``); each
expert takes at most C
tokens (GShard's capacity, C = max(ceil(T·k·cf / E), min(T, 16)), so tiny
decode batches never drop), a token's slot in an expert is its rank among
the (token, choice) pairs routed there in token-major, choice-minor order,
and the pairs past capacity are dropped.  Shared experts (DeepSeek) run
densely alongside.

Port of ``repro.models.moe`` (``init_moe``, ``_num_groups``, ``moe_ffn``).
As in the reference, the tokens are grouped by data shard: G = the
activation policy's dp size (``repro_torch.parallel.policy``), or 1
without a policy or when it does not divide the token count; the slots,
the capacity and the combine are per group.  On DTensors the layouts are
pinned with ``constrain`` at the reference's sites: the input on the
batch, the expert buffers in GShard's (G on data, E on model) layout;
the slot fill and the combine run under ``local_map`` on each shard's
own groups, so their inputs hold whole groups (G on data, a group's
tokens on one shard, where the reference splits them over ``model``:
a group's slots rank all its tokens).  The slot fill, a scatter-max in
the reference (``buf.at[e, p].max``), is ``scatter_reduce_(..., "amax")``:
only dropped pairs collide, all at slot C - 1 with value 0, so the max
keeps the kept token.  The router's ``dense`` takes f32 input and f32
weights and so is routed to the kernel's f32 form under
``scheduled_kernels``; the shared experts go through ``layers.mlp`` and
are routed too; the expert products are batched matmuls outside any
kernel, as in the reference, where they are einsums outside Pallas.
Under ``repro_torch.tracing.recording`` an FFN records the spans
``moe.route``, ``moe.dispatch`` (the slot fill), ``moe.experts`` (the
three expert products) and ``moe.combine``, and counts the expert
products' operations as unrouted (``gemm.unrouted_flops``: 2 x E x slots
x d x ff each), beside what ``layers.dense`` counts.
"""

from __future__ import annotations

import functools

import torch

from repro_torch import tracing
from repro_torch.kernels.ref import torch_dtype
from repro_torch.models import layers as L
from repro_torch.models.config import GroupedMoEConfig, ModelConfig, MoEConfig
from repro_torch.parallel.policy import constrain, gather_fsdp, get_policy, run_local, spec_for


def init_moe(gen, cfg: ModelConfig, dtype=torch.float32, *, lead=()):
    m = cfg.moe
    d, ff, e = cfg.d_model, m.d_ff_expert, m.n_experts  # the experts held here
    scale = (2.0 / (d + ff)) ** 0.5
    # each expert's matrix drawn on its own (lead + expert), as one tensor
    params = {
        "router": L.init_dense(gen, d, share(m)[0], dtype=torch.float32, lead=lead),  # every expert scored
        "gate": L.draw_normal(gen, (d, ff), scale, dtype, (*lead, e)),
        "up": L.draw_normal(gen, (d, ff), scale, dtype, (*lead, e)),
        "down": L.draw_normal(gen, (ff, d), scale, dtype, (*lead, e)),
    }
    if m.n_shared_experts:
        params["shared"] = L.init_mlp(gen, d, ff * m.n_shared_experts, dtype, lead=lead)
    if sigmoid_scored(m):
        # trained, it balances the experts' loads; random here, at about the
        # gap between a token's 8th and 9th sigmoid score of 256
        params["score_bias"] = L.draw_normal(gen, (share(m)[0],), SCORE_BIAS_SCALE, torch.float32, lead)
    return params


#: the scale of the correction bias drawn at init (``init_moe``)
SCORE_BIAS_SCALE = 0.02


def sigmoid_scored(m: MoEConfig) -> bool:
    """Whether the router scores experts by sigmoid with a correction bias
    (Kimi-Linear's router) rather than by softmax."""
    return isinstance(m, GroupedMoEConfig) and m.scoring == "sigmoid"


def share(m: MoEConfig) -> tuple[int, int]:
    """(the router's width, the first expert held here): a
    ``GroupedMoEConfig``'s share, else every expert from 0."""
    if isinstance(m, GroupedMoEConfig) and m.n_routed_experts:
        return m.n_routed_experts, m.first_expert
    return m.n_experts, 0


def capacity(m: MoEConfig, t: int) -> int:
    """Slots per expert for ``t`` tokens (the reference's formula), over
    the router's width: an expert's share of the pairs is the same whether
    or not the others are held here."""
    return int(max(-(-t * m.top_k * m.capacity_factor // share(m)[0]), min(t, 16)))


def group_limited_top_k(probs: torch.Tensor, k: int, n_group: int, topk_group: int):
    """DeepSeek-V2's ``group_limited_greedy``: (scores, expert ids) [T, k],
    the best k of each token's experts among the ``topk_group`` of its
    ``n_group`` equal groups whose best expert scores highest."""
    t, e = probs.shape
    best = probs.reshape(t, n_group, e // n_group).amax(-1)  # [T, groups]
    kept = torch.zeros_like(best, dtype=torch.bool).scatter_(1, torch.topk(best, topk_group, dim=-1).indices, True)
    mask = kept[:, :, None].expand(t, n_group, e // n_group).reshape(t, e)
    return torch.topk(probs.masked_fill(~mask, 0.0), k, dim=-1)


def route(params, cfg: ModelConfig, xt: torch.Tensor):
    """[T, d] -> (weights [T, k] f32, expert ids [T, k] over the router's
    width, aux loss): the f32 router, its softmax, the top-k renormalized
    (a ``GroupedMoEConfig``: group-limited and scaled; sigmoid-scored:
    chosen by score + ``score_bias``, weighted by the scores, renormalised
    where ``renormalize``, and scaled), the load-balance loss."""
    m: MoEConfig = cfg.moe
    logits = L.dense(params["router"], xt.to(torch.float32))  # [T, E]
    probs = torch.sigmoid(logits) if sigmoid_scored(m) else torch.softmax(logits, dim=-1)
    if sigmoid_scored(m):  # Kimi-Linear
        if m.n_group != 1:
            raise ValueError(f"{cfg.name}: the port routes sigmoid scores over one group, not {m.n_group}")
        idx = torch.topk(probs + gather_fsdp(params["score_bias"]).to(torch.float32), m.top_k, dim=-1).indices
        weights = probs.gather(-1, idx)
        if m.renormalize:
            weights = weights / (weights.sum(-1, keepdim=True) + 1e-20)
        weights = weights * m.routed_scaling_factor
    elif isinstance(m, GroupedMoEConfig):  # DeepSeek-V2: scaled, not renormalized
        weights, idx = group_limited_top_k(probs, m.top_k, m.n_group, m.topk_group)
        weights = weights * m.routed_scaling_factor
    else:
        weights, idx = torch.topk(probs, m.top_k, dim=-1)
        weights = weights / torch.clamp_min(weights.sum(-1, keepdim=True), 1e-9)
    experts = torch.arange(probs.shape[-1], device=xt.device)
    density = (idx[:, :1] == experts).to(torch.float32).mean(0)  # one_hot(idx[:, 0]).mean(0)
    aux = probs.shape[-1] * torch.sum(density * probs.mean(0)) * m.aux_loss_weight
    return weights, idx, aux


def _num_groups(t: int) -> int:
    pol = get_policy()
    g = pol.dp_size if pol is not None else 1
    return g if t % g == 0 else 1


def dispatch(idx: torch.Tensor, n_experts: int, cap: int):
    """Slots of one group's flattened [T·k] (token, choice) pairs, ``idx``
    the experts held here numbered from 0 and -1 for a pair routed to an
    expert held elsewhere (it takes no slot): (position within the
    expert, kept, slot -> source token + 1 as [E, C] with 0 = empty)."""
    t, k = idx.shape
    held = idx.reshape(-1) >= 0
    token_of = torch.arange(t, device=idx.device).repeat_interleave(k)
    flat = torch.clamp_min(idx.reshape(-1), 0)
    onehot = torch.nn.functional.one_hot(flat, n_experts).to(torch.int32) * held[:, None]  # [T*k, E]
    # each expert's running count, scanned along its own row of [E, T*k]: a
    # scan over the outer dim of [T*k, E] runs one thread an expert (about
    # 100 ms a layer at T*k = 393k on an H100)
    count = torch.cumsum(onehot.t().contiguous(), dim=1).t()
    pos = ((count - onehot) * onehot).sum(-1)  # [T*k]
    keep = (pos < cap) & held
    safe_pos = torch.where(keep, pos, torch.full_like(pos, cap - 1))
    src = torch.where(keep, token_of + 1, torch.zeros_like(token_of))
    slot_src = torch.zeros(n_experts * cap, dtype=src.dtype, device=idx.device)
    slot_src.scatter_reduce_(0, flat * cap + safe_pos, src, "amax", include_self=True)
    return safe_pos, keep, slot_src.reshape(n_experts, cap)


def _fill(xg: torch.Tensor, idx_g: torch.Tensor, n_experts: int, cap: int, compute):
    """Per group: each (token, choice)'s slot, and the expert buffers.
    xg [G, Tl, d], idx_g [G, Tl, k] -> (buf [G, E, C, d] in ``compute``,
    safe_pos [G, Tl*k], keep [G, Tl*k])."""
    g, tl, d = xg.shape
    # [G, Tl*k], [G, Tl*k], [G, E, C]: each group's slots, as the reference's vmap
    per_group = [dispatch(i, n_experts, cap) for i in idx_g]
    safe_pos, keep, slot_src = (torch.stack(z) for z in zip(*per_group))
    slot_valid = slot_src > 0
    slot_tok = torch.clamp_min(slot_src - 1, 0)
    rows = torch.arange(g, device=xg.device)[:, None]
    buf = xg[rows, slot_tok.reshape(g, -1)].reshape(g, n_experts, cap, d)
    buf = torch.where(slot_valid[..., None], buf, torch.zeros((), dtype=buf.dtype, device=buf.device))
    return buf.to(compute), safe_pos, keep


def _combine(out_buf: torch.Tensor, idx_g: torch.Tensor, safe_pos, keep, w_g: torch.Tensor):
    """Per group: each (token, choice)'s slot back, weighted, summed over
    k.  out_buf [G, E, C, d], idx_g / w_g [G, Tl, k] -> [G, Tl, d]."""
    g, tl, k = idx_g.shape
    d = out_buf.shape[-1]
    rows = torch.arange(g, device=out_buf.device)[:, None]
    gathered = out_buf[rows, torch.clamp_min(idx_g, 0).reshape(g, tl * k), safe_pos]  # [G, Tl*k, d]
    zero = torch.zeros((), dtype=gathered.dtype, device=gathered.device)
    gathered = torch.where(keep[..., None], gathered, zero)
    mixed = (gathered.reshape(g * tl, k, d) * w_g.reshape(g * tl, k, 1).to(out_buf.dtype)).sum(1)
    return mixed.reshape(g, tl, d)


def moe_ffn(params, cfg: ModelConfig, x: torch.Tensor, router=None):
    """x [B, S, d] -> ([B, S, d], aux load-balance loss).

    The router scores every expert (``share``: the router's width); the
    layer computes what the experts held here give to the tokens routed
    to them, from the (token, choice) pairs routed here, each expert
    taking at most ``capacity`` of them, and adds the shared experts.
    Pairs routed to experts held elsewhere are left out: their part of
    the result is the other chips'.  Under a recording it counts
    ``moe.pairs`` (every pair routed), ``moe.held_pairs`` (those routed
    here) and ``moe.dropped_pairs`` (those past capacity), which reads
    the last two back from the device: one wait a layer, only while a
    recording is on.  ``router`` stands in for ``route`` (the same
    arguments and results): the captured decode step cuts its CUDA graphs
    there (``lm._DecodeGraphs``).

    On DTensors the slot fill and the combine run per group under
    ``local_map``, each shard on its own groups (G on the data axes), and
    the expert products run on the buffers' GShard layout (G on data, E
    on model)."""
    m: MoEConfig = cfg.moe
    b, s, d = x.shape
    t = b * s
    e, k = m.n_experts, m.top_k
    compute = torch_dtype(cfg.compute_dtype)
    # re-anchor to batch-only sharding before flattening: a (dp-batch,
    # tp-seq) layout flattens to an interleaving no placement expresses
    x = constrain(x, "dp", None, None)
    xt = x.reshape(t, d)

    with tracing.span("moe.route"):
        weights, idx, aux = (router or route)(params, cfg, xt)
    g = _num_groups(t)
    tl = t // g
    cap = capacity(m, tl)
    with tracing.span("moe.dispatch"):
        routed, first = share(m)
        if routed != e or first:  # the experts held here from 0, -1 for the others'
            local = idx - first
            idx = torch.where((local >= 0) & (local < e), local, torch.full_like(local, -1))
        xg = constrain(xt.reshape(g, tl, d), "dp", None, None)
        idx_g = constrain(idx.reshape(g, tl, k), "dp", None, None)
        w_g = constrain(weights.reshape(g, tl, k), "dp", None, None)
        gspec = spec_for((g,), "dp") or (None,)
        buf, safe_pos, keep = run_local(
            functools.partial(_fill, n_experts=e, cap=cap, compute=compute),
            xg,
            idx_g,
            out_specs=(gspec + (None, None, None), gspec + (None,), gspec + (None,)),
        )
        buf = constrain(buf, "dp", "tp", None, None)  # the GShard (g, e) layout
        if tracing.active() is not None:  # one readback a layer, only while recording
            held, kept = torch.stack([(idx >= 0).sum(), keep.sum()]).tolist()
            tracing.count("moe.pairs", t * k)
            tracing.count("moe.held_pairs", held)
            tracing.count("moe.dropped_pairs", held - kept)

    # expert SwiGLU on [E, G·C, d]
    with tracing.span("moe.experts"):
        buf = buf.transpose(0, 1).reshape(e, g * cap, d)
        gate = torch.bmm(buf, gather_fsdp(params["gate"]).to(compute))
        up = torch.bmm(buf, gather_fsdp(params["up"]).to(compute))
        h = torch.nn.functional.silu(gate.to(torch.float32)).to(compute) * up
        out_buf = torch.bmm(h, gather_fsdp(params["down"]).to(compute))  # [E, G·C, d]
        if tracing.active() is not None:
            tracing.count("gemm.unrouted_flops", 3 * 2 * e * g * cap * d * m.d_ff_expert)

    with tracing.span("moe.combine"):
        out_buf = out_buf.reshape(e, g, cap, d).transpose(0, 1)  # [G, E, C, d]
        out_buf = constrain(out_buf, "dp", "tp", None, None)
        out_buf = constrain(out_buf, "dp", None, None, None)  # each shard gathers its groups' slots
        mixed = run_local(_combine, out_buf, idx_g, safe_pos, keep, w_g, out_specs=(gspec + (None, None),))
        mixed = mixed.reshape(t, d)

    if m.n_shared_experts:
        mixed = mixed + L.mlp(params["shared"], xt, compute_dtype=compute)

    return constrain(mixed.reshape(b, s, d).to(x.dtype), "dp", None, None), aux
