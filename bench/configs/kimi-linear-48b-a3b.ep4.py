"""kimi-linear-48b-a3b at all 27 layers in their published order (KDA at
20 of them, NoPE MLA at 1-based 4, 8, ..., 24 and 27) and this chip's
share of a 4-way expert-parallel layer: experts 0-63 of 256, the router
at its published width, sigmoid scores with a correction bias, top-8
renormalised and scaled by 2.446, one shared expert, a dense layer 0.
bf16 with an f32 KDA state; the sizes and the share are in
``kimi-linear-48b-a3b.ep4.json`` beside this file, whose keys are the
published config.json's.

``make_weights`` draws ``init_lm``'s tree for the port's configuration
as ``lmshapes.make_weights`` does (the layout and scales, every normal
leaf of one dtype carved from one flat buffer drawn from the seed on the
device), and KDA's A_log and dt_bias from the same generator after them;
``lmshapes`` covers no KDA, MLA, prefix, tail or shared expert.
``request_flops`` counts what a token meets: KDA's projections and its
recurrence (6 K V operations a token and head), MLA's projections and
attention at its 192 / 128 head dims over each token's real causal
context, the dense FFN or the router, the shared expert and 8 x 64 / 256
routed experts (their expected share held here), and the head for each
generated token.
"""

from __future__ import annotations

import math

import torch

import lmshapes

#: the draws of KDA's A_log (exp A_log uniform here) and of softplus(dt_bias)
#: (log-uniform here), and the correction bias's std (the port's ``init_kda``
#: and ``init_moe``; the configuration file's ``assumed``)
A_RANGE = (1.0, 16.0)
DT_RANGE = (1e-3, 1e-1)
CONV_SCALE = 0.2
SCORE_BIAS_SCALE = 0.02


def layer_types(spec: dict) -> tuple[str, ...]:
    """Each layer's block kind in order, from the published 1-based lists."""
    lac, n = spec["linear_attn_config"], spec["num_hidden_layers"]
    full, kda = set(lac["full_attn_layers"]), set(lac["kda_layers"])
    if full & kda or full | kda != set(range(1, n + 1)):
        raise ValueError(f"{spec['name']}: full_attn_layers and kda_layers do not split the {n} layers")
    return tuple("attn" if i + 1 in full else "kda" for i in range(n))


def period(types: tuple[str, ...], first: int) -> tuple[str, ...]:
    """The shortest pattern that the layers after the dense prefix repeat
    at least twice whole, a shorter tail after them allowed."""
    body = types[first:]
    for p in range(1, len(body) // 2 + 1):
        whole = len(body) // p * p
        if all(body[i] == body[i % p] for i in range(whole)):
            return body[:p]
    return body


def model_config(spec: dict):
    """The port's ``HybridMLAConfig`` with a sigmoid-scored
    ``GroupedMoEConfig`` from the published keys of a configuration file."""
    from repro_torch.models.config import GroupedMoEConfig, HybridMLAConfig, KDAConfig

    if spec["v_head_dim"] != spec["qk_nope_head_dim"] or spec["rope_scaling"] is not None:
        raise ValueError(f"{spec['name']}: the port's MLA takes v_head_dim = qk_nope_head_dim and no rope scaling")
    if spec["moe_layer_freq"] != 1 or not spec["use_grouped_topk"]:
        raise ValueError(f"{spec['name']}: the port routes every layer after the dense prefix, grouped top-k")
    types = layer_types(spec)
    first = spec["first_k_dense_replace"]
    lac = spec["linear_attn_config"]
    return HybridMLAConfig(
        name=spec["name"],
        family="hybrid",
        n_layers=spec["num_hidden_layers"],
        d_model=spec["hidden_size"],
        n_heads=spec["num_attention_heads"],
        n_kv_heads=spec["num_key_value_heads"],
        head_dim=spec["qk_nope_head_dim"],
        d_ff=spec["intermediate_size"],
        vocab=spec["vocab_size"],
        kv_lora_rank=spec["kv_lora_rank"],
        qk_rope_dim=spec["qk_rope_head_dim"],
        q_lora_rank=spec["q_lora_rank"] or 0,
        rope=not spec["mla_use_nope"],
        block_pattern=period(types, first),
        layer_types=types,
        kda=KDAConfig(n_heads=lac["num_heads"], head_dim=lac["head_dim"], conv_size=lac["short_conv_kernel_size"]),
        moe=GroupedMoEConfig(
            n_experts=spec["num_experts"],
            top_k=spec["num_experts_per_token"],
            d_ff_expert=spec["moe_intermediate_size"],
            n_shared_experts=spec["num_shared_experts"],
            capacity_factor=spec["capacity_factor"],
            first_dense=first,
            n_routed_experts=spec["router_experts"],
            first_expert=spec["first_expert"],
            n_group=spec["num_expert_group"],
            topk_group=spec["topk_group"],
            routed_scaling_factor=spec["routed_scaling_factor"],
            scoring=spec["moe_router_activation_func"],
            renormalize=spec["moe_renormalize"],
        ),
        rope_theta=float(spec["rope_theta"]),
        norm_eps=spec["rms_norm_eps"],
        tie_embeddings=spec["tie_word_embeddings"],
        param_dtype=spec["param_dtype"],
        compute_dtype=spec["compute_dtype"],
        attn_chunk=spec["attn_chunk"],
        kv_cache_dtype=spec["kv_cache_dtype"],
    )


def _leaves(cfg) -> dict:
    """``init_lm``'s tree for ``cfg`` with each leaf a recipe, as
    ``lmshapes._leaves`` gives them, and ("a_log" | "dt_bias", shape) for
    KDA's two drawn float32 leaves."""
    from repro_torch.models import lm

    dt = cfg.param_dtype
    d, h, dh, v = cfg.d_model, cfg.n_heads, cfg.head_dim_, cfg.vocab
    r, dr = cfg.kv_lora_rank, cfg.qk_rope_dim
    kh, kd, taps = cfg.kda.n_heads, cfg.kda.head_dim, cfg.kda.conv_size
    m = cfg.moe

    def dense(d_in, d_out, lead, dtype=dt):
        return {"w": ("normal", (*lead, d_in, d_out), math.sqrt(2.0 / (d_in + d_out)), dtype)}

    def norm(n, lead):
        return {"scale": ("ones", (*lead, n), dt)}

    def mlp(ff, lead):
        return {"gate": dense(d, ff, lead), "up": dense(d, ff, lead), "down": dense(ff, d, lead)}

    def block(kind, lead):
        if kind == "attn":
            return {"q": dense(d, h * (dh + dr), lead), "kv_down": dense(d, r + dr, lead), "kv_norm": norm(r, lead),
                    "k_up": dense(r, h * dh, lead), "v_up": dense(r, h * dh, lead), "o": dense(h * dh, d, lead)}
        w = kh * kd
        return {"q": dense(d, w, lead), "k": dense(d, w, lead), "v": dense(d, w, lead),
                "conv_q": ("normal", (*lead, taps, w), CONV_SCALE, dt),
                "conv_k": ("normal", (*lead, taps, w), CONV_SCALE, dt),
                "conv_v": ("normal", (*lead, taps, w), CONV_SCALE, dt),
                "f_a": dense(d, kd, lead), "f_b": dense(kd, w, lead), "g_a": dense(d, kd, lead),
                "g_b": dense(kd, w, lead), "b": dense(d, kh, lead), "A_log": ("a_log", (*lead, kh)),
                "dt_bias": ("dt_bias", (*lead, w)), "o_norm": norm(kd, lead), "o": dense(w, d, lead)}

    def layer(kind, moe, lead):
        p = {"ln1": norm(d, lead), "block": block(kind, lead), "ln2": norm(d, lead)}
        if moe:
            e, ff = m.n_experts, m.d_ff_expert
            s = math.sqrt(2.0 / (d + ff))
            p["ffn"] = {
                "router": dense(d, m.n_routed_experts, lead, "float32"),
                "gate": ("normal", (*lead, e, d, ff), s, dt),
                "up": ("normal", (*lead, e, d, ff), s, dt),
                "down": ("normal", (*lead, e, ff, d), s, dt),
                "shared": mlp(ff * m.n_shared_experts, lead),
                "score_bias": ("normal", (*lead, m.n_routed_experts), SCORE_BIAS_SCALE, "float32"),
            }
        else:
            p["ffn"] = mlp(cfg.d_ff, lead)
        return p

    kinds = lm.layer_kinds(cfg)
    groups = (lm.n_scan_groups(cfg),)
    tail = lm.suffix_kinds(cfg)
    tree = {
        "embed": {"table": ("normal", (v, d), 0.02, dt)},
        "final_norm": {"scale": ("ones", (d,), dt)},
        "head": dense(d, v, ()),
        "prefix": [layer(kind, moe, ()) for kind, moe in kinds[: m.first_dense]],
        "groups": {f"pos{p}": layer(kind, moe, groups)
                   for p, (kind, moe) in enumerate(kinds[m.first_dense : m.first_dense + len(cfg.pattern)])},
    }
    if tail:
        tree["suffix"] = [layer(kind, moe, ()) for kind, moe in tail]
    return tree


def make_weights(seed: int, cfg, device) -> dict:
    """``init_lm``'s tree for ``cfg`` on ``device``, its normal leaves drawn
    from ``seed`` as ``lmshapes.make_weights`` draws them, then A_log and
    dt_bias from the same generator, leaf by leaf."""
    dev = torch.device(device)
    recipes = _leaves(cfg)
    sizes: dict[str, int] = {}
    for r in lmshapes._recipes(recipes):
        if r[0] == "normal":
            sizes[r[3]] = sizes.get(r[3], 0) + math.prod(r[1])
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed % 2**63)
    flat, offsets = {}, dict.fromkeys(sizes, 0)
    for name in sorted(sizes):
        buf = torch.empty(sizes[name], dtype=getattr(torch, name), device=dev)
        for start in range(0, buf.numel(), lmshapes.DRAW_CHUNK):
            buf[start : start + lmshapes.DRAW_CHUNK].normal_(generator=gen)
        flat[name] = buf

    def build(r):
        if r[0] == "normal":
            dtype, n = r[3], math.prod(r[1])
            leaf = flat[dtype][offsets[dtype] : offsets[dtype] + n].view(r[1])
            offsets[dtype] += n
            return leaf.mul_(r[2])
        if r[0] == "a_log":
            return torch.empty(r[1], dtype=torch.float32, device=dev).uniform_(*A_RANGE, generator=gen).log_()
        if r[0] == "dt_bias":
            lo, hi = (math.log(x) for x in DT_RANGE)
            dt = torch.empty(r[1], dtype=torch.float32, device=dev).uniform_(lo, hi, generator=gen).exp_()
            return dt + torch.log(-torch.expm1(-dt))  # softplus(dt_bias) = dt
        return torch.ones(r[1], dtype=getattr(torch, r[2]), device=dev)

    return lmshapes._map(recipes, build)


def kda_params(cfg) -> int:
    """KDA's matrix weights, one layer: q, k, v, the two low-rank gates,
    beta and the output projection."""
    d, w, kd, kh = cfg.d_model, cfg.kda.n_heads * cfg.kda.head_dim, cfg.kda.head_dim, cfg.kda.n_heads
    return 3 * d * w + 2 * (d * kd + kd * w) + d * kh + w * d


def mla_params(cfg) -> int:
    """MLA's matrix weights, one layer (direct q): q, kv_down, k_up, v_up, o."""
    d, h, dh, r, dr = cfg.d_model, cfg.n_heads, cfg.head_dim_, cfg.kv_lora_rank, cfg.qk_rope_dim
    return d * h * (dh + dr) + d * (r + dr) + 2 * r * h * dh + h * dh * d


def active_body_params(cfg) -> int:
    """Matrix weights a token meets below the head, of which the routed
    experts' at their expected share held here (top_k x held / routed)."""
    m, d = cfg.moe, cfg.d_model
    types = [cfg.layer_kind(i) for i in range(cfg.n_layers)]
    mixers = sum(kda_params(cfg) if t == "kda" else mla_params(cfg) for t in types)
    moe_ffn = d * m.n_routed_experts + 3 * d * m.d_ff_expert * m.n_shared_experts
    routed = m.top_k * m.n_experts / m.n_routed_experts * 3 * d * m.d_ff_expert
    n_moe = cfg.n_layers - m.first_dense
    return mixers + m.first_dense * 3 * d * cfg.d_ff + n_moe * (moe_ffn + routed)


def request_flops(cfg, prompt_len: int, new_tokens: int) -> float:
    """Useful model FLOPs of one request, as ``lmshapes.request_flops``
    counts them (the prompt and the first ``new_tokens`` - 1 generated
    tokens fed, the head for each generated token), with KDA's recurrence
    at 6 K V operations a token and head (the decay, S^T k, the rank-one
    update and S^T q; the kernel's bound counts 7 with the decay's
    multiply) and MLA's attention at its expanded head dims: QK^T over
    dh + dr, PV over dh."""
    fed = prompt_len + new_tokens - 1
    types = [cfg.layer_kind(i) for i in range(cfg.n_layers)]
    n_kda, n_mla = types.count("kda"), types.count("attn")
    kd = cfg.kda.head_dim
    recurrence = 6.0 * kd * kd * cfg.kda.n_heads * fed * n_kda
    dqk, dv = cfg.head_dim_ + cfg.qk_rope_dim, cfg.head_dim_
    attn = 2.0 * cfg.n_heads * (dqk + dv) * fed * (fed + 1) / 2 * n_mla
    return 2.0 * active_body_params(cfg) * fed + 2.0 * cfg.d_model * cfg.vocab * new_tokens + recurrence + attn
