"""deepseek-v2-236b cut to the first pipeline stage of 12 layers (the
dense layer 0, then 11 MoE layers) and this chip's share of an 8-way
expert-parallel layer: experts 0-19 of 160, one routing group, with the
router at its published width, group-limited top-6 and the two shared
experts.  MLA as published: q-LoRA 1536 with its norm, the latent 512
normed, 64 rope dims under YaRN.  bf16; the sizes and the cut are in
``deepseek-v2-236b.12l.ep8.json`` beside this file, whose keys are the
published config.json's.

``make_weights`` draws ``init_lm``'s tree for the port's configuration
as ``lmshapes.make_weights`` does (the layout and scales, every normal
leaf of one dtype carved from one flat buffer drawn from the seed on the
device); ``lmshapes`` covers no MLA, prefix layer or shared expert.
``request_flops`` counts what a token meets: MLA's projections, the
dense FFN or the router, the shared experts and 6 x 20 / 160 routed
experts (its expected share held here), the head for each generated
token, and attention at MLA's expanded 192 / 128 head dims over each
token's real causal context.  The routed share is the deployment's,
not what a run computes: the random router sends 10.7-12.8 % of the
pairs (not 12.5 %) to the experts held here, and capacity drops about a
fifth of those, so ``mfu`` credits about 1.5 times the routed work that
was done (PERF.md, section 6).
"""

from __future__ import annotations

import math

import torch

import lmshapes


def model_config(spec: dict):
    """The port's ``MLAConfig`` with a ``GroupedMoEConfig`` from the
    published keys of a configuration file."""
    from repro_torch.models.config import GroupedMoEConfig, MLAConfig, YarnRope

    if spec["norm_topk_prob"] or spec["topk_method"] != "group_limited_greedy" or spec["scoring_func"] != "softmax":
        raise ValueError(f"{spec['name']}: the port routes DeepSeek-V2's way only (softmax, group-limited, scaled)")
    rs = spec["rope_scaling"]
    return MLAConfig(
        name=spec["name"],
        family="moe",
        n_layers=spec["num_hidden_layers"],
        d_model=spec["hidden_size"],
        n_heads=spec["num_attention_heads"],
        n_kv_heads=spec["num_key_value_heads"],
        head_dim=spec["qk_nope_head_dim"],
        d_ff=spec["intermediate_size"],
        vocab=spec["vocab_size"],
        qkv_bias=spec["attention_bias"],
        kv_lora_rank=spec["kv_lora_rank"],
        qk_rope_dim=spec["qk_rope_head_dim"],
        q_lora_rank=spec["q_lora_rank"],
        rope_scaling=YarnRope(factor=rs["factor"], original_max_position=rs["original_max_position_embeddings"],
                              beta_fast=rs["beta_fast"], beta_slow=rs["beta_slow"], mscale=rs["mscale"],
                              mscale_all_dim=rs["mscale_all_dim"]),
        moe=GroupedMoEConfig(
            n_experts=spec["n_routed_experts"],
            top_k=spec["num_experts_per_tok"],
            d_ff_expert=spec["moe_intermediate_size"],
            n_shared_experts=spec["n_shared_experts"],
            capacity_factor=spec["capacity_factor"],
            first_dense=spec["first_k_dense_replace"],
            n_routed_experts=spec["router_experts"],
            first_expert=spec["first_expert"],
            n_group=spec["n_group"],
            topk_group=spec["topk_group"],
            routed_scaling_factor=spec["routed_scaling_factor"],
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
    ``lmshapes._leaves`` gives them."""
    dt = cfg.param_dtype
    d, h, dh, v = cfg.d_model, cfg.n_heads, cfg.head_dim_, cfg.vocab
    r, dr, qr = cfg.kv_lora_rank, cfg.qk_rope_dim, cfg.q_lora_rank
    m = cfg.moe
    groups = cfg.n_layers - m.first_dense

    def dense(d_in, d_out, lead, dtype=dt):
        return {"w": ("normal", (*lead, d_in, d_out), math.sqrt(2.0 / (d_in + d_out)), dtype)}

    def norm(n, lead):
        return {"scale": ("ones", (*lead, n), dt)}

    def mlp(ff, lead):
        return {"gate": dense(d, ff, lead), "up": dense(d, ff, lead), "down": dense(ff, d, lead)}

    def layer(lead, moe):
        p = {"ln1": norm(d, lead), "block": {
            "q_a": dense(d, qr, lead), "q_norm": norm(qr, lead), "q_b": dense(qr, h * (dh + dr), lead),
            "kv_down": dense(d, r + dr, lead), "kv_norm": norm(r, lead),
            "k_up": dense(r, h * dh, lead), "v_up": dense(r, h * dh, lead), "o": dense(h * dh, d, lead),
        }, "ln2": norm(d, lead)}
        if moe:
            e, ff = m.n_experts, m.d_ff_expert
            s = math.sqrt(2.0 / (d + ff))
            p["ffn"] = {
                "router": dense(d, m.n_routed_experts, lead, "float32"),
                "gate": ("normal", (*lead, e, d, ff), s, dt),
                "up": ("normal", (*lead, e, d, ff), s, dt),
                "down": ("normal", (*lead, e, ff, d), s, dt),
                "shared": mlp(ff * m.n_shared_experts, lead),
            }
        else:
            p["ffn"] = mlp(cfg.d_ff, lead)
        return p

    return {
        "embed": {"table": ("normal", (v, d), 0.02, dt)},
        "final_norm": {"scale": ("ones", (d,), dt)},
        "head": dense(d, v, ()),
        "prefix": [layer((), False) for _ in range(m.first_dense)],
        "groups": {"pos0": layer((groups,), True)},
    }


def make_weights(seed: int, cfg, device) -> dict:
    """``init_lm``'s tree for ``cfg`` on ``device``, its normal leaves drawn
    from ``seed`` as ``lmshapes.make_weights`` draws them."""
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
        return torch.ones(r[1], dtype=getattr(torch, r[2]), device=dev)

    return lmshapes._map(recipes, build)


def mla_params(cfg) -> int:
    """MLA's matrix weights, one layer: q_a, q_b, kv_down, k_up, v_up, o."""
    d, h, dh, r, dr, qr = cfg.d_model, cfg.n_heads, cfg.head_dim_, cfg.kv_lora_rank, cfg.qk_rope_dim, cfg.q_lora_rank
    return d * qr + qr * h * (dh + dr) + d * (r + dr) + 2 * r * h * dh + h * dh * d


def active_body_params(cfg) -> int:
    """Matrix weights a token meets below the head, of which the routed
    experts' at their expected share held here (top_k x held / routed)."""
    m, d = cfg.moe, cfg.d_model
    dense_ffn = 3 * d * cfg.d_ff
    moe_ffn = d * m.n_routed_experts + 3 * d * m.d_ff_expert * m.n_shared_experts
    routed = m.top_k * m.n_experts / m.n_routed_experts * 3 * d * m.d_ff_expert
    n_moe = cfg.n_layers - m.first_dense
    return cfg.n_layers * mla_params(cfg) + m.first_dense * dense_ffn + n_moe * (moe_ffn + routed)


def request_flops(cfg, prompt_len: int, new_tokens: int) -> float:
    """Useful model FLOPs of one request, as ``lmshapes.request_flops``
    counts them (the prompt and the first ``new_tokens`` - 1 generated
    tokens fed, the head for each generated token), attention at MLA's
    expanded head dims: QK^T over dh + dr, PV over dh, every layer."""
    fed = prompt_len + new_tokens - 1
    dqk, dv = cfg.head_dim_ + cfg.qk_rope_dim, cfg.head_dim_
    attn = 2.0 * cfg.n_heads * (dqk + dv) * fed * (fed + 1) / 2 * cfg.n_layers
    return 2.0 * active_body_params(cfg) * fed + 2.0 * cfg.d_model * cfg.vocab * new_tokens + attn
