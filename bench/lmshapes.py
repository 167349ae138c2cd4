"""What the benchmark knows of the port's LM shapes: the parameter tree
that ``repro_torch.models.lm.init_lm`` builds, drawn here from the seed,
and the model FLOPs a request needs.

The weights are the benchmark's inputs, handed to the program and, after
the window, to the plain reference.  They follow ``init_lm``'s layout and
scales (``layers.init_dense``: normal * sqrt(2 / (d_in + d_out)); the
embedding 0.02; Mamba's conv 0.2, ``A_log`` = log(1..d_state), ``D`` = 1;
norms 1, biases 0; the MoE router and ``A_log``, ``D`` in float32, every
other leaf in ``param_dtype``), but not its draws: every normal leaf of
one dtype is carved from one flat buffer, drawn on the device from a
``torch.Generator`` seeded with the seed in a few large calls.

Covers the block kinds of the configurations benchmarked here: attention
without MLA, Mamba, SwiGLU MLPs and MoE FFNs.  A configuration with other
kinds brings its own weight maker in its ``configs/<name>.py``.
"""

from __future__ import annotations

import dataclasses
import math

import torch

#: the largest slice of a flat buffer drawn by one call
DRAW_CHUNK = 1 << 30


def model_config(spec: dict):
    """The port's ``ModelConfig`` from a configuration file: every key that
    names one of its fields, the nested ``moe`` and ``mamba`` groups as
    their dataclasses; other keys (source, reduced, assumed) are ignored."""
    from repro_torch.models.config import MambaConfig, ModelConfig, MoEConfig

    names = {f.name for f in dataclasses.fields(ModelConfig)}
    kw = {k: v for k, v in spec.items() if k in names}
    if kw.get("moe") is not None:
        kw["moe"] = MoEConfig(**kw["moe"])
    if kw.get("mamba") is not None:
        kw["mamba"] = MambaConfig(**kw["mamba"])
    if kw.get("block_pattern") is not None:
        kw["block_pattern"] = tuple(kw["block_pattern"])
    return ModelConfig(**kw)


def pattern(cfg) -> tuple[str, ...]:
    return tuple(cfg.block_pattern) if cfg.block_pattern else ("attn",)


def is_moe(cfg, pos: int) -> bool:
    m = cfg.moe
    return m is not None and pos >= m.offset and (pos - m.offset) % m.every == 0


def n_groups(cfg) -> int:
    p = len(pattern(cfg))
    if cfg.n_layers % p:
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers are not whole groups of {p}")
    return cfg.n_layers // p


def _check(cfg) -> None:
    if cfg.kv_lora_rank or cfg.frontend or (cfg.moe is not None and cfg.moe.first_dense):
        raise NotImplementedError(f"{cfg.name}: MLA, frontends and leading dense layers need their own weight maker")
    if cfg.moe is not None and cfg.moe.n_shared_experts:
        raise NotImplementedError(f"{cfg.name}: shared experts need their own weight maker")
    if cfg.mlp_kind != "swiglu" or set(pattern(cfg)) - {"attn", "mamba"}:
        raise NotImplementedError(f"{cfg.name}: only attention and Mamba blocks with SwiGLU FFNs are covered")


def _mamba_sizes(cfg):
    mc = cfg.mamba
    d_in = mc.expand * cfg.d_model
    return d_in, mc.dt_rank or -(-cfg.d_model // 16), mc.d_state, mc.d_conv


def _leaves(cfg):
    """The tree of ``init_lm`` with each leaf a recipe: ("normal", shape,
    scale, dtype), ("ones" | "zeros", shape, dtype) or ("a_log", shape)."""
    dt = cfg.param_dtype
    d, h, hkv, dh, v = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_, cfg.vocab
    g = (n_groups(cfg),)

    def dense(d_in, d_out, bias=False, dtype=dt, lead=g):
        leaf = {"w": ("normal", (*lead, d_in, d_out), math.sqrt(2.0 / (d_in + d_out)), dtype)}
        if bias:
            leaf["b"] = ("zeros", (*lead, d_out), dtype)
        return leaf

    def layer(kind, moe):
        p = {"ln1": {"scale": ("ones", (*g, d), dt)}}
        if kind == "attn":
            p["block"] = {
                "q": dense(d, h * dh, cfg.qkv_bias),
                "k": dense(d, hkv * dh, cfg.qkv_bias),
                "v": dense(d, hkv * dh, cfg.qkv_bias),
                "o": dense(h * dh, d),
            }
        else:
            d_in, dtr, n, k = _mamba_sizes(cfg)
            p["block"] = {
                "in_proj": dense(d, 2 * d_in),
                "conv_w": ("normal", (*g, k, d_in), 0.2, dt),
                "conv_b": ("zeros", (*g, d_in), dt),
                "x_proj": dense(d_in, dtr + 2 * n),
                "dt_proj": dense(dtr, d_in, bias=True),
                "A_log": ("a_log", (*g, d_in, n)),
                "D": ("ones", (*g, d_in), "float32"),
                "out_proj": dense(d_in, d),
            }
        if moe:
            m = cfg.moe
            e, ff = m.n_experts, m.d_ff_expert
            s = math.sqrt(2.0 / (d + ff))
            p["ln2"] = {"scale": ("ones", (*g, d), dt)}
            p["ffn"] = {
                "router": dense(d, e, dtype="float32"),
                "gate": ("normal", (*g, e, d, ff), s, dt),
                "up": ("normal", (*g, e, d, ff), s, dt),
                "down": ("normal", (*g, e, ff, d), s, dt),
            }
        elif cfg.d_ff:
            p["ln2"] = {"scale": ("ones", (*g, d), dt)}
            p["ffn"] = {"gate": dense(d, cfg.d_ff), "up": dense(d, cfg.d_ff), "down": dense(cfg.d_ff, d)}
        return p

    tree = {
        "embed": {"table": ("normal", (v, d), 0.02, dt)},
        "final_norm": {"scale": ("ones", (d,), dt)},
    }
    if not cfg.tie_embeddings:
        tree["head"] = dense(d, v, lead=())
    tree["prefix"] = []
    tree["groups"] = {f"pos{i}": layer(kind, is_moe(cfg, i)) for i, kind in enumerate(pattern(cfg))}
    return tree



def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def _recipes(tree) -> list:
    out = []
    _map(tree, out.append)
    return out


def make_weights(seed: int, cfg, device) -> dict:
    """``init_lm``'s tree for ``cfg`` on ``device``, its normal leaves drawn
    from ``seed``: one flat buffer per dtype, filled a chunk of at most
    ``DRAW_CHUNK`` values per call, each leaf a scaled view of it."""
    _check(cfg)
    dev = torch.device(device)
    recipes = _leaves(cfg)
    sizes: dict[str, int] = {}
    for r in _recipes(recipes):
        if r[0] == "normal":
            sizes[r[3]] = sizes.get(r[3], 0) + math.prod(r[1])
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed % 2**63)
    flat = {}
    for name in sorted(sizes):
        buf = torch.empty(sizes[name], dtype=getattr(torch, name), device=dev)
        for start in range(0, buf.numel(), DRAW_CHUNK):
            buf[start : start + DRAW_CHUNK].normal_(generator=gen)
        flat[name] = buf
    offsets = dict.fromkeys(sizes, 0)

    def build(r):
        kind, shape = r[0], r[1]
        if kind == "normal":
            dtype, n = r[3], math.prod(shape)
            leaf = flat[dtype][offsets[dtype] : offsets[dtype] + n].view(shape)
            offsets[dtype] += n
            return leaf.mul_(r[2])
        if kind == "a_log":
            a = torch.log(torch.arange(1, shape[-1] + 1, dtype=torch.float32, device=dev))
            return a.expand(shape).clone()
        fill = torch.ones if kind == "ones" else torch.zeros
        return fill(shape, dtype=getattr(torch, r[2]), device=dev)

    return _map(recipes, build)


def active_body_params(cfg) -> int:
    """Matrix weights a token meets below the head: each layer's
    projections, and of an MoE FFN the router and its top-k experts."""
    d, h, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    total = 0
    for i, kind in enumerate(pattern(cfg)):
        if kind == "attn":
            total += d * h * dh + 2 * d * hkv * dh + h * dh * d
        else:
            d_in, dtr, n, _ = _mamba_sizes(cfg)
            total += d * 2 * d_in + d_in * (dtr + 2 * n) + dtr * d_in + d_in * d
        if is_moe(cfg, i):
            total += d * cfg.moe.n_experts + cfg.moe.top_k * 3 * d * cfg.moe.d_ff_expert
        elif cfg.d_ff:
            total += 3 * d * cfg.d_ff
    return total * n_groups(cfg)


def request_flops(cfg, prompt_len: int, new_tokens: int) -> float:
    """Useful model FLOPs of one request: 2 x the active matrix weights for
    each token whose result is used (the prompt and the first
    ``new_tokens`` - 1 generated tokens, fed back), the head for each
    generated token, and attention's QK^T and PV over each token's real
    causal context.  Padding is not useful work, nor is the engine's last
    decode step, whose token is dropped; the Mamba scan's elementwise work
    is left out."""
    fed = prompt_len + new_tokens - 1
    n_attn = sum(k == "attn" for k in pattern(cfg)) * n_groups(cfg)
    attn = 4.0 * cfg.n_heads * cfg.head_dim_ * fed * (fed + 1) / 2 * n_attn
    return 2.0 * active_body_params(cfg) * fed + 2.0 * cfg.d_model * cfg.vocab * new_tokens + attn
