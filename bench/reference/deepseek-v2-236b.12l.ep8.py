"""Plain float32 reference of deepseek-v2-236b.12l.ep8 as the port runs it.

Per layer: RMSNorm, MLA, RMSNorm, then the FFN: at layer 0 a SwiGLU MLP
of width 12288, at layers 1-11 the MoE share below.  The keys read from
the configuration file are the published config.json's.

MLA (arXiv:2405.04434 §2.1, the published config.json): c_q =
RMSNorm(x W_qa) (rank 1536), q = c_q W_qb split per head into 128 nope
and 64 rope dims; [c_kv | k_pe] = x W_kva, c_kv = RMSNorm(c_kv) (rank
512), k_nope = c_kv W_kup and v = c_kv W_vup per head (128 each), k_pe
one 64-dim head shared by every head.  q_pe and k_pe are rotated by RoPE
at positions 0..S-1 (left padding included, unmasked) as two halves,
the port's layout (the published code de-interleaves the rope dims
first: with random weights a fixed permutation of the rope columns of
W_qb and W_kva), with YaRN's frequencies (factor 40 over the original
4096 positions, the ramp between beta_fast 32 and beta_slow 1
rotations) and magnitude mscale(40, 0.707) / mscale(40, 0.707) = 1.  The
softmax scale is 192^-1/2 times mscale(40, 0.707)^2, mscale(s, m) = 0.1 m
ln(s) + 1.  Attention runs one batch row and one block of query rows at
a time, each row's softmax exact over its causal context, the nope and
rope parts' logits summed without making the expanded k.

MoE (the share this chip holds): the float32 router scores all 160
experts (softmax); group-limited greedy keeps each token's 3 of 8
groups of 20 whose best expert scores highest and takes the top 6
experts of those; each taken expert's weight is its score times 16 (no
renormalisation).  Only experts 0-19 are held: a pair routed elsewhere
is left out.  Each held expert takes at most C = max(ceil(T 6 1.25 /
160), min(T, 16)) of the T tokens of one engine call (``segments``), the
pairs ranked token-major, choice-minor, the rest dropped, as GShard's
rule in ``jamba-v0.1-52b.8l.py``.  Two shared SwiGLU experts (one MLP of
width 3072) run on every token.

``routes`` (``plain.Routes``): where ``forced`` holds the program's
expert ids, the reference takes them (weighted by its own router's
scores) and keeps ``gap`` (``choice_gap``), the widest gap in router
logits by which a forced choice lies below the reference's own grouped
choice at that token, at the stage that made it: the group, against
the reference's 3rd best group, and the expert, against the 6th best
expert of the groups taken.  (Against the 6th expert of the reference's
own groups alone, a token whose 3rd and 4th groups tie within rounding
reads a whole spread of logits whichever group the program takes: the
group choice is discontinuous as the top-k is.)  ``used`` records the
ids taken.
"""

import math

import torch

from reference import plain

BLOCK_Q = 256  # query rows of one attention block


def yarn_mscale(factor: float, m: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * m * math.log(factor) + 1.0


def rope_tables(s: int, dim: int, spec: dict, device):
    """cos, sin [S, dim / 2] of YaRN-scaled RoPE at positions 0..S-1."""
    rs, theta, half = spec["rope_scaling"], float(spec["rope_theta"]), dim // 2
    factor, orig = rs["factor"], rs["original_max_position_embeddings"]
    base = theta ** (torch.arange(half, dtype=torch.float64) * 2 / dim)

    def dim_at(rotations):  # the dim whose wavelength turns ``rotations`` times over orig
        return dim * math.log(orig / (rotations * 2 * math.pi)) / (2 * math.log(theta))

    low, high = max(math.floor(dim_at(rs["beta_fast"])), 0), min(math.ceil(dim_at(rs["beta_slow"])), dim - 1)
    ramp = ((torch.arange(half, dtype=torch.float64) - low) / ((high - low) or 0.001)).clamp(0, 1)
    freqs = (1.0 / base) * (1 - ramp) + (1.0 / (factor * base)) * ramp
    ang = torch.arange(s, dtype=torch.float64)[:, None] * freqs
    mag = yarn_mscale(factor, rs["mscale"]) / yarn_mscale(factor, rs["mscale_all_dim"])
    return [(t * mag).to(torch.float32).to(device) for t in (torch.cos(ang), torch.sin(ang))]


def rotate(x, cos, sin):
    """RoPE over the two halves of the last dim: x [..., S, D]."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def softmax_scale(spec: dict) -> float:
    rs = spec["rope_scaling"]
    m = yarn_mscale(rs["factor"], rs["mscale_all_dim"])
    return (spec["qk_nope_head_dim"] + spec["qk_rope_head_dim"]) ** -0.5 * m * m


def mla(p, x, spec, mm):
    """Causal MLA over x [B, S, d], one batch row at a time."""
    b, s, _ = x.shape
    h, dn, dr, dv = (spec["num_attention_heads"], spec["qk_nope_head_dim"], spec["qk_rope_head_dim"],
                     spec["v_head_dim"])
    r, eps = spec["kv_lora_rank"], spec["rms_norm_eps"]
    cos, sin = rope_tables(s, dr, spec, x.device)
    scale = softmax_scale(spec)
    out = torch.empty(b, s, h * dv, dtype=torch.float32, device=x.device)
    for row in range(b):
        xr = x[row]
        cq = plain.rmsnorm(plain.dense(p["q_a"], xr, mm), p["q_norm"]["scale"], eps)
        q = plain.dense(p["q_b"], cq, mm).reshape(s, h, dn + dr).transpose(0, 1)  # [H, S, 192]
        q_nope, q_pe = q[..., :dn], rotate(q[..., dn:], cos, sin)
        down = plain.dense(p["kv_down"], xr, mm)
        ckv = plain.rmsnorm(down[:, :r], p["kv_norm"]["scale"], eps)
        k_pe = rotate(down[:, r:], cos, sin)  # [S, 64], every head's
        k_nope = plain.dense(p["k_up"], ckv, mm).reshape(s, h, dn).transpose(0, 1)
        v = plain.dense(p["v_up"], ckv, mm).reshape(s, h, dv).transpose(0, 1)
        del q, cq, down, ckv
        for q0 in range(0, s, BLOCK_Q):
            q1 = min(q0 + BLOCK_Q, s)
            logits = (q_nope[:, q0:q1] @ k_nope[:, :q1].transpose(-1, -2) + q_pe[:, q0:q1] @ k_pe[:q1].T) * scale
            future = torch.arange(q1, device=x.device)[None, :] > torch.arange(q0, q1, device=x.device)[:, None]
            probs = torch.softmax(logits.masked_fill(future, float("-inf")), dim=-1)
            out[row, q0:q1] = (probs @ v[:, :q1]).transpose(0, 1).reshape(q1 - q0, h * dv)
            del logits, probs
        del q_nope, q_pe, k_pe, k_nope, v
    return plain.dense(p["o"], out, mm)


def choose(routes, logits, spec):
    """(weights, expert ids) [..., 6] over the router's width, the
    reference's own group-limited choice or the forced one (``routes``)."""
    k, groups, kept = spec["num_experts_per_tok"], spec["n_group"], spec["topk_group"]
    probs = torch.softmax(logits, dim=-1)
    e = probs.shape[-1]
    best = probs.unflatten(-1, (groups, e // groups)).amax(-1)
    chosen = torch.zeros_like(best, dtype=torch.bool).scatter_(-1, torch.topk(best, kept, dim=-1).indices, True)
    allowed = chosen.repeat_interleave(e // groups, dim=-1)
    own = torch.topk(probs.masked_fill(~allowed, 0.0), k, dim=-1).indices
    if routes.forced is not None:
        idx = routes.forced[len(routes.used)].to(own.device)
        routes.gap = max(routes.gap, float(choice_gap(logits, idx, k, groups, kept).max()))
        own = idx
    routes.used.append(own)
    return probs.gather(-1, own) * spec["routed_scaling_factor"], own


def choice_gap(logits, idx, k: int, groups: int, kept: int):
    """How far, in router logits, the expert ids ``idx`` [..., k] lie below
    the reference's own group-limited choice, stage by stage: a group
    taken lies below the reference's ``kept``-th best group (a group's
    logit: its best expert's) by the group gap; an expert lies below the
    k-th best expert of the groups taken (those of ``idx``, filled up to
    ``kept`` with the reference's best others) by the expert gap.  A
    router that chose as the reference would, up to rounding, reads about
    twice its logits' distance at both stages, even where two groups tie;
    one that chose other experts or groups reads the spread of the
    logits."""
    e = logits.shape[-1]
    per = e // groups
    best = logits.unflatten(-1, (groups, per)).amax(-1)  # [..., groups]
    taken = idx // per
    group_gap = (torch.topk(best, kept, dim=-1).values[..., -1:] - best.gather(-1, taken)).amax(-1)
    first = torch.zeros_like(best, dtype=torch.bool).scatter_(-1, taken, True)
    fill = torch.topk(best.masked_fill(first, float("inf")), kept, dim=-1).indices
    allowed = torch.zeros_like(first).scatter_(-1, fill, True).repeat_interleave(per, dim=-1)
    kth = torch.topk(logits.masked_fill(~allowed, float("-inf")), k, dim=-1).values[..., -1:]
    expert_gap = (kth - logits.gather(-1, idx)).amax(-1)
    return torch.maximum(group_gap, expert_gap)


def moe(p, x, spec, segments, mm, routes):
    k, e_all = spec["num_experts_per_tok"], spec["router_experts"]
    first, held = spec["first_expert"], spec["n_routed_experts"]
    cf = spec["capacity_factor"]
    b, s, d = x.shape
    w, idx = choose(routes, plain.dense(p["router"], x, plain.f32_mm), spec)
    keep = torch.zeros(b, s, k, dtype=torch.bool, device=x.device)
    for lo, hi in segments:
        ids = idx[:, lo:hi].reshape(-1)  # token-major, choice-minor
        t = b * (hi - lo)
        cap = int(max(-(-t * k * cf // e_all), min(t, 16)))
        onehot = torch.nn.functional.one_hot(ids, e_all)
        rank = ((onehot.cumsum(0) - onehot) * onehot).sum(-1)
        keep[:, lo:hi] = (rank < cap).reshape(b, hi - lo, k)
    xt, out = x.reshape(-1, d), torch.zeros(b * s, d, dtype=torch.float32, device=x.device)
    idx, w, keep = idx.reshape(-1, k), w.reshape(-1, k), keep.reshape(-1, k)
    for ex in range(held):
        tok, choice = torch.nonzero((idx == first + ex) & keep, as_tuple=True)
        if tok.numel():
            xe = xt[tok]
            hid = torch.nn.functional.silu(mm(xe, plain.f32(p["gate"][ex]))) * mm(xe, plain.f32(p["up"][ex]))
            out.index_add_(0, tok, mm(hid, plain.f32(p["down"][ex])) * w[tok, choice, None])
    return out.reshape(b, s, d) + plain.swiglu(p["shared"], x, mm)


def logits(weights, spec, tokens, read, segments, mm=plain.f32_mm, routes=None):
    routes = routes if routes is not None else plain.Routes()
    eps = spec["rms_norm_eps"]
    dense = spec["first_k_dense_replace"]
    x = plain.f32(weights["embed"]["table"][tokens.long()])
    for i in range(spec["num_hidden_layers"]):
        lp = weights["prefix"][i] if i < dense else plain.layer_params(weights, i - dense, 0)
        x = x + mla(lp["block"], plain.rmsnorm(x, lp["ln1"]["scale"], eps), spec, mm)
        h = plain.rmsnorm(x, lp["ln2"]["scale"], eps)
        x = x + (plain.swiglu(lp["ffn"], h, mm) if i < dense else moe(lp["ffn"], h, spec, segments, mm, routes))
    x = plain.rmsnorm(x[:, read], weights["final_norm"]["scale"], eps)
    return plain.dense(weights["head"], x, mm)
