"""Plain float32 reference of jamba-v0.1-52b.8l as the port runs it.

Per layer: RMSNorm, then the mixer (Mamba, or causal GQA attention with
RoPE at position 3 of the period), RMSNorm, then the FFN (a SwiGLU MLP,
or at every other layer from 1 on an MoE of 16 SwiGLU experts, top-2).

Mamba (the port's form, without the published dt/B/C norms): in_proj to
(u, z); a causal depthwise conv of 4 taps with bias over u, SiLU; x_proj
to (dt_raw, B, C); dt = softplus(dt_proj(dt_raw)); A = -exp(A_log);
h_t = exp(dt_t A) h_{t-1} + dt_t u_t B_t from h_{-1} = 0, stepped one
position at a time; y_t = h_t . C_t + D u_t; out_proj(y * SiLU(z)).

MoE (the port's capacity rule, GShard's): the float32 router's softmax,
its top-2 renormalised to sum 1; each expert takes at most
C = max(ceil(T k cf / E), min(T, 16)) of the T tokens routed in one
engine call, the (token, choice) pairs ranked token-major, choice-minor
(tokens row-major over the call's positions), and drops the rest.
``segments`` lists the positions of each call: the prefill's prompt
positions over all rows, then each decode step's one position.

The top-2 choice is discontinuous: where two experts' probabilities lie
closer than bfloat16 rounding moves them, the program and this float32
reference pick different experts, and that token's output differs by a
whole expert's.  So ``routes`` (``plain.Routes``) can hand the reference
the experts the judged side chose in each layer; it then reads, layer by
layer, how far below its own router's choice those experts lie, which
checks the router by itself.
"""

import torch

from reference import plain


def causal_conv(u, w, b):
    """Depthwise causal conv over S: u [B, S, D], w [K, D]."""
    k, s = w.shape[0], u.shape[1]
    up = torch.nn.functional.pad(u, (0, 0, k - 1, 0))
    return sum(up[:, i : i + s] * w[i] for i in range(k)) + b


def mamba(p, x, spec, mm):
    n = spec["mamba"]["d_state"]
    f32 = plain.f32
    u, z = plain.dense(p["in_proj"], x, mm).chunk(2, dim=-1)
    u = torch.nn.functional.silu(causal_conv(u, f32(p["conv_w"]), f32(p["conv_b"])))
    proj = plain.dense(p["x_proj"], u, mm)
    dtr = proj.shape[-1] - 2 * n
    dt_raw, bm, cm = proj.split([dtr, n, n], dim=-1)
    dt = torch.nn.functional.softplus(plain.dense(p["dt_proj"], dt_raw, mm))
    a = -torch.exp(f32(p["A_log"]))
    h = torch.zeros(x.shape[0], u.shape[-1], n, dtype=torch.float32, device=x.device)
    y = torch.empty_like(u)
    for t in range(x.shape[1]):
        h = torch.exp(dt[:, t, :, None] * a) * h + (dt[:, t] * u[:, t])[..., None] * bm[:, t, None, :]
        y[:, t] = (h * cm[:, t, None, :]).sum(-1)
    y = y + f32(p["D"]) * u
    return plain.dense(p["out_proj"], y * torch.nn.functional.silu(z), mm)


def moe(p, x, spec, segments, mm, routes):
    m = spec["moe"]
    e, k, cf = m["n_experts"], m["top_k"], m["capacity_factor"]
    b, s, d = x.shape
    w, idx = routes.choose(plain.dense(p["router"], x, plain.f32_mm), k)
    w = w / w.sum(-1, keepdim=True)
    keep = torch.zeros(b, s, k, dtype=torch.bool, device=x.device)
    for lo, hi in segments:
        ids = idx[:, lo:hi].reshape(-1)  # token-major, choice-minor
        t = b * (hi - lo)
        cap = int(max(-(-t * k * cf // e), min(t, 16)))
        onehot = torch.nn.functional.one_hot(ids, e)
        rank = ((onehot.cumsum(0) - onehot) * onehot).sum(-1)
        keep[:, lo:hi] = (rank < cap).reshape(b, hi - lo, k)
    xt, out = x.reshape(-1, d), torch.zeros(b * s, d, dtype=torch.float32, device=x.device)
    idx, w, keep = idx.reshape(-1, k), w.reshape(-1, k), keep.reshape(-1, k)
    for ex in range(e):
        tok, choice = torch.nonzero((idx == ex) & keep, as_tuple=True)
        if tok.numel():
            xe = xt[tok]
            hid = torch.nn.functional.silu(mm(xe, plain.f32(p["gate"][ex]))) * mm(xe, plain.f32(p["up"][ex]))
            out.index_add_(0, tok, mm(hid, plain.f32(p["down"][ex])) * w[tok, choice, None])
    return out.reshape(b, s, d)


def logits(weights, spec, tokens, read, segments, mm=plain.f32_mm, routes=None):
    moe_every, moe_offset = spec["moe"]["every"], spec["moe"]["offset"]
    routes = routes if routes is not None else plain.Routes()

    def block(kind, p, h):
        return plain.attention(p, h, spec, mm) if kind == "attn" else mamba(p, h, spec, mm)

    def ffn(pos, p, h):
        if pos >= moe_offset and (pos - moe_offset) % moe_every == 0:
            return moe(p, h, spec, segments, mm, routes)
        return plain.swiglu(p, h, mm)

    return plain.forward(weights, spec, tokens, read, block=block, ffn=ffn, mm=mm)
