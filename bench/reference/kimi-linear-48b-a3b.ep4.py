"""Plain float32 reference of kimi-linear-48b-a3b.ep4 as the port runs it.

Per layer: RMSNorm, the mixer (KDA at the published kda_layers, MLA at
the full_attn_layers), RMSNorm, then the FFN: at layer 0 a SwiGLU MLP of
width 9216, at layers 1-26 the MoE share below.  The keys read from the
configuration file are the published config.json's; the weights are
laid out as the port's ``init_lm`` lays them out (the dense layer 0, the
layers after it as whole repeats of their shortest period, stacked, and
the layers past the last whole repeat in a tail).

KDA (Kimi Delta Attention, per head of K = V = 128, 32 heads): q =
L2norm(SiLU(conv4(x W_q))) 128^-1/2, k = L2norm(SiLU(conv4(x W_k))), v =
SiLU(conv4(x W_v)), each conv depthwise and causal over the sequence (the
left padding included, unmasked); g = -exp(A_log[h]) softplus(x W_fa W_fb
+ dt_bias), a log-decay per key channel; beta = sigmoid(x W_b); with S a
128 x 128 float32 state from zeros, per position S <- Diag(exp g) S, S
<- S + beta k (v - S^T k)^T, o = S^T q; y = (RMSNorm(o) w_norm
sigmoid(x W_ga W_gb)) W_o, the norm per head.  ``recurrence`` walks the
positions one at a time; ``chunked`` is its exact rewrite over chunks of
``CHUNK`` positions, which the check runs (a CPU test holds the two
together).  Within a chunk with decays c_t = the running sum of g (each
factor exp(c_t - c_s) of a later position over an earlier one is at
most 1, so no product of exp(c) and exp(-c) is formed):

    A[t, s] = sum_i k_t,i k_s,i exp(c_t,i - c_s,i)   (s < t)
    B[t, s] = sum_i q_t,i k_s,i exp(c_t,i - c_s,i)   (s <= t)
    W = (I + diag(beta) A)^-1 diag(beta) (V - (K exp(c)) S0)
    O = (Q exp(c)) S0 + B W
    S1 = exp(c_last) S0 + (K exp(c_last - c))^T W

with W the rows each position adds to the state (beta (v - S^T k) in
the recurrence).  The chunk-local parts (A, B, the triangular solves) are
computed for many chunks at once; only S0 -> S1 walks the chunks in order.

MLA (no positional encoding: ``mla_use_nope``): q = x W_q split per head
into 128 nope and 64 "rope" dims, none rotated; [c_kv | k_pe] = x W_kva,
c_kv = RMSNorm(c_kv) (rank 512), k_nope = c_kv W_kup and v = c_kv W_vup
per head (128 each), k_pe one 64-dim head shared by every head.  The
softmax scale is 192^-1/2.  Attention runs one batch row and one block of
query rows at a time, each row's softmax exact over its causal context,
the nope and rope parts' logits summed without making the expanded k.

MoE (the share this chip holds): the float32 router's logits through a
sigmoid are each expert's score; each token takes the 8 experts of
largest score + e_score_correction_bias (``score_bias``), weighted by
their scores, renormalised to sum to 1 and times 2.446.  Only experts
0-63 of 256 are held: a pair routed elsewhere is left out.  Each held
expert takes at most C = max(ceil(T 8 1.25 / 256), min(T, 16)) of the T
tokens of one engine call (``segments``), the pairs ranked token-major,
choice-minor, the rest dropped.  One shared SwiGLU expert of width 1024
runs on every token.

``routes`` (``plain.Routes``): where ``forced`` holds the program's
expert ids, the reference takes them (weighted by its own scores) and
keeps ``gap``, the widest gap in biased scores by which a forced choice
lies below the reference's own 8th largest biased score at that token.
``used`` records the ids taken.
"""

import torch
import torch.nn.functional as F

from reference import plain

BLOCK_Q = 256  # query rows of one MLA attention block
CHUNK = 32  # positions of one KDA chunk
CHUNK_SLICE = 32  # chunks whose chunk-local parts are computed at once
L2_EPS = 1e-6


def layer_types(spec: dict) -> list[str]:
    """Each layer's mixer, "kda" or "mla", from the published 1-based lists."""
    lac = spec["linear_attn_config"]
    kda = set(lac["kda_layers"])
    return ["kda" if i + 1 in kda else "mla" for i in range(spec["num_hidden_layers"])]


def layer_weights(weights: dict, spec: dict, i: int) -> dict:
    """Layer ``i``'s parameters in the port's layout: the dense prefix,
    whole repeats of the shortest period (at least two) after it, then
    the tail."""
    first = spec["first_k_dense_replace"]
    if i < first:
        return weights["prefix"][i]
    body = layer_types(spec)[first:]
    p = next((p for p in range(1, len(body) // 2 + 1)
              if all(body[j] == body[j % p] for j in range(len(body) // p * p))), len(body))
    j = i - first
    whole = len(body) // p * p
    return plain.layer_params(weights, j // p, j % p) if j < whole else weights["suffix"][j - whole]


def _conv(y, w):
    """SiLU of the depthwise causal conv over dim 1 of y [B, S, C], taps w [k, C]."""
    taps, s = w.shape[0], y.shape[1]
    yp = F.pad(y, (0, 0, taps - 1, 0))
    out = yp[:, :s] * w[0]
    for i in range(1, taps):
        out = out + yp[:, i : i + s] * w[i]
    return F.silu(out)


def _l2norm(x):
    return x * torch.rsqrt((x * x).sum(-1, keepdim=True) + L2_EPS)


def recurrence(q, k, v, g, beta):
    """o [B, S, H, V] of the KDA recurrence, one position at a time from a
    zero state: q, k, g [B, S, H, K], v [B, S, H, V], beta [B, S, H]."""
    b, s, h, dk = q.shape
    state = torch.zeros(b, h, dk, v.shape[-1], dtype=torch.float32, device=q.device)
    out = []
    for t in range(s):
        state = state * torch.exp(g[:, t])[..., None]
        u = v[:, t] - torch.einsum("bhkv,bhk->bhv", state, k[:, t])
        state = state + beta[:, t, :, None, None] * k[:, t, ..., None] * u[:, :, None, :]
        out.append(torch.einsum("bhkv,bhk->bhv", state, q[:, t]))
    return torch.stack(out, dim=1)


def chunked(q, k, v, g, beta, chunk: int = CHUNK):
    """``recurrence``'s o, computed chunk by chunk (the equations above)."""
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    pad = -s % chunk  # padded positions: k = v = 0, g = 0 leave the state as it is

    def blocks(t):  # [B, S, H, ...] -> [B, H, N, C, ...]
        t = F.pad(t, (0,) * (2 * (t.dim() - 2)) + (0, pad))
        n = t.shape[1] // chunk
        return t.reshape(b, n, chunk, h, *t.shape[3:]).movedim(3, 1)

    q, k, v, g, beta = (blocks(t) for t in (q, k, v, g, beta))
    n = q.shape[2]
    c = g.cumsum(dim=3)  # [B, H, N, C, K]
    del g
    a = torch.empty(b, h, n, chunk, chunk, device=q.device)
    bm = torch.empty_like(a)
    for n0 in range(0, n, CHUNK_SLICE):
        cs = c[:, :, n0 : n0 + CHUNK_SLICE]
        # k_s exp(c_t - c_s) for every (t, s) of a chunk: [.., t, s, K]
        ks = (cs[..., :, None, :] - cs[..., None, :, :]).clamp_max_(0).exp_().mul_(k[:, :, n0 : n0 + CHUNK_SLICE, None])
        a[:, :, n0 : n0 + CHUNK_SLICE] = torch.einsum("bhntk,bhntsk->bhnts", k[:, :, n0 : n0 + CHUNK_SLICE], ks)
        bm[:, :, n0 : n0 + CHUNK_SLICE] = torch.einsum("bhntk,bhntsk->bhnts", q[:, :, n0 : n0 + CHUNK_SLICE], ks)
        del ks
    ones = torch.ones(chunk, chunk, dtype=torch.bool, device=q.device)
    a = a.masked_fill_(~ones.tril(-1), 0.0)
    bm = bm.masked_fill_(~ones.tril(0), 0.0)
    lower = a.mul_(beta[..., None]).add_(torch.eye(chunk, device=q.device))
    ec = torch.exp(c)
    u = torch.linalg.solve_triangular(lower, beta[..., None] * v, upper=False, unitriangular=True)
    wk = torch.linalg.solve_triangular(lower, beta[..., None] * (k * ec), upper=False, unitriangular=True)
    del lower, v, beta
    qd = q * ec
    del q, ec
    last = c[..., -1:, :]  # [B, H, N, 1, K]
    kend = k * torch.exp(last - c)
    dend = torch.exp(last).transpose(-1, -2)  # [B, H, N, K, 1]
    del k, c
    state = torch.zeros(b, h, dk, dv, dtype=torch.float32, device=qd.device)
    out = torch.empty(b, h, n, chunk, dv, dtype=torch.float32, device=qd.device)
    for i in range(n):
        w = u[:, :, i] - wk[:, :, i] @ state
        out[:, :, i] = qd[:, :, i] @ state + bm[:, :, i] @ w
        state = dend[:, :, i] * state + kend[:, :, i].transpose(-1, -2) @ w
    return out.movedim(1, 3).reshape(b, n * chunk, h, dv)[:, :s]


def kda(p, x, spec, mm, form=chunked):
    """KDA over x [B, S, d] (the equations above), the recurrence by ``form``."""
    lac = spec["linear_attn_config"]
    h, dk = lac["num_heads"], lac["head_dim"]
    b, s, _ = x.shape

    def mixed(name):
        return _conv(plain.dense(p[name], x, mm), plain.f32(p[f"conv_{name}"])).reshape(b, s, h, dk)

    q = _l2norm(mixed("q")) * dk**-0.5
    k = _l2norm(mixed("k"))
    v = mixed("v")
    decay = plain.dense(p["f_b"], plain.dense(p["f_a"], x, mm), mm).reshape(b, s, h, dk)
    g = -torch.exp(plain.f32(p["A_log"]))[:, None] * F.softplus(decay + plain.f32(p["dt_bias"]).reshape(h, dk))
    beta = torch.sigmoid(plain.dense(p["b"], x, mm))
    del decay
    o = form(q, k, v, g, beta)
    del q, k, v, g, beta
    gate = plain.dense(p["g_b"], plain.dense(p["g_a"], x, mm), mm).reshape(b, s, h, dk)
    o = plain.rmsnorm(o, p["o_norm"]["scale"], spec["rms_norm_eps"]) * torch.sigmoid(gate)
    return plain.dense(p["o"], o.reshape(b, s, h * dk), mm)


def mla(p, x, spec, mm):
    """Causal MLA without positional encoding over x [B, S, d], one batch
    row at a time."""
    b, s, _ = x.shape
    h, dn, dr, dv = (spec["num_attention_heads"], spec["qk_nope_head_dim"], spec["qk_rope_head_dim"],
                     spec["v_head_dim"])
    r, eps = spec["kv_lora_rank"], spec["rms_norm_eps"]
    scale = (dn + dr) ** -0.5
    out = torch.empty(b, s, h * dv, dtype=torch.float32, device=x.device)
    for row in range(b):
        xr = x[row]
        q = plain.dense(p["q"], xr, mm).reshape(s, h, dn + dr).transpose(0, 1)  # [H, S, 192]
        q_nope, q_pe = q[..., :dn], q[..., dn:]
        down = plain.dense(p["kv_down"], xr, mm)
        ckv = plain.rmsnorm(down[:, :r], p["kv_norm"]["scale"], eps)
        k_pe = down[:, r:]  # [S, 64], every head's
        k_nope = plain.dense(p["k_up"], ckv, mm).reshape(s, h, dn).transpose(0, 1)
        v = plain.dense(p["v_up"], ckv, mm).reshape(s, h, dv).transpose(0, 1)
        del down, ckv
        for q0 in range(0, s, BLOCK_Q):
            q1 = min(q0 + BLOCK_Q, s)
            logits = (q_nope[:, q0:q1] @ k_nope[:, :q1].transpose(-1, -2) + q_pe[:, q0:q1] @ k_pe[:q1].T) * scale
            future = torch.arange(q1, device=x.device)[None, :] > torch.arange(q0, q1, device=x.device)[:, None]
            probs = torch.softmax(logits.masked_fill(future, float("-inf")), dim=-1)
            out[row, q0:q1] = (probs @ v[:, :q1]).transpose(0, 1).reshape(q1 - q0, h * dv)
            del logits, probs
        del q, q_nope, q_pe, k_pe, k_nope, v
    return plain.dense(p["o"], out, mm)


def choose(routes, logits, bias, spec):
    """(weights, expert ids) [..., 8] over the router's width: the
    reference's own choice by biased sigmoid score, or the forced one
    (``routes``); weights the unbiased scores, renormalised and scaled."""
    k = spec["num_experts_per_token"]
    scores = torch.sigmoid(logits)
    biased = scores + plain.f32(bias)
    top = torch.topk(biased, k, dim=-1)
    own = top.indices
    if routes.forced is not None:
        idx = routes.forced[len(routes.used)].to(own.device)
        routes.gap = max(routes.gap, float((top.values[..., -1:] - biased.gather(-1, idx)).max()))
        own = idx
    routes.used.append(own)
    w = scores.gather(-1, own)
    if spec["moe_renormalize"]:
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    return w * spec["routed_scaling_factor"], own


def moe(p, x, spec, segments, mm, routes):
    k, e_all = spec["num_experts_per_token"], spec["router_experts"]
    first, held = spec["first_expert"], spec["num_experts"]
    cf = spec["capacity_factor"]
    b, s, d = x.shape
    w, idx = choose(routes, plain.dense(p["router"], x, plain.f32_mm), p["score_bias"], spec)
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


def logits(weights, spec, tokens, read, segments, mm=plain.f32_mm, routes=None, form=chunked):
    routes = routes if routes is not None else plain.Routes()
    eps = spec["rms_norm_eps"]
    dense = spec["first_k_dense_replace"]
    x = plain.f32(weights["embed"]["table"][tokens.long()])
    for i, kind in enumerate(layer_types(spec)):
        lp = layer_weights(weights, spec, i)
        h = plain.rmsnorm(x, lp["ln1"]["scale"], eps)
        x = x + (kda(lp["block"], h, spec, mm, form) if kind == "kda" else mla(lp["block"], h, spec, mm))
        h = plain.rmsnorm(x, lp["ln2"]["scale"], eps)
        x = x + (plain.swiglu(lp["ffn"], h, mm) if i < dense else moe(lp["ffn"], h, spec, segments, mm, routes))
    x = plain.rmsnorm(x[:, read], weights["final_norm"]["scale"], eps)
    return plain.dense(weights["head"], x, mm)
