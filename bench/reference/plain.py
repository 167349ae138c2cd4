"""The plain reference of the port's LM stack, in float32 PyTorch.

Written from the equations, not from the program: it imports nothing of
``repro_torch`` (nor JAX, nor the JAX package), runs no kernel, cache or
batching of the program, and reads only the weights and tokens that the
benchmark made.  One forward pass runs over a wave's whole sequences
(the left padding with token 0, unmasked, as the engine serves it, then
the served tokens), layer by layer, each layer's weights widened to
float32 as it is reached, attention one row at a time, so that a
full-width model fits beside the program's bf16 weights.

Every matrix product goes through ``mm``: ``f32_mm`` (TF32 off) is the
reference, ``fp8_mm`` the control, the same arithmetic with both operands
rounded to float8 e4m3 (per-row and per-column scales), the nearest
precision below the configurations' bfloat16.
"""

from __future__ import annotations

import contextlib
import math

import torch

F8_MAX = 448.0


class Routes:
    """Expert choices through an MoE model's layers, in layer order.

    Where ``forced`` holds a choice per layer ([B, S, k] expert ids), the
    reference takes those experts (weighted by its own router's
    probabilities) and keeps ``gap``: the widest gap, in router logits,
    by which a forced expert lies below its own router's k-th best at the
    same token.  A router that chose as the reference would, up to
    rounding, reads about twice its logits' distance; one that chose
    otherwise reads the spread of the router's logits.  ``used`` records
    the choices taken."""

    def __init__(self, forced=None):
        self.forced = forced
        self.used: list = []
        self.gap = 0.0

    def choose(self, logits: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
        """(weights, expert ids) of one MoE layer from its router's logits."""
        probs = torch.softmax(logits, dim=-1)
        w, own = torch.topk(probs, k, dim=-1)
        if self.forced is not None:
            idx = self.forced[len(self.used)].to(own.device)
            kth = torch.topk(logits, k, dim=-1).values[..., -1:]
            self.gap = max(self.gap, float((kth - logits.gather(-1, idx)).max()))
            w, own = probs.gather(-1, idx), idx
        self.used.append(own)
        return w, own


def f32_mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x @ w


def _to_fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    scale = torch.clamp_min(t.abs().amax(dim=dim, keepdim=True) / F8_MAX, 1e-30)
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def fp8_mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return _to_fp8(x, -1) @ _to_fp8(w, -2)


@contextlib.contextmanager
def full_f32():
    """float32 products in float32, not TF32, while the reference runs."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    prec = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = m, c
        torch.set_float32_matmul_precision(prec)


def f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32)


def dense(p: dict, x: torch.Tensor, mm) -> torch.Tensor:
    y = mm(x, f32(p["w"]))
    return y + f32(p["b"]) if "b" in p else y


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * f32(scale)


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding over the two halves of the last dim: x [..., S, D]."""
    half = x.shape[-1] // 2
    freqs = 1.0 / theta ** (torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = pos.to(torch.float32)[:, None] * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(p: dict, x: torch.Tensor, spec: dict, mm) -> torch.Tensor:
    """Causal GQA attention with RoPE at positions 0..S-1 (each KV head
    serves its consecutive query heads), softmax in float32."""
    b, s, _ = x.shape
    h, hkv = spec["n_heads"], spec["n_kv_heads"]
    dh = spec.get("head_dim") or spec["d_model"] // h
    pos = torch.arange(s, device=x.device)

    def heads(t, n):
        return t.reshape(b, s, n, dh).transpose(1, 2)

    q = rope(heads(dense(p["q"], x, mm), h), pos, spec["rope_theta"])
    k = rope(heads(dense(p["k"], x, mm), hkv), pos, spec["rope_theta"])
    v = heads(dense(p["v"], x, mm), hkv)
    k, v = k.repeat_interleave(h // hkv, dim=1), v.repeat_interleave(h // hkv, dim=1)
    future = torch.ones(s, s, dtype=torch.bool, device=x.device).triu(1)
    out = torch.empty_like(q)
    for r in range(b):
        scores = (q[r] @ k[r].transpose(-1, -2)) / math.sqrt(dh)
        out[r] = torch.softmax(scores.masked_fill(future, float("-inf")), dim=-1) @ v[r]
        del scores
    return dense(p["o"], out.transpose(1, 2).reshape(b, s, h * dh), mm)


def swiglu(p: dict, x: torch.Tensor, mm) -> torch.Tensor:
    return dense(p["down"], torch.nn.functional.silu(dense(p["gate"], x, mm)) * dense(p["up"], x, mm), mm)


def layer_params(weights: dict, g: int, pos: int) -> dict:
    """Group ``g``'s slice of the stacked parameters at pattern position ``pos``."""

    def take(t):
        if isinstance(t, dict):
            return {k: take(v) for k, v in t.items()}
        return t[g]

    return take(weights["groups"][f"pos{pos}"])


def forward(weights: dict, spec: dict, tokens: torch.Tensor, read: torch.Tensor, *, block, ffn, mm=f32_mm):
    """Logits [B, len(read), V] at positions ``read`` of ``tokens`` [B, S].

    ``block(kind, params, h)`` runs a layer's mixer on its normed input and
    ``ffn(is_moe, params, h)`` its FFN; a layer is x + block(norm(x)), then
    x + ffn(norm(x)) where it has one."""
    pattern = spec.get("block_pattern") or ["attn"]
    eps = spec["norm_eps"]
    x = f32(weights["embed"]["table"][tokens.long()])
    for g in range(spec["n_layers"] // len(pattern)):
        for i, kind in enumerate(pattern):
            lp = layer_params(weights, g, i)
            x = x + block(kind, lp["block"], rmsnorm(x, lp["ln1"]["scale"], eps))
            if "ffn" in lp:
                x = x + ffn(i, lp["ffn"], rmsnorm(x, lp["ln2"]["scale"], eps))
    x = rmsnorm(x[:, read], weights["final_norm"]["scale"], eps)
    return dense(weights["head"], x, mm)
