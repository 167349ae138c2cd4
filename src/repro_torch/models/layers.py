"""Shared layers: norm, RoPE, dense (with scheduled-kernel routing),
SwiGLU MLP, embedding.  Functional style: ``init_*`` build param trees,
apply functions are pure.

Port of ``repro.models.layers``.  The ``init_*`` functions draw from an
explicit ``torch.Generator`` on the device the parameters live on, each
tensor in float32 and then cast to the parameter dtype, as the reference
does.  ``lead`` is a leading shape for parameters stacked across scan
groups: the stacked tensor is allocated once and each group's slice is
drawn into it in place, so a full-width model never holds a float32 copy
of more than one tensor.  The draws follow torch's generator, not JAX's:
a model built here and one built by the reference from the same seed
differ, and parity tests convert the reference's parameters instead
(``repro_torch.models.lm.params_from_numpy``).
"""

from __future__ import annotations

import itertools

import torch

from repro_torch.kernels import ops, policy
from repro_torch.kernels.ref import gelu_tanh


def draw_normal(
    gen: torch.Generator, shape, scale: float, dtype: torch.dtype, lead=()
) -> torch.Tensor:
    """``normal(shape) * scale`` drawn in float32 on ``gen``'s device and
    cast to ``dtype``, for each index of ``lead`` in turn."""
    out = torch.empty((*lead, *shape), dtype=dtype, device=gen.device)
    for idx in itertools.product(*(range(n) for n in lead)):
        out[idx].copy_(torch.randn(shape, generator=gen, device=gen.device) * scale)
    return out


# ---------------------------------------------------------------------------
# dense — every model GEMM funnels through here so the paper's scheduled
# kernels apply framework-wide when a policy is active.
# ---------------------------------------------------------------------------


def init_dense(gen, d_in: int, d_out: int, *, bias: bool = False, dtype=torch.float32, lead=()):
    scale = (2.0 / (d_in + d_out)) ** 0.5
    p = {"w": draw_normal(gen, (d_in, d_out), scale, dtype, lead)}
    if bias:
        p["b"] = torch.zeros((*lead, d_out), dtype=dtype, device=gen.device)
    return p


def dense(params, x: torch.Tensor, *, compute_dtype=None) -> torch.Tensor:
    """``x @ w (+ b)``.  Under ``policy.scheduled_kernels`` a product of at
    least ``min_m`` rows (m = the product of x's leading dims) runs on the
    scheduled GEMM kernel with the f32 accumulator, bias added there in
    f32, output in x's dtype; otherwise ``x @ w`` runs first and the bias
    is added in the output dtype."""
    w = params["w"]
    b = params.get("b")
    if compute_dtype is not None:
        x = x.to(compute_dtype)
        w = w.to(compute_dtype)

    pol = policy.get_policy()
    if pol is not None:
        m = 1
        for s in x.shape[:-1]:
            m *= s
        cfg = pol.config_for(m, x.shape[-1], w.shape[-1], x.dtype, has_bias=b is not None)
        if cfg is not None:
            return ops.matmul(x, w, cfg, b)

    out = x @ w
    if b is not None:
        out = out + b.to(out.dtype)
    return out


# ---------------------------------------------------------------------------


def init_rmsnorm(d: int, dtype=torch.float32, *, device=None, lead=()):
    return {"scale": torch.ones((*lead, d), dtype=dtype, device=device)}


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * params["scale"].to(torch.float32)).to(dt)


# ---------------------------------------------------------------------------


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float = 10000.0):
    """cos/sin tables for given positions: [..., head_dim//2]."""
    half = head_dim // 2
    exponent = torch.arange(half, dtype=torch.float32, device=positions.device) / half
    freqs = 1.0 / (theta**exponent)
    angles = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [..., S, D]; cos/sin broadcastable [..., S, D//2] (split halves)."""
    x1, x2 = torch.chunk(x, 2, dim=-1)
    cos = cos.to(x1.dtype)
    sin = sin.to(x1.dtype)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


# ---------------------------------------------------------------------------


def init_mlp(gen, d_model: int, d_ff: int, dtype=torch.float32, kind: str = "swiglu", *, lead=()):
    if kind == "gelu":
        return {
            "up": init_dense(gen, d_model, d_ff, bias=True, dtype=dtype, lead=lead),
            "down": init_dense(gen, d_ff, d_model, bias=True, dtype=dtype, lead=lead),
        }
    return {
        "gate": init_dense(gen, d_model, d_ff, dtype=dtype, lead=lead),
        "up": init_dense(gen, d_model, d_ff, dtype=dtype, lead=lead),
        "down": init_dense(gen, d_ff, d_model, dtype=dtype, lead=lead),
    }


def mlp(params, x: torch.Tensor, *, compute_dtype=None) -> torch.Tensor:
    u = dense(params["up"], x, compute_dtype=compute_dtype)
    if "gate" in params:
        g = dense(params["gate"], x, compute_dtype=compute_dtype)
        h = torch.nn.functional.silu(g.to(torch.float32)).to(u.dtype) * u
    else:
        h = gelu_tanh(u.to(torch.float32)).to(u.dtype)
    return dense(params["down"], h, compute_dtype=compute_dtype)


# ---------------------------------------------------------------------------


def init_embedding(gen, vocab: int, d_model: int, dtype=torch.float32):
    return {"table": draw_normal(gen, (vocab, d_model), 0.02, dtype)}


def embed(params, tokens: torch.Tensor) -> torch.Tensor:
    return params["table"][tokens.long()]


def unembed(params, x: torch.Tensor, *, compute_dtype=None) -> torch.Tensor:
    t = params["table"]
    if compute_dtype is not None:
        x = x.to(compute_dtype)
        t = t.to(compute_dtype)
    return x @ t.T
