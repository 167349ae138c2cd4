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

import functools
import itertools
import math

import torch
from torch._subclasses.fake_tensor import FakeTensor

from repro_torch import tracing
from repro_torch.kernels import ops, policy
from repro_torch.kernels.ref import gelu_tanh
from repro_torch.parallel.policy import gather_fsdp, gather_rows, reduce_partial


def draw_normal(
    gen: torch.Generator, shape, scale: float, dtype: torch.dtype, lead=()
) -> torch.Tensor:
    """``normal(shape) * scale`` drawn in float32 on ``gen``'s device and
    cast to ``dtype``, for each index of ``lead`` in turn; under a
    ``FakeTensorMode`` (shapes without values) nothing is drawn."""
    out = torch.empty((*lead, *shape), dtype=dtype, device=gen.device)
    if isinstance(out, FakeTensor):  # shapes only (a dry run): there are no values to draw
        return out
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


def _count_flops(counter: str, x: torch.Tensor, w: torch.Tensor) -> None:
    """Add the 2·m·k·n operations of a weight product ``x @ w`` to
    ``counter`` ("gemm.routed_flops" or "gemm.unrouted_flops") while a
    ``tracing`` recording is on."""
    if tracing.active() is not None:
        tracing.count(counter, 2 * x.numel() * w.shape[-1])


def dense(params, x: torch.Tensor, *, compute_dtype=None) -> torch.Tensor:
    """``x @ w (+ b)``.  Under ``policy.scheduled_kernels`` a product of at
    least ``min_m`` rows (m = the product of x's leading dims) runs on the
    scheduled GEMM kernel with the f32 accumulator, bias added there in
    f32, output in x's dtype; otherwise ``x @ w`` runs first and the bias
    is added in the output dtype.

    The scheduled kernel has no backward (nor has the reference's Pallas
    kernel), so under a policy a product that autograd would differentiate
    raises ``RuntimeError`` before any launch, on every device: training
    runs unrouted.  Under ``repro_torch.tracing.recording`` each product
    counts its 2·m·k·n operations as routed or unrouted."""
    w = gather_fsdp(params["w"])
    b = gather_fsdp(params.get("b"))
    pol = policy.get_policy()
    differentiated = any(t is not None and t.requires_grad for t in (x, w, b))
    if pol is not None and torch.is_grad_enabled() and differentiated:
        raise RuntimeError(
            "layers.dense: a scheduled-kernel policy is installed and autograd would differentiate "
            "this product, but the scheduled GEMM kernel has no backward; run training outside "
            "scheduled_kernels (unrouted), as the reference does"
        )
    x = gather_rows(x)
    if compute_dtype is not None:
        x = x.to(compute_dtype)
        w = w.to(compute_dtype)

    if pol is not None:
        m = 1
        for s in x.shape[:-1]:
            m *= s
        cfg = pol.config_for(m, x.shape[-1], w.shape[-1], x.dtype, has_bias=b is not None)
        if cfg is not None:
            _count_flops("gemm.routed_flops", x, w)
            return ops.matmul(x, w, cfg, b)
    _count_flops("gemm.unrouted_flops", x, w)

    # a row-parallel product's pending sums are reduced here (all-reduce),
    # so its gradient comes back whole over the model axis
    out = reduce_partial(x @ w)
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


def yarn_mscale(factor: float, mscale: float) -> float:
    """YaRN's attention-temperature factor: 0.1 mscale ln(factor) + 1."""
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


@functools.lru_cache(maxsize=None)
def yarn_frequencies(half: int, theta: float, scaling, device=None) -> torch.Tensor:
    """YaRN's inverse frequencies of a rope part of ``2 half`` dims
    (DeepSeek-V2's ``DeepseekV2YarnRotaryEmbedding``) on ``device``: the
    original theta^(-i / half) on the dims that turn more than
    ``beta_fast`` times over ``original_max_position``, divided by
    ``factor`` on those that turn fewer than ``beta_slow`` times, a linear
    ramp between.  Made once per device: a copy from the host at every
    call would wait for the device's queue."""
    exponent = torch.arange(half, dtype=torch.float32) / half
    extra = 1.0 / theta**exponent
    inter = 1.0 / (scaling.factor * theta**exponent)

    def dim_of(rotations: float) -> float:
        return half * math.log(scaling.original_max_position / (rotations * 2 * math.pi)) / math.log(theta)

    low = max(math.floor(dim_of(scaling.beta_fast)), 0)
    high = min(math.ceil(dim_of(scaling.beta_slow)), 2 * half - 1)
    ramp = torch.clamp((torch.arange(half, dtype=torch.float32) - low) / ((high - low) or 0.001), 0, 1)
    keep = 1.0 - ramp  # 1 where the original frequency stays
    return (inter * (1 - keep) + extra * keep).to(device)


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float = 10000.0, scaling=None):
    """cos/sin tables for given positions: [..., head_dim//2]; with
    ``scaling`` (``config.YarnRope``) YaRN's frequencies and magnitude."""
    half = head_dim // 2
    if scaling is None:
        exponent = torch.arange(half, dtype=torch.float32, device=positions.device) / half
        freqs = 1.0 / (theta**exponent)
    else:
        freqs = yarn_frequencies(half, theta, scaling, positions.device)
    angles = positions.to(torch.float32)[..., None] * freqs
    if scaling is None:
        return torch.cos(angles), torch.sin(angles)
    mag = yarn_mscale(scaling.factor, scaling.mscale) / yarn_mscale(scaling.factor, scaling.mscale_all_dim)
    return torch.cos(angles) * mag, torch.sin(angles) * mag


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


def chunk_len(s: int, target: int) -> int:
    """The chunk length of a sequence of ``s`` that the chunked Mamba and
    mLSTM forms run at: ``target`` (at most ``s``) where it divides ``s``,
    else the whole sequence as one chunk, as the reference does."""
    c = min(target, s)
    return s if s % c else c


# ---------------------------------------------------------------------------


def init_embedding(gen, vocab: int, d_model: int, dtype=torch.float32):
    return {"table": draw_normal(gen, (vocab, d_model), 0.02, dtype)}


def embed(params, tokens: torch.Tensor) -> torch.Tensor:
    """Rows of the table; over a vocab-sharded table each shard looks up
    its own rows and the partial rows are summed (all-reduce)."""
    return reduce_partial(torch.nn.functional.embedding(tokens.long(), gather_fsdp(params["table"])))


def unembed(params, x: torch.Tensor, *, compute_dtype=None) -> torch.Tensor:
    t = gather_fsdp(params["table"])
    if compute_dtype is not None:
        x = x.to(compute_dtype)
        t = t.to(compute_dtype)
    t = t.T
    _count_flops("gemm.unrouted_flops", x, t)
    return x @ t
