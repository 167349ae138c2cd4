"""KDA (Kimi Delta Attention) block — Kimi-Linear's linear-attention layer.

A gated delta rule with a decay per key channel.  Per head (``KDAConfig``:
H heads of K = V = ``head_dim``) and position:

    q = L2norm(SiLU(conv(x W_q))) K^-1/2,  k = L2norm(SiLU(conv(x W_k))),
    v = SiLU(conv(x W_v))                  (depthwise causal convs over S)
    g = -exp(A_log[h]) softplus(x W_fa W_fb + dt_bias)   (the log-decay, [K])
    beta = sigmoid(x W_b)                                (one a head)
    S <- Diag(exp g) S;  S <- S + beta k (v - S^T k)^T;  o = S^T q
    y = (RMSNorm(o) w_norm sigmoid(x W_ga W_gb)) W_o     (the norm per head)

with S a [K, V] float32 state.  The recurrence is one call of
``kernels/kda.py:kda_recurrent`` a block call, prefill and decode step
alike (the kernel on the card, the plain position loop elsewhere); a
decode step is the same call at S = 1 from the cached state, in place
where the caller hands the cache's state as ``into``.  The projections
(q, k, v, the two low-rank gates, beta, out) go through ``layers.dense``
and so through the scheduled kernel under ``scheduled_kernels``; the
convolutions, norms and gates are elementwise work in float32, q, k and v
rounded to the compute dtype once before the recurrence.

The port's own module: the reference has no linear-attention block.  The
kernel has no backward and reads a tensor's own memory, so a block whose
inputs require grad (training) or are DTensors calls the plain version
itself.  Under ``repro_torch.tracing.recording`` a block records the
spans ``kda.proj`` (the five input projections, the convolutions, the
gate and beta), ``kda.core`` (the recurrence) and ``kda.out`` (the gated
norm and W_o), and counts ``kda.kernel_calls`` or ``kda.plain_calls``
once.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch import tracing
from repro_torch.kernels import kda as KK
from repro_torch.kernels.ref import torch_dtype
from repro_torch.models import layers as L
from repro_torch.models.config import HybridMLAConfig, ModelConfig

#: the L2 norm's epsilon on q and k (FLA's ``l2norm``)
L2_EPS = 1e-6
#: the range of exp(A_log) and of softplus(dt_bias) drawn at init (Mamba's
#: and FLA's KDA initialisation)
A_RANGE = (1.0, 16.0)
DT_RANGE = (1e-3, 1e-1)
#: the convolutions' taps are drawn normal at this scale, as Mamba's
CONV_SCALE = 0.2


def _sizes(cfg: HybridMLAConfig) -> tuple[int, int, int]:
    kc = cfg.kda
    return kc.n_heads, kc.head_dim, kc.conv_size


def init_kda(gen, cfg: ModelConfig, dtype=torch.float32, *, lead=()):
    h, dk, conv = _sizes(cfg)
    d, width = cfg.d_model, h * dk
    dev = gen.device
    a = torch.empty((*lead, h), dtype=torch.float32, device=dev).uniform_(*A_RANGE, generator=gen)
    lo, hi = (math.log(x) for x in DT_RANGE)
    dt = torch.exp(torch.empty((*lead, width), dtype=torch.float32, device=dev).uniform_(lo, hi, generator=gen))
    return {
        "q": L.init_dense(gen, d, width, dtype=dtype, lead=lead),
        "k": L.init_dense(gen, d, width, dtype=dtype, lead=lead),
        "v": L.init_dense(gen, d, width, dtype=dtype, lead=lead),
        "conv_q": L.draw_normal(gen, (conv, width), CONV_SCALE, dtype, lead),
        "conv_k": L.draw_normal(gen, (conv, width), CONV_SCALE, dtype, lead),
        "conv_v": L.draw_normal(gen, (conv, width), CONV_SCALE, dtype, lead),
        "f_a": L.init_dense(gen, d, dk, dtype=dtype, lead=lead),
        "f_b": L.init_dense(gen, dk, width, dtype=dtype, lead=lead),
        "g_a": L.init_dense(gen, d, dk, dtype=dtype, lead=lead),
        "g_b": L.init_dense(gen, dk, width, dtype=dtype, lead=lead),
        "b": L.init_dense(gen, d, h, dtype=dtype, lead=lead),
        "A_log": torch.log(a),
        "dt_bias": dt + torch.log(-torch.expm1(-dt)),  # softplus(dt_bias) = dt
        "o_norm": L.init_rmsnorm(dk, dtype, device=dev, lead=lead),
        "o": L.init_dense(gen, width, d, dtype=dtype, lead=lead),
    }


class KDAState(NamedTuple):
    S: torch.Tensor  # [B, H, K, V] f32
    conv_q: torch.Tensor  # [B, conv - 1, H K]: the last inputs of each convolution
    conv_k: torch.Tensor
    conv_v: torch.Tensor


def init_kda_state(cfg: ModelConfig, batch: int, dtype=torch.float32, *, device=None, lead=()) -> KDAState:
    h, dk, conv = _sizes(cfg)
    tail = (*lead, batch, conv - 1, h * dk)
    return KDAState(
        S=torch.zeros((*lead, batch, h, dk, dk), dtype=torch.float32, device=device),
        conv_q=torch.zeros(tail, dtype=dtype, device=device),
        conv_k=torch.zeros(tail, dtype=dtype, device=device),
        conv_v=torch.zeros(tail, dtype=dtype, device=device),
    )


def _conv(x: torch.Tensor, w: torch.Tensor, tail: torch.Tensor | None):
    """SiLU of the depthwise causal conv of x [B, S, C] (w [taps, C]) in
    float32, after the ``tail`` of earlier inputs [B, taps - 1, C] (None:
    zeros) -> (y [B, S, C] f32, the new tail: the last taps - 1 inputs).
    The positions whose taps reach into the tail come from a short copy of
    it; the others are taps - 1 fused multiply-adds over shifted views of
    x, so no padded copy of x is made."""
    taps, (b, s, c) = w.shape[0], x.shape
    if tail is None:
        tail = torch.zeros((b, taps - 1, c), dtype=x.dtype, device=x.device)
    w32 = w.to(torch.float32)
    head = min(s, taps - 1)
    xp = torch.cat([tail.to(x.dtype), x[:, :head]], dim=1).to(torch.float32)
    y = torch.empty((b, s, c), dtype=torch.float32, device=x.device)
    y[:, :head] = sum(xp[:, i : i + head] * w32[i] for i in range(taps))
    if s > head:
        x32 = x.to(torch.float32)
        body = torch.mul(x32[:, : s - head], w32[0], out=y[:, head:])
        for i in range(1, taps):
            body.addcmul_(x32[:, i : s - head + i], w32[i])
        del x32
    new_tail = x[:, s - (taps - 1) :] if s >= taps - 1 else torch.cat([tail[:, s:].to(x.dtype), x], dim=1)
    return F.silu(y, inplace=True), new_tail


def _l2norm(x: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """x / sqrt(sum x^2 + eps) over the last dim, times ``scale``, in place."""
    return x.mul_((torch.rsqrt(torch.linalg.vecdot(x, x) + L2_EPS) * scale)[..., None])


def kda_block(params, cfg: ModelConfig, x: torch.Tensor, state: KDAState | None = None, *, into=None):
    """x [B, S, d] -> (y [B, S, d], final KDAState): one recurrence over S
    from ``state`` (None: zeros).  ``into`` ([B, H, K, V] f32, may be
    ``state.S``) receives the final S in place; the returned state's S is
    then ``into`` itself."""
    h, dk, _ = _sizes(cfg)
    b, s, _ = x.shape
    compute = torch_dtype(cfg.compute_dtype)
    f32 = torch.float32
    with tracing.span("kda.proj"):
        heads = []
        tails = []
        for name in ("q", "k", "v"):
            p = L.dense(params[name], x, compute_dtype=compute)
            y, tail = _conv(p, params[f"conv_{name}"], getattr(state, f"conv_{name}") if state is not None else None)
            y = y.reshape(b, s, h, dk)
            if name != "v":
                y = _l2norm(y, dk**-0.5 if name == "q" else 1.0)
            heads.append(y.to(compute))
            tails.append(tail)
            del p, y
        decay = L.dense(params["f_b"], L.dense(params["f_a"], x, compute_dtype=compute), compute_dtype=compute)
        a = torch.exp(params["A_log"].to(f32))[:, None]  # [H, 1]
        g = F.softplus(decay.reshape(b, s, h, dk) + params["dt_bias"].to(f32).reshape(h, dk)).mul_(-a)
        beta = torch.sigmoid(L.dense(params["b"], x, compute_dtype=compute).to(f32))

    with tracing.span("kda.core"):
        q, k, v = heads
        args = (q, k, v, g, beta, state.S.contiguous() if state is not None else None)
        differentiated = torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (*args, x))
        if differentiated or isinstance(q, DTensor):
            tracing.count("kda.plain_calls")
            o, s_new = KK.kda_recurrent_plain(*args, state=into)
        else:
            o, s_new = KK.kda_recurrent(*args, state=into)

    with tracing.span("kda.out"):
        gate = L.dense(params["g_b"], L.dense(params["g_a"], x, compute_dtype=compute), compute_dtype=compute)
        o = o.to(f32)
        norm = torch.rsqrt(torch.linalg.vecdot(o, o) / dk + cfg.norm_eps)  # RMSNorm over each head's V
        o.mul_(norm[..., None]).mul_(params["o_norm"]["scale"].to(f32))
        o.mul_(torch.sigmoid_(gate.reshape(b, s, h, dk).to(f32)))
        y = L.dense(params["o"], o.to(compute).reshape(b, s, h * dk), compute_dtype=compute)
    return y.to(x.dtype), KDAState(s_new, *tails)
