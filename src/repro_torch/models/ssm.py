"""Mamba (selective SSM) block — Jamba's recurrent layer.

Prefill runs a chunked selective scan: a loop over sequence chunks
carrying the SSM state h [B, d_in, d_state]; inside a chunk the
recurrence h_t = a_t * h_{t-1} + b_t is a parallel prefix scan, so peak
memory is O(chunk * d_in * d_state) instead of O(S * ...).  Decode
carries h explicitly, O(1) per token.

The selective scan is elementwise work, not a GEMM; the projections
around it (in, x, dt, out) go through ``layers.dense`` and so through the
scheduled kernel under ``scheduled_kernels``.

Port of ``repro.models.ssm``.  ``jax.lax.associative_scan`` becomes a
log-step (Hillis–Steele) scan over the chunk axis with the reference's
combine ``(a1·a2, a2·b1 + b2)``: ⌈log₂ chunk⌉ rounds of whole-tensor
products (7 at chunk 128) instead of one host step per position.  The
two scans associate the products differently, so they agree to float
rounding, not bit for bit.  ``jax.checkpoint`` (training only) is left
out.  Under ``repro_torch.tracing.recording`` a block records the spans
``mamba.in_proj`` (with the causal conv), ``mamba.scan`` (the chunk loop)
and ``mamba.out_proj`` (with the gate).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import tracing
from repro_torch.kernels.ref import torch_dtype
from repro_torch.models import layers as L
from repro_torch.models.config import MambaConfig, ModelConfig


def _dt_rank(cfg: ModelConfig) -> int:
    mc = cfg.mamba or MambaConfig()
    return mc.dt_rank or -(-cfg.d_model // 16)


def init_mamba(gen, cfg: ModelConfig, dtype=torch.float32, *, lead=()):
    mc = cfg.mamba or MambaConfig()
    d = cfg.d_model
    d_in = mc.expand * d
    dtr = _dt_rank(cfg)
    dev = gen.device
    a = torch.arange(1, mc.d_state + 1, dtype=torch.float32, device=dev)
    return {
        "in_proj": L.init_dense(gen, d, 2 * d_in, dtype=dtype, lead=lead),
        "conv_w": L.draw_normal(gen, (mc.d_conv, d_in), 0.2, dtype, lead),
        "conv_b": torch.zeros((*lead, d_in), dtype=dtype, device=dev),
        "x_proj": L.init_dense(gen, d_in, dtr + 2 * mc.d_state, dtype=dtype, lead=lead),
        "dt_proj": L.init_dense(gen, dtr, d_in, bias=True, dtype=dtype, lead=lead),
        "A_log": torch.log(a).expand(*lead, d_in, mc.d_state).clone(),
        "D": torch.ones((*lead, d_in), dtype=torch.float32, device=dev),
        "out_proj": L.init_dense(gen, d_in, d, dtype=dtype, lead=lead),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, state=None):
    """Depthwise causal conv along S: x [B,S,Din], w [K,Din].  The K terms
    are summed in the reference's order.  Returns (y, new_state), the
    state being the trailing K-1 inputs."""
    ksz = w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], ksz - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    xp = torch.cat([state.to(x.dtype), x], dim=1)
    s = x.shape[1]
    y = sum(xp[:, i : i + s] * w[i][None, None, :] for i in range(ksz))
    new_state = xp[:, -(ksz - 1) :] if ksz > 1 else state
    return y + b[None, None, :], new_state


class MambaState(NamedTuple):
    h: torch.Tensor  # [B, d_in, d_state] f32
    conv: torch.Tensor  # [B, K-1, d_in]


def init_mamba_state(cfg: ModelConfig, batch: int, dtype=torch.float32, *, device=None, lead=()) -> MambaState:
    mc = cfg.mamba or MambaConfig()
    d_in = mc.expand * cfg.d_model
    return MambaState(
        h=torch.zeros((*lead, batch, d_in, mc.d_state), dtype=torch.float32, device=device),
        conv=torch.zeros((*lead, batch, mc.d_conv - 1, d_in), dtype=dtype, device=device),
    )


def _ssm_params(params, cfg: ModelConfig, u: torch.Tensor):
    """u [B,S,d_in] -> (dA [B,S,d_in,n], dBu [B,S,d_in,n], C [B,S,n])."""
    mc = cfg.mamba or MambaConfig()
    dtr = _dt_rank(cfg)
    proj = L.dense(params["x_proj"], u)  # [B,S,dtr+2n]
    # dt is a strided slice: ops._operands copies it to a contiguous tensor
    dt, bmat, cmat = torch.split(proj, [dtr, mc.d_state, mc.d_state], dim=-1)
    dt = torch.nn.functional.softplus(L.dense(params["dt_proj"], dt).to(torch.float32))  # [B,S,d_in]
    a = -torch.exp(params["A_log"])  # [d_in, n]
    d_a = torch.exp(dt[..., None] * a[None, None])
    d_bu = (dt * u.to(torch.float32))[..., None] * bmat.to(torch.float32)[:, :, None, :]
    return d_a, d_bu, cmat.to(torch.float32)


def _scan_chunk(h0: torch.Tensor, d_a: torch.Tensor, d_bu: torch.Tensor):
    """Inclusive scan of h_t = dA_t h_{t-1} + dBu_t over the chunk axis
    (dim 1), log-step: at offset o each position combines with the one o
    before it, ``(a1·a2, a2·b1 + b2)`` with 1 the earlier.
    h0 [B,d_in,n]; dA/dBu [B,c,d_in,n] -> (h over the chunk, final h)."""
    a, b = d_a, d_bu
    c = a.shape[1]
    off = 1
    while off < c:
        a, b = (
            torch.cat([a[:, :off], a[:, :-off] * a[:, off:]], dim=1),
            torch.cat([b[:, :off], a[:, off:] * b[:, :-off] + b[:, off:]], dim=1),
        )
        off *= 2
    h = a * h0[:, None] + b
    return h, h[:, -1]


def mamba_block(params, cfg: ModelConfig, x: torch.Tensor, state: MambaState | None = None):
    """x [B,S,d] -> (y [B,S,d], final MambaState).  Chunked over S."""
    mc = cfg.mamba or MambaConfig()
    b, s, _ = x.shape
    compute = torch_dtype(cfg.compute_dtype)
    with tracing.span("mamba.in_proj"):
        xz = L.dense(params["in_proj"], x, compute_dtype=compute)
        u, z = torch.chunk(xz, 2, dim=-1)  # [B,S,d_in] each
        conv_state = state.conv if state is not None else None
        u, conv_state = _causal_conv(u, params["conv_w"].to(compute), params["conv_b"].to(compute), conv_state)
        u = torch.nn.functional.silu(u)

    with tracing.span("mamba.scan"):
        if state is not None:
            h = state.h
        else:
            h = torch.zeros((b, u.shape[-1], mc.d_state), dtype=torch.float32, device=x.device)

        chunk = L.chunk_len(s, mc.chunk)
        ys = []
        for c0 in range(0, s, chunk):
            u_c = u[:, c0 : c0 + chunk]
            d_a, d_bu, c_c = _ssm_params(params, cfg, u_c)
            h_seq, h = _scan_chunk(h, d_a, d_bu)
            y_c = torch.einsum("bcdn,bcn->bcd", h_seq, c_c)  # [B,c,d_in]
            ys.append(y_c + params["D"][None, None] * u_c.to(torch.float32))
        y = torch.cat(ys, dim=1)

    with tracing.span("mamba.out_proj"):
        y = y.to(compute) * torch.nn.functional.silu(z.to(torch.float32)).to(compute)
        out = L.dense(params["out_proj"], y, compute_dtype=compute)
    return out.to(x.dtype), MambaState(h=h, conv=conv_state)


def mamba_decode_step(params, cfg: ModelConfig, x: torch.Tensor, state: MambaState):
    """Single-token step: x [B,1,d] -> (y [B,1,d], new state).  O(1) in S."""
    return mamba_block(params, cfg, x, state)
