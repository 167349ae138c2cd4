"""Mamba (selective SSM) block — Jamba's recurrent layer.

A block call runs the causal conv, then the x and dt projections once
over the whole sequence, then one selective scan
(``kernels/scan.py:selective_scan``) carrying the SSM state h [B, d_in,
d_state] from the given state (or zeros) to the returned one: the fused
CUDA kernel on the card, the chunked plain version elsewhere, whose peak
memory is O(chunk * d_in * d_state) instead of O(S * ...).  Decode is the
same call at S = 1, O(1) per token.

The scan is elementwise work, not a GEMM; the projections around it (in,
x, dt, out) go through ``layers.dense`` and so through the scheduled
kernel under ``scheduled_kernels``.

Port of ``repro.models.ssm``; the reference computes the x and dt
projections inside its chunk loop, the port before it, on the same rows.
``jax.checkpoint`` (training only) is left out.  The kernel has no
backward and reads a tensor's own memory, so a block whose inputs require
grad (training) or are DTensors (a sharded block) calls the plain version
itself.  Under ``repro_torch.tracing.recording`` a block records the spans
``mamba.in_proj`` (with the causal conv), ``mamba.scan`` (the x and dt
projections and the scan) and ``mamba.out_proj`` (with the gate), and
counts ``mamba.kernel_calls`` or ``mamba.plain_calls`` once.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch import tracing
from repro_torch.kernels import scan
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


def mamba_block(params, cfg: ModelConfig, x: torch.Tensor, state: MambaState | None = None):
    """x [B,S,d] -> (y [B,S,d], final MambaState): one scan over S."""
    mc = cfg.mamba or MambaConfig()
    s = x.shape[1]
    compute = torch_dtype(cfg.compute_dtype)
    with tracing.span("mamba.in_proj"):
        xz = L.dense(params["in_proj"], x, compute_dtype=compute)
        u, z = torch.chunk(xz, 2, dim=-1)  # [B,S,d_in] each
        conv_state = state.conv if state is not None else None
        u, conv_state = _causal_conv(u, params["conv_w"].to(compute), params["conv_b"].to(compute), conv_state)
        u = torch.nn.functional.silu(u)

    with tracing.span("mamba.scan"):
        proj = L.dense(params["x_proj"], u)  # [B,S,dtr+2n]
        # dt is a strided slice: ops._operands copies it to a contiguous tensor
        dt, bmat, cmat = torch.split(proj, [_dt_rank(cfg), mc.d_state, mc.d_state], dim=-1)
        dt = L.dense(params["dt_proj"], dt)  # [B,S,d_in], before softplus
        h0 = state.h.contiguous() if state is not None else None
        args = (u, dt, params["A_log"], params["D"], bmat.contiguous(), cmat.contiguous(), h0)
        opts = {"chunk": L.chunk_len(s, mc.chunk)}
        differentiated = torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in args)
        if differentiated or isinstance(u, DTensor):
            tracing.count("mamba.plain_calls")
            y, h = scan.selective_scan_plain(*args, **opts)
        else:
            y, h = scan.selective_scan(*args, **opts)

    with tracing.span("mamba.out_proj"):
        y = y.to(compute) * torch.nn.functional.silu(z.to(torch.float32)).to(compute)
        out = L.dense(params["out_proj"], y, compute_dtype=compute)
    return out.to(x.dtype), MambaState(h=h, conv=conv_state)


def mamba_decode_step(params, cfg: ModelConfig, x: torch.Tensor, state: MambaState):
    """Single-token step: x [B,1,d] -> (y [B,1,d], new state).  O(1) in S."""
    return mamba_block(params, cfg, x, state)
