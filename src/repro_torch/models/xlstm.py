"""xLSTM blocks: mLSTM (matrix memory, parallelizable) and sLSTM (scalar
memory with recurrent gate connections, strictly sequential).

mLSTM prefill uses the quadratic parallel form (a decay-masked
attention-like product), chunked with the recurrent (C, n, m) state
carried across chunks; decode updates the matrix memory C [B, H, d, d]
in O(1) per token.  sLSTM is a loop over time with an exponential-gating
stabilizer state.

The gate and projection GEMMs go through ``layers.dense`` and so through
the scheduled kernel under ``scheduled_kernels``; the recurrences are
elementwise work and plain torch.

Port of ``repro.models.xlstm``.  ``lax.scan`` over chunks and over time
becomes a Python loop; ``jax.checkpoint`` (training only) is left out.
The masked log-decay keeps the reference's ``-inf`` entries before its
row max, and the stabilizer's ``max(m, 0)``.  sLSTM's ``x_t @ w_in + h @
r`` stays a plain f32 product per step, as in the reference, where it is
outside any kernel.  On DTensors the recurrences run under ``local_map``
on each shard's own batch rows (and, for the mLSTM, heads): the sLSTM's
recurrent weights are gathered once per block, not per step.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.kernels.ref import torch_dtype
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig, XLSTMConfig
from repro_torch.parallel.policy import (
    constrain,
    data_partial,
    heads_axis,
    on_mesh_of,
    replicate,
    run_local,
    spec_for,
)

# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def init_mlstm(gen, cfg: ModelConfig, dtype=torch.float32, *, lead=()):
    xc = cfg.xlstm or XLSTMConfig()
    d = cfg.d_model
    d_in = int(xc.proj_factor * d)
    return {
        "up": L.init_dense(gen, d, 2 * d_in, dtype=dtype, lead=lead),
        "q": L.init_dense(gen, d_in, d_in, dtype=dtype, lead=lead),
        "k": L.init_dense(gen, d_in, d_in, dtype=dtype, lead=lead),
        "v": L.init_dense(gen, d_in, d_in, dtype=dtype, lead=lead),
        "i_gate": L.init_dense(gen, d_in, cfg.n_heads, bias=True, dtype=dtype, lead=lead),
        "f_gate": L.init_dense(gen, d_in, cfg.n_heads, bias=True, dtype=dtype, lead=lead),
        "o_gate": L.init_dense(gen, d_in, d_in, bias=True, dtype=dtype, lead=lead),
        "down": L.init_dense(gen, d_in, d, dtype=dtype, lead=lead),
    }


class MLSTMState(NamedTuple):
    c: torch.Tensor  # [B, H, dh, dh] matrix memory
    n: torch.Tensor  # [B, H, dh] normalizer
    m: torch.Tensor  # [B, H] gate stabilizer


def init_mlstm_state(cfg: ModelConfig, batch: int, *, device=None, lead=()) -> MLSTMState:
    xc = cfg.xlstm or XLSTMConfig()
    d_in = int(xc.proj_factor * cfg.d_model)
    h = cfg.n_heads
    dh = d_in // h
    f32 = dict(dtype=torch.float32, device=device)
    return MLSTMState(
        c=torch.zeros((*lead, batch, h, dh, dh), **f32),
        n=torch.zeros((*lead, batch, h, dh), **f32),
        m=torch.zeros((*lead, batch, h), **f32),
    )


def _heads(x: torch.Tensor, h: int) -> torch.Tensor:
    b, s, _ = x.shape
    x = constrain(x, "dp", None, heads_axis(h))  # whole heads per shard
    return x.reshape(b, s, h, -1).permute(0, 2, 1, 3)  # [B,H,S,dh]


def _project(params, cfg: ModelConfig, x: torch.Tensor):
    """The shared front of both forms: (u, z, q, k / sqrt(dh), v, input
    gate log, forget gate pre-activation) with the gates as [B,S,H] f32
    (``_gates`` turns them into the [B,H,S] logs)."""
    h = cfg.n_heads
    compute = torch_dtype(cfg.compute_dtype)
    up = L.dense(params["up"], x, compute_dtype=compute)
    u, z = torch.chunk(up, 2, dim=-1)
    q = _heads(L.dense(params["q"], u, compute_dtype=compute), h)
    k = _heads(L.dense(params["k"], u, compute_dtype=compute), h)
    v = _heads(L.dense(params["v"], u, compute_dtype=compute), h)
    k = k / (q.shape[-1] ** 0.5)
    i_gate = L.dense(params["i_gate"], u).to(torch.float32)
    f_gate = L.dense(params["f_gate"], u).to(torch.float32)
    return u, z, q, k, v, i_gate, f_gate


def _gates(i_gate: torch.Tensor, f_gate: torch.Tensor):
    """[B,S,H] gate projections -> (input gate log, forget gate
    log-sigmoid) as [B,H,S]."""
    return i_gate.permute(0, 2, 1), torch.nn.functional.logsigmoid(f_gate).permute(0, 2, 1)


def _log_decay(fcum: torch.Tensor, i_log: torch.Tensor) -> torch.Tensor:
    """Log decay from s to t, fcum_t - fcum_s + i_s, with -inf above the
    diagonal (t < s)."""
    s = fcum.shape[-1]
    logd = fcum[..., :, None] - fcum[..., None, :] + i_log[..., None, :]
    tri = torch.tril(torch.ones((s, s), dtype=torch.bool, device=fcum.device))
    return torch.where(tri[None, None], logd, torch.full((), float("-inf"), device=fcum.device))


def _output(params, cfg: ModelConfig, u, z, y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """o-gate, silu(z) gate and the down projection of y [B,H,S,dh]."""
    compute = torch_dtype(cfg.compute_dtype)
    b, h, s, _ = y.shape
    y = constrain(y.permute(0, 2, 1, 3).reshape(b, s, -1), "dp", None, heads_axis(h))
    o = torch.sigmoid(L.dense(params["o_gate"], u).to(torch.float32)).to(compute)
    gated = y.to(compute) * o * torch.nn.functional.silu(z.to(torch.float32)).to(compute)
    return L.dense(params["down"], gated, compute_dtype=compute).to(x.dtype)


def _on_heads(fn, *args, out_ranks: tuple[int, ...]):
    """``fn(q, k, v, i_gate, f_gate, *state)``: q, k, v and the state
    [B, H, ...], the gates [B, S, H].  On DTensors each shard runs its own
    batch rows and heads (``local_map``: batch on the data axes, heads on
    the model axis where it divides them), its outputs of ranks
    ``out_ranks`` laid out alike."""
    if not any(isinstance(a, DTensor) for a in args):
        return run_local(fn, *args)
    like = next(a for a in args if isinstance(a, DTensor))
    hx = heads_axis(args[0].shape[1])
    laid = []
    for i, a in enumerate(args):
        dims = ["dp"] + [None] * (a.dim() - 1)
        dims[2 if i in (3, 4) else 1] = hx  # the gates carry heads last
        laid.append(constrain(on_mesh_of(a, like), *dims))
    b, h = args[0].shape[:2]
    specs = tuple(spec_for((b, h, *(1,) * (r - 2)), "dp", hx) for r in out_ranks)
    return run_local(fn, *laid, out_specs=specs)


def _mlstm_parallel_core(q, k, v, i_gate, f_gate):
    i_log, f_log = _gates(i_gate, f_gate)
    fcum = torch.cumsum(f_log, dim=-1)  # [B,H,S]
    logd = _log_decay(fcum, i_log)
    m = torch.clamp_min(logd.amax(dim=-1, keepdim=True), 0.0)  # stabilizer
    d = torch.exp(logd - m)
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k).to(torch.float32) * d
    norm = torch.maximum(scores.sum(-1).abs(), torch.exp(-m[..., 0]))[..., None]
    return torch.einsum("bhqk,bhkd->bhqd", (scores / norm).to(v.dtype), v)


def mlstm_parallel(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Parallel form over the full sequence: y_t = o_t * (sum_{s<=t} D_ts
    q_t.k_s v_s) / norm, with the log-decay matrix D from the cumulative
    forget gates."""
    u, z, q, k, v, i_gate, f_gate = _project(params, cfg, x)
    y = _on_heads(_mlstm_parallel_core, q, k, v, i_gate, f_gate, out_ranks=(4,))
    return _output(params, cfg, u, z, y, x)


def _mlstm_chunk_core(q, k, v, i_gate, f_gate, c, n, m_prev, *, compute):
    """The recurrence of one chunk on [B, H, ...] tensors: (y, the state
    at the chunk's end)."""
    i_log, f_log = _gates(i_gate, f_gate)
    fcum = torch.cumsum(f_log, dim=-1)
    f32 = torch.float32

    logd = _log_decay(fcum, i_log)  # intra-chunk decay
    logc = fcum + m_prev[..., None]  # the carried state decayed to each position

    m_intra = logd.amax(dim=-1)
    m_tot = torch.clamp_min(torch.maximum(m_intra, logc), 0.0)  # [B,H,S]
    d_intra = torch.exp(logd - m_tot[..., None])
    d_carry = torch.exp(logc - m_tot)

    scores = torch.einsum("bhqd,bhkd->bhqk", q, k).to(f32) * d_intra
    num_carry = torch.einsum("bhsd,bhde->bhse", q.to(f32), c) * d_carry[..., None]
    den_carry = torch.einsum("bhsd,bhd->bhs", q.to(f32), n) * d_carry
    num = torch.einsum("bhqk,bhkd->bhqd", scores, v.to(f32)) + num_carry
    den = scores.sum(-1) + den_carry
    norm = torch.maximum(den.abs(), torch.exp(-m_tot))[..., None]
    y = (num / norm).to(compute)

    # the state at the end of the chunk
    f_tot = fcum[..., -1]  # [B,H]
    tail = i_log + fcum[..., -1:] - fcum  # [B,H,S]
    m_new = torch.maximum(f_tot + m_prev, tail.amax(dim=-1))
    decay_state = torch.exp(f_tot + m_prev - m_new)
    kv_w = torch.exp(tail - m_new[..., None])
    c_new = c * decay_state[..., None, None] + torch.einsum(
        "bhsd,bhse,bhs->bhde", k.to(f32), v.to(f32), kv_w
    )
    n_new = n * decay_state[..., None] + torch.einsum("bhsd,bhs->bhd", k.to(f32), kv_w)
    return y, c_new, n_new, m_new


def _mlstm_chunk_recurrent(params, cfg: ModelConfig, x: torch.Tensor, state: MLSTMState):
    """One chunk: intra-chunk parallel form + the carried state, and the
    state at the chunk's end."""
    compute = torch_dtype(cfg.compute_dtype)
    u, z, q, k, v, i_gate, f_gate = _project(params, cfg, x)
    y, c_new, n_new, m_new = _on_heads(
        functools.partial(_mlstm_chunk_core, compute=compute),
        q, k, v, i_gate, f_gate, state.c, state.n, state.m,
        out_ranks=(4, 4, 3, 2),
    )
    return _output(params, cfg, u, z, y, x), MLSTMState(c=c_new, n=n_new, m=m_new)


def _mlstm_chunk_scan(params, cfg: ModelConfig, x: torch.Tensor, state: MLSTMState, chunk: int):
    ys = []
    for c0 in range(0, x.shape[1], chunk):
        y, state = _mlstm_chunk_recurrent(params, cfg, x[:, c0 : c0 + chunk], state)
        ys.append(y)
    return torch.cat(ys, dim=1), state


def mlstm_block(params, cfg: ModelConfig, x: torch.Tensor, *, chunk: int = 0) -> torch.Tensor:
    """The parallel form chunked over S (memory O(chunk^2)), carrying the
    recurrent (C, n, m) state across chunks; one parallel pass where the
    chunk would be the whole sequence."""
    s = x.shape[1]
    chunk = L.chunk_len(s, chunk or cfg.attn_chunk)
    if chunk == s:
        return mlstm_parallel(params, cfg, x)
    state = init_mlstm_state(cfg, x.shape[0], device=x.device)
    y, _ = _mlstm_chunk_scan(params, cfg, x, state, chunk)
    return y


def mlstm_decode_step(params, cfg: ModelConfig, x: torch.Tensor, state: MLSTMState):
    """One token [B,1,d]: O(1) matrix-memory update."""
    return _mlstm_chunk_recurrent(params, cfg, x, state)


def mlstm_prefill(params, cfg: ModelConfig, x: torch.Tensor, state: MLSTMState, *, chunk: int = 512):
    """Chunked prefill carrying the matrix memory (memory O(chunk^2))."""
    return _mlstm_chunk_scan(params, cfg, x, state, L.chunk_len(x.shape[1], chunk))


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def init_slstm(gen, cfg: ModelConfig, dtype=torch.float32, *, lead=()):
    d = cfg.d_model
    scale = (1.0 / d) ** 0.5
    return {
        "w_in": L.draw_normal(gen, (d, 4 * d), scale, dtype, lead),
        "r": L.draw_normal(gen, (d, 4 * d), scale, dtype, lead),
        "b": torch.zeros((*lead, 4 * d), dtype=dtype, device=gen.device),
        "out": L.init_dense(gen, d, d, dtype=dtype, lead=lead),
    }


class SLSTMState(NamedTuple):
    c: torch.Tensor  # [B, d]
    n: torch.Tensor  # [B, d]
    h: torch.Tensor  # [B, d]
    m: torch.Tensor  # [B, d] stabilizer


def init_slstm_state(cfg: ModelConfig, batch: int, *, device=None, lead=()) -> SLSTMState:
    shape = (*lead, batch, cfg.d_model)
    return SLSTMState(*(torch.zeros(shape, dtype=torch.float32, device=device) for _ in range(4)))


def _slstm_step(params, x_t: torch.Tensor, st: SLSTMState) -> SLSTMState:
    f32 = torch.float32
    gates = x_t.to(f32) @ params["w_in"].to(f32) + st.h @ params["r"].to(f32) + params["b"].to(f32)
    i_t, f_t, z_t, o_t = torch.chunk(gates, 4, dim=-1)
    m_new = torch.maximum(f_t + st.m, i_t)
    i_ = torch.exp(i_t - m_new)
    f_ = torch.exp(f_t + st.m - m_new)
    c_new = f_ * st.c + i_ * torch.tanh(z_t)
    n_new = f_ * st.n + i_
    h_new = torch.sigmoid(o_t) * c_new / torch.clamp_min(n_new, 1e-6)
    return SLSTMState(c=c_new, n=n_new, h=h_new, m=m_new)


def _slstm_scan(x, w_in, r, b, c, n, h, m):
    """The loop over time: x [B,S,d] -> (h over time [B,S,d] in x's
    dtype, the final c, n, h, m)."""
    params = {"w_in": w_in, "r": r, "b": b}
    st = SLSTMState(c=c, n=n, h=h, m=m)
    hs = []
    for t in range(x.shape[1]):
        st = _slstm_step(params, x[:, t], st)
        hs.append(st.h)
    return (torch.stack(hs, dim=1).to(x.dtype), *st)


def slstm_block(params, cfg: ModelConfig, x: torch.Tensor, state: SLSTMState | None = None):
    """x [B,S,d] -> (y [B,S,d], final state); a loop over time.  On
    DTensors the loop runs on each data shard's own rows (``local_map``),
    the recurrent weights gathered once per block rather than per step."""
    st = state if state is not None else init_slstm_state(cfg, x.shape[0], device=x.device)
    weights = (params["w_in"], params["r"], params["b"])
    out_specs = grads = None
    if isinstance(x, DTensor):
        x = constrain(x, "dp", None, None)
        st = SLSTMState(*(constrain(on_mesh_of(t, x), "dp", None) for t in st))
        weights = tuple(replicate(w) for w in weights)
        spec = spec_for(st.c.shape, "dp", None)
        out_specs = ((spec[0], None, None), spec, spec, spec, spec)
        grads = (None, *(data_partial(w) for w in weights), None, None, None, None)
    y, *last = run_local(_slstm_scan, x, *weights, *st, out_specs=out_specs, grad_placements=grads)
    st = SLSTMState(*last)
    compute = torch_dtype(cfg.compute_dtype)
    return L.dense(params["out"], y, compute_dtype=compute).to(x.dtype), st


def slstm_decode_step(params, cfg: ModelConfig, x: torch.Tensor, state: SLSTMState):
    return slstm_block(params, cfg, x, state)
