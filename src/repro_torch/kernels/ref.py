"""Plain PyTorch versions of the scheduled GEMM kernel.

Port of ``repro.kernels.ref`` (``gemm_ref``, ``qgemm_ref``,
``flash_attention_ref``).  They run on whatever device their tensors lie
on: the CPU tests use them as the kernel, and ``chip_smoke.py`` holds the
CUDA kernel against them on the card.  ``flash_attention_ref`` is the
dense oracle of the LM's attention (``repro_torch.models.flash`` and
``repro_torch.models.attention``), which is plain torch in the port as
it is plain JAX in the reference.

Integer products are summed in float64, which is exact here (every
partial sum of int8 products stays far below 2**53), and then wrapped to
int32 through int64, which reproduces the reference's int32 accumulator
(mod-2**32 wrap) bit for bit on both the CPU and the card, where torch
has no integer matrix product.
"""

from __future__ import annotations

import torch

_DTYPES = {
    "int8": torch.int8,
    "uint8": torch.uint8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float64": torch.float64,
    "bool": torch.bool,
}


def torch_dtype(name) -> torch.dtype:
    """The torch dtype of a numpy-style dtype name (or a torch dtype)."""
    if isinstance(name, torch.dtype):
        return name
    return _DTYPES[str(name)]


def dtype_name(dtype: torch.dtype) -> str:
    """The numpy-style name of a torch dtype (``torch.bfloat16`` -> ``"bfloat16"``)."""
    return str(dtype).removeprefix("torch.")


def int_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Exact integer ``x @ w`` as int64 (see the module docstring)."""
    return (x.to(torch.float64) @ w.to(torch.float64)).to(torch.int64)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (tanh approximation) in the tensor's own dtype."""
    c = torch.full((), 0.7978845608028654, dtype=x.dtype, device=x.device)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + 0.044715 * (x * x * x)))))


def gemm_ref(
    x: torch.Tensor,
    w: torch.Tensor,
    bias: torch.Tensor | None = None,
    *,
    acc_dtype="float32",
    out_dtype="float32",
    activation: str | None = None,
) -> torch.Tensor:
    """``activation(x @ w + bias)`` with the sum in ``acc_dtype``."""
    acc_t = torch_dtype(acc_dtype)
    if acc_t == torch.int32:
        acc = int_matmul(x, w)
        if bias is not None:
            acc = acc + bias.to(torch.int32).to(torch.int64)
        acc = acc.to(torch.int32)
    else:
        acc = x.to(acc_t) @ w.to(acc_t)
        if bias is not None:
            acc = acc + bias.to(acc_t)
    if activation == "relu":
        acc = torch.clamp_min(acc, 0)
    elif activation == "gelu":
        acc = gelu_tanh(acc)
    elif activation is not None:
        raise ValueError(f"unknown activation {activation!r}")
    return acc.to(torch_dtype(out_dtype))


def qgemm_ref(
    x_q: torch.Tensor,
    w_q: torch.Tensor,
    bias: torch.Tensor | None,
    *,
    requant_scale: float,
    clip_lo: float = -128.0,
    clip_hi: float = 127.0,
    out_dtype="int8",
) -> torch.Tensor:
    """Quantized dense: int8 x int8 -> int32 acc -> requantize -> clip.

    The requantize multiplies in float32 by the float32 value of the scale
    and rounds half to even, as ``jnp.round`` does."""
    acc = int_matmul(x_q, w_q)
    if bias is not None:
        acc = acc + bias.to(torch.int32).to(torch.int64)
    acc = acc.to(torch.int32)
    scale = torch.full((), requant_scale, dtype=torch.float32, device=acc.device)
    out = torch.round(acc.to(torch.float32) * scale)
    out = torch.clamp(out, float(clip_lo), float(clip_hi))
    return out.to(torch_dtype(out_dtype))


def flash_attention_ref(
    q: torch.Tensor,  # [B, H, S, D]
    k: torch.Tensor,  # [B, H_kv, S, D]
    v: torch.Tensor,  # [B, H_kv, S, D]
    *,
    causal: bool = True,
    window: int | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """Dense causal / windowed attention; GQA and MQA repeat each KV head
    over its consecutive query heads (``jnp.repeat``: ``repeat_interleave``)."""
    b, h, s, d = q.shape
    h_kv = k.shape[1]
    if h_kv != h:
        rep = h // h_kv
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    scale = scale if scale is not None else 1.0 / (d**0.5)
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k).to(torch.float32) * scale
    qi = torch.arange(s, device=q.device)[:, None]
    ki = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= ki <= qi
    if window is not None:
        mask &= ki > qi - window
    logits = torch.where(mask, logits, torch.tensor(-1e30, dtype=torch.float32, device=q.device))
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), v)
